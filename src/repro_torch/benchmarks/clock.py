"""The clock of the port's report drivers (``axpydot``, ``gemver``,
``lenet``, ``jacobi_chain``): on the card the median of :data:`REPS`
CUDA-event timings of a call after one warm-up call; on the CPU (the plain
versions) the least of :data:`REPS` host-clock calls after a warm-up, as
the reference's drivers take their races (``benchmarks/lenet.py::_best``;
the harness runs a CPU run on ``run.CPU_THREADS`` intra-op threads). A CPU
time says nothing of the card's: every row names where it was taken.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

#: timed calls a time is taken over
REPS = 5


class Clock:
    """Times calls on ``device``; ``where`` names it for the report rows."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.where = torch.cuda.get_device_name(device) if self.on_card \
            else "CPU (plain versions)"

    def ms(self, fn, reps: int = REPS) -> float:
        """Milliseconds a call of ``fn`` takes (its result is discarded)."""
        if not self.on_card:
            fn()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return min(times)
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def check_race(self, winner_ms: float, loser_ms: float, claim: str):
        """A race of the reference, kept on every device: ``winner_ms``
        must be below ``loser_ms``."""
        assert winner_ms < loser_ms, claim


def tensors(d: dict, device: torch.device) -> dict:
    """numpy inputs as tensors on ``device`` (moved once, before timing;
    numpy scalars become 0-d tensors)."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in d.items()}
