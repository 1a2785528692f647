"""The training runtime, the counterpart of the reference's
``repro/runtime/trainer.py``, on one device.

The control loop is the reference's: checkpoint/restart through atomic
step-directory checkpoints (``checkpoint/``) and counter-based data
(``data/``), so a restart replays exactly; a heartbeat monitor flags
steps past a deadline and stragglers past ``straggler_factor`` times the
median. The reference jits its step through the compilation cache; the
port's step runs eagerly, op by op (capturing it as a CUDA graph is
queued in ROADMAP for a ``perf_opt`` PR). The mesh, sharded checkpoints,
gradient compression and the simulated cluster come with the scale-out
runtime (ROADMAP step 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from ..configs.base import ModelConfig
from ..data import DataConfig, make_global_batch
from ..launch.steps import _no_mesh, make_train_step
from ..pipeline.stages import resolve_device


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 20
    checkpoint_every: int = 10
    ckpt_dir: Optional[str] = None
    heartbeat_deadline_s: float = 300.0
    straggler_factor: float = 2.0
    log_every: int = 1


class HeartbeatMonitor:
    """Tracks per-step durations; flags stragglers and missed deadlines."""

    def __init__(self, deadline_s: float, straggler_factor: float):
        self.deadline_s = deadline_s
        self.straggler_factor = straggler_factor
        self.durations = []
        self.events = []
        self.host_status = {}  # host -> last status ("ok|straggler|dead")

    def record(self, host: int, duration: float):
        self.durations.append(duration)
        if duration > self.deadline_s:
            self.events.append(("dead", host, duration))
            self.host_status[host] = "dead"
            return "dead"
        # dead hosts record inf/NaN durations; those must not enter the
        # straggler median or one death inflates the threshold forever
        finite = [d for d in self.durations[-32:] if np.isfinite(d)]
        med = float(np.median(finite)) if finite else duration
        if len(finite) >= 4 and duration > self.straggler_factor * med:
            self.events.append(("straggler", host, duration))
            self.host_status[host] = "straggler"
            return "straggler"
        self.host_status[host] = "ok"
        return "ok"


class Trainer:
    """Trains ``cfg`` on ``device`` (``cuda`` unless given another; without
    a card asking for it raises) with the reference's loop: restore the
    latest checkpoint or init, then one step a global batch, a checkpoint
    every ``checkpoint_every`` steps. As the reference's, its step keeps
    every activation (``remat=False``)."""

    def __init__(self, cfg: ModelConfig, mesh=None,
                 tcfg: TrainerConfig = None, seq_len: int = 512,
                 global_batch: int = 8, device=None):
        _no_mesh(mesh, "Trainer")
        self.cfg = cfg
        self.tcfg = tcfg or TrainerConfig()
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.device = resolve_device(device)
        self.step_fn, self.model, self.opt = make_train_step(
            cfg, remat=False)
        self.data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                   global_batch=global_batch)
        self.monitor = HeartbeatMonitor(self.tcfg.heartbeat_deadline_s,
                                        self.tcfg.straggler_factor)

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen)
        return {"params": params, "opt": self.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32)}

    def restore_or_init(self) -> Dict:
        state = self.init_state()
        if self.tcfg.ckpt_dir:
            last = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
            if last is not None:
                state = ckpt_lib.restore(self.tcfg.ckpt_dir, last, state)
        return state

    # -- loop ---------------------------------------------------------------
    def run(self, on_step: Callable = None) -> Dict:
        state = self.restore_or_init()
        start = int(state["step"])
        metrics_log = []
        for step in range(start, self.tcfg.steps):
            t0 = time.time()
            batch_np = make_global_batch(self.data_cfg, step, self.cfg)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch_np.items()}
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.monitor.record(0, dt)
            metrics_log.append({"step": step, "loss": loss,
                                "grad_norm": float(metrics["grad_norm"]),
                                "s": dt})
            if on_step:
                on_step(step, metrics)
            if (self.tcfg.ckpt_dir
                    and (step + 1) % self.tcfg.checkpoint_every == 0):
                ckpt_lib.save(self.tcfg.ckpt_dir, step + 1, state)
        return {"state": state, "log": metrics_log,
                "events": self.monitor.events}
