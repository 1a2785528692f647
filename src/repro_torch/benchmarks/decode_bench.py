"""Device time of ``decode_attention`` (kernel row 11) at three bf16 cases,
warm and with its operands out of the L2 cache, one JSON line a case.

The cases are the serving step's (B 64, C 64, H 24, Dh 128, every row at
pos 38: 2,496 of 4,096 K/V rows admitted), a long context (B 8, C 4,096,
H 24, Dh 128) and gemma3-4b's windowed layers GQA-repeated (B 16,
C 2,048, H 8, Dh 256, window 1,024), the last two at pos = C - 1. A time
is ``chip_smoke.py``'s ``device_ms``: calls captured in one CUDA graph and
replayed between two CUDA events, the best of three replays, a call's
mean; cold, the calls rotate over copies of the operands that together
exceed twice the 50 MB L2. Each case is first held to the plain version
(one bf16 ulp), so a time is that of a kernel that did the work. The
bound is the bytes of q, pos, out and the admitted K and V rows at
3.35 TB/s (the H100 SXM data sheet's rate).

The script imports ``repro_torch`` from the path it is run with, so it
times another checkout's kernel as well, through the same public wrapper:
run two checkouts in turns on one card to compare them::

    PYTHONPATH=src python3 src/repro_torch/benchmarks/decode_bench.py
    PYTHONPATH=<checkout>/src \
        python3 src/repro_torch/benchmarks/decode_bench.py --tag parent

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

#: name -> (B, C, H, Dh, window, pos)
CASES = {"serving": (64, 64, 24, 128, None, 38),
         "long": (8, 4096, 24, 128, None, 4095),
         "windowed": (16, 2048, 8, 256, 1024, 2047)}
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
REPS = 10


def graph_ms(calls) -> float:
    """The card's time for one of ``calls``, replayed as one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in dict.fromkeys(calls):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in calls:
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times) / len(calls)


def run_case(name: str, seed: int = 0) -> dict:
    from repro_torch.kernels.attention import (decode_attention,
                                               decode_attention_ref)
    B, C, H, Dh, window, p = CASES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(*s, generator=g, device="cuda")
               .to(torch.bfloat16)
               for s in ((B, H, Dh), (B, C, H, Dh), (B, C, H, Dh)))
    pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
    got = decode_attention(q, k, v, pos, window=window)
    want = decode_attention_ref(q, k, v, pos, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2.0 ** -7)
    rows = min(p, C - 1) + 1 - (max(0, p - window + 1) if window else 0)
    read = 2 * B * rows * H * Dh * k.element_size()
    nbytes = read + 2 * q.numel() * q.element_size() + 4 * B
    copies = [(q, k, v, pos)] + [
        tuple(t.clone() for t in (q, k, v, pos))
        for _ in range(2 * L2_BYTES // read + 1)]
    fns = [(lambda c=c: decode_attention(*c, window=window)) for c in copies]
    warm = graph_ms([fns[0]] * REPS)
    cold = graph_ms(fns * -(-REPS // len(fns)))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"case": name, "shape": [B, C, H, Dh], "window": window,
            "pos": p, "rows_kv": B * rows, "bytes": nbytes,
            "cold_copies": len(copies), "bound_ms": bound,
            "device_ms": warm, "device_ms_cold": cold,
            "share_of_bound": bound / warm,
            "share_of_bound_cold": bound / cold}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="this",
                        help="a name for the checkout timed, printed with "
                             "each line")
    parser.add_argument("--cases", nargs="+", default=list(CASES),
                        choices=list(CASES))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device is available", file=sys.stderr)
        return 2
    for name in args.cases:
        row = run_case(name)
        print(json.dumps({"tag": args.tag, **row}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
