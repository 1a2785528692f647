"""Device time of ``flash_attention_bwd`` (kernel row 12b) at the training
path's two attention layers, in fp32 and bf16, one JSON line a case, timed
by ``chip_smoke.py``'s own yardstick.

The cases are starcoder2-3b's layer (B 1, S 4,096, Hq 24, Hkv 2, Dh 128)
and LM100M's (B 8, S 256, H 10, Dh 64), both causal, on seeded normal
q, k, v and dout; out and the rows' log-sum-exp come from the plain
forward (``flash_attention_ref``) on the card. Each case is first held to
the backward's plain version as ``chip_smoke.py``'s ``measure_train``
holds it (``Smoke.flash_bwd_held``), so a time is that of a kernel that did
the work. A time is ``Smoke.device_ms``: calls captured in one CUDA graph
and replayed between two CUDA events, the best of three replays, a call's
mean. The bound is 10 Dh flops an admitted pair and query head over the
route's peak (``chip_smoke``'s bf16 tensor-core and 3xTF32 peaks), as
``measure_train``'s. With ``--library``, the line adds PyTorch's
scaled_dot_product_attention backward on the GQA-repeated heads by CUDA
events and by device time (``Smoke.flash_bwd_library``, ``is_causal``);
with ``--profile``, each of the kernel's launches' device time by name
(torch.profiler, a call's mean).

``chip_smoke.py`` is taken from this checkout and ``repro_torch`` from the
path the script is run with, so that it times another checkout's kernel
through the same public functions and the same yardstick: run two
checkouts in turns on one card to compare them::

    PYTHONPATH=src python3 tools/flash_bwd_bench.py [--library]
    PYTHONPATH=<checkout>/src python3 tools/flash_bwd_bench.py --tag parent

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the yardstick)

#: name -> (B, S, Hq, Hkv, Dh), causal
CASES = {"starcoder2": (1, 4096, 24, 2, 128),
         "lm100m": (8, 256, 10, 10, 64)}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
PEAK = {"fp32": cs.TF32X3_FLOP_PER_S, "bf16": cs.BF16_TENSOR_FLOP_PER_S}


def kernels_ms(fn, reps: int = 10) -> dict:
    """The device time of the kernels ``fn`` launches by name, a call's
    mean over ``reps`` calls under torch.profiler (after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            found = re.search(r"(\w+)[<(]", e.name)
            name = found.group(1) if found else e.name[:40]
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
    return by_name


def run_case(smoke, name: str, dt: str, library: bool, profile: bool,
             seed: int = 0) -> dict:
    from repro_torch.kernels.attention import (flash_attention_bwd,
                                               flash_attention_bwd_ref,
                                               flash_attention_ref)
    B, S, Hq, Hkv, Dh = CASES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, Dh, generator=g, device="cuda")
                   .to(DTYPES[dt]) for H in (Hq, Hkv, Hkv, Hq))
    out, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, do)
    worst, err = smoke.flash_bwd_held(f"{name} {dt}", got, plain, q, k, v,
                                      do)
    del got, plain

    def kernel():
        return flash_attention_bwd(q, k, v, out, lse, do)
    n_ops = 10 * Dh * (S * (S + 1) // 2) * B * Hq
    ms = smoke.device_ms(kernel)
    row = {"case": name, "dtype": dt, "shape": [B, S, Hq, Hkv, Dh],
           "x_limit": worst, "max_abs_err": err, "ops": n_ops,
           "bound_ms": n_ops / PEAK[dt] * 1e3, "device_ms": ms}
    row["bound_share"] = row["bound_ms"] / ms
    if profile:
        row["kernels_ms"] = kernels_ms(kernel)
    if library:
        row["library_ms"], row["library_device_ms"] = \
            smoke.flash_bwd_library(q, k, v, do)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="this",
                        help="a name for the checkout timed, printed with "
                             "each line")
    parser.add_argument("--cases", nargs="+", default=list(CASES),
                        choices=list(CASES))
    parser.add_argument("--dtypes", nargs="+", default=list(DTYPES),
                        choices=list(DTYPES))
    parser.add_argument("--library", action="store_true",
                        help="also time PyTorch's SDPA backward")
    parser.add_argument("--profile", action="store_true",
                        help="also give each kernel's device time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_bench: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = cs.Smoke()
    for name in args.cases:
        for dt in args.dtypes:
            row = run_case(smoke, name, dt, args.library, args.profile)
            print(json.dumps({"tag": args.tag, **row}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
