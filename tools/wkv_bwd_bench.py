"""Device time of ``wkv_chunked_bwd`` (kernel row 13b) at rwkv6-7b's
layer on the training path, in fp32 and bf16, one JSON line a case, timed
by ``chip_smoke.py``'s own yardstick.

The case is rwkv6-7b's layer (B 1, S 4,096, H 64, hd 64, no state0) on
operands drawn as ``chip_smoke.py`` draws them (``Smoke.wkv_inputs``: the
decays in the model's range) with a seeded normal dout and final-state
gradient. Each case is first held to the backward's plain version as
``measure_train`` holds it (``Smoke.bwd_within`` for dr, dk, dv, dw, du;
in bf16 one bf16 ulp of each element besides, the outputs' rounding), so a
time is that of a kernel that did the work. A time is ``Smoke.device_ms``:
calls captured in one CUDA graph and replayed between two CUDA events, the
best of three replays, a call's mean. The bound is the bytes the function
must move (r, k, v, w, dout in; dr, dk, dv, dw out; u and du) over the
memory rate, as ``measure_train``'s. With ``--profile``, each of the
kernel's launches' device time by name (torch.profiler, a call's mean).

``chip_smoke.py`` is taken from this checkout and ``repro_torch`` from the
path the script is run with, so that it times another checkout's kernel
through the same public functions and the same yardstick: run two
checkouts in turns on one card to compare them::

    PYTHONPATH=src python3 tools/wkv_bwd_bench.py [--profile]
    PYTHONPATH=<checkout>/src python3 tools/wkv_bwd_bench.py --tag parent

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS.parent))
sys.path.insert(0, str(TOOLS))
import chip_smoke as cs  # noqa: E402  (the yardstick)
from flash_bwd_bench import kernels_ms  # noqa: E402

#: name -> (B, S, H, hd)
CASES = {"rwkv6": (1, 4096, 64, 64)}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def run_case(smoke, name: str, dt: str, profile: bool, seed: int = 0) -> dict:
    from repro_torch.kernels.rwkv import wkv_chunked_bwd, wkv_chunked_bwd_ref
    B, S, H, hd = CASES[name]
    dtype = DTYPES[dt]
    r, k, v, w, u, s0 = smoke.wkv_inputs(B, S, H, hd, dtype, seed, "none")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
    ds = torch.randn(B, H, hd, hd, generator=g, device="cuda")
    got = wkv_chunked_bwd(r, k, v, w, u, s0, do, ds)
    plain = wkv_chunked_bwd_ref(r, k, v, w, u, s0, do, ds)
    out_rel = cs.BF16_ULP if dtype == torch.bfloat16 else 0.0
    worst, err = 0.0, 0.0
    for part, a, p in zip(("dr", "dk", "dv", "dw", "du"), got, plain):
        ok, e, ratio = smoke.bwd_within(a, p, 0.0,
                                        0.0 if part == "du" else out_rel)
        cs.check(ok, f"wkv_chunked_bwd {part} at {name} {dt}: {ratio:.3g} "
                     f"x its limit against the plain version")
        worst, err = max(worst, ratio), max(err, e)
    del got, plain

    def kernel():
        return wkv_chunked_bwd(r, k, v, w, u, s0, do, ds)
    nbytes = 9 * r.numel() * r.element_size() + 2 * u.numel() * 4
    ms = smoke.device_ms(kernel)
    row = {"case": name, "dtype": dt, "shape": [B, S, H, hd],
           "x_limit": worst, "max_abs_err": err, "bytes": nbytes,
           "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3, "device_ms": ms}
    row["bound_share"] = row["bound_ms"] / ms
    if profile:
        row["kernels_ms"] = kernels_ms(kernel)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="this",
                        help="a name for the checkout timed, printed with "
                             "each line")
    parser.add_argument("--dtypes", nargs="+", default=list(DTYPES),
                        choices=list(DTYPES))
    parser.add_argument("--profile", action="store_true",
                        help="also give each kernel's device time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv_bwd_bench: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = cs.Smoke()
    for name in CASES:
        for dt in args.dtypes:
            row = run_case(smoke, name, dt, args.profile)
            print(json.dumps({"tag": args.tag, **row}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
