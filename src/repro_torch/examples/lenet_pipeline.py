"""Paper §5 case study on the port: the LeNet-5 inference ladder (Table
3), as ``examples/lenet_pipeline.py`` walks it.

naive -> InputToConstant -> StreamingComposition, driven through the
staged pipeline (``Lowered.optimize`` with pass pipelines): the naive
program on the structural interpreter (``torch``), the streamed one on the
``cuda`` backend, where both conv+pool pairs fuse and the Conv and Linear
levels run the hand-written ``matmul`` kernel (``csrc/gemm.cu``); each
held to the plain PyTorch oracle at the reference's tolerances.

    PYTHONPATH=src python -m repro_torch.examples.lenet_pipeline \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import kernels  # noqa: F401  (registers the Conv2d+MaxPool2d fusion)
from ..frontends.ml import build_lenet, init_lenet_params, lenet_reference
from ..pipeline import (DeviceOffloadPass, InputToConstantPass,
                        StreamingCompositionPass, lower)
from ..pipeline.stages import resolve_device


def main(argv=None) -> dict:
    """Run the ladder; returns the off-chip volumes, the fused regions and
    the streamed program's probabilities (a tensor on the device)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = 100
    params = init_lenet_params()
    weights = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((batch, 1, 28, 28))
                        .astype(np.float32), device=dev)
    expected = lenet_reference(weights, x)

    print("== naive (all parameters and intermediates off-chip)")
    l1 = lower(build_lenet(batch)).optimize([DeviceOffloadPass()])
    v_naive = l1.sdfg.off_chip_volume()
    print(f"   off-chip volume: {v_naive/2**20:.2f} MiB")
    got = l1.compile("torch", device=dev)(x=x, **weights)["probs"]
    torch.testing.assert_close(got, expected, rtol=1e-2, atol=1e-4)

    print("== InputToConstant (paper: parameters fixed in hardware)")
    l2 = lower(build_lenet(batch)).optimize(
        [InputToConstantPass(parameters=params), DeviceOffloadPass()])
    v_const = l2.sdfg.off_chip_volume()
    print(f"   off-chip volume: {v_const/2**20:.2f} MiB")

    print(f"== + StreamingComposition, cuda backend on {dev}")
    l2.optimize([StreamingCompositionPass()])
    v_stream = l2.sdfg.off_chip_volume()
    c = l2.compile("cuda", device=dev)
    c(x=x)      # the kernels build and compile on the first call
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    probs = c(x=x)["probs"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    torch.testing.assert_close(probs, expected, rtol=1e-2, atol=1e-4)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "CPU (plain versions)"
    print(f"   off-chip volume: {v_stream/2**20:.2f} MiB")
    print(f"   fused pipelines: {c.report['fused_regions']}")
    print(f"   inference time on {where}: {dt*1e3:.1f} ms for batch {batch}")
    print("OK")
    return {"volumes": (v_naive, v_const, v_stream),
            "fused_regions": c.report["fused_regions"], "probs": probs}


if __name__ == "__main__":
    main()
