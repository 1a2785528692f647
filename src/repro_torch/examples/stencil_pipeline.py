"""Paper §6 case study on the port: a StencilFlow program through the
multi-level stack.

JSON program (Fig. 17, two diffusion iterations over 1,024 x 512) ->
Stencil Library Nodes -> DeviceOffload + StreamingComposition -> one fused
multi-stage kernel (``stencil2d_chain``, ``csrc/stencil.cu``: the
intermediate field never leaves shared memory), checked against two plain
``stencil2d_ref`` passes.

    PYTHONPATH=src python -m repro_torch.examples.stencil_pipeline \
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels  # noqa: F401  (registers the Stencil chains)
from repro_torch.frontends.stencil import build_stencil_program
from repro_torch.kernels.stencil import stencil2d_ref
from repro_torch.pipeline import (DeviceOffloadPass, StreamingCompositionPass,
                                  lower)

PROGRAM = {
    "name": "diffusion_2it",
    "dimensions": [1024, 512],
    "outputs": ["d"],
    "inputs": {"a": {"data_type": "float32", "input_dims": ["j", "k"]}},
    "program": {
        "b": {"computation": "b = c0*a[j,k] + c1*a[j-1,k] + c2*a[j+1,k] + "
                             "c3*a[j,k-1] + c4*a[j,k+1]"},
        "d": {"computation": "d = c0*b[j,k] + c1*b[j-1,k] + c2*b[j+1,k] + "
                             "c3*b[j,k-1] + c4*b[j,k+1]"},
    },
}
OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def main(argv=None) -> dict:
    """Run the flow; returns the fused regions, the off-chip volumes before
    and after streaming, and the output (a tensor on the device)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    print("== parse JSON program ->", len(PROGRAM["program"]),
          "stencil operators")
    staged = lower(build_stencil_program(PROGRAM))
    staged.optimize([DeviceOffloadPass()])
    v0 = staged.sdfg.off_chip_volume()
    staged.optimize([StreamingCompositionPass()])
    n_comp = staged.reports[-1]["passes"][0]["summary"]
    v1 = staged.sdfg.off_chip_volume()
    print(f"== StreamingComposition: {n_comp} intermediate(s) -> streams; "
          f"volume {v0/2**20:.1f} -> {v1/2**20:.1f} MiB")

    c = staged.compile("cuda", device=args.device)
    print("== fused:", c.report["fused_regions"], "on", c.device)

    rng = np.random.default_rng(0)
    a = rng.standard_normal(tuple(PROGRAM["dimensions"])).astype(np.float32)
    co = np.array([0.2, 0.1, 0.15, 0.25, 0.3], np.float32)
    out = c(a=a, b_coeffs=co, d_coeffs=co)["d"]
    ta = torch.from_numpy(a).to(out.device)
    exp = stencil2d_ref(stencil2d_ref(ta, co, OFFSETS), co, OFFSETS)
    torch.testing.assert_close(out, exp, rtol=1e-4, atol=1e-5)
    print("== matches the unfused reference. OK")
    return {"fused_regions": c.report["fused_regions"], "volumes": (v0, v1),
            "out": out}


if __name__ == "__main__":
    main()
