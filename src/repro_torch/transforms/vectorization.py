"""Vectorization (paper §3.2.4): widen the data path to W elements.

On FPGA, W controls the unroll factor of inner circuits and accumulation
interleaving. On Hopper, the natural W is a warp's 16-byte fp32 loads
(32 threads x 4 = 128 elements); the transformation records W on the SDFG
and on each container
whose minor dimension divides W, and Library-Node expansions consult it to
pick block shapes / partial-sum widths (e.g. Dot's partial-sum buffer).
"""
from __future__ import annotations

from typing import Dict

from ..core.dtypes import HOPPER_LANES, rows_for_bytes
from ..core.sdfg import Array, SDFG, Scalar, Stream
from .base import Transformation


class Vectorization(Transformation):
    def __init__(self, width: int = HOPPER_LANES):
        self.width = width

    def find_matches(self, sdfg: SDFG, width: int = None, **kwargs):
        w = width or self.width
        if sdfg.metadata.get("vector_width") == w:
            return
        yield {"width": w}

    def apply_match(self, sdfg: SDFG, match: Dict):
        w = match["width"]
        sdfg.metadata["vector_width"] = w
        env = sdfg.symbol_values
        min_bytes = None
        for name, desc in sdfg.arrays.items():
            if isinstance(desc, (Scalar, Stream)) or not isinstance(desc, Array):
                continue
            if not desc.shape:
                continue
            min_bytes = desc.dtype.bytes if min_bytes is None \
                else min(min_bytes, desc.dtype.bytes)
            minor = desc.shape[-1]
            try:
                if minor.evaluate(env) % w == 0:
                    desc.vector_width = w
            except Exception:
                # symbolic minor dim: assume divisible (checked at dry-run)
                desc.vector_width = w
        if min_bytes is not None:
            # the dtype-aware row count MapTiling's second-dim default
            # consults when a scope's own containers don't pin one
            # (narrowest container wins: its packing needs the most rows)
            sdfg.metadata["sublane_width"] = rows_for_bytes(min_bytes)
