"""InputToConstant (paper §5.1, DaCeML): bake inference parameters into the
program as compile-time constants.

On FPGA the parameters are fixed in hardware; on TPU they become jit-closure
constants folded into the XLA executable. The transformation verifies the
parameter is never written, installs the value in ``sdfg.constants``, and
removes the container from the argument list. Off-chip volume accounting
then excludes reads of constant containers (they are loaded once with the
program, not per execution — DESIGN.md §2).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.sdfg import AccessNode, SDFG
from .base import Transformation


class InputToConstant(Transformation):
    def __init__(self, parameters: Dict[str, np.ndarray] = None):
        self.parameters = parameters or {}

    def find_matches(self, sdfg: SDFG, parameters: Dict[str, np.ndarray] = None,
                     **kwargs):
        params = parameters or self.parameters
        for name, value in params.items():
            if name in sdfg.constants or name not in sdfg.arrays:
                continue
            yield {"name": name, "value": value}

    def can_apply(self, sdfg: SDFG, match: Dict) -> bool:
        name = match["name"]
        # verify the parameter array is never written (paper: 'first
        # verifies that the parameter array is never written to')
        for st in sdfg.states:
            for node in st.data_nodes():
                if node.data == name and st.in_degree(node) > 0:
                    return False
        return True

    def apply_match(self, sdfg: SDFG, match: Dict):
        name, value = match["name"], match["value"]
        sdfg.constants[name] = np.asarray(value)
        desc = sdfg.arrays[name]
        desc.transient = False  # stays addressable; excluded from args by
        #                        sdfg.argument_names() via constants check
