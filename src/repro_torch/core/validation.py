"""SDFG validation (paper §2.5 / Fig. 7).

Enforces the constraints the paper relies on:

  * streams are bounded and single-producer / single-consumer (FPGA
    hardware constraint; on TPU it is what makes stream->VMEM-block fusion
    legal),
  * producer/consumer *volume* matching on streams -- the paper's Fig.-7
    check that the data volume pushed equals the volume popped (a mismatch
    means deadlock on FPGA, and an illegal fusion on TPU),
  * structural sanity: memlets name existing containers, map scopes are
    well formed, tasklet connectors match their edges.
"""
from __future__ import annotations

from typing import Dict

from .memlet import Memlet
from .sdfg import (AccessNode, LibraryNode, MapEntry, MapExit, NestedSDFG,
                   SDFG, State, Stream, Tasklet)
from .symbolic import Expr


class ValidationError(Exception):
    """Structural validation failure. ``code`` ties the failure into the
    typed diagnostic taxonomy (``analysis.diagnostics.CODES``); checks
    predating the taxonomy leave it None (reported as STRUCT000)."""

    def __init__(self, message: str, code: str = None):
        super().__init__(message)
        self.code = code


def validate_state(state: State, sdfg: SDFG):
    g = state.graph
    # structural checks -----------------------------------------------------
    for e in state.edges:
        if e.memlet.data is not None and e.memlet.data not in sdfg.arrays:
            raise ValidationError(
                f"{state.label}: memlet references unknown container "
                f"{e.memlet.data!r}")
    for node in state.nodes:
        if isinstance(node, Tasklet):
            # connector shadowing: a duplicate within either list makes
            # the tasklet namespace ambiguous — two edges feed one fn
            # kwarg / one output key names two edges (STRUCT002). The
            # same name appearing as both an input and an output is
            # legal: inputs are fn kwargs, outputs are result-dict keys,
            # two separate namespaces.
            dup_in = [c for c in set(node.inputs)
                      if node.inputs.count(c) > 1]
            dup_out = [c for c in set(node.outputs)
                       if node.outputs.count(c) > 1]
            if dup_in or dup_out:
                detail = []
                if dup_in:
                    detail.append(f"duplicate inputs {sorted(dup_in)}")
                if dup_out:
                    detail.append(f"duplicate outputs {sorted(dup_out)}")
                raise ValidationError(
                    f"{state.label}/{node.label}: connector shadowing — "
                    f"{'; '.join(detail)}", code="STRUCT002")
            in_conns = {e.dst_conn for e in state.in_edges(node) if e.dst_conn}
            out_conns = {e.src_conn for e in state.out_edges(node) if e.src_conn}
            missing_in = set(node.inputs) - in_conns
            missing_out = set(node.outputs) - out_conns
            if missing_in:
                raise ValidationError(
                    f"{state.label}/{node.label}: unconnected input "
                    f"connectors {sorted(missing_in)}")
            if missing_out:
                raise ValidationError(
                    f"{state.label}/{node.label}: unconnected output "
                    f"connectors {sorted(missing_out)}")
        if isinstance(node, MapEntry):
            exits = [n for n in state.nodes
                     if isinstance(n, MapExit) and n.entry is node]
            if len(exits) != 1:
                raise ValidationError(
                    f"{state.label}/{node.label}: map entry must have exactly "
                    f"one exit (found {len(exits)})")

    # stream constraints ------------------------------------------------------
    producers: Dict[str, int] = {}
    consumers: Dict[str, int] = {}
    pushed: Dict[str, Expr] = {}
    popped: Dict[str, Expr] = {}
    for node in state.nodes:
        if not isinstance(node, AccessNode):
            continue
        desc = sdfg.arrays[node.data]
        if not isinstance(desc, Stream):
            continue
        if desc.buffer_size <= 0:
            raise ValidationError(
                f"stream {node.data!r} must be bounded (buffer_size > 0)")
        for e in state.in_edges(node):
            producers[node.data] = producers.get(node.data, 0) + 1
            vol = e.memlet.volume_or_subset()
            if vol is not None:
                pushed[node.data] = pushed.get(node.data, Expr.const(0)) + vol
        for e in state.out_edges(node):
            consumers[node.data] = consumers.get(node.data, 0) + 1
            vol = e.memlet.volume_or_subset()
            if vol is not None:
                popped[node.data] = popped.get(node.data, Expr.const(0)) + vol

    for name in set(producers) | set(consumers):
        desc = sdfg.arrays[name]
        # arrays-of-streams (systolic pipes) may have one producer/consumer
        # per array index; allow up to the array size.
        limit = 1
        if desc.shape:
            try:
                limit = desc.num_elements.evaluate(sdfg.symbol_values)
            except Exception:
                limit = None  # symbolic pipe count: skip cardinality check
        if limit is not None and producers.get(name, 0) > limit:
            raise ValidationError(
                f"stream {name!r}: {producers[name]} producers "
                f"(single-producer constraint, limit {limit})")
        if limit is not None and consumers.get(name, 0) > limit:
            raise ValidationError(
                f"stream {name!r}: {consumers[name]} consumers "
                f"(single-consumer constraint, limit {limit})")

    # producer/consumer volume check (Fig. 7) -----------------------------
    for name in set(pushed) & set(popped):
        desc = sdfg.arrays[name]
        if desc.shape:
            # arrays-of-streams (systolic pipes): the Fig.-7 annotation is
            # per pipe index; graph-level totals intentionally differ.
            continue
        if pushed[name] != popped[name]:
            # exact symbolic equality required; mismatch => deadlock/illegal fusion
            raise ValidationError(
                f"stream {name!r}: produced volume {pushed[name]} != "
                f"consumed volume {popped[name]} (Fig.-7 check)")


def validate_sdfg(sdfg: SDFG):
    # container names and symbol names share the argument/closure
    # namespace at codegen time — a collision silently shadows one with
    # the other (STRUCT001). (The historical duplicate-container check
    # iterated dict keys, which cannot repeat, so it never fired.)
    collisions = sorted(set(sdfg.arrays) & set(sdfg.symbol_values))
    if collisions:
        raise ValidationError(
            f"container name(s) {collisions} collide with symbol names",
            code="STRUCT001")
    for st in sdfg.states:
        validate_state(st, sdfg)
        for node in st.nodes:
            if isinstance(node, NestedSDFG):
                validate_sdfg(node.sdfg)
