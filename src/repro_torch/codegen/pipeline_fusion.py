"""Pipeline fusion for the cuda backend (DESIGN.md §3.3).

After StreamingComposition converts intermediate HBM arrays into streams,
this codegen pass finds maximal chains of Library Nodes connected through
stream containers and — when the chain matches a registered fused-kernel
pattern — replaces the whole chain with a single tasklet calling a fused
hand-written kernel. The stream's data then lives in registers for its
entire lifetime: the GPU realization of the paper's 'PEs chained by
FIFOs'.

Unmatched chains still compile (each node expands on its own and the stream
materializes), mirroring the paper's fallback to generic expansions.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..core.sdfg import AccessNode, LibraryNode, SDFG, State, Stream, Tasklet

#: (tuple of LibraryNode type names) -> factory(nodes, sdfg, state, in_map,
#: out_map) returning the fused tasklet body. Registered by
#: repro_torch.kernels.
FUSION_REGISTRY: Dict[Tuple[str, ...], Callable] = {}


def register_fusion(pattern: Tuple[str, ...]):
    def deco(factory):
        FUSION_REGISTRY[pattern] = factory
        return factory
    return deco


def _stream_chains(state: State, sdfg: SDFG) -> List[List[LibraryNode]]:
    """Maximal linear chains L0 -stream-> L1 -stream-> ... of library nodes."""
    def nodes_of(container: str):
        return [n for n in state.nodes
                if isinstance(n, AccessNode) and n.data == container]

    def stream_successor(node):
        """Producer -> (its stream nodes) -> consumer library node, possibly
        through a consumer-side access node of the same container."""
        for e in state.out_edges(node):
            if isinstance(e.dst, AccessNode) and isinstance(
                    sdfg.arrays[e.dst.data], Stream):
                for an in nodes_of(e.dst.data):
                    for oe in state.out_edges(an):
                        if isinstance(oe.dst, LibraryNode):
                            return e.dst.data, oe.dst
        return None, None

    def stream_predecessor(node):
        for e in state.in_edges(node):
            if isinstance(e.src, AccessNode) and isinstance(
                    sdfg.arrays[e.src.data], Stream):
                for an in nodes_of(e.src.data):
                    for ie in state.in_edges(an):
                        if isinstance(ie.src, LibraryNode):
                            return ie.src
        return None

    chains = []
    seen = set()
    for node in state.nodes:
        if not isinstance(node, LibraryNode) or node in seen:
            continue
        if stream_predecessor(node) is not None:
            continue  # not a chain head
        chain = [node]
        cur = node
        while True:
            _, nxt = stream_successor(cur)
            if nxt is None or nxt in seen:
                break
            chain.append(nxt)
            cur = nxt
        for n in chain:
            seen.add(n)
        if len(chain) > 1:
            chains.append(chain)
    return chains


def fuse_stream_pipelines(sdfg: SDFG) -> List[str]:
    fused = []
    for state in sdfg.states:
        for full_chain in _stream_chains(state, sdfg):
            # greedy longest-sub-chain matching: a long streamed pipeline
            # may contain several registered fusable segments
            segments = []
            i = 0
            names = [type(n).__name__ for n in full_chain]
            while i < len(full_chain):
                best = None
                for j in range(len(full_chain), i + 1, -1):
                    if tuple(names[i:j]) in FUSION_REGISTRY:
                        best = j
                        break
                if best is None:
                    i += 1
                else:
                    segments.append(full_chain[i:best])
                    i = best
            for chain in segments:
                fused.extend(_fuse_one(sdfg, state, chain))
    return fused


def _fuse_one(sdfg: SDFG, state: State, chain) -> List[str]:
    key = tuple(type(n).__name__ for n in chain)
    factory = FUSION_REGISTRY.get(key)
    if factory is None:
        return []
    chain_set = set(chain)
    intermediates = set()
    for i, node in enumerate(chain[:-1]):
        for e in state.out_edges(node):
            if isinstance(e.dst, AccessNode) and isinstance(
                    sdfg.arrays[e.dst.data], Stream):
                # both producer- and consumer-side nodes
                for an in state.nodes:
                    if isinstance(an, AccessNode) and an.data == e.dst.data:
                        intermediates.add(an)
    # external edges and their fused-tasklet connector names
    in_map, out_map = {}, {}
    ext_in, ext_out = [], []
    for node in chain:
        for e in state.in_edges(node):
            if e.src in intermediates or e.src in chain_set:
                continue
            conn = f"{node.label}__{e.dst_conn}"
            in_map[(node.label, e.dst_conn)] = conn
            ext_in.append((e, conn))
        for e in state.out_edges(node):
            if e.dst in intermediates or e.dst in chain_set:
                continue
            conn = f"{node.label}__{e.src_conn}"
            out_map[(node.label, e.src_conn)] = conn
            ext_out.append((e, conn))
    fn = factory(chain, sdfg, state, in_map, out_map)
    t = state.add_tasklet("fused_" + "_".join(key).lower(),
                          [c for _, c in ext_in],
                          [c for _, c in ext_out], fn)
    for e, conn in ext_in:
        state.add_edge(e.src, e.src_conn, t, conn, e.memlet)
    for e, conn in ext_out:
        state.add_edge(t, conn, e.dst, e.dst_conn, e.memlet)
    for node in chain:
        state.remove_node(node)
    for an in intermediates:
        if an in state.graph and state.in_degree(an) == 0 \
                and state.out_degree(an) == 0:
            state.remove_node(an)
    return ["+".join(key)]
