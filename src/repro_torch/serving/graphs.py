"""The served decode step captured as one CUDA graph per (B, ctx) bucket.

The reference compiles each bucket's step into one XLA program
(``jax.jit(positional, donate_argnums=donate)``, ``repro/serving/
compile.py``): after the first call a step is one dispatch. The port's step
is the structural interpreter walking the SDFG and launching every tasklet's
PyTorch kernels and every generated or hand-written kernel from Python, some
3,400 launches a step at full width. Its counterpart of the jitted bucket is
the same launches recorded once into a ``torch.cuda.CUDAGraph`` and replayed:

* A bucket's first step runs eagerly on a side stream (PyTorch's warm-up
  before a capture: Triton compiles, the hand kernels build, cuBLAS takes
  its workspace for that stream) and is the step's result. Then the step is
  captured on the same stream against the tensors that call was given, and
  every later call replays it.
* The graph reads its inputs where they lay at capture. Before a replay a
  live input that is another tensor (this step's tokens, positions and
  block table; page and state arrays a recovery replaced) is copied into
  the captured one; the weights, and the pages and state rows a donating
  step writes in place, are the captured tensors themselves.
* A step that does not donate (the fault-tolerant mode) must leave its
  inputs intact, so that the interpreter rung can re-run a failed step from
  them. Its bucket holds two graphs over two buffers of each donated
  container: graph k copies set k into set 1 - k and writes set 1 - k, and
  the replay picks the graph whose input set holds the live arrays (the
  copies of ``CompiledDecodeStep.__call__``, taken inside the graph).
* Every bucket of a compiler shares one graph memory pool. That is safe
  because the replays run one after another on one stream and everything a
  step hands back is read before the next replay: the logits are copied out
  of the pool, and the pages and states are buffers allocated outside it.
* The wrappers' launch counters are Python and run only while a step is
  captured. The capture records what each counter moved, puts the counters
  back, and every replay adds that again, so a count stays the number of
  launches the card ran. The launch observers
  (``codegen.cuda_backend.LAUNCH_OBSERVERS``) are called at capture, with
  the graph's own operand tensors, which every replay refills.

Nothing here falls back: a capture or a replay that fails raises, and the
serving ladder treats it as it treats a compile error on the card
(:func:`~repro_torch.serving.faults.degrades`). The CPU has no graphs; there
the step runs eagerly, which is a property of the device, not a fallback.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

#: the counting attributes of a kernel wrapper: the launches, and the
#: launches by kernel name or by route
_COUNT_ATTRS = ("launches", "launches_by_name", "routes")


def counted_wrappers() -> List:
    """Every wrapper that counts the launches of its kernel: the generated
    kernels' two emitters and the hand-written kernels."""
    from ..codegen import cuda_backend
    from ..kernels import attention, axpydot, dot, gemm, rwkv, stencil
    from ..models import blocks
    seen, out = set(), []
    for w in (cuda_backend.run_grid_kernel, cuda_backend.run_two_phase,
              attention.decode_attention, attention.flash_attention,
              rwkv.wkv_chunked, blocks.wkv_chunked, gemm.matmul, dot.dot,
              axpydot.axpydot, stencil.stencil2d, stencil.stencil2d_chain,
              stencil.diffusion2d, stencil.jacobi3d, stencil.diffusion3d):
        if id(w) not in seen:
            seen.add(id(w))
            out.append(w)
    return out


def counts_snapshot():
    """Every wrapper's launch counts, to put back with
    :func:`restore_counts` (launches a tool makes to compare, not the main
    path's)."""
    return _snapshot(counted_wrappers())


def restore_counts(snapshot):
    _restore(snapshot)


def _snapshot(wrappers) -> List[Tuple[object, str, object]]:
    snap = []
    for w in wrappers:
        for a in _COUNT_ATTRS:
            v = getattr(w, a, None)
            if isinstance(v, dict):
                snap.append((w, a, dict(v)))
            elif isinstance(v, int):
                snap.append((w, a, v))
    return snap


def _moved(before) -> List[Tuple[object, str, object]]:
    """What each counter moved since ``before``."""
    out = []
    for w, a, old in before:
        new = getattr(w, a)
        if isinstance(old, dict):
            d = {k: n - old.get(k, 0) for k, n in new.items()
                 if n != old.get(k, 0)}
            if d:
                out.append((w, a, d))
        elif new != old:
            out.append((w, a, new - old))
    return out


def _restore(before):
    """Put the counters back; a dict is changed in place, since callers
    hold it (``matmul.routes``)."""
    for w, a, old in before:
        if isinstance(old, dict):
            d = getattr(w, a)
            d.clear()
            d.update(old)
        else:
            setattr(w, a, old)


def _add(moved):
    for w, a, n in moved:
        if isinstance(n, dict):
            d = getattr(w, a)
            for k, v in n.items():
                d[k] = d.get(k, 0) + v
        else:
            setattr(w, a, getattr(w, a) + n)


class StepGraphs:
    """What the captured steps of one compiler share: the side stream on
    which each bucket's first step runs and its graph is captured, the
    graph memory pool, and the two buffers of each donated container for
    the steps that do not donate. Raises where there is no card."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a decode step is captured only on a CUDA "
                             f"device, not {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("capturing the decode step needs a CUDA "
                               "device, and none is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._pairs: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def pair(self, name: str, like: torch.Tensor):
        """The two buffers of donated container ``name`` at ``like``'s
        shape and dtype, shared by every bucket that has that shape."""
        key = (name, tuple(like.shape), like.dtype)
        if key not in self._pairs:
            self._pairs[key] = (torch.empty_like(like),
                                torch.empty_like(like))
        return self._pairs[key]

    def warm(self, fn: Callable, args):
        """``fn(args)`` eagerly on the side stream: a bucket's first step."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn(args)
        cur.wait_stream(self.stream)
        return out

    def capture(self, body: Callable):
        """``body()`` captured into a new graph on the side stream, in the
        shared pool: (graph, its outputs, what the launch counters moved).
        The counters are put back as they were."""
        wrappers = counted_wrappers()
        before = _snapshot(wrappers)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = body()
        finally:
            moved = _moved(before)
            _restore(before)
        return graph, out, moved


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


class CapturedStep:
    """One bucket's step as CUDA graphs (see the module's docstring).

    ``run(args)`` runs the compiled step on ``args`` writing the donated
    containers in place; ``args`` are the first call's inputs, which the
    graphs read from then on. ``donate=False`` captures two graphs over the
    buffer pairs of ``graphs``."""

    def __init__(self, graphs: StepGraphs, run: Callable, args,
                 donated, donate: bool):
        self.graphs = graphs
        self.donated = [n for n in args if n in donated]
        # what the graphs read where it lay at capture (a step that does
        # not donate reads its donated containers from the buffer pairs)
        self.static = {n: a for n, a in args.items()
                       if donate or n not in self.donated}
        self.donate = donate
        if donate:
            self.sets = None
            g, out, self.moved = graphs.capture(lambda: run(self.static))
            self.captured = [(g, out)]
            return
        pairs = {n: graphs.pair(n, args[n]) for n in self.donated}
        self.sets = [{n: p[k] for n, p in pairs.items()} for k in (0, 1)]
        self.captured = []
        for k in (0, 1):
            src, dst = self.sets[k], self.sets[1 - k]

            def body(src=src, dst=dst):
                for n in self.donated:
                    dst[n].copy_(src[n])
                return run({**self.static, **dst})
            g, out, self.moved = graphs.capture(body)
            self.captured.append((g, out))

    def _fill(self, args) -> int:
        """Copy the live inputs the graphs do not already read into the
        captured tensors; the graph to replay."""
        for n, st in self.static.items():
            if not _same(args[n], st):
                st.copy_(args[n])
        if self.sets is None:
            return 0
        k = 1 if any(_same(args[n], self.sets[1][n])
                     for n in self.donated) else 0
        for n in self.donated:
            live = args[n]
            if _same(live, self.sets[1 - k][n]):   # the graph writes there
                live = live.clone()
            if not _same(live, self.sets[k][n]):
                self.sets[k][n].copy_(live)
        return k

    def __call__(self, args) -> Dict[str, torch.Tensor]:
        graph, out = self.captured[self._fill(args)]
        graph.replay()
        _add(self.moved)
        out = dict(out)
        # the logits lie in the shared pool, which the next replay reuses
        out["logits"] = out["logits"].clone()
        return out
