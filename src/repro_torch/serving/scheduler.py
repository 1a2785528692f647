"""Continuous-batching scheduler over the paged KV cache.

Requests are admitted/evicted *between* compiled decode steps. Admission
is reservation-based: a request enters only when a free slot exists and
the pool can reserve its worst-case page count (prompt + max_new_tokens),
so a running request can never be starved of pages mid-decode. Prefill is
chunked — the prompt runs through ``model.decode_step`` in fixed-size
chunks against a small dense scratch cache, then the K/V slab is
scattered into freshly bound pages and the scratch is dropped; chunked
and whole-prompt prefill agree bit-for-bit because ``decode_step`` masks
by absolute position, not by chunk boundary.

Each step runs one (B, ctx)-bucketed compiled SDFG step
(:mod:`.compile`): B is the smallest bucket covering the highest occupied
slot, ctx the smallest page-multiple bucket covering the longest live
sequence. Padding lanes carry zeroed block-table rows (-> null page) and
position 0; their logits are never sampled. Eviction frees the request's
pages, returns its unused reservation, zeroes its block-table row, and
the next admission reuses both the slot and the pages — no live batch
array is ever reshaped.

Fault tolerance is layered around the compiled step, not into
user code:

* **Recompute preemption** — if binding a page at a boundary crossing
  raises :class:`PageError` (pool pressure, injected or real), the
  youngest admitted request is evicted with its generated tokens kept,
  re-queued at the front, and re-prefilled over prompt + generated
  tokens on readmission; the re-prefill does not re-sample, so greedy
  streams are byte-identical to an unpreempted run. A request preempted
  more than ``max_preemptions`` times finishes ``preempted_limit``.
* **Typed finish reasons** — every request ends with
  ``Request.finish_reason`` in :data:`FINISH_REASONS`; per-request
  ``deadline_s`` and the scheduler-wide ``queue_ttl_s`` expire requests
  (queued or active) with ``timeout``.
* **Degradation ladder** — a step that raises or produces non-finite
  logits on an active lane is (1) re-run through the never-donating
  torch-interpreter fallback bucket when the inputs are still alive
  (``donate=False``, the default once an injector is armed), else
  (2) recovered by *recompute*: every active request is preempted with
  its tokens, the page/state arrays are re-zeroed (a donating step may
  have consumed them), and readmission re-prefills. Lanes that stay
  non-finite and steps that keep failing increment per-request
  ``n_failures``; at ``max_failures`` the request finishes ``failed``
  instead of retrying forever. Detection and the event log live in the
  :class:`~repro_torch.serving.faults.StepWatchdog` (HeartbeatMonitor-backed).
  On the card the ladder takes planted faults and non-finite logits only
  (:func:`~repro_torch.serving.faults.degrades`), and non-finite logits
  skip rung (1), the interpreter: a kernel that fails to build or launch
  raises out of :meth:`Scheduler.step`.
* **Snapshot/restore** — :meth:`Scheduler.snapshot` serializes the whole
  in-flight state (queue, slots, block tables, KV pages, recurrent
  states, RNG) host-side; :meth:`Scheduler.restore` resumes token-exact
  in a fresh scheduler over the same model/config.

The port runs one host shard: ``n_shards > 1`` and ``shrink`` need the
sharded decode step (ShardMapPass, ROADMAP queue 1 item 9) and raise
``NotImplementedError``. Tensors live on the scheduler's ``device``
(``cuda`` unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..pipeline.stages import resolve_device
from .compile import (DecodeStepCompiler, _no_shards,
                      attention_layer_shapes, state_specs)
from .faults import StepFault, StepWatchdog, degrades
from .pages import KVPagePool, PageError, dtype_name, from_numpy, to_numpy

#: the typed ways a request can end
FINISH_REASONS = ("eos", "max_tokens", "timeout", "preempted_limit",
                  "failed")

SNAPSHOT_VERSION = 1


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None  # wall budget from submit time
    # -- scheduler-owned runtime state --
    slot: int = -1
    pos: int = 0                      # next KV write position
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    reserved_left: int = 0
    submit_time: float = 0.0
    first_token_time: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # one of FINISH_REASONS when done
    n_preemptions: int = 0
    n_failures: int = 0
    admit_seq: int = -1               # admission order; youngest = max

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.submit_time


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class Scheduler:
    """Continuous batching + chunked prefill over compiled decode steps."""

    def __init__(self, model, params, *, max_slots: int = 8,
                 page_size: int = 16, n_pages: int = 64,
                 max_model_len: int = 256, prefill_chunk: int = 8,
                 cache_dtype="bfloat16",
                 compiler: Optional[DecodeStepCompiler] = None,
                 dtype_aware_sublanes: bool = False, compile_cache=None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0,
                 queue_ttl_s: Optional[float] = None,
                 max_preemptions: int = 3, max_failures: int = 3,
                 injector=None, watchdog: Optional[StepWatchdog] = None,
                 donate: Optional[bool] = None,
                 n_shards: int = 1, device=None,
                 expansion_level: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if max_model_len % page_size:
            raise ValueError("max_model_len must be a multiple of "
                             f"page_size ({page_size}), got {max_model_len}")
        _no_shards(n_shards)
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_model_len = max_model_len
        self.prefill_chunk = prefill_chunk
        self.queue_ttl_s = queue_ttl_s
        self.max_preemptions = max_preemptions
        self.max_failures = max_failures
        self.injector = injector
        self._clock = clock
        self.n_shards = 1
        self._spb = max_slots // self.n_shards  # slots per host shard
        self.mesh_sig = None
        self.dtype_aware_sublanes = dtype_aware_sublanes
        self.pool = KVPagePool(attention_layer_shapes(model), n_pages,
                               page_size, dtype=cache_dtype,
                               device=self.device)
        if donate is None:
            # donation consumes the step inputs, which forecloses the
            # re-run-from-same-inputs recovery rung; an armed injector
            # implies fault-tolerant mode, so default donation off there
            donate = injector is None
        self.compiler = compiler or DecodeStepCompiler(
            model, params, page_size=page_size, n_pages=n_pages,
            cache_dtype=cache_dtype,
            dtype_aware_sublanes=dtype_aware_sublanes, cache=compile_cache,
            donate=donate, device=self.device,
            expansion_level=expansion_level)
        self.watchdog = watchdog or StepWatchdog()
        self.block_table = np.zeros(
            (max_slots, max_model_len // page_size), np.int32)
        self._sspecs = state_specs(model)
        self.states: Dict[str, torch.Tensor] = self._zero_states()
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.temperature = float(temperature)
        self.top_k = top_k
        self._rng = np.random.default_rng(seed)
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.last_logits = None
        self.events: List[dict] = []
        self.n_preemptions = 0
        self.n_fallback_steps = 0
        self.n_recomputes = 0
        self._next_rid = 0
        self._admit_seq = 0
        self._prefill_step = model.decode_step
        self.n_steps = 0         # scheduler iterations — the fault clock
        self.n_decode_steps = 0  # compiled decode steps actually executed
        if injector is not None:
            injector.attach(self)

    def _zero_states(self) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros((self.max_slots,) + shape,
                                  dtype=getattr(torch, dt),
                                  device=self.device)
                for name, (li, shape, dt) in self._sspecs.items()}

    def _shard_of(self, slot: int) -> int:
        return slot // self._spb

    # -- submission / admission -----------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_model_len:
            raise ValueError(f"prompt of {len(prompt)} tokens >= "
                             f"max_model_len {self.max_model_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, list(prompt), max_new_tokens, eos_id,
                      deadline_s=deadline_s, submit_time=self._clock())
        self.queue.append(req)
        return rid

    def _free_slot(self, total_pages: int = 0) -> Optional[int]:
        """First free slot whose host shard can still reserve
        ``total_pages`` (with one shard this is just first-free)."""
        for i, r in enumerate(self.slots):
            if (r is None and self.pool.available_in(self._shard_of(i))
                    >= total_pages):
                return i
        return None

    def _try_admit(self):
        while self.queue:
            req = self.queue[0]
            total_tokens = min(len(req.prompt) + req.max_new_tokens,
                               self.max_model_len)
            total_pages = self.pool.pages_for(total_tokens)
            if self._free_slot() is None:
                return
            slot = self._free_slot(total_pages)
            if slot is None:
                return
            self.queue.popleft()
            self.pool.reserve(total_pages, self._shard_of(slot))
            self._admit(req, slot, total_pages)

    def _admit(self, req: Request, slot: int, total_pages: int):
        """Chunked prefill into a dense scratch cache, then scatter the
        K/V slab into pages and install the request in its slot.

        A *re*-admission (a preempted request carrying generated tokens)
        prefills prompt + tokens_out[:-1] — everything whose K/V the
        evicted pages held — and does NOT sample: the last generated
        token is still waiting to be fed to the next decode step, so the
        resumed stream is exactly the unpreempted one."""
        model, params = self.model, self.params
        seq = req.prompt + req.tokens_out[:-1]
        prompt = torch.as_tensor(seq, dtype=torch.int32,
                                 device=self.device)[None]
        L = len(seq)
        cache = model.init_cache(1, L, dtype=self.pool.dtype,
                                 device=self.device)
        logits = None
        i = 0
        while i < L:
            chunk = prompt[:, i:i + self.prefill_chunk]
            logits, cache = self._prefill_step(params, cache, chunk)
            i += chunk.shape[1]

        n_prompt_pages = self.pool.pages_for(L)
        pages = self.pool.alloc(n_prompt_pages, shard=self._shard_of(slot))
        req.pages = pages
        req.reserved_left = total_pages - n_prompt_pages
        self.block_table[slot, :len(pages)] = pages

        for li, layer_cache in self._iter_layer_caches(cache):
            if "k" in layer_cache:  # attention
                self.pool.write_prefill(li, pages, layer_cache["k"][0, :L],
                                        layer_cache["v"][0, :L])
            else:  # recurrent state rows
                for key, a in layer_cache.items():
                    name = f"st{li}__{key}"
                    self.states[name][slot] = a[0]

        req.slot = slot
        req.pos = L
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[slot] = req
        if not req.tokens_out:  # fresh request: sample its first token
            first = self._sample(logits[0, -1].float().cpu().numpy())
            req.tokens_out.append(first)
            req.first_token_time = self._clock()
            req.token_times.append(req.first_token_time - req.submit_time)
            self._maybe_finish(req, first)

    @staticmethod
    def _iter_layer_caches(cache):
        """(flat layer index, per-layer cache dict) in execution order."""
        yield from enumerate(cache["layers"])

    # -- finishing / eviction / preemption --------------------------------
    def _maybe_finish(self, req: Request, last_token: int):
        if req.eos_id is not None and last_token == req.eos_id:
            self._finish(req, "eos")
        elif (len(req.tokens_out) >= req.max_new_tokens
              or req.pos >= self.max_model_len - 1):
            self._finish(req, "max_tokens")

    def _strip(self, req: Request, touch_state: bool = True):
        """Return the request's pool/slot resources. ``touch_state=False``
        skips zeroing the state rows (recompute recovery replaces the
        whole arrays — the old ones may hold a failed step's writes)."""
        if req.pages:
            self.pool.free(req.pages)
            req.pages = []
        if req.reserved_left:
            self.pool.unreserve(req.reserved_left,
                                self._shard_of(req.slot)
                                if req.slot >= 0 else 0)
            req.reserved_left = 0
        if req.slot >= 0:
            self.block_table[req.slot, :] = 0
            if touch_state:
                for name in self.states:
                    self.states[name][req.slot] = 0
            self.slots[req.slot] = None
            req.slot = -1

    def _finish(self, req: Request, reason: str):
        assert reason in FINISH_REASONS, reason
        self._strip(req)
        req.finish_reason = reason
        req.done = True
        self.finished.append(req)

    def _preempt(self, req: Request):
        """Evict keeping generated tokens; re-queue at the front for
        recompute-readmission (or finish ``preempted_limit``)."""
        self.n_preemptions += 1
        req.n_preemptions += 1
        self._strip(req)
        if req.n_preemptions > self.max_preemptions:
            req.finish_reason = "preempted_limit"
            req.done = True
            self.finished.append(req)
            self.events.append({"kind": "preempted_limit", "rid": req.rid,
                                "step": self.n_steps})
        else:
            self.queue.appendleft(req)
            self.events.append({"kind": "preempt", "rid": req.rid,
                                "step": self.n_steps,
                                "kept_tokens": len(req.tokens_out)})

    def _expire(self):
        """Finish queued/active requests past their deadline or TTL."""
        now = self._clock()
        for r in list(self.queue):
            limit = r.deadline_s if r.deadline_s is not None \
                else self.queue_ttl_s
            if limit is not None and now - r.submit_time > limit:
                self.queue.remove(r)
                self._finish(r, "timeout")
                self.events.append({"kind": "timeout", "rid": r.rid,
                                    "where": "queue", "step": self.n_steps})
        for r in list(self.slots):
            if (r is not None and r.deadline_s is not None
                    and now - r.submit_time > r.deadline_s):
                self._finish(r, "timeout")
                self.events.append({"kind": "timeout", "rid": r.rid,
                                    "where": "active", "step": self.n_steps})

    # -- decode ----------------------------------------------------------
    def _buckets(self, active: List[Request]) -> tuple:
        top_slot = max(r.slot for r in active)
        B = min(_pow2_at_least(top_slot + 1), self.max_slots)
        longest = max(r.pos + 1 for r in active)
        pages = _pow2_at_least(self.pool.pages_for(longest))
        ctx = min(pages * self.page_size, self.max_model_len)
        return B, ctx

    def _bind_pages(self, active: List[Request]):
        """Bind a fresh page to each request crossing a page boundary.
        Pool pressure (PageError) preempts the youngest admitted request
        instead of killing the server."""
        for r in list(active):
            if r.done or r.slot < 0:
                continue  # evicted while a victim for an earlier request
            while len(r.pages) < self.pool.pages_for(r.pos + 1):
                reserved = r.reserved_left > 0
                sh = self._shard_of(r.slot)
                try:
                    pg = self.pool.alloc(1, reserved=reserved, shard=sh)[0]
                except PageError:
                    # pressure is per host shard: evicting a request on
                    # another shard frees no page this one can use
                    victim = max(
                        (a for a in self.slots if a is not None
                         and self._shard_of(a.slot) == sh),
                        key=lambda a: a.admit_seq)
                    self._preempt(victim)
                    if victim is r:
                        break
                    continue
                if reserved:
                    r.reserved_left -= 1
                self.block_table[r.slot, len(r.pages)] = pg
                r.pages.append(pg)

    def _step_kwargs(self, B: int, ctx: int) -> Dict[str, torch.Tensor]:
        active = [r for r in self.slots if r is not None]
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        for r in active:
            tokens[r.slot, 0] = r.tokens_out[-1]
            positions[r.slot] = r.pos
        n_bt = ctx // self.page_size
        kwargs = dict(self.compiler.flat_weights)
        dev = self.device
        kwargs["tokens"] = torch.as_tensor(tokens, device=dev)
        kwargs["positions"] = torch.as_tensor(positions, device=dev)
        bt = np.ascontiguousarray(self.block_table[:B, :n_bt])
        kwargs["block_table"] = torch.as_tensor(bt, device=dev)
        for li in attention_layer_shapes(self.model):
            kwargs[f"kp{li}"] = self.pool.k_pages[li]
            kwargs[f"vp{li}"] = self.pool.v_pages[li]
        for name in self._sspecs:
            kwargs[name] = self.states[name][:B]
        return kwargs

    def _execute(self, step_fn, kwargs, active, B, ctx):
        """Run one decode step through the degradation ladder.

        Returns ``(out, rows, dt, bad)`` on success — ``bad`` the active
        requests whose logits stayed non-finite after the ladder — or
        ``None`` when no usable output was produced (recompute recovery
        has already re-queued the active requests)."""

        def attempt(fn, retry):
            if self.injector is not None:
                self.injector.on_execute(self.n_steps, retry=retry)
            t0 = time.perf_counter()
            out = fn(kwargs)
            if out["logits"].is_cuda:
                torch.cuda.synchronize(out["logits"].device)
            dt = time.perf_counter() - t0
            raw = out["logits"].float().cpu().numpy()
            rows = raw
            if self.injector is not None:
                rows = self.injector.corrupt_logits(self.n_steps, raw)
            return out, rows, dt, rows is not raw

        def bad_lanes(rows):
            return [r for r in active
                    if not np.isfinite(rows[r.slot]).all()]

        try:
            out, rows, dt, planted = attempt(step_fn, retry=False)
            bad = bad_lanes(rows)
            if not bad:
                return out, rows, dt, []
            self.watchdog.fault(self.n_steps, "nan_logits",
                                f"slots {[r.slot for r in bad]}")
        except Exception as e:  # noqa: BLE001 - planted or on the CPU
            if not degrades(e, self.device):
                raise
            planted = isinstance(e, StepFault)
            self.watchdog.fault(self.n_steps, "step_exception", repr(e))
        # rung 2: re-run from the same inputs — possible only when the
        # primary step did not donate (inputs still alive); on the card
        # only for a planted fault, since the rung is the plain version
        if not self.compiler.donate and (planted or self.device.type
                                         != "cuda"):
            try:
                fb = self.compiler.fallback_for(B, ctx)
                out, rows, dt, _ = attempt(fb, retry=True)
                self.n_fallback_steps += 1
                bad = bad_lanes(rows)
                if bad:
                    self.watchdog.fault(self.n_steps,
                                        "nan_logits_persistent",
                                        f"slots {[r.slot for r in bad]}")
                return out, rows, dt, bad
            except Exception as e:  # noqa: BLE001 - drop to rung 3
                if not degrades(e, self.device):
                    raise
                self.watchdog.fault(self.n_steps, "fallback_failed",
                                    repr(e))
        # rung 3: recompute — preempt everyone with tokens kept, rebuild
        # the device arrays (a donating step may have written them),
        # re-prefill on admit
        self._recover_recompute(active)
        return None

    def _recover_recompute(self, active: List[Request]):
        self.n_recomputes += 1
        self.watchdog.fault(self.n_steps, "recompute_recovery",
                            f"rids {[r.rid for r in active]}")
        for r in sorted(active, key=lambda a: a.admit_seq, reverse=True):
            r.n_failures += 1
            self._strip(r, touch_state=False)
            if r.n_failures >= self.max_failures:
                r.finish_reason = "failed"
                r.done = True
                self.finished.append(r)
            else:
                self.queue.appendleft(r)
        self.block_table[:] = 0
        self.pool.reset_storage()
        self.states = self._zero_states()

    def step(self) -> List[Request]:
        """Admit waiting requests, run one compiled decode step over all
        active slots, sample, and evict finished requests. Returns the
        requests that finished during this step.

        ``n_steps`` ticks on every call — including iterations where
        recovery preempted everyone and no decode ran — so it is the
        clock fault plans key on: a stalled scheduler still advances
        toward e.g. a scheduled pressure release. ``n_decode_steps``
        counts compiled steps actually executed."""
        try:
            return self._step_inner()
        finally:
            self.n_steps += 1

    def _step_inner(self) -> List[Request]:
        n_done = len(self.finished)
        self._expire()
        if self.injector is not None:
            self.injector.on_step_begin(self.n_steps, self)
        self._try_admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            return self.finished[n_done:]

        self._bind_pages(active)
        active = [r for r in self.slots if r is not None]
        if not active:
            return self.finished[n_done:]

        B, ctx = self._buckets(active)
        kwargs = self._step_kwargs(B, ctx)
        step_fn = self.compiler.step_for(B, ctx)
        result = self._execute(step_fn, kwargs, active, B, ctx)
        if result is None:  # recompute recovery: no tokens this step
            return self.finished[n_done:]
        out, rows, dt, bad = result
        self.last_logits = out["logits"]

        for li in attention_layer_shapes(self.model):
            self.pool.k_pages[li] = out[f"kp{li}"]
            self.pool.v_pages[li] = out[f"vp{li}"]
        for name in self._sspecs:
            if B == self.max_slots:
                # the full slice aliased (and donated) the master buffer
                self.states[name] = out[name]
            else:
                self.states[name][:B] = out[name]

        slow = (self.injector.slow_factor_for(self.n_steps)
                if self.injector is not None else 1.0)
        self.watchdog.record(self.n_steps, dt * slow)
        self.n_decode_steps += 1

        skip = set()
        for r in bad:  # lanes still non-finite after the ladder
            skip.add(r.rid)
            r.n_failures += 1
            if r.n_failures >= self.max_failures:
                self._finish(r, "failed")
        for r in active:
            if r.done or r.rid in skip:
                continue  # failed lanes retry (or are done) — no token
            t = self._sample(rows[r.slot])
            r.pos += 1
            r.tokens_out.append(t)
            r.token_times.append(dt)
            self._maybe_finish(r, t)
        return self.finished[n_done:]

    def _sample(self, row) -> int:
        """Next token from one request's last-position logits: greedy
        argmax at ``temperature == 0`` (the default, preserving the
        token-exact reference tests), otherwise softmax sampling at the
        given temperature, optionally truncated to the ``top_k`` highest
        logits, drawn from the scheduler's seeded generator."""
        row = np.asarray(row, np.float64)
        row = row.reshape(-1, row.shape[-1])[-1]
        if self.temperature == 0.0:
            return int(row.argmax())
        logits = row / self.temperature
        if self.top_k is not None and self.top_k < logits.shape[-1]:
            kth = np.partition(logits, -self.top_k)[-self.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        return int(self._rng.choice(p.shape[-1], p=p))

    def run(self, max_steps: int = 100000) -> List[Request]:
        """Drive until every submitted request finishes."""
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slots):
                break
            self.step()
        else:
            raise RuntimeError(f"did not drain within {max_steps} steps")
        return sorted(self.finished, key=lambda r: r.rid)

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        """One typed view of the run: finish reasons, recovery counters,
        watchdog/compiler event logs, pool accounting."""
        reasons = Counter(r.finish_reason for r in self.finished)
        return {"n_shards": self.n_shards,
                "mesh_signature": self.mesh_sig,
                "n_steps": self.n_steps,
                "n_decode_steps": self.n_decode_steps,
                "finished": len(self.finished),
                "queued": len(self.queue),
                "active": sum(r is not None for r in self.slots),
                "finish_reasons": dict(reasons),
                "preemptions": self.n_preemptions,
                "fallback_steps": self.n_fallback_steps,
                "recomputes": self.n_recomputes,
                "watchdog_events": list(self.watchdog.events),
                "compiler_events": list(self.compiler.events),
                "events": list(self.events),
                "pool": self.pool.stats()}

    # -- snapshot / restore -----------------------------------------------
    def _snapshot_config(self) -> dict:
        return {"max_slots": self.max_slots, "page_size": self.page_size,
                "n_pages": self.pool.n_pages,
                "max_model_len": self.max_model_len,
                "cache_dtype": dtype_name(self.pool.dtype),
                "n_shards": self.n_shards}

    def snapshot(self) -> dict:
        """Serialize the whole in-flight state host-side (numpy-backed).

        Call between steps (after :meth:`step` returns). The snapshot is
        a deep copy: continuing this scheduler afterwards does not
        disturb it. Restoring into a fresh scheduler over the same
        model/params/config resumes token-exact — the compiled step is a
        pure function of exactly what the snapshot captures (tokens,
        block tables, pages, recurrent states, RNG)."""
        def req(r):
            return None if r is None else dataclasses.asdict(r)

        return {"version": SNAPSHOT_VERSION,
                "config": self._snapshot_config(),
                "now": self._clock(),
                "queue": [req(r) for r in self.queue],
                "slots": [req(r) for r in self.slots],
                "finished": [req(r) for r in self.finished],
                "block_table": self.block_table.copy(),
                "pool": self.pool.snapshot(),
                "states": {name: to_numpy(a)
                           for name, a in self.states.items()},
                "rng": self._rng.bit_generator.state,
                "next_rid": self._next_rid,
                "admit_seq": self._admit_seq,
                "n_steps": self.n_steps,
                "n_decode_steps": self.n_decode_steps}

    def restore(self, snap: dict) -> "Scheduler":
        """Load a :meth:`snapshot` into this (fresh) scheduler.

        The scheduler must be built over the same model geometry
        (slots/pages/model-len/dtype); wall-clock request timestamps are
        rebased onto this scheduler's clock so deadlines keep meaning
        'time since submission'."""
        if snap.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"unknown snapshot version "
                             f"{snap.get('version')!r}")
        if snap["config"] != self._snapshot_config():
            raise ValueError(f"snapshot config {snap['config']} does not "
                             f"match scheduler {self._snapshot_config()}")
        shift = self._clock() - snap["now"]

        def req(d):
            if d is None:
                return None
            r = Request(**d)
            r.submit_time += shift
            if r.first_token_time:
                r.first_token_time += shift
            return r

        self.queue = deque(req(d) for d in snap["queue"])
        self.slots = [req(d) for d in snap["slots"]]
        self.finished = [req(d) for d in snap["finished"]]
        self.block_table = np.array(snap["block_table"], np.int32)
        self.pool.restore(snap["pool"])
        self.states = {name: from_numpy(snap["states"][name],
                                        self.states[name].dtype, self.device)
                       for name in self.states}
        self._rng.bit_generator.state = snap["rng"]
        self._next_rid = int(snap["next_rid"])
        self._admit_seq = int(snap["admit_seq"])
        self.n_steps = int(snap["n_steps"])
        self.n_decode_steps = int(snap["n_decode_steps"])
        self.last_logits = None
        return self

    # -- elastic multi-host: shrink + per-host snapshot shards -------------
    def shrink(self, n_shards: int):
        """Live mesh shrink (host loss) needs the sharded decode step."""
        raise NotImplementedError(
            "Scheduler.shrink needs the sharded decode step (ShardMapPass), "
            "which is not ported to the torch package yet (ROADMAP queue 1 "
            "item 9)")

    def snapshot_to_dir(self, d):
        """Sharded :meth:`snapshot`: one ``meta.json`` (control state +
        mesh signature) plus one ``host{h}.npz`` per host shard holding
        only that host's slot rows and page block — what each host of a
        real pod can write locally without gathering the cluster. The
        directory commit is atomic (tmp + rename)."""
        import json
        import os
        import shutil

        d = str(d)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def req(r):
            return None if r is None else dataclasses.asdict(r)

        meta = {"version": SNAPSHOT_VERSION,
                "config": self._snapshot_config(),
                "mesh_signature": self.mesh_sig,
                "now": self._clock(),
                "queue": [req(r) for r in self.queue],
                "slots": [req(r) for r in self.slots],
                "finished": [req(r) for r in self.finished],
                "pool": {"free": [p for f in self.pool._shard_free
                                  for p in f],
                         "reserved_by": list(self.pool._shard_reserved),
                         "seized": self.pool._seized},
                "rng": self._rng.bit_generator.state,
                "next_rid": self._next_rid,
                "admit_seq": self._admit_seq,
                "n_steps": self.n_steps,
                "n_decode_steps": self.n_decode_steps}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        spb, pps = self._spb, self.pool.pages_per_shard
        for h in range(self.n_shards):
            arrs = {"block_table":
                    self.block_table[h * spb:(h + 1) * spb].copy()}
            for name, a in self.states.items():
                arrs[f"st::{name}"] = to_numpy(a[h * spb:(h + 1) * spb])
            for li in self.pool.k_pages:
                arrs[f"kp{li}"] = to_numpy(
                    self.pool.k_pages[li][h * pps:(h + 1) * pps])
                arrs[f"vp{li}"] = to_numpy(
                    self.pool.v_pages[li][h * pps:(h + 1) * pps])
            np.savez(os.path.join(tmp, f"host{h:03d}.npz"), **arrs)
        _commit(d, tmp)
        return d

    def restore_from_dir(self, d) -> "Scheduler":
        """Load a :meth:`snapshot_to_dir` directory into this (fresh)
        scheduler — possibly over a *different* mesh.

        * Same shard count, all host files present: exact restore
          (byte-identical continuation, like :meth:`restore`).
        * Fewer shards here, or a host file missing (that host died
          with its snapshot shard): the surviving hosts restore
          exactly; every request whose slot lived on a lost shard is
          re-queued with its generated tokens kept and a typed
          ``restore_recompute`` event — its KV pages are gone, so
          readmission re-prefills from tokens (the recompute rung),
          keeping greedy streams byte-identical.
        * More shards here (grow): all snapshot shards restore, the new
          hosts start empty.

        Slot-per-host and pages-per-host geometry must match — the
        snapshot's host shards map 1:1 onto this scheduler's."""
        import json
        import os

        d = str(d)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"unknown snapshot version "
                             f"{meta.get('version')!r}")
        cfg_s = dict(meta["config"])
        cfg_m = self._snapshot_config()
        k_snap = int(cfg_s.get("n_shards", 1))
        spb_s = cfg_s["max_slots"] // k_snap
        pps_s = cfg_s["n_pages"] // k_snap
        same = {k: cfg_s[k] for k in ("page_size", "max_model_len",
                                      "cache_dtype")}
        if (same != {k: cfg_m[k] for k in same}
                or spb_s != self._spb
                or pps_s != self.pool.pages_per_shard):
            raise ValueError(f"snapshot geometry {cfg_s} does not map "
                             f"onto scheduler {cfg_m}")
        shift = self._clock() - meta["now"]

        def req(dd):
            if dd is None:
                return None
            r = Request(**dd)
            r.submit_time += shift
            if r.first_token_time:
                r.first_token_time += shift
            return r

        host_file = {h: os.path.join(d, f"host{h:03d}.npz")
                     for h in range(k_snap)}
        dead = [h for h in range(k_snap)
                if h >= self.n_shards or not os.path.exists(host_file[h])]
        alive = [h for h in range(k_snap) if h not in dead]

        self.block_table = np.zeros(
            (self.max_slots, self.max_model_len // self.page_size),
            np.int32)
        self.states = self._zero_states()
        self.pool.reset_storage()
        pps = self.pool.pages_per_shard
        self.pool._shard_free = [
            list(range((h + 1) * pps - 1, h * pps, -1))
            for h in range(self.n_shards)]
        self.pool._shard_reserved = [0] * self.n_shards
        self.pool._seized = 0

        spb = self._spb
        for h in alive:
            with np.load(host_file[h]) as z:
                self.block_table[h * spb:(h + 1) * spb] = z["block_table"]
                for name in self.states:
                    self.states[name][h * spb:(h + 1) * spb] = from_numpy(
                        z[f"st::{name}"], self.states[name].dtype,
                        self.device)
                for li in self.pool.k_pages:
                    self.pool.k_pages[li][h * pps:(h + 1) * pps] = \
                        from_numpy(z[f"kp{li}"], self.pool.dtype, self.device)
                    self.pool.v_pages[li][h * pps:(h + 1) * pps] = \
                        from_numpy(z[f"vp{li}"], self.pool.dtype, self.device)
            self.pool._shard_free[h] = [
                p for p in meta["pool"]["free"]
                if self.pool.shard_of(p) == h]
            self.pool._shard_reserved[h] = \
                int(meta["pool"]["reserved_by"][h])

        self.queue = deque(req(dd) for dd in meta["queue"])
        self.finished = [req(dd) for dd in meta["finished"]]
        self.slots = [None] * self.max_slots
        lost: List[Request] = []
        for r in (req(dd) for dd in meta["slots"]):
            if r is None:
                continue
            h = self._shard_of(r.slot)
            if h in dead:
                r.pages = []
                r.reserved_left = 0
                r.slot = -1
                lost.append(r)
            else:
                self.slots[r.slot] = r
        for r in sorted(lost, key=lambda a: a.admit_seq, reverse=True):
            self.queue.appendleft(r)
            self.events.append({"kind": "restore_recompute",
                                "rid": r.rid, "step": self.n_steps,
                                "kept_tokens": len(r.tokens_out)})
        if dead:
            self.n_recomputes += 1
            self.watchdog.fault(self.n_steps, "restore_shard_lost",
                                f"shards {dead}, rids "
                                f"{[r.rid for r in lost]}")
        self._rng.bit_generator.state = meta["rng"]
        self._next_rid = int(meta["next_rid"])
        self._admit_seq = int(meta["admit_seq"])
        self.n_steps = int(meta["n_steps"])
        self.n_decode_steps = int(meta["n_decode_steps"])
        self.last_logits = None
        return self

    # -- invariants -------------------------------------------------------
    def check_invariants(self):
        """Page accounting + block-table consistency; raises PageError."""
        live: List[int] = []
        for r in self.slots:
            if r is None:
                continue
            live.extend(r.pages)
            row = self.block_table[r.slot]
            if list(row[:len(r.pages)]) != r.pages:
                raise PageError(f"block-table row of slot {r.slot} does "
                                f"not match its pages: {row[:len(r.pages)]}"
                                f" vs {r.pages}")
            if any(row[len(r.pages):]):
                raise PageError(f"stale block-table entries in slot "
                                f"{r.slot}: {row}")
        if any(p % self.pool.pages_per_shard == 0 for p in live):
            raise PageError("null page bound to a live request")
        if len(set(live)) != len(live):
            raise PageError(f"page bound to two live requests: {live}")
        for r in self.slots:
            if r is not None and any(
                    self.pool.shard_of(p) != self._shard_of(r.slot)
                    for p in r.pages):
                raise PageError(f"request {r.rid} in slot {r.slot} holds "
                                f"pages off its host shard: {r.pages}")
        n_accounted = self.pool.num_free + len(live) + self.pool._seized
        n_data = self.pool.n_pages - self.pool.n_shards  # one null each
        if n_accounted != n_data:
            raise PageError(f"page leak: {self.pool.num_free} free + "
                            f"{len(live)} live + {self.pool._seized} "
                            f"seized != {n_data}")
        reserved = sum(r.reserved_left for r in self.slots if r is not None)
        if reserved != self.pool._reserved:
            raise PageError(f"reservation drift: pool {self.pool._reserved}"
                            f" vs requests {reserved}")
        for i, r in enumerate(self.slots):
            if r is None and any(self.block_table[i]):
                raise PageError(f"free slot {i} has a non-zero "
                                "block-table row")
        for r in self.finished:
            if not r.done or r.finish_reason not in FINISH_REASONS:
                raise PageError(f"request {r.rid} finished without a "
                                f"typed reason: {r.finish_reason!r}")

def _commit(d, tmp) -> None:
    """Atomically replace directory ``d`` with ``tmp``: rename the live dir
    aside, move tmp in, then delete — never a window with no valid
    snapshot (the reference's ``checkpoint/store.py::_commit``, kept here
    until the checkpoint store is ported)."""
    import os
    import shutil
    d, tmp = str(d), str(tmp)
    old = d + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(d):
        os.rename(d, old)
    os.rename(tmp, d)
    if os.path.exists(old):
        shutil.rmtree(old)
