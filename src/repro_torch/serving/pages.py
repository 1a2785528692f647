"""Paged KV cache (KVPagePool): fixed-size pages + per-slot block tables.

The pool owns, per attention layer, a pair of page arrays
``(n_pages, page_size, Hkv, Dh)``; sequences own *pages*, not a
contiguous cache slab, so evicting a request frees its pages for the
next admission without reshaping any live batch array. Page 0 is a
reserved **null page**: block-table rows of inactive/evicted slots are
zero, so the compiled decode step's KV write for padding lanes lands on
the null page and the gather for those lanes reads it — both are masked
out downstream (the attention mask covers positions > pos, and padding
lanes are dropped before sampling), so the null page may hold garbage.

Allocation is two-phase so admission can never strand a running request:
``reserve`` claims worst-case page counts at admit time (a counter, no
page identities), and ``alloc`` later binds concrete pages as the
sequence actually crosses page boundaries. ``available`` is
free-minus-reserved; the scheduler admits against it.

Multi-host sharding (``n_shards > 1``): the page id space splits into
``n_shards`` contiguous blocks of ``pages_per_shard`` pages — block
``h`` lives on host ``h``'s device shard of the page arrays, and its
first page (global id ``h * pages_per_shard``) is that shard's null
page. Accounting (free lists, reservations) is per shard, because a
slot hosted on shard ``h`` can only ever reference shard-``h`` pages:
inside a sharded step each host would see only its own page block,
addressed by local ids. ``shrink`` drops the trailing shards — host loss
— once every request living on them is gone; capacity reshrinks and the
surviving shards keep their pages. The accounting is the reference's; the
sharded decode step itself waits for ShardMapPass (ROADMAP queue 1 item
9), so the scheduler runs one shard.

The page arrays are torch tensors on the pool's device (``cuda`` unless
the caller names another; without a card that raises). Page writes
(``write_prefill`` here, the compiled step's KV write) update them in
place: the pool owns its arrays, and a donating step consumes last step's
pages and returns this step's without a copy.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..pipeline.stages import resolve_device

NULL_PAGE = 0


def torch_dtype(dtype) -> torch.dtype:
    """A dtype given by name (``"bfloat16"``) or as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("torch.", ""))


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16`` (or the name itself)."""
    return str(torch_dtype(dtype)).replace("torch.", "")


class PageError(RuntimeError):
    """Pool invariant violation (double free, over-allocation...)."""


class KVPagePool:
    """Page accounting + per-attention-layer page storage.

    ``layers`` maps flat layer index -> (n_kv_heads, head_dim) for every
    attention layer of the model (non-attention layers hold no pages).
    """

    def __init__(self, layers: Dict[int, Tuple[int, int]], n_pages: int,
                 page_size: int, dtype=torch.bfloat16, n_shards: int = 1,
                 device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_pages % n_shards:
            raise ValueError(f"n_pages {n_pages} not divisible by "
                             f"n_shards {n_shards}")
        if n_pages // n_shards < 2:
            raise ValueError(f"need >= 2 pages per shard (1 null + data), "
                             f"got {n_pages} over {n_shards} shards")
        self.n_pages = n_pages
        self.n_shards = n_shards
        self.pages_per_shard = n_pages // n_shards
        self.page_size = page_size
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self._layers = dict(layers)
        # the first page of each shard block is that shard's null page
        # and is never handed out (shard 0's is the global NULL_PAGE)
        pps = self.pages_per_shard
        self._shard_free: List[List[int]] = [
            list(range((h + 1) * pps - 1, h * pps, -1))
            for h in range(n_shards)]
        self._shard_reserved: List[int] = [0] * n_shards
        self._seized = 0
        self.k_pages: Dict[int, torch.Tensor] = {}
        self.v_pages: Dict[int, torch.Tensor] = {}
        self.reset_storage()

    # -- accounting -----------------------------------------------------
    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._shard_free)

    @property
    def _reserved(self) -> int:
        return sum(self._shard_reserved)

    @property
    def available(self) -> int:
        """Pages that can still be *reserved* by a new admission."""
        return self.num_free - self._reserved

    def available_in(self, shard: int) -> int:
        """Reservable pages on one shard (admission checks the shard the
        request's slot lives on)."""
        return len(self._shard_free[shard]) - self._shard_reserved[shard]

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    def null_page(self, shard: int) -> int:
        return shard * self.pages_per_shard

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size) if n_tokens > 0 else 0

    def reserve(self, n: int, shard: int = 0):
        if n > self.available_in(shard):
            raise PageError(f"cannot reserve {n} pages on shard {shard}: "
                            f"only {self.available_in(shard)} available")
        self._shard_reserved[shard] += n

    def unreserve(self, n: int, shard: int = 0):
        if n > self._shard_reserved[shard]:
            raise PageError(f"unreserve({n}) exceeds shard {shard} "
                            f"reservation {self._shard_reserved[shard]}")
        self._shard_reserved[shard] -= n

    def alloc(self, n: int = 1, reserved: bool = True,
              shard: int = 0) -> List[int]:
        """Bind ``n`` concrete pages on one shard. With ``reserved`` (the
        scheduler path) the pages come out of this request's prior
        reservation."""
        free = self._shard_free[shard]
        if n > len(free):
            raise PageError(f"out of pages: want {n}, free "
                            f"{len(free)} on shard {shard}")
        if reserved:
            self.unreserve(n, shard)
        elif n > self.available_in(shard):
            raise PageError(f"alloc({n}) would eat into reservations: "
                            f"available {self.available_in(shard)} on "
                            f"shard {shard}")
        return [free.pop() for _ in range(n)]

    def free(self, pages: List[int]):
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise PageError(f"freeing unknown page {p}")
            if p % self.pages_per_shard == 0:
                raise PageError("freeing the null page")
            sh = self.shard_of(p)
            if p in self._shard_free[sh]:
                raise PageError(f"double free of page {p}")
            self._shard_free[sh].append(p)

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "free": self.num_free,
                "reserved": self._reserved, "available": self.available,
                "seized": self._seized, "page_size": self.page_size,
                "n_shards": self.n_shards,
                "free_by_shard": [len(f) for f in self._shard_free]}

    # -- fault injection / recovery -------------------------------------
    def seize(self, n: int = 0) -> List[int]:
        """Remove up to ``n`` free pages (all of them for ``n <= 0``)
        from circulation WITHOUT reservation accounting — the
        fault-injection hook for forced page pressure. Seized pages may
        leave ``available`` negative; the scheduler's preemption path is
        what absorbs that hazard. Return them with :meth:`release`."""
        if n <= 0 or n > self.num_free:
            n = self.num_free
        out: List[int] = []
        h = 0
        while len(out) < n:
            if self._shard_free[h]:
                out.append(self._shard_free[h].pop())
            h = (h + 1) % self.n_shards
        self._seized += len(out)
        return out

    def release(self, pages: List[int]):
        """Return pages taken by :meth:`seize` to the free list."""
        if len(pages) > self._seized:
            raise PageError(f"releasing {len(pages)} pages but only "
                            f"{self._seized} are seized")
        for p in pages:
            sh = self.shard_of(p) if 0 <= p < self.n_pages else -1
            if (sh < 0 or p % self.pages_per_shard == 0
                    or p in self._shard_free[sh]):
                raise PageError(f"releasing bad/free page {p}")
        self._seized -= len(pages)
        for p in pages:
            self._shard_free[self.shard_of(p)].append(p)

    def reset_storage(self):
        """(Re)allocate zeroed page arrays. Used at construction and by
        recompute recovery, where a failed donating step has consumed
        the live arrays and every sequence will be re-prefilled."""
        for li, (hkv, dh) in self._layers.items():
            shape = (self.n_pages, self.page_size, hkv, dh)
            self.k_pages[li] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
            self.v_pages[li] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)

    def shrink(self, n_shards: int):
        """Drop the trailing shards (host loss): capacity reshrinks to
        ``n_shards * pages_per_shard`` pages, surviving shards keep
        their pages and free lists. Every page of a dropped shard must
        already be free — the scheduler preempts the requests living
        there first ("preempt to fit")."""
        if not (1 <= n_shards < self.n_shards):
            raise PageError(f"shrink to {n_shards} shards from "
                            f"{self.n_shards} is not a shrink")
        if self._seized:
            raise PageError(f"cannot shrink with {self._seized} seized "
                            f"pages in flight")
        pps = self.pages_per_shard
        for h in range(n_shards, self.n_shards):
            if len(self._shard_free[h]) != pps - 1 or self._shard_reserved[h]:
                raise PageError(
                    f"shard {h} still has live/reserved pages "
                    f"({pps - 1 - len(self._shard_free[h])} live, "
                    f"{self._shard_reserved[h]} reserved); preempt its "
                    f"requests before shrinking")
        self.n_shards = n_shards
        self.n_pages = n_shards * pps
        self._shard_free = self._shard_free[:n_shards]
        self._shard_reserved = self._shard_reserved[:n_shards]
        for li in self.k_pages:
            self.k_pages[li] = self.k_pages[li][:self.n_pages].clone()
            self.v_pages[li] = self.v_pages[li][:self.n_pages].clone()

    # -- snapshot --------------------------------------------------------
    def snapshot(self) -> dict:
        """Host-side copy of accounting + page storage (numpy arrays, the
        pages in float32)."""
        return {"free": [p for f in self._shard_free for p in f],
                "reserved": self._reserved,
                "reserved_by": list(self._shard_reserved),
                "n_shards": self.n_shards,
                "seized": self._seized,
                "k_pages": {li: to_numpy(a)
                            for li, a in self.k_pages.items()},
                "v_pages": {li: to_numpy(a)
                            for li, a in self.v_pages.items()}}

    def restore(self, snap: dict):
        if set(snap["k_pages"]) != set(self.k_pages):
            raise PageError("snapshot layer set does not match this pool")
        if snap.get("n_shards", 1) != self.n_shards:
            raise PageError(f"snapshot has {snap.get('n_shards', 1)} "
                            f"shards, pool has {self.n_shards}")
        flat = list(snap["free"])
        self._shard_free = [[p for p in flat if self.shard_of(p) == h]
                            for h in range(self.n_shards)]
        rby = snap.get("reserved_by")
        if rby is not None:
            self._shard_reserved = [int(r) for r in rby]
        else:
            self._shard_reserved = [int(snap["reserved"])] + \
                [0] * (self.n_shards - 1)
        self._seized = int(snap.get("seized", 0))
        for li in self.k_pages:
            self.k_pages[li] = from_numpy(snap["k_pages"][li], self.dtype,
                                          self.device)
            self.v_pages[li] = from_numpy(snap["v_pages"][li], self.dtype,
                                          self.device)

    # -- storage --------------------------------------------------------
    def write_prefill(self, li: int, pages: List[int], k, v):
        """Scatter a prefilled (S, Hkv, Dh) K/V slab into ``pages``.
        S is padded up to a whole number of pages (pad rows are past the
        sequence position, hence masked at attention time)."""
        ps = self.page_size
        s = k.shape[0]
        pad = len(pages) * ps - s
        if pad < 0:
            raise PageError(f"{len(pages)} pages cannot hold {s} tokens")
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for store, x in ((self.k_pages[li], k), (self.v_pages[li], v)):
            x = torch.as_tensor(x).to(self.device)
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).reshape(
                len(pages), ps, *x.shape[1:])
            store.index_copy_(0, idx, x.to(self.dtype))


def to_numpy(a: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (bf16 widened to float32, which holds it
    exactly)."""
    a = a.detach()
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.cpu().numpy().copy()


def from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)
