"""Compilation cache for the staged pipeline (ROADMAP: serve-heavy-traffic).

Keys are structural: for SDFG programs, ``(content_hash, backend,
pipeline_signature, device)``.
Values are whatever the builder produced (a ``Compiled`` stage, a
``Lowered``, a jitted step function). The cache is a bounded LRU so long
sweeps (dry-runs over every arch x shape cell) cannot grow it without
limit.

A single process-wide instance, ``COMPILATION_CACHE``, is shared by
``Lowered.compile`` and the launch-layer helpers; tests construct private
instances.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional

_MISSING = object()

#: env var overriding the default LRU capacity. Serving sweeps many
#: (batch, context) shape buckets; a deployment holding more live buckets
#: than the default can raise this without code changes.
CACHE_SIZE_ENV = "REPRO_COMPILE_CACHE_SIZE"
DEFAULT_MAX_ENTRIES = 128


def _default_max_entries() -> int:
    raw = os.environ.get(CACHE_SIZE_ENV)
    if raw is None:
        return DEFAULT_MAX_ENTRIES
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{CACHE_SIZE_ENV}={raw!r} is not an integer") from None
    if n < 1:
        raise ValueError(f"{CACHE_SIZE_ENV} must be >= 1, got {n}")
    return n


class CompilationCache:
    """Bounded LRU cache with hit/miss accounting.

    Capacity: explicit ``max_entries`` wins; ``None`` defers to the
    ``REPRO_COMPILE_CACHE_SIZE`` env var (read at construction time), then
    to ``DEFAULT_MAX_ENTRIES``.
    """

    def __init__(self, max_entries: Optional[int] = None):
        self.max_entries = _default_max_entries() if max_entries is None \
            else max_entries
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: Hashable, default=None) -> Optional[Any]:
        with self._lock:
            value = self._entries.get(key, _MISSING)
            if value is _MISSING:
                self.misses += 1
                return default
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def contains(self, key: Hashable) -> bool:
        """Membership test without touching hit/miss counters."""
        with self._lock:
            return key in self._entries

    def store(self, key: Hashable, value: Any) -> Any:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return value

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        value = self.lookup(key, _MISSING)
        if value is not _MISSING:
            return value
        return self.store(key, builder())

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses}

    def __len__(self):
        return len(self._entries)

    def __repr__(self):
        s = self.stats
        return (f"CompilationCache({s['entries']} entries, "
                f"{s['hits']} hits, {s['misses']} misses)")


#: process-wide cache used by ``Lowered.compile`` and the launch layer.
COMPILATION_CACHE = CompilationCache()
