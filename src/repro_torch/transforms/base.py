"""Transformation framework: pattern-match + rewrite on SDFGs (paper §3.2).

DaCe expresses transformations as subgraph pattern matches; we keep the
same contract with a lighter API: ``find_matches`` yields candidate dicts,
``can_apply`` validates, ``apply_match`` mutates the graph.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from ..core.sdfg import SDFG, State


class Transformation:
    def find_matches(self, sdfg: SDFG) -> Iterable[Dict]:
        raise NotImplementedError

    def can_apply(self, sdfg: SDFG, match: Dict) -> bool:
        return True

    def apply_match(self, sdfg: SDFG, match: Dict) -> None:
        raise NotImplementedError

    def apply_everywhere(self, sdfg: SDFG, **kwargs) -> int:
        count = 0
        # fixpoint: a rewrite can expose new matches, but each pass collects
        # matches first so mutation does not invalidate the iterator.
        for _ in range(100):
            matches = [m for m in self.find_matches(sdfg, **kwargs)
                       if self.can_apply(sdfg, m)]
            if not matches:
                break
            applied_this_pass = 0
            for m in matches:
                if not self.can_apply(sdfg, m):  # may be stale after rewrite
                    continue
                self.apply_match(sdfg, m)
                count += 1
                applied_this_pass += 1
            if applied_this_pass == 0:
                break
        return count
