"""LRU result cache for (s, t) distance answers.

Distances are immutable for a given index generation, so caching is
sound. Anything that mutates the index in place (§8.3
``insert_vertex``/``delete_vertex``) invalidates it — call
``DistanceServer.refresh()`` afterwards. Keys are exact (s, t) pairs;
construct with ``symmetric=True`` (``DistanceServer(...,
cache_symmetric=True)``) for undirected indexes so (t, s) hits too.

The port's copy of ``repro.serve.cache`` (pure Python).
"""
from __future__ import annotations

from collections import OrderedDict


class LRUCache:
    """Bounded LRU map from (s, t) to a float distance.

    ``capacity <= 0`` disables the cache (every get misses, puts are
    dropped) so call sites need no branching.
    """

    def __init__(self, capacity: int, symmetric: bool = False):
        self.capacity = int(capacity)
        self.symmetric = bool(symmetric)
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def _key(self, s: int, t: int):
        if self.symmetric and t < s:
            return (t, s)
        return (s, t)

    def get(self, s: int, t: int):
        if self.capacity <= 0:
            self.misses += 1
            return None
        key = self._key(s, t)
        val = self._d.get(key)
        if val is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return val

    def put(self, s: int, t: int, value: float) -> None:
        if self.capacity <= 0:
            return
        key = self._key(s, t)
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
