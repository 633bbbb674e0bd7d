"""NSB hot-set model over page ids: a fully-associative LRU of
``capacity_pages`` pages that installs on every miss.

The serve engine scores each decode step's unique layer-0 pages against
it (the demand-LRU NSB hit rate).  It counts exactly as the reference's
``core/nvr/capture.py::PageCache`` in its demand mode, which sits on the
simulator's cache model; the simulator is a later slice of the port.
"""

from __future__ import annotations

from collections import OrderedDict


class PageCache:
    def __init__(self, capacity_pages: int) -> None:
        if capacity_pages < 1:
            raise ValueError(f"capacity_pages must be >= 1, got "
                             f"{capacity_pages}")
        self.capacity = capacity_pages
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def touch(self, page: int) -> bool:
        """Access one page id; True on a hit.  A miss installs the page,
        evicting the least recently used one when full."""
        p = int(page)
        if p in self._lru:
            self._lru.move_to_end(p)
            self.hits += 1
            return True
        self.misses += 1
        if len(self._lru) >= self.capacity:
            self._lru.popitem(last=False)
        self._lru[p] = None
        return False

    @property
    def hit_rate(self) -> float | None:
        """Hit rate, or None before any traffic."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else None
