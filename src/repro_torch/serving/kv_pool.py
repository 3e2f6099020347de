"""Fixed-size KV page pool: the allocator behind paged continuous batching.

A copy of ``repro/serving/kv_pool.py`` (pure Python there too).

The pool owns ``num_pages`` physical pages of ``page_size`` token slots
each, shared by every layer (one block table per sequence; layer caches are
parallel planes indexed by the same physical page ids -- vLLM's design).
Page 0 is reserved as the *null page*: block-table entries of inactive
slots and the not-yet-written tail all point at it, and the paged decode
kernel never reads a page past a sequence's length
(``kernels/flash_decode.flash_decode_paged``).

Allocation is host-side and O(1) per page (a free-list stack); the device
never sees the pool -- only the int32 block table the engine pushes each
tick. ``alloc`` is all-or-nothing (admission either fully fits or waits),
``extend`` grows a live sequence by one page (alloc-on-append), ``free``
retires a request's pages back to the stack (free-on-retire).
"""

from __future__ import annotations

from typing import Dict, List, Optional

NULL_PAGE = 0


class KVPagePool:
    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "need at least the null page + one real page"
        assert page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free-list: hot pages are reused first. Page 0 (null) is never
        # in the list.
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}  # rid -> physical page ids

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (the null page is bookkeeping, not capacity)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def pages_of(self, rid: int) -> List[int]:
        """Physical pages owned by ``rid``, in logical order."""
        return list(self._owned.get(rid, ()))

    def pages_for_tokens(self, tokens: int) -> int:
        """Pages needed to hold positions [0, tokens); callers wanting write
        headroom for position L ask for L + 1 tokens."""
        return -(-tokens // self.page_size)

    def page_utilization(self) -> float:
        return self.used_pages / self.usable_pages if self.usable_pages else 0.0

    def alloc(self, rid: int, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages for a new request; None (and no change) if
        the pool cannot fully satisfy it -- admission is all-or-nothing."""
        assert rid not in self._owned, f"rid {rid} already holds pages"
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned[rid] = pages
        return list(pages)

    def extend(self, rid: int) -> Optional[int]:
        """Alloc-on-append: one more page for a live request; None on OOM
        (the engine then preempts -- see PagedServingEngine)."""
        if not self._free:
            return None
        page = self._free.pop()
        self._owned.setdefault(rid, []).append(page)
        return page

    def free(self, rid: int) -> int:
        """Free-on-retire: return all of ``rid``'s pages; returns count."""
        pages = self._owned.pop(rid, [])
        self._free.extend(reversed(pages))
        return len(pages)

    # ------------------------------------------------------ observability
    def register_metrics(self, registry, prefix: str = "kv_pool") -> None:
        """Register lazily sampled pool gauges into a metrics registry
        (``repro_torch.obs.metrics.MetricsRegistry``): ``<prefix>/{num_pages,
        used_pages, free_pages, page_utilization, resident_seqs}``. All read
        live allocator state at snapshot time -- no write traffic on the
        alloc/extend/free hot path."""
        registry.gauge_fn(f"{prefix}/num_pages", lambda: float(self.usable_pages))
        registry.gauge_fn(f"{prefix}/used_pages", lambda: float(self.used_pages))
        registry.gauge_fn(f"{prefix}/free_pages", lambda: float(self.free_pages))
        registry.gauge_fn(f"{prefix}/page_utilization", self.page_utilization)
        registry.gauge_fn(f"{prefix}/resident_seqs", lambda: float(len(self._owned)))
