"""Paged KV-cache allocator: one physical page pool, per-request block tables.

The serving engine's KV cache is a pool of fixed-size physical pages
(``cfg.kv_page`` tokens each); every request owns a *block table* mapping
its logical pages (position // page) to physical page ids.  The allocator
manages the free list, grows block tables on demand, and releases a
request's pages on completion or preemption.

Cross-request prefix caching (the ROADMAP's "caching" lever): physical
pages are *ref-counted* and full prompt pages are *content-addressed* by
a hash chain over their token content.  ``ensure_prompt`` splits into a
cached-hit **attach** (refcount++ on a page another request already
materialised) and a fresh allocation; releasing a page whose content is
registered in the prefix index parks it in an LRU of
unreferenced-but-cached pages instead of the free list, so a later
request with the same prompt prefix can re-attach it.  When a request's
write frontier lands in a shared page (a fully-cached prompt whose last
token must be recomputed to produce logits) the allocator performs
**copy-on-write**: the request gets a private copy and the engine
replays the pool bytes via :meth:`drain_copies`.

The physical page id is the unit the whole memory-system story shares:

* the TopK selection in the paged decode path gathers K/V *by physical
  page id* (``sparse_attention.select_pages_blocktable``),
* the NSB hot-set accounting (``capture.PageCache``) is keyed by the same
  physical ids, and
* the capture recorder (``capture.PageStream``) tags those ids per
  request/step so the NVR simulator replays the allocator's actual
  layout — with prefix caching on, genuinely *shared* physical ids, so
  NSB hit rate and NVR miss reduction are measured on the real reuse
  structure of multi-tenant traffic.

Physical page 0 is reserved as a scratch/null page: padded batch rows and
masked prefill positions write there, so the model step functions never
need data-dependent shapes.  The allocator never hands page 0 out.

**Host spill tier** (``spill_pages > 0``): preemption can *swap out*
instead of free-and-recompute.  ``spill_request`` snapshots every page a
request holds into host spill slots (the engine performs the actual
device->host copies via :meth:`drain_spill_outs`) and releases the HBM
pages; ``resume_spilled`` allocates fresh HBM pages all-or-nothing and
queues the host->device restores (:meth:`drain_swap_ins`), so the
request resumes at its old KV frontier with zero recompute.  Spill slots
are only ids here — the bytes live in :class:`~.spill.HostSpillPool`.

Invariants this module maintains (audited by
:meth:`KVBlockAllocator.check_tier_invariants` and the hypothesis
property suite):

* **One tier per physical page id** — every allocatable HBM page id is
  in exactly one of {referenced by >= 1 block table, cached-but-free
  LRU, free list} at all times.  In particular a page released by a
  spill is *unregistered* from the prefix index first, so its content
  can never sit in the cached LRU and the spill pool simultaneously
  (resume restores from the spill snapshot, never from a maybe-evicted
  cache entry).
* **Refcount conservation** — ``_ref[p]`` equals the number of block
  tables containing ``p``; refs are only created by allocation/attach
  and only destroyed by ``_release_ref``.
* **Reservation is all-or-nothing** — ``ensure`` / ``ensure_prompt`` /
  ``resume_spilled`` either take every page they need or take none and
  leave state untouched (no partial reservations to unwind).
* **Spill-slot bijection** — a spill slot id is owned by exactly one
  (request, logical page) snapshot, or is free, or is draining (queued
  for an engine copy); slots drain before they recycle, so a queued
  host transfer can never read a slot a same-iteration spill reused.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

NULL_PAGE = 0

_CHAIN_SEED = 0x9E3779B9


@dataclass
class AllocatorStats:
    allocs: int = 0
    frees: int = 0
    alloc_failures: int = 0    # ensure() growth failures (preempt trigger)
    admission_blocks: int = 0  # ensure_prompt() refusals (HOL polling)
    peak_in_use: int = 0
    prefix_hits: int = 0       # pages attached from the prefix index
    prefix_evictions: int = 0  # cached pages reclaimed for fresh allocs
    cow_copies: int = 0        # shared pages privatised before a write
    spill_out_pages: int = 0   # page snapshots queued device -> host
    swap_in_pages: int = 0     # page restores queued host -> device
    spill_failures: int = 0    # spill refused (tier off / slots short)
    spill_unregistered: int = 0  # prefix entries dropped at spill time
    session_holds: int = 0     # block tables adopted by idle sessions
    session_releases: int = 0  # idle-session holds released


class KVBlockAllocator:
    """Free-list + prefix-cache allocator over ``n_pages`` physical pages.

    ``n_pages`` includes the reserved scratch page 0, so ``capacity`` —
    the number of allocatable pages — is ``n_pages - 1``.

    Page lifecycle: free -> referenced (refcount >= 1, possibly by
    several requests sharing a prompt prefix) -> either free again, or —
    when the page's content is registered in the prefix index — *cached*
    (refcount 0, content retained, LRU-evictable).  ``pages_free`` counts
    everything reclaimable (free list + cached LRU), so admission-control
    arithmetic is unchanged by caching.
    """

    def __init__(self, n_pages: int, page_tokens: int,
                 prefix_cache: bool = True, spill_pages: int = 0) -> None:
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.prefix_cache = prefix_cache
        # pop() from the end -> low page ids are handed out first
        self._free = list(range(n_pages - 1, NULL_PAGE, -1))
        self._tables: dict[int, list[int]] = {}
        self._ref: dict[int, int] = {}                 # page -> refcount
        # content-addressing: chain key -> (page, token tuple); the token
        # tuple is compared on attach, so a hash collision can never
        # splice the wrong content into a request
        self._index: dict[int, tuple[int, tuple]] = {}
        self._page_key: dict[int, int] = {}            # page -> chain key
        self._cached: OrderedDict[int, None] = OrderedDict()
        # rid -> (pages registered so far, chain key at that depth):
        # register_prefix resumes here instead of re-hashing the prompt
        self._reg_state: dict[int, tuple[int, int]] = {}
        self._pending_copies: list[tuple[int, int]] = []
        # pages whose last live reference dropped since the previous
        # drain_released(): the runahead hot tier invalidates these —
        # a freed page can be re-taken and rewritten, so a staged copy
        # of its old content must never resolve again
        self._released: list[int] = []
        # -- host spill tier (ids only; bytes live in spill.HostSpillPool)
        self.spill_pages = spill_pages
        self._spill_free = list(range(spill_pages - 1, -1, -1))
        # rid -> (slot ids, old physical page ids) aligned by logical page
        self._spilled: dict[int, tuple[list[int], list[int]]] = {}
        # engine transfer queues: device->host snapshots and host->device
        # restores.  Slots referenced by queued swap-ins are *draining*:
        # they recycle only when drain_swap_ins() hands the copies to the
        # engine, so a spill in the same scheduler pass cannot overwrite
        # a snapshot before its restore is read.
        self._pending_spill_out: list[tuple[int, int]] = []  # (page, slot)
        self._pending_swap_in: list[tuple[int, int]] = []    # (slot, page)
        self._slots_draining: list[int] = []
        # rid -> {old page id -> new page id} from the latest resume; the
        # engine drains these to remap predictor history onto the
        # restored physical ids
        self._pending_remaps: list[tuple[int, dict[int, int]]] = []
        # page id -> number of live host snapshots taken from it: while
        # > 0 a release must not park the id in the cached LRU (see
        # _release_ref — one home per content)
        self._snap_refs: dict[int, int] = {}
        # rids whose block table is an *idle-session hold*: KV pinned
        # between conversation turns by the engine's session layer, not
        # by a live request.  Pure accounting — the pages behave like
        # any other referenced pages; the gauge lets metrics and the
        # idle-eviction hook see how much of the pool sessions pin.
        self._session_rids: set[int] = set()
        self.stats = AllocatorStats()

    # -- capacity ------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def pages_free(self) -> int:
        """Reclaimable pages: the free list plus cached-but-unreferenced
        pages (evictable, so they count as available for admission)."""
        return len(self._free) + len(self._cached)

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one live request."""
        return self.capacity - self.pages_free

    @property
    def pages_cached(self) -> int:
        return len(self._cached)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    # -- block tables --------------------------------------------------------

    def table(self, rid: int) -> list[int]:
        return self._tables.setdefault(rid, [])

    def table_array(self, rid: int, n_logical: int) -> np.ndarray:
        """The request's block table padded with NULL_PAGE to length
        ``n_logical`` (the step functions take fixed-shape tables)."""
        bt = np.full((n_logical,), NULL_PAGE, dtype=np.int32)
        pages = self._tables.get(rid, [])
        bt[: len(pages)] = pages[:n_logical]
        return bt

    # -- idle-session holds --------------------------------------------------

    def adopt_table(self, new_rid: int, old_rid: int) -> bool:
        """Hand ``old_rid``'s block table (and its prefix-registration
        cursor) to ``new_rid`` without touching refcounts.

        The engine's session layer uses this at request completion to
        keep a finished conversation turn's KV alive under a *holder*
        rid between turns — the pages stay referenced (un-evictable)
        until the holder is spilled (idle swap-out) or freed.  The
        holder is marked so :meth:`pages_session_held` and the tier
        invariants can account for session-pinned pages."""
        if new_rid in self._tables or new_rid in self._spilled \
                or old_rid not in self._tables:
            return False
        self._tables[new_rid] = self._tables.pop(old_rid)
        st = self._reg_state.pop(old_rid, None)
        if st is not None:
            self._reg_state[new_rid] = st
        self._session_rids.add(new_rid)
        self.stats.session_holds += 1
        return True

    @property
    def session_rids(self) -> frozenset:
        return frozenset(self._session_rids)

    @property
    def pages_session_held(self) -> int:
        """HBM pages pinned by idle-session holders."""
        return sum(len(self._tables.get(r, ())) for r in self._session_rids)

    @property
    def pages_session_spilled(self) -> int:
        """Host spill slots owned by idle-session holders (idle
        swap-outs waiting for the conversation's next turn)."""
        return sum(len(self._spilled[r][0]) for r in self._session_rids
                   if r in self._spilled)

    # -- page plumbing -------------------------------------------------------

    def _take_page(self) -> int:
        """One reclaimable page (caller has checked availability): free
        list first, then evict the least-recently-parked cached page."""
        if self._free:
            return self._free.pop()
        page, _ = self._cached.popitem(last=False)
        key = self._page_key.pop(page)
        del self._index[key]
        self.stats.prefix_evictions += 1
        return page

    def _release_ref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page]:
            return
        del self._ref[page]
        self._released.append(page)
        if page in self._page_key and page in self._snap_refs:
            # the page's content is snapshotted in the host spill tier:
            # one home per content — unregister it so the id free-lists
            # instead of sitting in the cached LRU *and* the spill pool
            # (resume always restores from the snapshot; an LRU entry
            # could be evicted underneath it).  A later re-take of the
            # same id by unrelated content may lose its cache entry this
            # way — a conservative cache miss, never a correctness bug.
            key = self._page_key.pop(page)
            del self._index[key]
            self.stats.spill_unregistered += 1
        if page in self._page_key:
            # content survives for future prefix attaches, LRU order
            self._cached[page] = None
            self._cached.move_to_end(page)
        else:
            self._free.append(page)

    def _chain_keys(self, tokens, n_pages: int):
        """``(key, chunk)`` per full page of ``tokens``: key i hashes the
        chain of pages [0..i], so equal keys mean equal prefix *and*
        equal absolute positions (RoPE-safe sharing)."""
        pt = self.page_tokens
        out = []
        h = _CHAIN_SEED
        for i in range(n_pages):
            chunk = tuple(int(t) for t in tokens[i * pt:(i + 1) * pt])
            h = hash((h, chunk))
            out.append((h, chunk))
        return out

    # -- allocation ----------------------------------------------------------

    def ensure(self, rid: int, n_tokens: int) -> bool:
        """Grow ``rid``'s block table to cover ``n_tokens`` positions
        with freshly-allocated private pages.

        All-or-nothing: returns False (and allocates nothing) if the
        reclaimable pages cannot supply every page needed.
        """
        need = self.pages_for_tokens(n_tokens) - len(self.table(rid))
        if need <= 0:
            return True
        if need > self.pages_free:
            self.stats.alloc_failures += 1
            return False
        pages = [self._take_page() for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        self._tables[rid].extend(pages)
        self.stats.allocs += need
        self.stats.peak_in_use = max(self.stats.peak_in_use,
                                     self.pages_in_use)
        return True

    def ensure_prompt(self, rid: int, tokens) -> tuple[bool, int]:
        """Reserve every page of a prompt, attaching cached prefix pages.

        Walks the token-hash chain of full pages from the request's
        current frontier: each chain hit *attaches* the cached physical
        page (refcount++, zero fresh pages charged); the first miss ends
        the chain and the remainder is allocated fresh.  If the chain
        covers the *entire* prompt, the last page is immediately
        copied-on-write so the frontier token's recompute (needed to
        produce logits) never writes into a shared page.

        All-or-nothing over the fresh pages; returns ``(ok,
        cached_tokens)`` where ``cached_tokens`` is how far the KV
        frontier can fast-forward (pool content already materialised).
        """
        tokens = np.asarray(tokens).reshape(-1)
        n_tokens = len(tokens)
        total = self.pages_for_tokens(n_tokens)
        table = self.table(rid)
        have = len(table)
        if total <= have:
            return True, 0
        attach: list[tuple[int, int]] = []             # (page, key)
        if self.prefix_cache:
            keys = self._chain_keys(tokens, min(total, n_tokens
                                                // self.page_tokens))
            for i in range(have, len(keys)):
                key, chunk = keys[i]
                hit = self._index.get(key)
                if hit is None or hit[1] != chunk:
                    break
                attach.append((hit[0], key))
        def _avail() -> int:
            return (len(self._free) + len(self._cached)
                    - sum(1 for p, _ in attach if p in self._cached))

        fresh = total - have - len(attach)
        full_hit = have + len(attach) == total
        if full_hit and attach:
            fresh += 1                                 # COW of the tail page
            if fresh > _avail():
                # the COW page may only be missing because every
                # reclaimable page is one we meant to attach: degrade to
                # attaching one page fewer and *prefilling* the tail
                attach.pop()
                fresh = total - have - len(attach)
                full_hit = False
        if fresh > _avail():
            # a blocked queue head polls this every scheduler tick:
            # tracked separately so alloc_failures keeps meaning
            # "mid-stream growth failed" (the preemption trigger)
            self.stats.admission_blocks += 1
            return False, 0
        for p, _ in attach:
            self._cached.pop(p, None)
            self._ref[p] = self._ref.get(p, 0) + 1
            table.append(p)
            self.stats.prefix_hits += 1
        if full_hit and attach:
            shared = table[-1]
            private = self._take_page()
            self._ref[private] = 1
            self._pending_copies.append((shared, private))
            table[-1] = private
            self._release_ref(shared)
            self.stats.cow_copies += 1
            self.stats.allocs += 1
            fresh -= 1
        for _ in range(fresh):
            p = self._take_page()
            self._ref[p] = 1
            table.append(p)
            self.stats.allocs += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use,
                                     self.pages_in_use)
        cached = min(len(attach) * self.page_tokens, n_tokens)
        return True, cached

    def drain_copies(self) -> list[tuple[int, int]]:
        """Pending ``(src, dst)`` copy-on-write pool copies; the engine
        must replay these on k/v/summary pools *before* running any
        prefill/decode that reads the destination pages."""
        out = self._pending_copies
        self._pending_copies = []
        return out

    def drain_released(self) -> list[int]:
        """Pages whose last live reference dropped since the previous
        call.  The runahead tier invalidates these before the next
        decode: once released a page may be re-taken and rewritten
        (directly from ``_free``, or evicted out of ``_cached``), and a
        staged copy of the old content must not survive that.  Cached
        pages that get re-attached later are re-staged on demand —
        conservatively losing a hit, never correctness."""
        out = self._released
        self._released = []
        return out

    # -- the prefix index ----------------------------------------------------

    def register_prefix(self, rid: int, tokens, n_computed: int) -> int:
        """Publish ``rid``'s fully-materialised whole prompt pages into
        the prefix index (call *after* their KV is written to the pool).
        Idempotent; an existing registration for the same content wins.
        Returns the number of newly-registered pages."""
        if not self.prefix_cache:
            return 0
        tokens = np.asarray(tokens).reshape(-1)
        n_full = min(n_computed, len(tokens)) // self.page_tokens
        table = self._tables.get(rid, [])
        n_full = min(n_full, len(table))
        done, h = self._reg_state.get(rid, (0, _CHAIN_SEED))
        pt = self.page_tokens
        new = 0
        for i in range(done, n_full):
            chunk = tuple(int(t) for t in tokens[i * pt:(i + 1) * pt])
            h = hash((h, chunk))
            page = table[i]
            if h not in self._index and page not in self._page_key:
                self._index[h] = (page, chunk)
                self._page_key[page] = h
                new += 1
        if n_full > done:
            self._reg_state[rid] = (n_full, h)
        return new

    # -- host spill tier ------------------------------------------------------

    @property
    def spill_slots_free(self) -> int:
        return len(self._spill_free)

    @property
    def pages_spilled(self) -> int:
        """Host snapshots currently held (slots owned by spilled rids)."""
        return sum(len(s) for s, _ in self._spilled.values())

    def is_spilled(self, rid: int) -> bool:
        return rid in self._spilled

    def _drop_snap_refs(self, old_pages) -> None:
        for p in old_pages:
            n = self._snap_refs.get(p, 0) - 1
            if n > 0:
                self._snap_refs[p] = n
            else:
                self._snap_refs.pop(p, None)

    def spill_request(self, rid: int) -> bool:
        """Swap ``rid`` out: snapshot every page it holds into host spill
        slots and release the HBM pages.

        All-or-nothing on the slots; returns False (state untouched,
        ``stats.spill_failures``) when the tier is disabled or short.
        The engine must drain :meth:`drain_spill_outs` — performing the
        device->host reads — before any pool write in the next
        iteration, because the released ids can be re-taken immediately.
        """
        pages = self._tables.get(rid, [])
        if not self.spill_pages or not pages \
                or len(pages) > len(self._spill_free):
            self.stats.spill_failures += 1
            return False
        slots = [self._spill_free.pop() for _ in pages]
        self._pending_spill_out.extend(zip(pages, slots))
        self._spilled[rid] = (slots, list(pages))
        for p in pages:
            self._snap_refs[p] = self._snap_refs.get(p, 0) + 1
        self._tables.pop(rid)
        self._reg_state.pop(rid, None)     # resume rebuilds on fresh ids
        self.stats.frees += len(pages)
        self.stats.spill_out_pages += len(pages)
        for p in reversed(pages):
            self._release_ref(p)
        return True

    def resume_spilled(self, rid: int, n_tokens: int = 0) -> bool:
        """Swap ``rid`` back in: allocate fresh HBM pages for every
        snapshot (plus enough extra private pages to cover ``n_tokens``
        positions, e.g. the rest of a partially-prefilled prompt) and
        queue the host->device restores (:meth:`drain_swap_ins`).

        All-or-nothing; returns False (``stats.admission_blocks``) when
        the pool cannot supply every page.  On success the request's
        block table covers its old KV frontier on *new* physical ids;
        the old->new map is queued for :meth:`drain_remaps` so the
        runahead predictor can carry its history across the rename.
        """
        rec = self._spilled.get(rid)
        if rec is None:
            return False
        slots, old_pages = rec
        extra = max(0, self.pages_for_tokens(n_tokens) - len(slots))
        if len(slots) + extra > self.pages_free:
            self.stats.admission_blocks += 1
            return False
        del self._spilled[rid]
        self._drop_snap_refs(old_pages)
        pages = [self._take_page() for _ in range(len(slots) + extra)]
        for p in pages:
            self._ref[p] = 1
        self._tables.setdefault(rid, []).extend(pages)
        self._pending_swap_in.extend(zip(slots, pages))
        # slots drain (recycle only once the engine takes the copies):
        # a spill queued later in the same scheduler pass must not reuse
        # a slot whose restore bytes have not been read yet
        self._slots_draining.extend(slots)
        self._pending_remaps.append((rid, dict(zip(old_pages, pages))))
        self.stats.allocs += len(pages)
        self.stats.swap_in_pages += len(slots)
        self.stats.peak_in_use = max(self.stats.peak_in_use,
                                     self.pages_in_use)
        return True

    def drain_spill_outs(self) -> list[tuple[int, int]]:
        """Pending ``(page, slot)`` device->host snapshots.  The engine
        must read the page bytes before this iteration writes any pool
        page (released ids are re-takeable the moment they free)."""
        out = self._pending_spill_out
        self._pending_spill_out = []
        return out

    def drain_swap_ins(self) -> list[tuple[int, int]]:
        """Pending ``(slot, page)`` host->device restores; taking them
        recycles the draining slots.  The engine applies these *after*
        spill-out reads and COW copies (both read pages a restore may
        overwrite) and before any prefill/decode touches the pages."""
        out = self._pending_swap_in
        self._pending_swap_in = []
        self._spill_free.extend(self._slots_draining)
        self._slots_draining = []
        return out

    def drain_remaps(self) -> list[tuple[int, dict[int, int]]]:
        """Pending ``(rid, {old page -> new page})`` renames from
        resumes, for predictor-history carry-over."""
        out = self._pending_remaps
        self._pending_remaps = []
        return out

    def check_tier_invariants(self) -> None:
        """Audit the one-tier-per-page partition and the spill-slot
        bijection (see the module docstring); raises AssertionError on
        the first violation.  O(n_pages) — called from tests and the
        hypothesis property suite, not the hot path."""
        held: dict[int, int] = {}
        for table in self._tables.values():
            for p in table:
                held[p] = held.get(p, 0) + 1
        assert held == self._ref, \
            f"refcount conservation broken: {held} != {self._ref}"
        live, free, cached = set(held), set(self._free), set(self._cached)
        assert len(free) == len(self._free), "duplicate free-list entries"
        assert live.isdisjoint(free), f"live∩free: {live & free}"
        assert live.isdisjoint(cached), f"live∩cached: {live & cached}"
        assert free.isdisjoint(cached), f"free∩cached: {free & cached}"
        assert live | free | cached == set(range(1, self.n_pages)), \
            "page ids lost or invented across tiers"
        for p in self._page_key:
            assert p not in free, f"registered page {p} on the free list"
        # spill slots: free + draining + owned partition [0, spill_pages)
        owned: list[int] = []
        snaps: dict[int, int] = {}
        for slots, old in self._spilled.values():
            assert len(slots) == len(old)
            owned.extend(slots)
            for p in old:
                snaps[p] = snaps.get(p, 0) + 1
        slots_all = self._spill_free + self._slots_draining + owned
        assert sorted(slots_all) == list(range(self.spill_pages)), \
            "spill slots lost, invented, or double-owned"
        assert snaps == self._snap_refs, \
            f"snapshot refcounts diverged: {snaps} != {self._snap_refs}"
        # the bugfix invariant: a snapshotted page id never also sits in
        # the cached-but-free LRU (one home per content)
        assert cached.isdisjoint(snaps), \
            f"pages in cached LRU and spill pool: {cached & set(snaps)}"
        # idle-session holders always have a home: a block table (pinned
        # in HBM) or a spill record (idle swap-out) — a mark without
        # either would be leaked session accounting
        for r in self._session_rids:
            assert r in self._tables or r in self._spilled, \
                f"session hold {r} has neither a table nor a snapshot"

    # -- release -------------------------------------------------------------

    def free_request(self, rid: int) -> list[int]:
        """Drop every reference ``rid`` holds; returns the released ids.
        Shared pages stay live for their other holders; registered pages
        whose refcount hits 0 park in the cached LRU, the rest return to
        the free list (LIFO, keeping hot physical ids dense).  A spilled
        rid's host slots are recycled too (snapshot discarded)."""
        rec = self._spilled.pop(rid, None)
        if rec is not None:
            slots, old_pages = rec
            self._spill_free.extend(slots)
            self._drop_snap_refs(old_pages)
        if rid in self._session_rids:
            self._session_rids.discard(rid)
            self.stats.session_releases += 1
        pages = self._tables.pop(rid, [])
        self._reg_state.pop(rid, None)     # a resume rebuilds its table
        self.stats.frees += len(pages)
        for p in reversed(pages):
            self._release_ref(p)
        return pages

    def owned(self, rid: int) -> int:
        return len(self._tables.get(rid, []))


@dataclass
class PagePoolConfig:
    """Geometry of the physical pools the engine allocates once."""

    n_pages: int
    page_tokens: int
    n_layers: int
    n_kv_heads: int
    head_dim: int
    dtype_bytes: int = 2

    @property
    def page_bytes(self) -> int:
        """K+V bytes of one physical page across all layers."""
        return (2 * self.n_layers * self.page_tokens * self.n_kv_heads
                * self.head_dim * self.dtype_bytes)

    @property
    def pool_bytes(self) -> int:
        return self.n_pages * self.page_bytes
