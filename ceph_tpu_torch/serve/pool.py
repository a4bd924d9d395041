"""Paged stripe pool — fixed-size pages + page-table indirection for
the ragged serving path (the Ragged Paged Attention design translated
to erasure coding).  A copy of ``ceph_tpu/serve/pool.py``; the pool is
host bookkeeping.

The dense batcher pads every shape bucket up a rung ladder, so a
mixed-stripe-size day pays ``padding_overhead`` on every fire and one
cached program per (pattern, rung).  The paged path instead stages
each admitted request into fixed-size PAGES of one pool per
(plugin, profile, op, erasure-pattern) queue:

- the pool is a host-side staging buffer ``(pages, rows, page_size)``
  uint8 with a free-list allocator; the batcher copies it to the card
  whole on every fire (serve/batcher.py), dead pages included, as the
  reference hands its jitted program the host buffer;
- the PAGE TABLE maps request id -> (page ids, byte length): a
  request of chunk size C occupies ceil(C / page_size) pages, so the
  only padding anywhere is the tail of its last page — zero whenever
  the page size divides the chunk size;
- pages are reclaimed EXPLICITLY at demux (``reclaim``); allocation
  failure is the batcher's backpressure signal (fire now, then
  retry);
- the per-fire ``(pages,)`` activity mask is data to the ragged
  kernel, so one callable and one kernel build per queue serve every
  occupancy — |patterns| entries, not |buckets| x |ladder|.

Column-locality makes the page a valid standalone chunk: GF region
math mixes rows (shards), never columns, so applying the code to each
page independently and concatenating columns IS the per-request
result.  Codes with internal column structure declare it
(codes/base.py): ``page_unit()`` quantizes the page size (field
elements, bitmatrix packet blocks, clay sub-chunk counts) and
``page_interleave()`` = Q makes :func:`split_pages` take column
slices of every one of the chunk's Q groups (clay's sub-chunk
coupling spans all groups at one intra-group offset), so every page
is still a valid mini-chunk.  ``join_pages`` inverts the layout on
the output rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..telemetry import metrics as tel

# the reference's tuned-table defaults (kind "stripe-pool"): the page
# size divides every SIMD-aligned power-of-two chunk size >= 512, so
# the mixed-size contention day pays ZERO page-tail padding
DEFAULT_PAGE_SIZE = 512
DEFAULT_POOL_PAGES = 64


def tuned_pool_config() -> Tuple[int, int]:
    """(page_size, pool_pages) from the installed best-config table
    (kind ``stripe-pool``), else the defaults.  Consulted once per
    batcher at construction — a tuned value changes pool geometry,
    never bytes."""
    from ..tune.table import consult
    page_size, pool_pages = DEFAULT_PAGE_SIZE, DEFAULT_POOL_PAGES
    cfg = consult("stripe-pool")
    if cfg:
        v = cfg.get("page_size")
        if isinstance(v, int) and not isinstance(v, bool) and v > 0:
            page_size = v
        v = cfg.get("pool_pages")
        if isinstance(v, int) and not isinstance(v, bool) and v > 0:
            pool_pages = v
    return page_size, pool_pages


def effective_page_size(requested: int, unit: int) -> int:
    """Round the configured page size UP to the plugin's page_unit()
    quantum (codes/base.py) so every page is a valid mini-chunk."""
    if unit <= 1:
        return requested
    return unit * math.ceil(requested / unit)


def split_pages(arr: np.ndarray, page_size: int,
                interleave: int = 1) -> np.ndarray:
    """(rows, C) -> (n_pages, rows, page_size) valid mini-chunks.

    interleave=Q: view the chunk as (rows, Q, C/Q) and give page p
    columns [p*sp, (p+1)*sp) of EVERY group (sp = page_size/Q); Q=1 is
    a plain contiguous split.  The tail page zero-pads — the ONLY
    padding in the paged path."""
    rows, c = arr.shape
    q = max(1, interleave)
    if c % q or page_size % q:
        raise ValueError(
            f"chunk {c} / page {page_size} must be multiples of the "
            f"interleave factor {q}")
    sc = c // q
    sp = page_size // q
    n = math.ceil(sc / sp)
    out = np.zeros((n, rows, page_size), np.uint8)
    v = arr.reshape(rows, q, sc)
    ov = out.reshape(n, rows, q, sp)
    for p in range(n):
        w = min(sp, sc - p * sp)
        ov[p, :, :, :w] = v[:, :, p * sp:p * sp + w]
    return out


def join_pages(pages: np.ndarray, total: int,
               interleave: int = 1) -> np.ndarray:
    """Inverse of split_pages on the OUTPUT rows: (n_pages, rows,
    page_size) -> (rows, total), dropping the tail-page pad."""
    n, rows, page_size = pages.shape
    q = max(1, interleave)
    sc = total // q
    sp = page_size // q
    out = np.empty((rows, q, sc), np.uint8)
    pv = pages.reshape(n, rows, q, sp)
    for p in range(n):
        w = min(sp, sc - p * sp)
        out[:, :, p * sp:p * sp + w] = pv[p, :, :, :w]
    return out.reshape(rows, total)


class PoolExhausted(RuntimeError):
    """Allocation failed — the batcher's backpressure signal: fire the
    queue (demux reclaims every page) and retry."""


class PagedStripePool:
    """One bounded page pool + page table (one per ragged queue).

    Host-side staging: ``buf`` is the (pages, rows, page_size) uint8
    array the ragged device program consumes whole (with the activity
    mask); ``alloc``/``write`` happen at admission (mux), ``reclaim``
    at demux.  Not thread-safe by itself — the batcher's lock covers
    it, like every other piece of bucket state."""

    def __init__(self, pages: int, rows: int, page_size: int,
                 interleave: int = 1) -> None:
        if pages < 1 or rows < 1 or page_size < 1:
            raise ValueError(
                f"pool geometry ({pages}, {rows}, {page_size}) must be "
                f"positive")
        self.pages = pages
        self.rows = rows
        self.page_size = page_size
        self.interleave = max(1, interleave)
        self.buf = np.zeros((pages, rows, page_size), np.uint8)
        # LIFO free list: recently-reclaimed pages are re-used first
        self._free: List[int] = list(range(pages - 1, -1, -1))
        # page table: req_id -> (page ids in column order, byte length)
        self._table: Dict[object, Tuple[Tuple[int, ...], int]] = {}
        self.allocs = 0
        self.reclaims = 0
        self.backpressure = 0
        self.high_water = 0

    # -- geometry -----------------------------------------------------------

    def pages_for(self, length: int) -> int:
        return math.ceil(length / self.page_size)

    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.pages - len(self._free)

    def occupancy(self) -> float:
        return self.used_pages() / self.pages

    def requests(self) -> List[object]:
        return list(self._table)

    # -- mux ----------------------------------------------------------------

    def write(self, req_id, payload: np.ndarray) -> Tuple[int, ...]:
        """Stage one request's (rows, C) payload into free pages;
        returns the page ids (column order).  Raises PoolExhausted on
        pressure (caller fires + retries) and ValueError for requests
        no empty pool could ever hold."""
        rows, length = payload.shape
        if rows != self.rows:
            raise ValueError(
                f"payload rows {rows} != pool rows {self.rows}")
        if req_id in self._table:
            raise ValueError(f"request {req_id!r} already staged")
        need = self.pages_for(length)
        if need > self.pages:
            raise ValueError(
                f"request of {length} bytes needs {need} pages; pool "
                f"has only {self.pages} (raise pool_pages or "
                f"page_size)")
        if need > len(self._free):
            self.backpressure += 1
            tel.counter("serve_pool_backpressure")
            raise PoolExhausted(
                f"{need} pages needed, {len(self._free)} free")
        ids = tuple(self._free.pop() for _ in range(need))
        # split_pages zero-pads the tail page, so stale bytes from the
        # page's previous tenant never ride into a fire
        self.buf[list(ids)] = split_pages(payload, self.page_size,
                                          self.interleave)
        self._table[req_id] = (ids, length)
        self.allocs += need
        self.high_water = max(self.high_water, self.used_pages())
        return ids

    def mask(self) -> np.ndarray:
        """(pages,) uint8 {0,1} activity mask — the ragged programs'
        traced operand (free-list reclaim scatters live pages, so this
        is a mask, never a prefix count)."""
        m = np.zeros(self.pages, np.uint8)
        for ids, _ in self._table.values():
            m[list(ids)] = 1
        return m

    # -- demux --------------------------------------------------------------

    def lease(self, req_id) -> Tuple[Tuple[int, ...], int]:
        return self._table[req_id]

    def read(self, req_id, out: np.ndarray) -> np.ndarray:
        """Gather one request's result rows from a per-page output
        array (pages, out_rows, page_size): page-table indirection +
        join_pages inverse layout, tail pad dropped."""
        ids, length = self._table[req_id]
        return join_pages(np.ascontiguousarray(out[list(ids)]), length,
                          self.interleave)

    def reclaim(self, req_id) -> int:
        """Return one request's pages to the free list (demux-time —
        the explicit reclaim of the paged contract); returns the page
        count."""
        ids, _ = self._table.pop(req_id)
        self._free.extend(ids)
        self.reclaims += len(ids)
        return len(ids)

    # -- accounting ---------------------------------------------------------

    def tail_bytes(self, req_id) -> int:
        """Page-tail pad bytes this request carries per row — THE only
        padding in the paged path (zero when page_size | length)."""
        ids, length = self._table[req_id]
        return len(ids) * self.page_size - length

    def stats(self) -> dict:
        return {
            "pages": self.pages,
            "page_size": self.page_size,
            "rows": self.rows,
            "used_pages": self.used_pages(),
            "occupancy": self.occupancy(),
            "high_water": self.high_water,
            "allocs": self.allocs,
            "reclaims": self.reclaims,
            "backpressure": self.backpressure,
        }


def pool_selftest(seed: int = 0) -> dict:
    """Host-tier pool selftest: split/join round-trips — contiguous and interleaved — plus
    alloc/reclaim free-list accounting and backpressure, all in pure
    numpy.  Returns the checked invariants; raises on any violation."""
    rng = np.random.default_rng(seed)
    checks = 0
    for q in (1, 4, 8):
        for c in (256, 512, 1280):
            if c % q:
                continue
            arr = rng.integers(0, 256, (3, c), dtype=np.uint8)
            for ps in (128, 256, 512):
                if ps % q:
                    continue
                pages = split_pages(arr, ps, q)
                back = join_pages(pages, c, q)
                if not np.array_equal(arr, back):
                    raise AssertionError(
                        f"split/join round-trip failed (C={c}, "
                        f"page={ps}, Q={q})")
                checks += 1
    pool = PagedStripePool(pages=4, rows=2, page_size=128, interleave=1)
    a = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    b = rng.integers(0, 256, (2, 128), dtype=np.uint8)
    pool.write("a", a)
    pool.write("b", b)
    if pool.used_pages() != 3 or pool.mask().sum() != 3:
        raise AssertionError("page-table accounting wrong after writes")
    try:
        pool.write("c", rng.integers(0, 256, (2, 256), dtype=np.uint8))
    except PoolExhausted:
        pass
    else:
        raise AssertionError("expected PoolExhausted at 1 free page")
    ident = np.broadcast_to(pool.buf, pool.buf.shape)  # fire stand-in
    got_a = pool.read("a", np.ascontiguousarray(ident))
    if not np.array_equal(got_a, a):
        raise AssertionError("page-table read-back diverged")
    pool.reclaim("a")
    pool.reclaim("b")
    if pool.used_pages() != 0 or pool.reclaims != pool.allocs:
        raise AssertionError("reclaim-after-demux accounting wrong")
    return {"round_trips": checks, "ok": True,
            **{k: pool.stats()[k] for k in ("allocs", "reclaims",
                                            "backpressure")}}
