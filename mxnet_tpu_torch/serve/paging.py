"""Host-side paged KV-cache bookkeeping: the page allocator and the
prefix hash table behind the paged decode engine.

Counterpart of ``mxnet_tpu/serve/paging.py``, line for line, with its own
copy of the page hash.  The device side of the paged pool is two heaps
``(layers, kv_pages, kv_page_len, heads, head_dim)`` owned by
:class:`~mxnet_tpu_torch.serve.decode.PagedDecodeServable`; this module is
everything the pump needs to decide, without touching the device, which
physical pages a session's logical positions live in:

* :class:`PageAllocator` — free-list allocator over the heap's page ids
  with refcounted sharing.  Page 0 is reserved as the scratch page
  (padded decode lanes and masked prefill rows scatter into it).  A
  released page whose content is published under a prefix hash is not
  freed: it parks in an LRU cache so that a later session with the same
  prefix can adopt it; cached pages are reclaimed lazily when the free
  list runs dry.  Admission is therefore bounded by ``free_pages()``
  (free + evictable), not by slot count.

* **Prefix hashing** — :func:`chain_hash` / :func:`page_hashes` roll a
  content hash over token ids at full-page boundaries.  ``hashes[i]``
  covers the entire prompt through page ``i``, so hash equality means the
  whole prefix is identical and the donor's KV pages can be adopted bit
  for bit.  Publication comes strictly after the pages' prefill chunks
  were issued on the device's stream, so an adopted page is never read
  before it is written.

Concurrency: the pump thread is the only mutator; handler threads read
:meth:`PageAllocator.stats` for the health surface, so every public
method takes the allocator lock.  Nothing here touches the device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from ..base import MXNetError

__all__ = ["PageAllocator", "chain_hash", "page_hashes",
           "SCRATCH_PAGE"]

#: page id 0 is never allocated: padded decode lanes and masked prefill
#: rows need somewhere harmless to scatter (the flat engine's scratch
#: slot, shrunk to one page)
SCRATCH_PAGE = 0

# 61-bit Mersenne-prime rolling hash (the reference's constants, so both
# packages hash a prompt alike): cheap in python ints, collision odds
# ~2^-61 per pair — and a collision only ever SHARES a page between
# prefixes, it cannot corrupt one, so the failure mode is a wrong (but
# deterministic) generation caught by the parity tests
_HASH_MOD = (1 << 61) - 1
_HASH_MULT = 1048583
HASH_SEED = 1469598103


def chain_hash(prev: int, tokens: Sequence[int]) -> int:
    """Extend a rolling content hash over ``tokens``.  Chained page by
    page, so equal hashes mean the ENTIRE prefix matches, not just the
    last page."""
    h = int(prev)
    for t in tokens:
        h = (h * _HASH_MULT + int(t) + 1) % _HASH_MOD
    return h


def page_hashes(prompt: Sequence[int], page_len: int) -> List[int]:
    """Chain hash at every FULL-page boundary of ``prompt``:
    ``hashes[i]`` covers ``prompt[:(i + 1) * page_len]``.  A trailing
    partial page is never hashed — only read-only full pages are
    shareable."""
    out: List[int] = []
    h = HASH_SEED
    for i in range(len(prompt) // page_len):
        h = chain_hash(h, prompt[i * page_len:(i + 1) * page_len])
        out.append(h)
    return out


class PageAllocator:
    """Refcounted free-list allocator over ``n_pages`` physical page
    ids (page 0 reserved: the scratch page).

    Lifecycle of one page::

        FREE --alloc--> HELD(ref=1) --publish--> HELD+HASHED
          ^                |  ^                      |
          |          release|  +--lookup (ref+=1) ---+ ... ref drops
          |                v                         v
          +---------- (unhashed)              CACHED (ref=0, in LRU)
          +<------- evicted when the free list runs dry ------+
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise MXNetError("PageAllocator: need >= 2 pages (page 0 "
                             "is the reserved scratch page)")
        self.n_pages = int(n_pages)
        self._lk = threading.Lock()
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._refs: List[int] = [0] * self.n_pages
        self._page_of_hash: Dict[int, int] = {}
        self._hash_of_page: Dict[int, int] = {}
        # cached pages: ref == 0 but hashed; OrderedDict as an LRU
        # (oldest first -> evicted first)
        self._lru: "OrderedDict[int, bool]" = OrderedDict()
        self.shared_hits = 0          # lookup() hits (pages adopted)
        self.evictions = 0            # cached pages reclaimed

    # -- allocation (pump thread) ------------------------------------------
    def alloc(self, k: int) -> Optional[List[int]]:
        """Take ``k`` pages (ref = 1 each), evicting cached prefix
        pages LRU-first if the free list runs dry.  Returns None —
        allocating NOTHING — when even eviction cannot cover ``k``:
        admission then waits, it never half-allocates."""
        with self._lk:
            if k > len(self._free) + len(self._lru):
                return None
            out: List[int] = []
            for _ in range(k):
                if self._free:
                    page = self._free.pop()
                else:
                    page, _ = self._lru.popitem(last=False)
                    h = self._hash_of_page.pop(page)
                    self._page_of_hash.pop(h, None)
                    self.evictions += 1
                self._refs[page] = 1
                out.append(page)
            return out

    def lookup(self, chain_h: int) -> Optional[int]:
        """Adopt the page published under ``chain_h`` (ref += 1), or
        None.  A cached page leaves the LRU — it is live again."""
        with self._lk:
            page = self._page_of_hash.get(chain_h)
            if page is None:
                return None
            self._refs[page] += 1
            self._lru.pop(page, None)
            self.shared_hits += 1
            return page

    def publish(self, chain_h: int, page: int) -> bool:
        """Expose a HELD page's content under its prefix hash.  First
        writer wins: if the hash is already published (a concurrent
        admission of the same prefix), the existing donor keeps it and
        this page simply stays private."""
        with self._lk:
            if chain_h in self._page_of_hash or page in self._hash_of_page:
                return False
            self._page_of_hash[chain_h] = page
            self._hash_of_page[page] = chain_h
            return True

    def release(self, page: int) -> None:
        """Drop one reference.  At ref 0 a hashed page parks in the
        LRU cache (still adoptable); an unhashed one returns to the
        free list."""
        with self._lk:
            r = self._refs[page] - 1
            if r < 0:
                raise MXNetError("PageAllocator: double release of "
                                 "page %d" % page)
            self._refs[page] = r
            if r == 0:
                if page in self._hash_of_page:
                    self._lru[page] = True
                else:
                    self._free.append(page)

    # -- read-only surface (any thread) -------------------------------------
    def free_pages(self) -> int:
        """Admission headroom: truly-free pages plus evictable cached
        ones."""
        with self._lk:
            return len(self._free) + len(self._lru)

    def shared_extra_refs(self) -> int:
        """Pages of HBM that sharing is currently saving: every
        reference past the first on a hashed page is a prefill the
        adopter did not pay and a page it did not allocate."""
        with self._lk:
            return sum(self._refs[p] - 1 for p in self._hash_of_page
                       if self._refs[p] > 1)

    def stats(self) -> Dict[str, int]:
        with self._lk:
            cached = len(self._lru)
            return {
                "n_pages": self.n_pages,
                "free": len(self._free) + cached,
                "cached": cached,
                "held": self.n_pages - 1 - len(self._free) - cached,
                "hashed": len(self._hash_of_page),
                "shared_hits": self.shared_hits,
                "evictions": self.evictions,
            }
