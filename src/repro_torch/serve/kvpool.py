"""Host-side paged-KV bookkeeping: page allocator + radix prefix cache
(a copy of ``repro.serve.kvpool``, which the port may not import).

Pure Python: the device side of paged serving is a fixed-shape pool
(``models.transformer.init_page_pool``) plus a block table copied to the
device once per decode step, so all allocation policy lives here where it
is cheap to run per scheduler tick and easy to property-test
(``tests/test_torch_paged.py`` drives these classes from hypothesis
strategies and against the reference's).

Conventions shared with the device side:

* **Page 0 is the sink page** — never handed out.  Retired or inactive
  batch lanes keep scattering their decode K/V somewhere; the runtime
  zeroes their block-table rows so those writes land in page 0, which
  no live row's table ever references and no ``kv_len`` mask reaches.
* **Reference counts own pages.**  A page is held once per slot using
  it and once more if the radix cache holds it; it returns to the free
  list exactly when the last reference is released.
* **Prefix sharing is whole-page-granular.**  The radix tree maps
  page-sized token chunks to pages, so a shared page is always full
  and therefore immutable — extension writes always land in the
  extender's own pages (copy-on-extend without any copying).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

SINK_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class PageAllocator:
    """Refcounted fixed-size page allocator over ``num_pages`` pages.

    Page ``SINK_PAGE`` (0) is reserved and never allocated; the usable
    capacity is ``num_pages - 1``.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"need at least 2 pages (sink + 1 usable), got {num_pages}")
        self.num_pages = num_pages
        # stack: pops hand out low page ids first (nicer to inspect)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` distinct pages with refcount 1 each."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"requested {n} pages, {len(self._free)} free "
                f"of {self.num_pages - 1} usable")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (pages must be live)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"retain of unallocated page {p}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; returns how many pages were freed."""
        freed = 0
        for p in pages:
            refs = self._refs.get(p)
            if refs is None:
                raise ValueError(f"double free of page {p}")
            if refs == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = refs - 1
        return freed

    def check(self) -> None:
        """Internal-consistency assertions (used by property tests)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicates")
        if SINK_PAGE in free or SINK_PAGE in self._refs:
            raise AssertionError("sink page entered circulation")
        if free & set(self._refs):
            raise AssertionError("page both free and allocated")
        if len(free) + len(self._refs) != self.num_pages - 1:
            raise AssertionError("pages leaked or duplicated")
        if any(r < 1 for r in self._refs.values()):
            raise AssertionError("non-positive refcount on a live page")


class _Node:
    __slots__ = ("children", "page", "tick")

    def __init__(self, page: int, tick: int):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.page = page
        self.tick = tick


class RadixCache:
    """Page-granular radix (trie) cache over prompt prefixes.

    Keys are tuples of ``page_size`` token ids; each node owns one
    reference on the page holding that chunk's K/V.  ``match`` returns
    the pages of the longest cached whole-page prefix; ``insert``
    registers a completed prompt's full pages; ``evict`` drops
    least-recently-used leaf nodes until enough pages are free.

    Because only *full* pages are ever cached and a prompt's total
    fill is always past its full-page region by the time it is
    inserted (the partial last page plus at least one generated token
    live beyond it), cached pages are never written again — sharing is
    copy-on-extend with no copying.
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.alloc = alloc
        self.page_size = page_size
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._tick = 0
        self.pages_cached = 0

    def _chunks(self, tokens: Sequence[int]):
        ps = self.page_size
        for i in range(0, (len(tokens) // ps) * ps, ps):
            yield tuple(int(t) for t in tokens[i:i + ps])

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Pages of the longest cached whole-page prefix of ``tokens``.

        The caller owns taking references (``alloc.retain``) on the
        pages it decides to use; matching only refreshes recency.
        """
        self._tick += 1
        pages: List[int] = []
        children = self._root
        for key in self._chunks(tokens):
            node = children.get(key)
            if node is None:
                break
            node.tick = self._tick
            pages.append(node.page)
            children = node.children
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register ``tokens``' full-page chunks as cached.

        ``pages[i]`` must hold the K/V of chunk ``i`` (the prompt's
        ordered page list).  Chunks already cached keep their existing
        page (equivalent bit-identical content — the exactness
        invariant); new chunks take one cache reference on the
        caller's page.  Returns the number of newly cached pages.
        """
        self._tick += 1
        added = 0
        children = self._root
        for i, key in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            node = children.get(key)
            if node is None:
                node = _Node(int(pages[i]), self._tick)
                self.alloc.retain([node.page])
                children[key] = node
                added += 1
                self.pages_cached += 1
            else:
                node.tick = self._tick
            children = node.children
        return added

    def evict(self, need_free: int) -> int:
        """Release LRU leaves until ``alloc.free_pages >= need_free``
        (or the cache is empty).  Returns the number of cache entries
        dropped.  Releasing an entry only frees its page if no slot
        still references it."""
        dropped = 0
        while self.alloc.free_pages < need_free:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            parent, key, node = leaf
            self.alloc.release([node.page])
            del parent[key]
            self.pages_cached -= 1
            dropped += 1
        return dropped

    def clear(self) -> int:
        """Drop every cached entry (releases all cache references)."""
        dropped = 0
        while True:
            leaf = self._lru_leaf()
            if leaf is None:
                return dropped
            parent, key, node = leaf
            self.alloc.release([node.page])
            del parent[key]
            self.pages_cached -= 1
            dropped += 1

    def _lru_leaf(self):
        """(parent_children, key, node) of the least-recent leaf."""
        best = None
        stack = [(self._root, k, n) for k, n in self._root.items()]
        while stack:
            parent, key, node = stack.pop()
            if node.children:
                stack.extend(
                    (node.children, k, n) for k, n in node.children.items())
            elif best is None or node.tick < best[2].tick:
                best = (parent, key, node)
        return best

    def check(self) -> None:
        """Internal-consistency assertions (used by property tests)."""
        count = 0
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            count += 1
            if self.alloc.refcount(node.page) < 1:
                raise AssertionError(
                    f"cached page {node.page} has no live reference")
            if node.page == SINK_PAGE:
                raise AssertionError("sink page cached")
            stack.extend(node.children.values())
        if count != self.pages_cached:
            raise AssertionError("pages_cached out of sync with tree")


def pages_needed(total_tokens: int, page_size: int) -> int:
    """Pages required to hold ``total_tokens`` positions."""
    return -(-int(total_tokens) // int(page_size))


def full_pages(prompt_len: int, page_size: int) -> int:
    """Whole pages exactly covered by a prompt (the cacheable region)."""
    return int(prompt_len) // int(page_size)


def shareable_prefix(match_pages: int, prompt_len: int,
                     page_size: int) -> int:
    """Tokens of cached prefix a request may reuse.

    Whole pages only, and always leaving at least one prompt token to
    run through prefill — the last-token logits must come from a live
    forward pass (also what keeps a fully-cached prompt from skipping
    the analog path entirely).
    """
    if prompt_len < 1:
        return 0
    cap = (prompt_len - 1) // page_size
    return min(int(match_pages), cap) * page_size
