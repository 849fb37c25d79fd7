"""Host-side radix index over page-grain token chunks for the shared
prefix pool (a copy of ``dlrover_tpu/serving/prefix_index.py``: pure
Python, the same in both packages).

The device pool (``serving.kv_cache.init_prefix_pool``) is a flat array
of ``num_pages`` KV pages; THIS structure decides what each page means.
It is a trie whose edges are exact ``page_size``-token tuples — a match
walks child dictionaries keyed by the literal token ids, so a hit IS an
exact token comparison and a hash collision is impossible by
construction (there is no hash shortcut to collide; dict key equality
compares the full tuple).

Refcounts pin pages for the admit window of a live request: a pinned
node (or any ancestor of one — children imply their parents) is never
an eviction victim. Eviction is LRU over refcount-0 LEAF nodes only, so
the invariant "every indexed page's whole prefix chain is present"
holds at all times; evicting a node removes it from the trie, which is
what makes page-id reuse safe — a stale page can never be matched
again, the next request with that prefix simply misses and prefills.

``release`` is idempotent per handle and survives ``flush`` (the handle
keeps references to the orphaned node objects, so decrementing them
after a flush touches nothing reachable) — refcounts can never dangle
across a pool rebuild or a live resize.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("serving.prefix_index")


@dataclass
class _Node:
    chunk: Tuple[int, ...]
    page_id: int
    parent: Optional["_Node"]
    refcount: int = 0
    last_use: int = 0
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)


@dataclass
class PrefixHandle:
    """A pin over one matched chain; ``release`` through the index is
    idempotent (the handle remembers it was released)."""

    nodes: List[_Node]
    released: bool = False

    @property
    def pages(self) -> List[int]:
        return [n.page_id for n in self.nodes]

    @property
    def tokens(self) -> int:
        return sum(len(n.chunk) for n in self.nodes)


class PrefixIndex:
    """Refcounted radix index mapping token-chunk chains to pool pages."""

    def __init__(self, page_size: int, num_pages: int):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = int(page_size)
        self.capacity = max(0, int(num_pages))
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._by_page: Dict[int, _Node] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._clock = itertools.count(1)
        # cumulative stats (survive flush — they describe the process,
        # not the current pool contents)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.published = 0
        self.publish_skipped = 0
        self.saved_tokens = 0

    # -- introspection -------------------------------------------------------

    @property
    def used_pages(self) -> int:
        return len(self._by_page)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "published": self.published,
            "publish_skipped": self.publish_skipped,
            "saved_tokens": self.saved_tokens,
            "used_pages": self.used_pages,
            "capacity": self.capacity,
        }

    # -- match / pin ---------------------------------------------------------

    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        pg = self.page_size
        out: List[_Node] = []
        level = self._root
        for i in range(0, len(tokens) - pg + 1, pg):
            chunk = tuple(int(t) for t in tokens[i:i + pg])
            node = level.get(chunk)
            if node is None:
                break
            out.append(node)
            level = node.children
        return out

    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None,
              align_pages: int = 1) -> Optional[PrefixHandle]:
        """Longest exact chain of full pages matching the leading
        tokens, pinned. Returns None on a zero-page match (and counts a
        miss). ``max_pages`` caps the chain (the engine's strictly-
        below-prompt-length cap); ``align_pages`` rounds it DOWN to a
        whole multiple (the engine's lcm(page, chunk) bitwise grain) —
        both applied BEFORE pinning, so only used pages are pinned."""
        chain = self._walk(tokens)
        if max_pages is not None:
            chain = chain[:max(0, int(max_pages))]
        a = max(1, int(align_pages))
        chain = chain[:(len(chain) // a) * a]
        if not chain:
            self.misses += 1
            return None
        now = next(self._clock)
        for node in chain:
            node.refcount += 1
            node.last_use = now
        self.hits += 1
        self.saved_tokens += len(chain) * self.page_size
        return PrefixHandle(nodes=chain)

    def release(self, handle: Optional[PrefixHandle]) -> None:
        """Idempotent unpin; safe on handles that predate a flush (the
        orphaned nodes absorb the decrement harmlessly)."""
        if handle is None or handle.released:
            return
        handle.released = True
        for node in handle.nodes:
            node.refcount = max(0, node.refcount - 1)

    # -- publish -------------------------------------------------------------

    def _evictable(self) -> List[_Node]:
        return [n for n in self._by_page.values()
                if n.refcount == 0 and not n.children]

    def _evict_one(self) -> Optional[int]:
        victims = self._evictable()
        if not victims:
            return None
        victim = min(victims, key=lambda n: n.last_use)
        level = (victim.parent.children if victim.parent is not None
                 else self._root)
        level.pop(victim.chunk, None)
        del self._by_page[victim.page_id]
        self.evictions += 1
        return victim.page_id

    def reserve_page(self) -> Optional[int]:
        """A free page id, LRU-evicting an unpinned leaf when the pool
        is full. None when every page is pinned or an ancestor of a
        pinned/live chain — the caller degrades to miss-and-prefill."""
        if self._free:
            return self._free.pop()
        return self._evict_one()

    def publish(self, tokens: Sequence[int]) -> List[Tuple[int, int]]:
        """Index the full pages of ``tokens`` that are not yet present.
        Returns ``[(page_index_within_prompt, pool_page_id), ...]`` for
        the NEWLY indexed pages — the caller must copy each slot page
        into its pool page. A full pool (all pages pinned) skips the
        remainder: logged and counted, never raised."""
        pg = self.page_size
        out: List[Tuple[int, int]] = []
        if self.capacity == 0:
            return out
        level = self._root
        parent: Optional[_Node] = None
        now = next(self._clock)
        for idx, i in enumerate(range(0, len(tokens) - pg + 1, pg)):
            chunk = tuple(int(t) for t in tokens[i:i + pg])
            node = level.get(chunk)
            if node is None:
                page_id = self.reserve_page()
                if page_id is None:
                    self.publish_skipped += 1
                    logger.debug(
                        "prefix pool full (all pages pinned); skipping "
                        "publish of %d remaining pages",
                        (len(tokens) - i) // pg)
                    break
                node = _Node(chunk=chunk, page_id=page_id, parent=parent,
                             last_use=now)
                level[chunk] = node
                self._by_page[page_id] = node
                self.published += 1
                out.append((idx, page_id))
            else:
                node.last_use = now
            parent = node
            level = node.children
        return out

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        """Drop every indexed page (pool rebuild / prefill-chunk grain
        change). Outstanding handles keep their orphaned node objects,
        so a later ``release`` is a no-op — no refcount can dangle into
        the fresh index."""
        self._root = {}
        self._by_page = {}
        self._free = list(range(self.capacity - 1, -1, -1))
