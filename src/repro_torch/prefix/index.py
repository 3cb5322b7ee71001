"""Token-id radix index over page-granular prompt prefixes (the port's copy
of ``repro.prefix.index``; page keys are the int32 token bytes, as there).

The index answers one question at admission time: *how many leading pages
of this prompt have we already computed KV for?* Keys are pages — fixed
``page_size`` runs of token ids — so two prompts share a cache node iff
they agree on a whole page, and a lookup walks at most
``prompt_len // page_size`` dict hops. Each node represents one page and
owns (via ``entries``, maintained by ``cache.PrefixCacheManager``) the
pool keys of that page's KV slices; a chain of nodes from the root is a
cached prefix.

The tree is pure bookkeeping — no tensors, no pool access — so it can be
unit-tested and reasoned about independently of the memory subsystem:

- ``match(tokens)``    — longest chain of cached pages leading the prompt;
- ``insert(tokens, n)``— extend the tree to cover the first ``n`` pages,
  returning the full chain and which nodes are new (donation fills those);
- ``remove(node)``     — drop a node *and every descendant* (a longer
  prefix is meaningless once one of its pages is gone);
- ``refs``/``last_use``— per-node pin count and LRU clock for the
  manager's eviction policy.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

_NODE_IDS = itertools.count()


class PrefixNode:
    """One cached page: ``page_size`` token ids at depth*page_size offset."""

    __slots__ = ("node_id", "parent", "page_key", "children", "entries",
                 "refs", "last_use", "depth", "hits")

    def __init__(self, parent: Optional["PrefixNode"], page_key: bytes,
                 depth: int) -> None:
        self.node_id = next(_NODE_IDS)
        self.parent = parent
        self.page_key = page_key
        self.children: Dict[bytes, "PrefixNode"] = {}
        self.entries: Dict[str, str] = {}   # page label -> pool key
        self.refs = 0                       # live requests reading this page
        self.last_use = 0                   # index LRU clock
        self.depth = depth                  # pages from root (1-based)
        self.hits = 0

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return (f"PrefixNode(id={self.node_id}, depth={self.depth}, "
                f"refs={self.refs}, children={len(self.children)})")


class RadixPrefixIndex:
    """Radix tree over token pages; one node per cached page."""

    def __init__(self, page_size: int) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self.root = PrefixNode(None, b"", 0)
        self.nodes: Dict[int, PrefixNode] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self.nodes)

    def _page_key(self, tokens: np.ndarray, page: int) -> bytes:
        a = page * self.page_size
        return np.ascontiguousarray(
            tokens[a:a + self.page_size], dtype=np.int32).tobytes()

    def _touch(self, chain: List[PrefixNode]) -> None:
        self._clock += 1
        for node in chain:
            node.last_use = self._clock

    # -- lookup --------------------------------------------------------
    def match(self, tokens: np.ndarray,
              max_pages: Optional[int] = None) -> List[PrefixNode]:
        """Longest cached chain of whole pages leading ``tokens`` (root →
        deepest), at most ``max_pages`` long. Refreshes the chain's LRU
        clock — a match is a use."""
        tokens = np.asarray(tokens).reshape(-1)
        limit = len(tokens) // self.page_size
        if max_pages is not None:
            limit = min(limit, max_pages)
        chain: List[PrefixNode] = []
        node = self.root
        for p in range(limit):
            child = node.children.get(self._page_key(tokens, p))
            if child is None:
                break
            chain.append(child)
            node = child
        if chain:
            self._touch(chain)
        return chain

    # -- growth --------------------------------------------------------
    def insert(self, tokens: np.ndarray,
               n_pages: int) -> Tuple[List[PrefixNode], List[PrefixNode]]:
        """Extend the tree to cover the first ``n_pages`` pages of
        ``tokens``. Returns ``(chain, created)``: the full root→deep chain
        and the subset that did not exist before (whose KV the caller must
        supply)."""
        tokens = np.asarray(tokens).reshape(-1)
        if n_pages * self.page_size > len(tokens):
            raise ValueError(
                f"prompt of {len(tokens)} tokens has no {n_pages} full "
                f"pages of {self.page_size}")
        chain: List[PrefixNode] = []
        created: List[PrefixNode] = []
        node = self.root
        for p in range(n_pages):
            key = self._page_key(tokens, p)
            child = node.children.get(key)
            if child is None:
                child = PrefixNode(node, key, p + 1)
                node.children[key] = child
                self.nodes[child.node_id] = child
                created.append(child)
            chain.append(child)
            node = child
        if chain:
            self._touch(chain)
        return chain, created

    # -- removal -------------------------------------------------------
    def remove(self, node: PrefixNode) -> List[PrefixNode]:
        """Detach ``node`` and its whole subtree (deepest prefixes first).
        Returns every removed node so the owner can release their pool
        entries. A chain is only as valid as its shallowest page."""
        if node.parent is not None:
            node.parent.children.pop(node.page_key, None)
        removed: List[PrefixNode] = []
        stack = [node]
        while stack:
            n = stack.pop()
            removed.append(n)
            self.nodes.pop(n.node_id, None)
            stack.extend(n.children.values())
            n.children.clear()
            n.parent = None
        return removed

    def evictable(self) -> List[PrefixNode]:
        """Leaf nodes with no live refs, coldest first — the only safe
        eviction order (removing an interior node would orphan deeper
        pages; removing a ref'd node would corrupt a running request)."""
        leaves = [n for n in self.nodes.values()
                  if not n.children and n.refs == 0]
        return sorted(leaves, key=lambda n: n.last_use)
