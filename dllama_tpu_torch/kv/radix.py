"""Radix (compressed prefix) tree over token IDs mapping prefixes to KV pages.

The port's own copy of dllama_tpu/kv/radix.py (it imports nothing of the
JAX package); the code is unchanged. Node ids anchor the JAX package's
shared speculation store (runtime/spec.py), not ported yet.

Stored sequences are always truncated to whole pages (``n * page_size``
tokens), so every page *slot* ``s`` covers token positions
``[s*ps, (s+1)*ps)``.  A page is owned by the unique tree node whose edge
span contains the slot's **last** position — two sequences share slot ``s``
iff they agree on all tokens through ``(s+1)*ps``, which is exactly the
condition under which their KV rows for that slot are identical (causal
attention: row ``p`` depends only on tokens ``[0, p]``).  This rule keeps
the pages collected while descending consecutive from slot 0.

``match`` is token-granular: the caller may reuse a *partial* final page
(rows past the match point hold stale tokens but are overwritten by suffix
prefill before any query position can attend to them — the same argument
that makes the engine's parked-lane padding rows safe).

Eviction is LRU over leaves whose pages have no users beyond the tree
itself (refcount 1 in the :class:`~.pool.PagePool`).

**Node identity** (the shared-speculation anchor): every
node carries a monotonically assigned ``node_id``, and :meth:`match`
reports the id of the deepest node whose edge contributed at least one
matched token as ``MatchResult.anchor``.  When an edge is SPLIT the new
head — the node that keeps the shared prefix — INHERITS the original id
and the tail gets a fresh one, so streams that anchored on a prefix stay
grouped under one id even after later inserts carve the edge up.  Ids are
advisory grouping keys only: eviction retires them silently (the shared
n-gram store ages the group out by LRU), and every draft they seed is
verified, so a stale anchor can cost acceptance but never correctness.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from .pool import PagePool


@dataclass
class MatchResult:
    n_tokens: int                 # longest stored prefix agreeing with the query
    pages: List[int]              # page ids for slots 0..len(pages)-1, in slot order
    # pages may extend past n_tokens (stale tail rows — safe to adopt) and is
    # always consecutive from slot 0.
    anchor: Optional[int] = None  # node_id of the deepest edge that matched
    # (None when nothing matched — the root is never an anchor)


class _Node:
    __slots__ = (
        "tokens", "start", "children", "pages", "parent", "last_access",
        "node_id",
    )

    def __init__(
        self,
        tokens: Tuple[int, ...],
        start: int,
        parent: Optional["_Node"],
        node_id: int = 0,
    ) -> None:
        self.tokens = tokens          # edge label from parent
        self.start = start            # absolute position of tokens[0]
        self.children: Dict[int, _Node] = {}
        self.pages: List[Tuple[int, int]] = []   # (slot, page_id), slot-ascending
        self.parent = parent
        self.last_access = 0
        self.node_id = node_id        # stable grouping key (see module doc)

    @property
    def end(self) -> int:
        return self.start + len(self.tokens)


class RadixTree:
    def __init__(self, page_size: int) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.root = _Node((), 0, None, node_id=0)
        self._clock = 0
        self._n_pages = 0
        self._next_id = 1

    # -- helpers -----------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _new_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def _slot_end(self, slot: int) -> int:
        return (slot + 1) * self.page_size - 1

    # -- lookup ------------------------------------------------------------
    def match(self, tokens: Sequence[int], touch: bool = True) -> MatchResult:
        """Longest stored prefix of ``tokens`` plus the pages covering it."""
        now = self._tick() if touch else self._clock
        node = self.root
        matched = 0
        pages: List[int] = []
        anchor: Optional[int] = None
        while True:
            if touch:
                node.last_access = now
            if matched >= len(tokens):
                break
            child = node.children.get(tokens[matched])
            if child is None:
                break
            edge = child.tokens
            j = 0
            limit = min(len(edge), len(tokens) - matched)
            while j < limit and edge[j] == tokens[matched + j]:
                j += 1
            if j > 0:
                # Every page on ``child`` continues the consecutive slot run;
                # pages past the agreement point only carry stale tail rows.
                pages.extend(pid for _, pid in child.pages)
                matched += j
                # deepest edge with >= 1 agreeing token: a PARTIAL edge
                # match still anchors here — when the diverging stream
                # later publishes, the split head inherits this very id
                anchor = child.node_id
                if touch:
                    child.last_access = now
            if j < len(edge):
                break
            node = child
        return MatchResult(n_tokens=matched, pages=pages, anchor=anchor)

    # -- insertion ---------------------------------------------------------
    def insert(
        self,
        tokens: Sequence[int],
        new_pages: Sequence[int],
        first_slot: int,
    ) -> None:
        """Store ``tokens`` (must be whole pages), attaching ``new_pages`` to
        slots ``first_slot .. first_slot+len(new_pages)-1``.  Slots below
        ``first_slot`` must already be present along the matched path (the
        caller dedups via :meth:`match` first)."""
        ps = self.page_size
        if len(tokens) % ps != 0:
            raise ValueError(f"insert length {len(tokens)} not a multiple of page_size {ps}")
        n_full = len(tokens) // ps
        if first_slot + len(new_pages) != n_full:
            raise ValueError(
                f"pages for slots [{first_slot}, {first_slot + len(new_pages)}) "
                f"do not reach sequence end (slot {n_full})"
            )
        if first_slot > 0:
            # Slots the caller dedup'd away must actually be stored: an
            # insert whose lower slots are missing (e.g. the matched leaf
            # was evicted after the caller's match) would otherwise build
            # a token path whose early positions have NO pages behind
            # them, and later matches would hand out the suffix pages as
            # if they covered slot 0. Validate BEFORE any mutation.
            need = first_slot * ps
            covered: set = set()
            node, pos = self.root, 0
            while pos < need:
                child = node.children.get(tokens[pos])
                if child is None:
                    break
                edge = child.tokens
                j = 0
                limit = min(len(edge), len(tokens) - pos)
                while j < limit and edge[j] == tokens[pos + j]:
                    j += 1
                if j > 0:
                    covered.update(s for s, _ in child.pages)
                pos += j
                if j < len(edge):
                    break
                node = child
            missing = set(range(first_slot)) - covered
            if pos < need or missing:
                raise ValueError(
                    f"insert(first_slot={first_slot}) on a path storing "
                    f"only {pos} matching tokens, missing page slots "
                    f"{sorted(missing)} — dedup'd slots must already "
                    "exist on the matched path"
                )
        now = self._tick()
        node = self.root
        pos = 0
        while pos < len(tokens):
            node.last_access = now
            child = node.children.get(tokens[pos])
            if child is None:
                child = _Node(tuple(tokens[pos:]), pos, node, self._new_id())
                node.children[tokens[pos]] = child
                child.last_access = now
                node = child
                pos = len(tokens)
                break
            edge = child.tokens
            j = 0
            limit = min(len(edge), len(tokens) - pos)
            while j < limit and edge[j] == tokens[pos + j]:
                j += 1
            if j < len(edge):
                # Split child's edge at offset j; ``head`` is the new parent
                # holding the shared prefix of the edge.
                head = self._split(child, j)
                head.last_access = now
                if j < len(tokens) - pos:
                    # Diverged: hang the remaining suffix off the split point.
                    rest = _Node(
                        tuple(tokens[pos + j:]), pos + j, head, self._new_id()
                    )
                    head.children[tokens[pos + j]] = rest
                    rest.last_access = now
                pos = len(tokens)
                break
            child.last_access = now
            node = child
            pos += j
        # Attach each new page to the node containing its slot's last position.
        for i, pid in enumerate(new_pages):
            slot = first_slot + i
            owner = self._node_at(tokens, self._slot_end(slot))
            owner.pages.append((slot, pid))
            owner.pages.sort()
        self._n_pages += len(new_pages)

    def _split(self, node: _Node, offset: int) -> "_Node":
        """Split ``node``'s edge at ``offset``: node keeps the tail, a new
        parent takes the head (and the pages whose slots end in it).  The
        head INHERITS ``node``'s id — streams that anchored on this edge
        matched at least its head, so the grouping key must follow the
        shared prefix; the tail is a new, narrower identity."""
        assert 0 < offset < len(node.tokens)
        head = _Node(node.tokens[:offset], node.start, node.parent, node.node_id)
        node.node_id = self._new_id()
        head.last_access = node.last_access
        node.parent.children[node.tokens[0]] = head
        node.parent = head
        node.start += offset
        node.tokens = node.tokens[offset:]
        head.children[node.tokens[0]] = node
        keep, move = [], []
        for slot, pid in node.pages:
            (move if self._slot_end(slot) < node.start else keep).append((slot, pid))
        node.pages = keep
        head.pages = move
        return head

    def _node_at(self, tokens: Sequence[int], position: int) -> _Node:
        """Node whose edge span contains absolute ``position`` along ``tokens``."""
        node = self.root
        while True:
            child = node.children[tokens[node.end]]
            if child.end > position:
                return child
            node = child

    # -- eviction ----------------------------------------------------------
    def evict(self, n_pages: int, pool: "PagePool") -> int:
        """LRU-evict leaves whose pages only the tree holds (refcount 1),
        releasing them into ``pool`` until ``n_pages`` are freed or nothing
        is evictable.  Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim: Optional[_Node] = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                    continue
                if node is self.root:
                    continue
                if any(pool.refcount(pid) != 1 for _, pid in node.pages):
                    continue
                if victim is None or node.last_access < victim.last_access:
                    victim = node
            if victim is None:
                break
            freed += pool.release([pid for _, pid in victim.pages])
            self._n_pages -= len(victim.pages)
            parent = victim.parent
            del parent.children[victim.tokens[0]]
            # Collapse now-childless, pageless ancestors immediately:
            # left in place they are match()-able token spans with no
            # pages behind them, inflating node/token counts forever if
            # pressure never recurs.
            node = parent
            while node is not self.root and not node.children and not node.pages:
                del node.parent.children[node.tokens[0]]
                node = node.parent
        return freed

    # -- introspection -----------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self._n_pages

    def node_count(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n - 1  # exclude root

    def token_count(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.tokens)
            stack.extend(node.children.values())
        return n

    def all_pages(self) -> List[int]:
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            out.extend(pid for _, pid in node.pages)
            stack.extend(node.children.values())
        return out

    def clear(self, pool: Optional["PagePool"] = None) -> None:
        if pool is not None:
            pages = self.all_pages()
            if pages:
                pool.release(pages)
        self.root = _Node((), 0, None)
        self._n_pages = 0
