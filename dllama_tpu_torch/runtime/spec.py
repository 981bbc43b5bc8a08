"""Speculative drafting for the lane scheduler: draft sources + policy.

The port's copy of dllama_tpu/runtime/spec.py (stdlib only). The port's
lane server serves every mode: ``off``, ``ngram``, ``shared`` and
``draft`` (the resident draft model: `resolve_draft_model` and the
drafter's ``use_draft_model`` branch, driven by the scheduler's
``_draft_with_model``).

Prompt-lookup speculation (Leviathan et al.'s accept-longest-prefix
verification, with Saxena-style n-gram drafting instead of a draft
model): each greedy lane keeps an n-gram index over its *own* context
(prompt + generated tokens, extended incrementally as tokens stream)
and, when the current suffix has appeared before, proposes the tokens
that followed that earlier occurrence as a draft.  The engine then
verifies the whole draft in ONE batched forward pass
(``InferenceEngine.verify_lanes``) and the scheduler accepts the
longest prefix whose greedy argmax matches, plus one correction token.

Second-generation sources compose behind the same drafter interface as
a cumulative mode ladder (``off`` ⊂ ``ngram`` ⊂ ``shared`` ⊂ ``draft``):

* ``shared`` adds a **cross-lane shared n-gram store**
  (:class:`SharedNgramStore`) keyed by radix-tree node identity
  (``kv/radix.py`` anchors): every greedy lane publishes its accepted
  continuation-past-anchor under its anchor's id, and a lane whose
  prefix matched the same node drafts from every sibling's published
  continuation — fanout workloads (many users, one system prompt)
  draft from each other's history from token one, exactly where a
  private index is still empty.  Without a KV manager (``kv_page_size
  < 0``) there are no anchors and ``shared`` degrades to per-lane
  ``ngram`` behavior.
* ``draft`` additionally consults a **resident draft model** (a tiny
  Llama-family checkpoint sharing the target's tokenizer, loaded via
  ``InferenceEngine.init_draft_model``) when both n-gram sources run
  dry: the scheduler catches the draft cache up and runs ``k`` cheap
  greedy steps through the engine's ``draft_step`` programs.

Per tick the composed policy is: private n-gram hit → free; else
shared-store hit → free; else (mode ``draft``) the draft model.  One
AIMD draft length ``k`` per lane is shared across all sources.

Greedy output stays token-exact for EVERY source: only tokens the
verify pass itself argmax'd are ever emitted, so the stream is
byte-identical to plain greedy decoding (``tests/test_spec.py`` proves
this with the same seeded parity harness used for chunked admission).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.lockwatch import make_lock

__all__ = [
    "DEFAULT_SHARED_MAX_NGRAM",
    "DEFAULT_SPEC_K",
    "NgramDrafter",
    "NgramIndex",
    "SPEC_MODES",
    "SOURCE_DRAFT",
    "SOURCE_NGRAM",
    "SOURCE_SHARED",
    "SharedNgramStore",
    "bucket_for",
    "resolve_draft_model",
    "resolve_spec_knobs",
    "spec_buckets",
]

DEFAULT_SPEC_K = 4
DEFAULT_MAX_NGRAM = 3
#: the cross-lane store ranks sources by matched suffix length, so it
#: needs a longer horizon than the private index: a sibling's genuine
#: replay matches a long run, while byte-level self-echoes rarely
#: extend past a trigram — equal horizons would tie on every tick and
#: starve the store
DEFAULT_SHARED_MAX_NGRAM = 12
DEFAULT_COOLDOWN = 4

#: cumulative speculation modes, weakest to strongest (each includes
#: every source to its left); ``off`` is a pure bypass
SPEC_MODES = ("off", "ngram", "shared", "draft")

#: draft-source labels (the ``dllama_spec_source_total{source=}`` values)
SOURCE_NGRAM = "ngram"
SOURCE_SHARED = "shared"
SOURCE_DRAFT = "draft"


def spec_buckets(k_max: int) -> Tuple[int, ...]:
    """Draft-length buckets: powers of two up to ``k_max`` plus
    ``k_max`` itself.

    The engine captures one verify graph per bucket (token width
    ``1 + bucket``) during ``rehearse_admission``, so no new shape is
    captured mid-serve; the scheduler pads a draft up to the next
    bucket.
    """
    if k_max < 1:
        return ()
    out: List[int] = []
    b = 1
    while b <= k_max:
        out.append(b)
        b *= 2
    if out[-1] != k_max:
        out.append(k_max)
    return tuple(out)


def bucket_for(k: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits a draft of ``k`` tokens."""
    for b in buckets:
        if k <= b:
            return b
    return buckets[-1]


def resolve_spec_knobs(
    speculation: Optional[str] = None, spec_k: Optional[int] = None
) -> Tuple[str, int]:
    """Resolve the speculation knobs: explicit argument beats the
    environment (``DLLAMA_SPECULATION``, ``DLLAMA_SPEC_K``) beats the
    default (``"off"``, ``DEFAULT_SPEC_K``)."""
    if speculation is None:
        speculation = os.environ.get("DLLAMA_SPECULATION", "").strip() or "off"
    if spec_k is None:
        raw = os.environ.get("DLLAMA_SPEC_K", "").strip()
        spec_k = int(raw) if raw else DEFAULT_SPEC_K
    mode = str(speculation)
    if mode not in SPEC_MODES:
        raise ValueError(
            f"speculation must be one of {'/'.join(SPEC_MODES)}, got {mode!r}"
        )
    return mode, max(1, int(spec_k))


def resolve_draft_model(draft_model: Optional[str] = None) -> Optional[str]:
    """Resolve the resident-draft-model checkpoint path: explicit
    argument beats the environment (``DLLAMA_DRAFT_MODEL``) beats None.
    Mode ``draft`` requires a path; the server errors out at startup
    otherwise."""
    if draft_model is None:
        draft_model = (
            os.environ.get("DLLAMA_DRAFT_MODEL", "").strip() or None
        )
    return draft_model


class NgramIndex:
    """Last-two-occurrence n-gram index over one lane's token stream.

    For every n in [1, max_n] maps the n-gram ending at each position to
    the *continuation start* of its latest and previous occurrences.
    Two deep matters: the current suffix always matches its own entry
    (whose continuation is empty), so lookups fall back to the previous
    occurrence to find real continuation tokens.
    """

    def __init__(self, max_n: int = DEFAULT_MAX_NGRAM) -> None:
        self.max_n = max(1, int(max_n))
        self.tokens: List[int] = []
        # per n: ngram -> (latest continuation start, previous or -1)
        self._occ: List[Dict[Tuple[int, ...], Tuple[int, int]]] = [
            {} for _ in range(self.max_n)
        ]

    def extend(self, tokens: Sequence[int]) -> None:
        for raw in tokens:
            self.tokens.append(int(raw))
            i = len(self.tokens)
            for n in range(1, self.max_n + 1):
                if i < n:
                    break
                key = tuple(self.tokens[i - n : i])
                d = self._occ[n - 1]
                prev = d.get(key)
                d[key] = (i, prev[0] if prev is not None else -1)

    def lookup(self, k: int) -> List[int]:
        """``k`` tokens predicted to follow the current suffix, read
        from the most recent *earlier* occurrence of the longest
        matching suffix n-gram ([] if the suffix has never been seen
        before).

        When the match sits close to the end of history — a stream in a
        short cycle, where the previous occurrence is one period back —
        the continuation is extended *cyclically*: once the copy runs
        past the end of recorded history it keeps reading from the
        draft itself, predicting that the period-``end - p`` repetition
        continues.  Without this a period-1 stall would only ever yield
        one draft token no matter how large ``k`` is.
        """
        return self.lookup_suffix(self.tokens, k)

    def lookup_suffix(self, suffix: Sequence[int], k: int) -> List[int]:
        """:meth:`lookup` generalized to an EXTERNAL query suffix: ``k``
        tokens this index's stream continued the longest matching
        suffix n-gram of ``suffix`` with.  This is the cross-lane read
        path — a sibling lane asks every store index "how did *your*
        stream continue my current suffix?".  An occurrence that ends
        exactly at this stream's end has an empty continuation and
        falls back to the previous occurrence, same as the own-suffix
        case; cyclic extension applies unchanged."""
        return self.lookup_suffix_n(suffix, k)[0]

    def lookup_suffix_n(
        self, suffix: Sequence[int], k: int
    ) -> Tuple[List[int], int]:
        """:meth:`lookup_suffix` plus the length ``n`` of the suffix
        n-gram that matched (0 on miss) — the cross-source quality
        signal the drafter ranks private vs shared candidates by."""
        toks = self.tokens
        end = len(toks)
        ns = len(suffix)
        if end == 0 or ns == 0 or k < 1:
            return [], 0
        for n in range(min(self.max_n, ns, end), 0, -1):
            key = tuple(int(t) for t in suffix[ns - n:])
            hit = self._occ[n - 1].get(key)
            if hit is None:
                continue
            # hit[0] may be the (empty-continuation) entry ending at
            # this stream's end; the previous occurrence is usable.
            p = hit[1] if hit[0] >= end else hit[0]
            if p < 0 or p >= end:
                continue
            out: List[int] = []
            for j in range(k):
                src = p + j
                out.append(toks[src] if src < end else out[src - end])
            return out, n
        return [], 0


class SharedNgramStore:
    """Cross-lane n-gram store keyed by radix-tree anchor identity.

    One *group* per radix ``node_id`` (the anchor a lane's admission
    match reported — see ``kv/radix.py``); inside a group, one
    :class:`NgramIndex` per publishing stream holding that stream's
    accepted continuation past the anchor.  A lane drafting under
    anchor ``N`` asks every *sibling* stream's index (its own
    continuation already lives in its private index) for the
    continuation of its current suffix, most recently published stream
    first.

    Bounded on every axis (groups, streams per group, tokens per
    stream), all LRU: anchor ids retired by radix eviction simply age
    out.  ``lock`` (lockwatch-tracked, leaf — nothing else is acquired
    under it) serializes scheduler publishes/lookups against `/metrics`
    and debug readers; the publish-while-draft interleavings are
    replayed deterministically in ``tests/test_spec.py``.
    """

    def __init__(
        self,
        max_n: int = DEFAULT_SHARED_MAX_NGRAM,
        max_groups: int = 64,
        max_streams_per_group: int = 8,
        max_tokens_per_stream: int = 4096,
    ) -> None:
        self.max_n = max(1, int(max_n))
        self.max_groups = max(1, int(max_groups))
        self.max_streams_per_group = max(1, int(max_streams_per_group))
        self.max_tokens_per_stream = max(1, int(max_tokens_per_stream))
        self.lock = make_lock("spec.shared_store")
        self._groups: "OrderedDict[int, OrderedDict[str, NgramIndex]]" = (
            OrderedDict()
        )
        self.n_hits = 0
        self.n_misses = 0

    def publish(
        self, anchor: int, stream_id: str, tokens: Sequence[int]
    ) -> None:
        """Append ``tokens`` (an accepted run of ``stream_id``'s
        continuation past ``anchor``) to the stream's group index.
        Tokens past the per-stream cap are dropped (bounded memory; the
        hot fanout prefix repeats early, not at token 4096)."""
        if not tokens:
            return
        with self.lock:
            group = self._groups.get(anchor)
            if group is None:
                group = OrderedDict()
                self._groups[anchor] = group
                while len(self._groups) > self.max_groups:
                    self._groups.popitem(last=False)
            else:
                self._groups.move_to_end(anchor)
            idx = group.get(stream_id)
            if idx is None:
                idx = NgramIndex(self.max_n)
                group[stream_id] = idx
                while len(group) > self.max_streams_per_group:
                    group.popitem(last=False)
            else:
                group.move_to_end(stream_id)
            room = self.max_tokens_per_stream - len(idx.tokens)
            if room > 0:
                idx.extend(list(tokens)[:room])

    def lookup(
        self,
        anchor: int,
        suffix: Sequence[int],
        k: int,
        exclude_stream: Optional[str] = None,
    ) -> List[int]:
        """``k`` tokens some SIBLING stream under ``anchor`` continued
        ``suffix`` with ([] when no sibling has seen it).  Streams are
        consulted most-recently-published first — deterministic for a
        seeded replay, and the freshest sibling is the likeliest to
        share the query lane's trajectory."""
        return self.lookup_n(anchor, suffix, k, exclude_stream)[0]

    def lookup_n(
        self,
        anchor: int,
        suffix: Sequence[int],
        k: int,
        exclude_stream: Optional[str] = None,
    ) -> Tuple[List[int], int]:
        """:meth:`lookup` plus the length of the matched suffix n-gram
        (0 on miss): the BEST match across siblings — longest n wins,
        recency breaks ties — so the drafter can rank the shared
        candidate against its private one on equal terms."""
        best: List[int] = []
        best_n = 0
        with self.lock:
            group = self._groups.get(anchor)
            if group:
                self._groups.move_to_end(anchor)
                for sid in reversed(group):
                    if sid == exclude_stream:
                        continue
                    out, n = group[sid].lookup_suffix_n(suffix, k)
                    if out and n > best_n:
                        best, best_n = out, n
            if best:
                self.n_hits += 1
            else:
                self.n_misses += 1
            return best, best_n

    def stats(self) -> Dict[str, int]:
        """Size/hit counters for the shared-store gauges."""
        with self.lock:
            return {
                "groups": len(self._groups),
                "streams": sum(len(g) for g in self._groups.values()),
                "tokens": sum(
                    len(i.tokens)
                    for g in self._groups.values()
                    for i in g.values()
                ),
                "hits": self.n_hits,
                "misses": self.n_misses,
            }


class NgramDrafter:
    """Per-lane drafter: n-gram prompt lookup plus AIMD draft-length
    adaptation.

    ``update`` feeds the lane's history (only the unseen tail is
    indexed), ``draft`` proposes up to the current adaptive ``k``
    tokens, and ``feedback`` adapts after each verify: full acceptance
    grows ``k`` additively, under-half acceptance halves it, and zero
    acceptance additionally pauses drafting for a few ticks — the
    context is clearly not in a repetitive stretch, so the lane rejoins
    the plain decode block instead of wasting verify dispatches.

    Second-generation sources compose here.  With a
    :class:`SharedNgramStore` attached (mode ``shared``/``draft``),
    ``update`` additionally PUBLISHES the history tail past the lane's
    radix anchor into the store, and ``draft`` ranks the store's best
    sibling continuation against the private candidate by matched
    n-gram length — longest match wins, ties go private; with
    ``use_draft_model`` (mode ``draft``), ``model_budget`` tells the
    scheduler how many draft-model tokens to propose when both n-gram
    sources ran dry this tick, or when the lane is cooling down after
    a fully rejected n-gram draft (the model carries none of the
    discredited n-gram evidence, so the cooldown re-routes the budget
    to it instead of idling).  ``last_source`` records which source
    produced the tick's draft (the ``dllama_spec_source_total`` label);
    the single AIMD ``k`` and cooldown are shared across all sources.
    """

    def __init__(
        self,
        k_max: int = DEFAULT_SPEC_K,
        max_n: int = DEFAULT_MAX_NGRAM,
        cooldown: int = DEFAULT_COOLDOWN,
        shared_store: Optional[SharedNgramStore] = None,
        stream_id: str = "",
        anchor: Optional[int] = None,
        anchor_offset: int = 0,
        use_draft_model: bool = False,
    ) -> None:
        self.k_max = max(1, int(k_max))
        self.k = self.k_max
        self.index = NgramIndex(max_n)
        self._cooldown_len = max(0, int(cooldown))
        self._cooldown = 0
        self.n_drafted = 0
        self.n_accepted = 0
        self.shared_store = shared_store
        self.stream_id = stream_id
        self.anchor = anchor
        # absolute history position where the anchor's continuation
        # begins; tokens before it are the (shared) matched prefix and
        # are never published
        self.anchor_offset = max(0, int(anchor_offset))
        self.use_draft_model = bool(use_draft_model)
        # absolute history length already published to the store
        self._published = self.anchor_offset
        #: source of the last non-empty draft (SOURCE_* label); the
        #: scheduler sets SOURCE_DRAFT itself after model drafting
        self.last_source: Optional[str] = None
        self._skip = False  # this tick is a cooldown tick
        # cooldown tick whose budget is re-routed to the draft model
        self._model_tick = False

    def rebind(self, anchor: Optional[int], anchor_offset: int) -> None:
        """Re-anchor after a park/resume or recovery re-admission whose
        radix match landed on a different node (prefix re-matched after
        eviction, or the first match on a recovery path).  The private
        index, AIMD ``k`` and cooldown all survive — that is the whole
        point of warm-starting; only the publish cursor resets so the
        continuation-past-NEW-anchor is published under the new id."""
        if anchor == self.anchor:
            return
        self.anchor = anchor
        self.anchor_offset = max(0, int(anchor_offset))
        self._published = self.anchor_offset

    def update(self, history: Sequence[int]) -> None:
        seen = len(self.index.tokens)
        if len(history) > seen:
            self.index.extend(history[seen:])
        if self.shared_store is not None and self.anchor is not None:
            if self._published < self.anchor_offset:
                self._published = self.anchor_offset
            if len(history) > self._published:
                start = self._published
                if start == self.anchor_offset and start > 0:
                    # seed the junction on the first publish: without
                    # the tail of the anchor prefix in the index, a
                    # sibling whose suffix still ends in prefix tokens
                    # (its very first post-anchor tick) can never match
                    # the run's opening tokens. The prefix up to the
                    # anchor is shared by every group member (that is
                    # what the radix match certifies), so these tokens
                    # are common knowledge, not a leak.
                    start = max(
                        0, start - (self.shared_store.max_n - 1)
                    )
                self.shared_store.publish(
                    self.anchor, self.stream_id, history[start:]
                )
                self._published = len(history)

    def draft(self, budget: Optional[int] = None) -> List[int]:
        self.last_source = None
        self._skip = False
        self._model_tick = False
        if self._cooldown > 0:
            self._cooldown -= 1
            self._skip = True
            # the n-gram evidence was just contradicted by a verify
            # (zero-acceptance draft); in mode ``draft`` the cooldown
            # re-routes this tick's budget to the resident model —
            # which carries none of that evidence — instead of idling
            self._model_tick = self.use_draft_model
            return []
        k = self.k if budget is None else min(self.k, budget)
        if k < 1:
            self._skip = True
            return []
        # longest-match-wins across the two n-gram sources: a private
        # 1-gram echo must not starve a sibling's max_n-long replay of
        # this exact trajectory (byte-level streams almost always have
        # SOME short self-repeat, so "private first, shared on miss"
        # would never consult the store). Ties go private — the lane's
        # own continuation is the safer bet at equal evidence.
        toks = self.index.tokens
        out, n_private = self.index.lookup_suffix_n(toks, k)
        if out:
            self.last_source = SOURCE_NGRAM
        if (
            self.shared_store is not None
            and self.anchor is not None
            and n_private < self.shared_store.max_n  # a match at the
            # store's full horizon cannot be beaten, so skip the lock
        ):
            suffix = toks[-self.shared_store.max_n:] if toks else []
            shared, n_shared = self.shared_store.lookup_n(
                self.anchor, suffix, k, exclude_stream=self.stream_id
            )
            if shared and n_shared > n_private:
                self.last_source = SOURCE_SHARED
                return shared
        return out

    def model_budget(self, budget: Optional[int] = None) -> int:
        """Draft-model token budget for this tick: the adaptive ``k``
        when the draft model is enabled and this tick's n-gram sources
        came up empty — or the lane is cooling down after an n-gram
        draft was fully rejected (the cooldown re-routes to the model
        rather than idling the lane) — else 0."""
        if not self.use_draft_model or self.last_source:
            return 0
        if self._skip and not self._model_tick:
            return 0
        k = self.k if budget is None else min(self.k, budget)
        return max(0, k)

    def feedback(self, proposed: int, accepted: int) -> None:
        self.n_drafted += proposed
        self.n_accepted += accepted
        if proposed <= 0:
            return
        if accepted >= proposed:
            self.k = min(self.k_max, self.k + 1)
        elif accepted * 2 < proposed:
            self.k = max(1, self.k // 2)
            # a fully rejected n-gram draft discredits the index for a
            # few ticks; a failed MODEL draft must not re-arm the
            # cooldown, or mode ``draft`` would pin a misfiring model
            # to the lane forever (cooldown -> model -> cooldown ...)
            if accepted == 0 and self.last_source != SOURCE_DRAFT:
                self._cooldown = self._cooldown_len
