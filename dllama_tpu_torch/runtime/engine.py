"""Inference engine: bucketed prefill, decode blocks, perplexity, lanes.

Counterpart of dllama_tpu/runtime/engine.py (reference: src/app.cpp:170-230,
dllama.cpp:13-116). Prefill walks the prompt in bucketed chunks
(`_bucket_for`, `prefill`); decoding runs blocks of steps whose
next token stays on the device, with one host readback a block
(`decode_block`: the argmax, or with temperature > 0 the on-device top-p
sampler `sample_per_lane` keyed by (seed, position)); `decode_step` (block
size 1) samples on the host with the reference-parity `Sampler`;
`perplexity` scores a prompt teacher-forced, one scalar a chunk.

``kv_dtype="int8"`` holds K/V as int8 with one f32 scale a row (`QuantKV`)
in the slab cache and in the lanes' pool: about half of bf16's bytes, read
by the attention kernels' int8 instantiations. A float ``kv_dtype`` ("f32",
"f16", "bf16") may differ from ``dtype``, as in the JAX engine: rows are
cast to the cache's type when written and the attention kernels' mixed-type
entries read q and the cache each in its own type (ops/flash_attention.py).

``prefill_buckets`` are the chunk widths of prefill (the JAX engine's, by
default (1, 8, 32, 128, 512); the CLI passes (1, ``--nbatches``, 512)); the
slab lanes' padding rows and the server's admission chunk follow the
largest. ``moe_decode_dedup`` ("auto": on for a model with experts at
``batch_size`` >= 8) runs Qwen3-MoE lane decode in two tiers chosen on the
device (ops/moe.py `moe_decode_tiers`).

A resident draft model (`init_draft_model`, ``--speculation draft``) keeps
its own dense params and slab cache [L_d, B, KH_d, S_d + pad, hd_d]:
`draft_prefill` catches one lane's draft rows up in the draft's buckets, on
that lane's rows alone (the port's slab-lane design, where the JAX engine
runs every lane with the others parked), and `draft_propose` runs one greedy
k-step block for every drafting lane, inactive lanes parked at -1 (they
write their padding row and read nothing). Both are CUDA graphs (keys
``draft_prefill`` and ``draft_step``) under `_draft_cache_guard`: a failed
draft dispatch resets the draft cache and moves ``draft_cache_epoch``,
never the target's caches or epochs.

The JAX engine runs one compiled program a shape. On the card the port
runs each of these forwards as a CUDA graph (runtime/graphs.py): every
prefill bucket, decode block width, the single step, each score chunk, each
lane-prefill bucket and lane decode block is captured on its first use and
replayed after it. ``cuda_graphs=False`` (or setting ``engine.cuda_graphs``)
runs them eagerly; the CPU always does. Either way a forward reads its
inputs from the static buffers the host fills before it runs.

Tensor and sequence parallelism (``tp``, ``sp``, with this rank's ``mesh``
from parallel/mesh.py; one engine a rank, ``tp * sp`` ranks): the params
are the rank's tp slices, read from the file as slices
(models/loader.py), the single stream's cache its [L, 1, KH/tp, S/sp, hd]
shard in the cyclic row order, and every forward `models.forward` on the
rank's mesh, with the tp all-reduces in f32, or in q80 with ``buffer_float_type="q80"``
(the reference's --buffer-float-type). Prefill buckets under sp are 1 or
multiples of sp. Lanes run on every rank too: the slab lanes' slab is the
rank's shard [L, B, KH/tp, (S + pad)/sp, hd] (the padding rounded up to a
multiple of sp), the page pool [L, P, KH/tp, ps, hd] on every rank (pool-
native lanes under tp alone, as in the JAX engine), an int8 cache under tp,
and the draft model sharded like the target under tp. With more than one
rank every dispatch runs eagerly (a gloo collective cannot be captured in
a CUDA graph), and every rank must run the same dispatches with the same
arguments and draws: ``inference`` and ``perplexity`` run one
deterministic program on every rank (``decode_block`` sampled with one
seed everywhere, so every rank draws the same token from the same gathered
logits); the server and ``chat`` run rank 0's loop alone and mirror each
dispatch to the other ranks (parallel/control.py), rank 0's draws through
``tape``. Qwen3-MoE runs under tp and sp: a rank holds F/tp hidden units of
every expert and the experts' f32 partials are all-reduced over tp (every
rank routes the same rows, so every rank takes the same kernels and
dedup tier); an int8 cache runs under sp, its shards in the cyclic order,
on the ring as int8 values and f32 scales.

Pipeline stages and dp lane shards (``pp``, ``dp``; the world is ``pp *
dp * sp * tp`` ranks, the JAX mesh's order, parallel/mesh.py). A rank of
stage s reads only its stage's layers from the file (and the embedding,
the final norm and the classifier), and its caches hold those layers
alone: the single stream's [L/pp, 1, KH/tp, S/sp, hd], the lanes' slab
[L/pp, B/dp, ...] and the pool [L/pp, P, KH/tp, ps, hd]. Every forward
goes through parallel/pipeline.forward_pp, prefill chunks in the JAX
engine's sequence waves (`_pp_micro`); every stage returns the same
logits. dp shards the lanes: lane l belongs to dp group l // (B/dp),
which runs its forwards (`_lane_span`), and a decode block's or a verify
pass's tokens are all-gathered over dp, so every rank returns every
lane's. The single stream and the draft model are not sharded over dp:
each dp group runs them whole. The page pool is one pool replicated over
dp, as the JAX pool is: every page a dp group writes reaches the other
groups before any lane reads it. A slab lane's ``kv_publish`` broadcasts
the pages it wrote from the lane's group; pool-native lanes (pp = 1)
replicate the rows each dispatch wrote, a lane chunk's by a broadcast from
its group and a decode block's or a verify pass's by one all-gather of
every group's rows (`_share_pool_rows`); a ``kv_page_copy`` runs on every
rank's copy alike. The JAX engine's refusals hold: pool-native lanes and
the draft model at pp > 1, a batch that dp does not divide, a pp that
does not divide the layers.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; on the card
every matmul and attention goes through the port's CUDA kernels. Weight
formats: ``q40`` (int8 values + f16 scales), ``q40i4`` (packed nibbles),
``q40i8`` (q40 requantized on the device to grouped int8, G from
`pick_group`), ``dense``, and ``auto`` (q40 for a Q40 file on the card,
dense elsewhere).

Lanes (`prefill_lane_chunk`, `decode_lanes`, `verify_lanes`,
`generate_batch`): ``batch_size`` independent streams, each at its own
position, in one of two modes (`init_kv_pool`'s ``native``):

* slab lanes (the JAX engine's default): each lane's KV lives in its rows
  of the lanes' slab [L, B, KH, S + pad, hd] (``lane_cache``, allocated at
  the first lane call, pad the largest prefill bucket). A parked lane
  writes into its padding rows past seq_len, where no live lane reads, and
  reads nothing; the slab attention entries take a position a lane. The
  optional page pool shares prefixes by copies: `kv_adopt` copies pool
  pages into a lane's rows, `kv_publish` a lane's rows into pool pages
  (the JAX ``_kv_copy_fn`` programs), in largest-first power-of-two
  buckets. A lane's prefill chunk runs on that lane's rows alone (one
  graph a bucket and a lane), where the JAX engine runs every lane at the
  chunk's width with the others parked;
* pool-native lanes: KV lives in the shared page pool [L, P, KH, ps, hd],
  read and written through per-lane page tables; idle lanes are parked at
  position -1 and write to the scratch page 0. The host keeps the page
  table and copies it to the card when it changes, not on every step.

In both modes a decode block runs every lane of the batch, so each lane's
values are the same whatever the others do. `verify_lanes` checks
speculative drafts: one forward of 1 + k rows a lane at its own position,
the greedy argmax grid back in one readback. The single-stream path keeps
its own slab cache [L, 1, KH, S, hd] (``cache``).

Crash consistency (dllama_tpu's ``_cache_guard`` and ``_kv_pool_guard``):
every dispatch runs inside a guard, its readback included (a replay's CUDA
error shows up there). A dispatch that raises leaves the bytes it wrote
unknown: the guard resets them in place (the captured graphs keep their
pointers), moves ``cache_epoch`` and re-raises. `_slab_guard` covers the
single-stream steps and the slab lanes' steps and `kv_adopt` (the slab is
zeroed for every lane; the pool and the radix tree survive);
`_kv_pool_guard` covers the pool-native steps, `kv_page_copy` and
`kv_publish` (the pool is zeroed and ``kv_pool_epoch`` moves;
``cache_epoch`` only in native mode, where the pool is the lanes' KV). The
scheduler tells a poisoned cache from an intact one by ``cache_epoch``, the
manager a poisoned pool by ``kv_pool_epoch``. The chaos plane
(runtime/faults.py) draws once a dispatch at each lane entry: a transient
fault is raised before the guard with no device work done, a poison fault
inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmHeader, ModelReader
from ..formats.quants import FloatType
from ..models import forward, init_kv_cache, load_params
from ..ops.int8_matmul import pick_group, requantize_params
from ..parallel.collectives import all_gather, broadcast
from ..parallel.mesh import shape_str, validate_pp, validate_sp, validate_tp
from ..parallel.pipeline import stage_range
from ..parallel.sharding import cyclic_rows, kv_shard_shape, lane_shard_shape, pool_shard_shape
from ..obs.cost import StepCostModel, extract_cost, hbm_peak_bytes_per_s, roofline_fraction
from ..obs.metrics import DEFAULT_TOKEN_BUCKETS_S, get_registry
from ..obs.recorder import get_recorder
from ..obs.spans import get_span_tracker
from ..ops.kv_cache import (
    kv_lane,
    kv_tensors,
    new_kv_leaf,
    pages_to_rows,
    reset_kv_leaf,
    rows_to_pages,
)
from .faults import get_fault_plane
from .graphs import StepGraphs
from .sampler import Sampler, sample_per_lane
from .spec import spec_buckets

logger = logging.getLogger(__name__)

# Prefill chunk buckets, the default of ``prefill_buckets`` (the reference's
# --nBatches role; the JAX engine compiles one program per bucket, the port
# keeps the same chunking).
DEFAULT_PREFILL_BUCKETS = (1, 8, 32, 128, 512)
I32, I64 = torch.int32, torch.int64
# kv_dtype names, as the JAX engine's
KV_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
             "int8": torch.int8}


def resolve_kv_dtype(kv_dtype, dtype) -> torch.dtype:
    """The cache's dtype from ``kv_dtype`` (None: ``dtype``; a name of
    `KV_DTYPES` or a torch dtype), with the JAX engine's names and message."""
    if isinstance(kv_dtype, str):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {sorted(KV_DTYPES)}, got {kv_dtype!r}")
        kv_dtype = KV_DTYPES[kv_dtype]
    return kv_dtype or dtype


def resolve_moe_decode_dedup(moe_decode_dedup, header: LlmHeader, batch_size: int) -> bool:
    """The JAX engine's resolution: ``"auto"`` is on iff the model has
    experts and ``batch_size`` >= 8 (at 8 lanes and more the capped grouped
    tier hits under moderate routing correlation; below, hits need strong
    correlation); any other value counts as its truth value."""
    if moe_decode_dedup == "auto":
        return bool(header.n_experts and batch_size >= 8)
    return bool(moe_decode_dedup)


# graph key head -> step kind (the dllama_engine_step_seconds label)
KEY_KINDS = {
    "prefill": "prefill",
    "step": "decode_step",
    "block": "decode_block",
    "score": "score",
    "kv_page_copy": "kv_page_copy",
    "kv_adopt": "kv_adopt",
    "kv_publish": "kv_publish",
    "lane_prefill": "prefill_lane_chunk",
    "lane_block": "decode_lanes",
    "lane_verify": "verify_lanes",
    "lane_prefill_paged": "prefill_lane_chunk",
    "lane_block_paged": "decode_lanes",
    "lane_verify_paged": "verify_lanes",
    "draft_prefill": "draft_prefill",
    "draft_step": "draft_step",
}


def _pairs(rows: int, pos: int) -> int:
    """(query row, cache row) pairs of ``rows`` causal rows from ``pos``."""
    return rows * pos + rows * (rows + 1) // 2


class _Dispatch:
    """One engine dispatch's observability (the JAX engine brackets each
    compiled-program call the same way): a ``step_dispatch`` recorder
    event, an ``engine`` span with a ``<kind>.device`` sub-span around the
    readback that already ends the dispatch (`device`), then
    ``dllama_engine_step_seconds{kind}`` (host seconds, call and readback),
    ``dllama_engine_block_token_seconds`` on block paths (neither for a
    dispatch that captured its graph) and a ``step_complete`` event. On the card two CUDA events bracket the
    dispatch on the stream, the first recorded right before the graph's
    launch (`StepGraphs.before_run`: host work before it, such as a stall
    of this thread, does not count as device time), the second before the
    readback; their device seconds and the step's analytic
    (flops, bytes) feed the engine's per-key cost accumulator once the end
    event has completed (`InferenceEngine.settle_costs`, on the engine's
    own thread: nothing here synchronises), unless the dispatch captured
    its graph. A dispatch that raises ends its span with the error and
    records nothing else."""

    __slots__ = ("engine", "kind", "key", "fields", "cost", "n_tokens", "span", "t0", "ev",
                 "capture_s", "graphed")

    def __init__(self, engine, kind: str, key, cost, n_tokens: int = 0, graphed: bool = True,
                 **fields):
        self.engine, self.kind, self.key, self.cost = engine, kind, key, cost
        self.n_tokens, self.fields, self.graphed = n_tokens, fields, graphed
        self.ev = None

    def __enter__(self):
        e = self.engine
        if e.tape is not None:  # the device work starts: rank 0 sends its command
            e.tape.launch()
        e.settle_costs()
        e.recorder.record("step_dispatch", step=self.kind, **self.fields)
        self.span = e._spans.begin(self.kind, component="engine", **self.fields)
        self.capture_s = e.graphs.capture_s
        if e.device.type == "cuda" and e.obs.enabled:
            self.ev = [None, None]
            if self.graphed:
                e.graphs.before_run = self._mark_start
            else:
                self._mark_start()
        self.t0 = time.perf_counter()
        return self

    def _mark_start(self) -> None:
        self.ev[0] = torch.cuda.Event(enable_timing=True)
        self.ev[0].record()

    def _mark_end(self) -> None:
        if self.ev is not None and self.ev[0] is not None and self.ev[1] is None:
            self.ev[1] = torch.cuda.Event(enable_timing=True)
            self.ev[1].record()

    def device(self, read):
        """``read()``, the dispatch's readback, inside the ``.device`` span."""
        self._mark_end()
        e = self.engine
        sp = e._spans.begin(self.kind + ".device", component="engine")
        try:
            return read()
        finally:
            e._spans.end(sp)

    def __exit__(self, exc_type, exc, tb):
        e = self.engine
        if e.graphs.before_run == self._mark_start:  # no run happened
            e.graphs.before_run = None
        if exc is not None:
            e._spans.end(self.span, error=str(exc))
            return False
        self._mark_end()
        dt = time.perf_counter() - self.t0
        e._spans.end(self.span)
        # a key's first use (eager, the kernels' first loads, then the
        # capture) is no representative step: neither its seconds (the
        # load predictor's and the watchdog's input) nor its cost count
        captured = e.graphs.capture_s != self.capture_s
        step = e._m_step.labels(kind=self.kind)
        if not captured:
            step.observe(dt)
            if self.n_tokens:
                e._m_tpot.observe(dt / self.n_tokens)
        e.recorder.record("step_complete", step=self.kind, ms=round(dt * 1000, 3), **self.fields)
        if self.ev is not None and self.ev[1] is None:
            return False  # no launch happened to time
        if e.obs.enabled and not captured:
            e._note_cost(self.key, self.ev, dt, self.cost)
        return False


@dataclasses.dataclass
class StepStats:
    """Per-forward timing surface (reference: dllama.cpp:59-66,88-95)."""

    time_ms: float
    n_tokens: int


def chunk_nll(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL of a chunk's unmasked rows: f32 logits [1, T,
    V], targets [1, T] int64, mask [1, T] f32 -> an f32 scalar (the JAX
    ``_score_fn``: logsumexp less the target's logit, masked, summed)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return ((lse - tgt) * mask)[0].sum()


class InferenceEngine:
    """See module docstring: one slab-cache stream, plus ``batch_size``
    lanes, slab or pool-native."""

    def __init__(
        self,
        model_path: str,
        dtype=torch.bfloat16,
        max_seq_len: int = 0,
        temperature: float = 0.0,
        topp: float = 0.9,
        seed: int = 12345,
        weight_format: str = "auto",
        device=None,
        batch_size: int = 1,
        cuda_graphs: bool = True,
        kv_dtype=None,
        prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
        moe_decode_dedup: bool | str = "auto",
        tp: int = 1,
        sp: int = 1,
        buffer_float_type: str = "f32",
        mesh=None,
        pp: int = 1,
        dp: int = 1,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if buffer_float_type not in ("f32", "q80"):
            raise ValueError(f"buffer_float_type must be 'f32' or 'q80', got "
                             f"{buffer_float_type!r}")
        self.tp, self.sp, self.pp, self.dp, self.mesh = tp, sp, pp, dp, mesh
        self.world = tp * sp * pp * dp
        self.sync_quant = buffer_float_type == "q80"
        if self.world > 1:
            if mesh is None or (mesh.tp.size, mesh.sp.size, mesh.pp.size,
                                mesh.dp.size) != (tp, sp, pp, dp):
                raise ValueError(f"{shape_str(tp, sp, pp, dp)} needs this rank's Mesh of the "
                                 "same shape (parallel.mesh.init_distributed or "
                                 "parallel.launch.spawn)")
        self.kv_dtype = resolve_kv_dtype(kv_dtype, dtype)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        # graph key -> [dispatches, device seconds, flops, bytes], settled
        # ones only; the dispatches whose end event has not completed wait
        # in _cost_pending
        self._key_cost: dict = {}
        self._cost_pending: list = []
        self._cost_lock = threading.Lock()
        # the captured-graph lint (analysis/graphlint.py): every capture is
        # linted as it lands; "0"/"off" disables, "strict" raises
        # XlalintError on a new finding, anything else warns
        self._xlalint_mode = os.environ.get("DLLAMA_XLALINT", "warn").strip().lower()
        self._xlalint_baseline: set | None = None
        self._init_obs()
        # a gloo collective cannot be captured: world > 1 runs eagerly
        self.graphs = StepGraphs(self.device, cuda_graphs and self.world == 1)
        self.reader = ModelReader(model_path, max_seq_len=max_seq_len)
        self.header: LlmHeader = self.reader.header
        validate_tp(self.header, tp)
        validate_sp(self.header, sp)
        validate_pp(self.header, pp)
        if dp < 1 or (dp > 1 and batch_size % dp != 0):
            raise ValueError(f"batch_size {batch_size} must divide over dp={dp} lanes")
        self.dtype = dtype
        self.temperature = temperature
        self.sampler = Sampler(self.header.vocab_size, temperature, topp, seed)
        # under sp a chunk wider than 1 splits its queries over the sp ranks;
        # under pp x sp a chunk fits one shard's rows (the JAX engine's rule)
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets)
            if b <= self.header.seq_len and (sp == 1 or b == 1 or b % sp == 0)
            and (pp == 1 or sp == 1 or b <= self.header.seq_len // sp)
        ) or ((1,) if sp == 1 else (sp,))
        self.moe_decode_dedup = resolve_moe_decode_dedup(moe_decode_dedup, self.header,
                                                         batch_size)
        # "auto": Q40 on the card (the kernel path), dense elsewhere, as the
        # JAX engine keeps Q40 only where its kernel runs
        if weight_format == "auto":
            weight_format = (
                "q40"
                if self.header.weight_type == FloatType.Q40 and self.device.type == "cuda"
                else "dense"
            )
        if weight_format not in ("dense", "q40", "q40i4", "q40i8"):
            raise ValueError(
                "weight_format must be 'auto', 'dense', 'q40', 'q40i4' or 'q40i8', "
                f"got {weight_format!r}"
            )
        self.weight_format = weight_format
        if weight_format != "dense" and tp > 1:
            # a column slice of a quantized weight cuts its scales' block axis
            # (in/32): every contraction dim must divide by 32 * tp
            for dim_name, dim in (("dim", self.header.dim), ("qDim", self.header.q_dim),
                                  ("hiddenDim", self.header.ff_dim)):
                if dim % (32 * tp) != 0:
                    raise ValueError(f"q40 weight format with tp={tp} needs {dim_name} "
                                     f"divisible by {32 * tp}, got {dim}")
        # q40i8 loads the file's Q40 blocks, then requantizes on the device
        self.params = load_params(
            self.reader, dtype=dtype, device=self.device,
            weight_format="q40" if weight_format == "q40i8" else weight_format,
            shard=(tp, mesh.tp.index) if tp > 1 else None,
            layers=stage_range(self.header, pp, mesh.pp.index) if pp > 1 else None,
        )
        self.i8_group = 0
        if weight_format == "q40i8":
            self.i8_group = pick_group(self.header, tp)
            self.params = requantize_params(self.params, self.header, self.i8_group)
        if self.world > 1:
            shape = kv_shard_shape(self.header, tp, sp, pp=pp)
            self.cache = {n: new_kv_leaf(shape, self.kv_dtype, self.device) for n in ("k", "v")}
        else:
            self.cache = init_kv_cache(self.header, 1, dtype=self.kv_dtype, device=self.device)
        self._cost = StepCostModel(self.header, self.params,
                                   torch.empty(0, dtype=self.kv_dtype).element_size(),
                                   self.kv_dtype == torch.int8, tp=tp, sp=sp, pp=pp)
        # slab lanes: their slab (allocated at the first lane call), its
        # padding rows (the widest chunk a parked lane writes; under sp
        # rounded up so that the padded rows tile the sp shards) and the
        # first of them, where parked lanes write
        self.lane_cache = None
        self._lane_pad = max(self.prefill_buckets) if batch_size > 1 else 0
        if self._lane_pad and sp > 1:
            self._lane_pad += (-self._lane_pad) % sp
        self._park = self.header.seq_len
        # dp: the lanes this rank's group owns, [lane0, lane0 + B/dp)
        self._lane0 = mesh.dp.index * (batch_size // dp) if dp > 1 else 0
        # the lanes' page pool (init_kv_pool); native: the pool is the
        # lanes' KV home, else the slab lanes' prefix store
        self.kv_pool = None
        self.kv_native = False
        self.kv_pool_epoch = 0
        # moves whenever a failed dispatch reset KV that streams held (a
        # slab, or the pool in native mode): the scheduler's and the
        # serialized server's poisoned-or-intact signal
        self.cache_epoch = 0
        self._kv_page_size = 0
        self._kv_pool_pages = 0
        self._kv_n_blocks = 0
        self._page_table = None  # host [B, n_blocks] int32, the truth
        self._pt_dev = None  # its copy on the device
        self._pt_dirty = False
        # plain counters: pool pages copied on the device (the COW forks),
        # pages copied from the pool into slab lanes and from them into the
        # pool, decode steps run by decode_lanes (each one forward of B
        # rows) and verify passes run by verify_lanes (each one forward of
        # B x t rows)
        self.kv_copy_pages = 0
        # native lanes under dp: the dp group that last wrote each pool page
        # (-1: none; `_share_pool_rows`), the lanes whose page-table row
        # changed since their last chunk, and the pages a lane's first chunk
        # after an adoption read that another dp group wrote
        self._page_writer = None
        self._adopted: set = set()
        self.kv_cross_dp_pages = 0
        self.kv_adopt_pages = 0
        self.kv_publish_pages = 0
        self.lane_decode_steps = 0
        self.lane_verify_steps = 0
        self._lane_seed_base = seed
        self._rng_calls = 0
        # the resident draft model (init_draft_model): its header, params,
        # slab cache and cost model; the epoch moves whenever a failed draft
        # dispatch reset its cache (the scheduler's cursors then restart)
        self._draft_header: LlmHeader | None = None
        self._draft_params = None
        self.draft_cache = None
        self._draft_cost = None
        self.draft_cache_epoch = 0
        self._m_spec_draft_ms = None
        # under world > 1, rank 0's draws (fault outcomes, seeds, samples)
        # go through a tape that its control plane sends to the other ranks,
        # which replay them (parallel/control.py); None: draw here
        self.tape = None

    # -- observability -----------------------------------------------------

    def _init_obs(self) -> None:
        """The JAX engine's observability handles (obs/): the step and
        per-token histograms, the capture (compile), cache-epoch and COW
        copy counters, the flight recorder and the span tracker, created
        before the first dispatch; every handle is a no-op while the
        registry is disabled. The per-key cost accumulator (made in
        ``__init__``) feeds `cost_report`, the registry's ``engine.cost``
        refresh hook."""
        self.obs = get_registry()
        self.recorder = get_recorder()
        self._spans = get_span_tracker()
        self._m_step = self.obs.histogram(
            "dllama_engine_step_seconds",
            "Wall time of one engine dispatch (graph replay or eager run + "
            "host readback), by step kind.",
            labelnames=("kind",),
        )
        self._m_compiles = self.obs.counter(
            "dllama_engine_compiles_total",
            "Step-program builds by origin: dispatch = a CUDA graph captured "
            "on its key's first use (the port's counterpart of a synchronous "
            "compile; the port has no background prefetch).",
            labelnames=("origin",),
        )
        self._m_epochs = self.obs.counter(
            "dllama_engine_cache_epochs_total",
            "KV rebuilds: a slab (single stream or lanes), or the native "
            "lanes' pool, reset by a failed dispatch (crash-consistency "
            "recovery).",
        )
        self._m_tpot = self.obs.histogram(
            "dllama_engine_block_token_seconds",
            "Per-token share of a block decode dispatch (dispatch wall "
            "time / tokens in the block).",
            buckets=DEFAULT_TOKEN_BUCKETS_S,
        )
        self._m_xlalint = self.obs.counter(
            "dllama_xlalint_findings_total",
            "New (non-baselined) graphlint findings on freshly captured CUDA "
            "graphs; any increment means a captured graph broke a host/"
            "donation/collective/dtype/launch-budget invariant.",
        )
        self._m_kv_copy_bytes = self.obs.counter(
            "dllama_kv_copy_bytes_total",
            "Device bytes moved by KV page copies: the pool's COW mid-page "
            "forks, and the slab lanes' adopt and publish copies (a native "
            "full-page prefix adoption moves zero bytes).",
        )
        # the card's HBM peak, read once here (the refresh hooks run on
        # other threads and read Python numbers only)
        self._hbm_peak = hbm_peak_bytes_per_s(self.device)
        self.obs.add_refresh_hook("engine.cost", self.cost_report)

    def _on_capture(self, key, seconds: float) -> None:
        self._m_compiles.labels(origin="dispatch").inc()
        self.recorder.record("compile", key=str(key), origin="dispatch", s=round(seconds, 4))
        self._xlalint_after_capture(key)

    @property
    def _xlalint_on(self) -> bool:
        return self._xlalint_mode not in ("0", "off", "false")

    def _xlalint_baseline_set(self) -> set:
        if self._xlalint_baseline is None:
            from ..analysis.core import load_baseline
            from ..analysis.graphlint import default_baseline_path

            self._xlalint_baseline = load_baseline(default_baseline_path())
        return self._xlalint_baseline

    def _xlalint_after_capture(self, key) -> None:
        """Lint ONE just-captured graph (`StepGraphs` read its nodes; the
        JAX engine's ``_xlalint_after_compile``). Warn by default;
        ``DLLAMA_XLALINT=strict`` raises XlalintError, ``0``/``off``
        disables. Outside strict mode a lint that fails, or a read of the
        graph that failed (`StepGraphs.read_errors`), does not stop the
        capture: it is logged and left as a recorder event."""
        read_error = self.graphs.read_errors.pop(key, None)
        if not self._xlalint_on or (key not in self.graphs.nodes and read_error is None):
            return
        from ..analysis.graphlint import XlalintError, lint_engine_key

        t0 = time.perf_counter()
        try:
            if read_error is not None:
                raise read_error
            new = lint_engine_key(self, key, self._xlalint_baseline_set())
        except Exception as e:
            if self._xlalint_mode == "strict":
                raise
            logger.exception("xlalint failed analyzing %r (graph NOT checked)", key)
            self.recorder.record("xlalint_error", key=str(key), error=str(e))
            return
        finally:
            lint_s = self.graphs.lint_seconds
            lint_s[key] = lint_s.get(key, 0.0) + time.perf_counter() - t0
        if not new:
            return
        rendered = "; ".join(f.render() for f in new)
        self._m_xlalint.inc(len(new))
        self.recorder.record("xlalint", key=str(key), n_findings=len(new))
        if self._xlalint_mode == "strict":
            raise XlalintError(
                f"xlalint: {len(new)} new finding(s) in captured graph {key!r}: {rendered}")
        logger.warning("xlalint: %d new finding(s) in captured graph %r: %s",
                       len(new), key, rendered)

    def xlalint_report(self) -> dict:
        """The captured-graph lint over EVERY key (what ``GET
        /v1/debug/xlalint`` serves): each graph's census, the findings
        split new-vs-baselined against xlalint-torch-baseline.json, and the
        keys skipped for having no graph (eager runs; every key on the
        CPU)."""
        from ..analysis.graphlint import lint_engine_report

        rep = lint_engine_report(self, self._xlalint_baseline_set())
        rep["mode"] = self._xlalint_mode
        return rep

    def _note_cost(self, key, ev, host_s: float, cost) -> None:
        """Queue one finished dispatch for the key's cost accumulator: on
        the card its device seconds come from its CUDA events once they
        complete; on the CPU its host seconds count at once."""
        flops, nbytes = cost
        if ev is None:
            self._add_cost(key, host_s, flops, nbytes)
        else:
            self._cost_pending.append((key, ev[0], ev[1], flops, nbytes))

    def _add_cost(self, key, seconds: float, flops: float, nbytes: float) -> None:
        with self._cost_lock:
            acc = self._key_cost.setdefault(key, [0, 0.0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += seconds
            acc[2] += flops
            acc[3] += nbytes

    def settle_costs(self) -> None:
        """Fold every pending dispatch whose end event has completed into
        its key's accumulator. ``Event.query`` does not block, so this adds
        no synchronisation; called on the engine's own thread at each
        dispatch (and by callers that want the last one counted)."""
        if not self._cost_pending:
            return
        left = []
        for key, e0, e1, flops, nbytes in self._cost_pending:
            if e1.query():
                self._add_cost(key, e0.elapsed_time(e1) / 1e3, flops, nbytes)
            else:
                left.append((key, e0, e1, flops, nbytes))
        self._cost_pending = left

    def device_step_seconds(self, kind: str) -> tuple[int, float] | None:
        """The settled dispatches of step kind ``kind`` (every graph key of
        it, capture dispatches left out) and their mean device seconds,
        from their CUDA events; None on the CPU, where no dispatch is
        timed on a device, and before any has settled. The load
        predictor's step cost on the card: a lane prefill chunk reads
        nothing back, so its host seconds are its enqueue, while its
        device time lands in the next decode block's readback. Python
        numbers only: callable from any thread."""
        if self.device.type != "cuda":
            return None
        n, s = 0, 0.0
        with self._cost_lock:
            for key, acc in self._key_cost.items():
                if self._key_kind(key) == kind:
                    n += acc[0]
                    s += acc[1]
        return (n, s / n) if n else None

    @staticmethod
    def _key_kind(key) -> str:
        """Step kind of a graph key (`KEY_KINDS`), the
        ``dllama_engine_step_seconds{kind=}`` label value."""
        return KEY_KINDS.get(key[0], key[0])

    def graph_report(self) -> list[dict]:
        """One row per graph key (the JAX engine's
        ``compile_cache_report``, what ``/v1/debug/compile`` serves): the
        key, its step kind, its origin, the capture's seconds (None for a
        key that has not been captured: eager runs, the CPU) and its
        analytic cost a dispatch (`obs.cost.extract_cost`), or
        ``"unavailable"`` before a dispatch of it has settled. Python
        numbers only: callable from any thread."""
        with self._cost_lock:
            costs = {k: list(v) for k, v in self._key_cost.items()}
        captured = dict(self.graphs.capture_seconds)
        out = []
        for key in list(dict.fromkeys([*captured, *costs])):
            cost = extract_cost(costs.get(key))
            out.append({
                "key": list(key),
                "kind": self._key_kind(key),
                "origin": "dispatch",
                "compile_seconds": captured.get(key),
                "cost": cost if cost is not None else "unavailable",
            })
        return out

    def cost_report(self) -> dict:
        """Fold the per-key costs into per-kind gauges and the fraction
        of the HBM roofline each kind achieved:
        ``dllama_compiled_step_flops``, ``dllama_compiled_step_bytes_accessed``
        and ``dllama_step_roofline_fraction`` by kind (the registry's
        ``engine.cost`` hook).

        The representative key of a kind is the one whose dispatch moves
        the most bytes (the widest block or bucket), as in the JAX engine.
        Its fraction divides that key's mean bytes by that key's own mean
        device seconds (CUDA events on the card; host seconds on the CPU,
        where the peak is unknown and no fraction is set). This differs
        from the JAX engine on purpose: it divides the largest program's
        bytes by the mean seconds over every width of the kind, which
        overstates the share when remainder blocks of 1-7 steps run beside
        8-step ones. Python numbers only: callable from any thread."""
        g_flops = self.obs.gauge(
            "dllama_compiled_step_flops",
            "Analytic flops of one dispatch of the representative (most "
            "bytes) graph key, per step kind (from the port's layouts).",
            labelnames=("kind",),
        )
        g_bytes = self.obs.gauge(
            "dllama_compiled_step_bytes_accessed",
            "Analytic bytes one dispatch of the representative graph key "
            "moves (weights read, KV rows read and written), per step kind.",
            labelnames=("kind",),
        )
        g_roof = self.obs.gauge(
            "dllama_step_roofline_fraction",
            "Achieved HBM bandwidth (the representative key's bytes / its "
            "mean device seconds) over the card's peak, per step kind; only "
            "set when the card's peak is known.",
            labelnames=("kind",),
        )
        peak = self._hbm_peak
        with self._cost_lock:
            costs = {k: list(v) for k, v in self._key_cost.items()}
        per_kind: dict[str, dict] = {}
        for key, acc in costs.items():
            cost = extract_cost(acc)
            if cost is None:
                continue
            kind = self._key_kind(key)
            cur = per_kind.get(kind)
            if cur is None or cost["bytes_accessed"] > cur["bytes_accessed"]:
                per_kind[kind] = dict(key=list(key), **cost, dispatches=acc[0],
                                      mean_step_s=acc[1] / acc[0] if acc[1] > 0 else None)
        for kind, info in per_kind.items():
            g_flops.labels(kind=kind).set(info["flops"])
            g_bytes.labels(kind=kind).set(info["bytes_accessed"])
            frac = roofline_fraction(info["bytes_accessed"], info["mean_step_s"] or 0.0, peak)
            info["roofline_fraction"] = frac
            if frac is not None:
                g_roof.labels(kind=kind).set(frac)
        return {"hbm_peak_bytes_per_s": peak, "kinds": per_kind}

    @property
    def graphs(self) -> StepGraphs:
        """The engine's graphs (runtime/graphs.py); one set in their place
        reports its captures to the engine's compile counter and lint too."""
        return self._graphs

    @graphs.setter
    def graphs(self, graphs: StepGraphs) -> None:
        graphs.on_capture = self._on_capture
        graphs.inspect = self._xlalint_on
        self._graphs = graphs

    @property
    def cuda_graphs(self) -> bool:
        """Whether the forwards run as CUDA graphs on the card (module doc)."""
        return self.graphs.enabled

    @cuda_graphs.setter
    def cuda_graphs(self, on: bool) -> None:
        self.graphs.enabled = bool(on)

    @torch.inference_mode()
    def reset(self) -> None:
        """Drop KV state (new conversation), in place: the single stream's
        cache and the slab lanes' (one cache holds both in the JAX engine);
        the captured graphs keep pointing at the same tensors, and the pool
        keeps its pages. In inference mode: a slab allocated by a lane call
        is an inference tensor."""
        for cache in (self.cache, self.lane_cache or {}):
            for leaf in cache.values():
                reset_kv_leaf(leaf)

    @contextlib.contextmanager
    def _slab_guard(self, cache):
        """A slab dispatch that raises leaves ``cache``'s rows unknown (the
        JAX engine's ``_cache_guard``): zero it in place, for every lane it
        holds, move ``cache_epoch`` and re-raise; the pool and its pages
        survive. If the reset raises too (a CUDA error that broke the
        context), that error propagates, raised from the first, with the
        epoch moved all the same."""
        try:
            yield
        except BaseException as e:
            self.recorder.record("error", error=str(e), error_type=type(e).__name__)
            self.recorder.postmortem("engine-step", e)
            try:
                for leaf in cache.values():
                    reset_kv_leaf(leaf)
            except Exception as reset_err:
                raise reset_err from e
            finally:
                self.cache_epoch += 1
                self._m_epochs.inc()
                self.recorder.record("cache_epoch", epoch=self.cache_epoch, native=False)
            raise

    def _forward(self, tokens, pos, cache, **kw):
        """The target's forward (`models.forward`) over the engine's params,
        with its MoE decode tiering, and under world > 1 this rank's mesh
        (under pp its stage, a chunk in `_pp_micro` waves)."""
        return forward(self.params, self.header, tokens, pos, cache,
                       moe_dedup=self.moe_decode_dedup, **kw, **self._mesh_kw(tokens.shape[1]))

    def _mesh_kw(self, t: int = 1) -> dict:
        """`forward`'s mesh arguments for a T-row chunk: this rank's mesh
        under world > 1, and under pp the chunk's sequence waves."""
        if self.world == 1:
            return {}
        kw = dict(mesh=self.mesh, sync_quant=self.sync_quant)
        if self.pp > 1:
            kw["n_micro"] = self._pp_micro(t)
        return kw

    def _pp_micro(self, t: int) -> int:
        """The sequence waves of a T-row chunk under pp (the JAX engine's
        rule): about 4 waves a stage in flight while each keeps >= 8 rows;
        1 at pp = 1 and for chunks narrower than 2 pp rows."""
        if self.pp == 1 or t < 2 * self.pp:
            return 1
        for k in (4 * self.pp, 2 * self.pp, self.pp):
            if t % k == 0 and t // k >= 8:
                return k
        return 1

    def _pos(self, buf: torch.Tensor, pos: int):
        """A forward's position: the static buffer a graph replays with, or
        under world > 1 (eager, module docstring) the host int."""
        return pos if self.world > 1 else buf

    def _draw(self, fn):
        """``fn()``, a random value or a fault outcome, drawn here; or
        through the tape under world > 1 (rank 0 records what it draws, the
        other ranks replay rank 0's values and draw nothing)."""
        return fn() if self.tape is None else self.tape.draw(fn)

    @torch.inference_mode()
    def step_logits(self, token: int, pos: int) -> torch.Tensor:
        """f32 logits [V] of one decode step of ``token`` at ``pos`` (its row
        written to the cache, as `decode_step` does), run eagerly, on the
        host."""
        tok = torch.tensor([[token]], dtype=I64, device=self.device)
        logits, _ = self._forward(tok, pos, self.cache, logits_mode="last")
        return logits[0, -1].float().cpu()

    @torch.inference_mode()
    def prompt_logits(self, tokens: list[int]) -> torch.Tensor:
        """f32 logits [T, V] of every row of ``tokens`` from a fresh cache, in
        one forward at position 0 (the single stream's cache holds the prompt
        after it), on the host."""
        self.reset()
        tok = torch.tensor([tokens], dtype=I64, device=self.device)
        logits, _ = self._forward(tok, 0, self.cache, logits_mode="all")
        return logits[0].float().cpu()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _static(self, **specs) -> dict:
        """Zeroed static buffers on the device: name=(shape, dtype)."""
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in specs.items()}

    def _bucket_for(self, n: int, pos: int) -> int:
        """Smallest bucket covering n tokens whose PADDED extent still fits
        in the cache (the padded rows are written too)."""
        space = self.header.seq_len - pos
        if self.pp > 1 and self.sp > 1:
            # the JAX engine's pp x sp cap: no chunk past one shard's rows
            space = min(space, self.header.seq_len // self.sp)
        fitting = [b for b in self.prefill_buckets if b <= space]
        if not fitting:
            # under sp a chunk wider than 1 splits its queries over sp ranks:
            # round down to a multiple of sp (or a width-1 chunk)
            if self.sp > 1 and space % self.sp:
                space -= space % self.sp
                if space == 0:
                    return 1
            return max(space, 1)
        for b in fitting:
            if n <= b:
                return b
        return fitting[-1]

    def _chunks(self, n: int, pos: int):
        """(bucket, width, pos) of each chunk that walks n tokens from pos."""
        while n > 0:
            bucket = self._bucket_for(n, pos)
            width = min(bucket, n)
            yield bucket, width, pos
            n -= width
            pos += width

    def prefill(self, tokens: list[int], pos: int = 0) -> StepStats:
        """Run all but the last prompt token through the cache in bucketed
        chunks (the last token is the decode loop's first input, reference:
        dllama.cpp:38-68). Padding tokens write garbage into cache rows past
        a chunk: the causal mask hides them until real tokens overwrite
        those positions."""
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prompt")
        if pos + n - 1 > self.header.seq_len:
            raise ValueError(
                f"prompt of {n} tokens at pos {pos} exceeds seqLen {self.header.seq_len}"
            )
        fill = tokens[:-1]
        total_ms = 0.0
        for bucket, width, p in self._chunks(len(fill), pos):
            chunk = fill[p - pos : p - pos + width] + [0] * (bucket - width)
            cost = self._cost.forward(bucket, 1, p + bucket, bucket, _pairs(bucket, p))
            t0 = time.perf_counter()
            with self._slab_guard(self.cache), _Dispatch(
                    self, "prefill", ("prefill", bucket, False), cost, pos=p, bucket=bucket) as d:
                self._slab_chunk(chunk, p)
                d.device(self._sync)
            total_ms += (time.perf_counter() - t0) * 1000
        return StepStats(time_ms=total_ms, n_tokens=max(n - 1, 0))

    @torch.inference_mode()
    def _slab_chunk(self, tokens: list[int], pos: int) -> None:
        """One prefill chunk [1, T] at ``pos`` (the graph ``("prefill", T,
        False)``); its last-row logits are computed and dropped."""
        t = len(tokens)
        key = ("prefill", t, False)
        b = self.graphs.buffers(key, lambda: self._static(tok=((1, t), I64), pos=((1,), I32)))
        self.graphs.put(b["tok"], tokens)
        self.graphs.put(b["pos"], pos)
        self.graphs.run(key, lambda: self._forward(b["tok"], self._pos(b["pos"], pos), self.cache,
                                                   logits_mode="last"))

    def _block_width(self, pos: int, block: int) -> int:
        """The full block whenever it fits the cache, else the space left."""
        if pos + block <= self.header.seq_len:
            return block
        return self.header.seq_len - pos

    @torch.inference_mode()
    def decode_step(self, token: int, pos: int) -> tuple[int, StepStats]:
        """Feed ``token`` at ``pos``; return the next token (argmax when
        temperature is 0, else the host sampler; dllama.cpp:74-99). The
        forward is the graph ``("step", greedy)``: the last row's logits
        land in a static buffer, and the argmax beside them when greedy."""
        if pos >= self.header.seq_len:
            raise ValueError(
                f"decode position {pos} out of range (seqLen {self.header.seq_len})"
            )
        greedy = self.temperature == 0.0
        key = ("step", greedy)
        v = self.header.vocab_size
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((1, 1), I64), pos=((1,), I32), logits=((1, v), torch.float32),
            next=((1,), I64)))

        def step():
            logits, _ = self._forward(b["tok"], self._pos(b["pos"], pos), self.cache,
                                      logits_mode="last")
            b["logits"].copy_(logits[:, -1, :])
            if greedy:
                b["next"].copy_(torch.argmax(logits[:, -1, :], dim=-1))

        t0 = time.perf_counter()
        cost = self._cost.forward(1, 1, pos + 1, 1, pos + 1)
        with self._slab_guard(self.cache), _Dispatch(self, "decode_step", key, cost,
                                                     pos=pos) as d:
            self.graphs.put(b["tok"], token)
            self.graphs.put(b["pos"], pos)
            self.graphs.run(key, step)
            if greedy:
                nxt = int(d.device(b["next"].item))
            else:
                logits = d.device(lambda: b["logits"][0].cpu().numpy())
        if not greedy:
            with self._spans.span("sample", component="engine", pos=pos):
                nxt = self._draw(lambda: self.sampler.sample(logits))
        return nxt, StepStats(time_ms=(time.perf_counter() - t0) * 1000, n_tokens=1)

    def _draw_seed(self) -> int:
        """The next seed of the engine's stream (reset by `set_seed`)."""
        return self._draw(self._next_seed)

    def _next_seed(self) -> int:
        self._rng_calls += 1
        return (self._lane_seed_base + 1_000_003 * self._rng_calls) & 0x7FFFFFFF

    @torch.inference_mode()
    def decode_block(self, token: int, pos: int, n_steps: int, seed: int | None = None) -> list[int]:
        """Decode up to ``n_steps`` tokens in one graph ``("block", n,
        greedy)``: each step's token feeds the next on the device, and the
        block's tokens come back to the host in one readback. With
        temperature > 0 each step samples on the device (`sample_per_lane`
        at the engine's temperature and top-p), its draw a function of
        ``seed`` (default: the engine's next) and the step's position
        only, so a stream does not depend on how it splits into blocks."""
        n = self._block_width(pos, n_steps)
        if n <= 0:
            return []
        greedy = self.temperature == 0.0
        key = ("block", n, greedy)
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((1, 1), I64), pos=((1,), I32), temp=((1,), torch.float32),
            topp=((1,), torch.float32), seed=((1,), I64), out=((n,), I64)))
        self.graphs.put(b["tok"], token)
        self.graphs.put(b["pos"], pos)
        if not greedy:
            self.graphs.put(b["temp"], self.temperature)
            self.graphs.put(b["topp"], self.sampler.topp)
            self.graphs.put(b["seed"], self._draw_seed() if seed is None else seed & 0x7FFFFFFF)

        def block():
            tok = b["tok"]
            for i in range(n):
                p = b["pos"] + i
                logits, _ = self._forward(tok, self._pos(p, pos + i), self.cache,
                                          logits_mode="last")
                last = logits[:, -1, :]
                if greedy:
                    nxt = torch.argmax(last, dim=-1)
                else:
                    nxt = sample_per_lane(last, b["temp"], b["topp"], b["seed"], p)
                b["out"][i] = nxt[0]
                tok = nxt[:, None]

        reads = _pairs(n, pos)
        cost = self._cost.forward(n, n, reads, n, reads, n=n)
        with self._slab_guard(self.cache), _Dispatch(self, "decode_block", key, cost,
                                                     n_tokens=n, pos=pos, n_steps=n) as d:
            self.graphs.run(key, block)
            return d.device(b["out"].tolist)

    def generate(
        self,
        prompt_tokens: list[int],
        max_steps: int,
        on_token=None,
        stop_condition=None,
        block_size: int = 8,
        start_pos: int = 0,
    ):
        """Prefill + decode; returns (tokens, eval_stats, pred_stats).
        ``max_steps`` caps the absolute position (from ``start_pos``), as
        the reference's --steps. Decoding runs in blocks of ``block_size``
        (greedy or sampled on the device, one seed a call), or step by step
        with the host sampler at ``block_size`` 1; a stop mid-block leaves
        the block's later KV rows as garbage that the causal mask hides and
        later writes overwrite."""
        max_pos = min(self.header.seq_len, start_pos + max_steps)
        eval_stats = self.prefill(prompt_tokens, pos=start_pos)
        pos = start_pos + len(prompt_tokens) - 1
        token = prompt_tokens[-1]
        out_tokens: list[int] = []
        pred_ms = 0.0
        seed = self._draw_seed() if self.temperature != 0.0 else 0
        while pos < max_pos:
            t0 = time.perf_counter()
            if block_size > 1:
                n = self._block_width(pos, block_size)
                toks = self.decode_block(token, pos, n, seed)[: max_pos - pos]
            else:
                toks = [self.decode_step(token, pos)[0]]
            pred_ms += (time.perf_counter() - t0) * 1000
            if not toks:
                break
            stopped = False
            for tk in toks:
                pos += 1
                out_tokens.append(tk)
                if on_token is not None and on_token(tk) is False:
                    stopped = True
                    break
                if stop_condition is not None and stop_condition(tk):
                    stopped = True
                    break
            if stopped:
                break
            token = out_tokens[-1]
        return out_tokens, eval_stats, StepStats(pred_ms, len(out_tokens))

    def perplexity(self, tokens: list[int]) -> tuple[float, float, int]:
        """Teacher-forced (nll, perplexity, n_scored) over ``tokens``, from a
        fresh cache, chunk by chunk over the prefill buckets (dllama_tpu's
        ``perplexity``; reference: dllama.cpp:132-172). Each chunk is the
        graph ``("score", T)``: all its logits, their logsumexp, the
        targets' gather and the mask of padding rows and of the final token,
        summed on the device to one f32 scalar; the host sums the chunks'
        scalars."""
        t = len(tokens)
        if t < 2:
            raise ValueError("need at least 2 tokens for perplexity")
        if t > self.header.seq_len:
            raise ValueError(f"{t} tokens exceed seqLen {self.header.seq_len}")
        bad = max(tokens)
        if bad >= self.header.vocab_size:
            raise ValueError(f"token id {bad} out of range for model vocab "
                             f"{self.header.vocab_size} (tokenizer/model mismatch?)")
        self.reset()
        nll_sum = 0.0
        for bucket, width, p in self._chunks(t, 0):
            # row j (global index p+j) is scored against token p+j+1; the
            # final token and padding rows are masked out
            scored = [p + j + 1 < t and j < width for j in range(bucket)]
            chunk = tokens[p : p + width] + [0] * (bucket - width)
            targets = [tokens[p + j + 1] if ok else 0 for j, ok in enumerate(scored)]
            nll_sum += self._score_chunk(chunk, targets, [float(ok) for ok in scored], p)
        n_scored = t - 1
        nll = nll_sum / n_scored
        return nll, float(np.exp(nll)), n_scored

    @torch.inference_mode()
    def _score_chunk(self, chunk: list[int], targets: list[int], mask: list[float],
                     pos: int) -> float:
        """The summed NLL of one chunk's unmasked rows (graph ``("score", T)``)."""
        t = len(chunk)
        key = ("score", t)
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((1, t), I64), pos=((1,), I32), tgt=((1, t), I64),
            mask=((1, t), torch.float32), nll=((), torch.float32)))
        for name, values in (("tok", chunk), ("pos", pos), ("tgt", targets), ("mask", mask)):
            self.graphs.put(b[name], values)

        def score():
            logits, _ = self._forward(b["tok"], self._pos(b["pos"], pos), self.cache,
                                      logits_mode="all")
            b["nll"].copy_(chunk_nll(logits, b["tgt"], b["mask"]))

        cost = self._cost.forward(t, t, pos + t, t, _pairs(t, pos))
        with self._slab_guard(self.cache), _Dispatch(self, "score", key, cost, pos=pos,
                                                     bucket=t) as d:
            self.graphs.run(key, score)
            return float(d.device(b["nll"].item))

    # -- lanes: slab or pool-native -------------------------------------------

    def set_seed(self, seed: int) -> None:
        """Reseed the host sampler and the unseeded lanes' draws."""
        self.sampler.set_seed(seed)
        self._lane_seed_base = seed
        self._rng_calls = 0

    def _require_kv_pool(self) -> None:
        if self.kv_pool is None:
            raise ValueError("KV page pool not initialized (init_kv_pool)")

    def _check_lane(self, lane: int) -> None:
        if not 0 <= lane < self.batch_size:
            raise ValueError(f"lane {lane} out of range")

    def _require_lanes(self) -> None:
        """Pool-native lanes need their pool; slab lanes need batch_size >
        1 (their parked writes land in padding rows) and their slab, which
        this allocates on first use (never again beneath a captured graph:
        a failed dispatch zeroes it in place)."""
        if self.kv_native:
            self._require_kv_pool()
            return
        if self.batch_size < 2:
            raise ValueError("per-lane serving needs batch_size > 1 "
                             "(lanes park their writes in cache padding rows)")
        if self.lane_cache is None:
            h = self.header
            shape = lane_shard_shape(h, self.tp, self.sp, self.batch_size, self._lane_pad,
                                     self.pp, self.dp)
            self.lane_cache = {n: new_kv_leaf(shape, self.kv_dtype, self.device)
                               for n in ("k", "v")}

    def init_kv_pool(self, page_size: int, n_pages: int = 0, native: bool = False) -> int:
        """Allocate the shared KV page pool ``[L, n_pages, KH, page_size,
        hd]`` per k/v leaf (QuantKV pairs for an int8 cache, scales [L,
        n_pages, KH, page_size, 1] of ones). Page 0 is scratch. Returns the
        page count.

        ``native=False`` (the JAX default): slab lanes, the pool a prefix
        store that `kv_adopt` and `kv_publish` copy to and from; ``n_pages``
        <= 0 picks two full-length sequences' worth, ``2 * (seq_len //
        page_size) + 1`` (the JAX engine's). The lanes' slab is allocated
        here when it is not yet. The JAX engine also requires ``page_size``
        <= its lane padding, so that its bucketed dynamic slices never
        clamp; the port's copies slice rows below seq_len and raise on a
        short slice, so it has no such limit.

        ``native=True``: pool-native lanes; parked lanes and unfilled
        page-table slots point at page 0. ``n_pages`` <= 0 picks one
        sequence per lane plus two shareable ones, ``(batch_size + 2) *
        n_blocks + 1``. On the card the paged kernels take page sizes that
        divide 32 or are multiples of 32. The lanes' slab, if any, is freed
        first.

        Every captured graph is dropped: the lanes' graphs of the other
        mode, and those that read the old pool's pointers.

        Under tp each rank holds its KV heads of every page, [L, n_pages,
        KH/tp, page_size, hd]; under pp its stage's layers; under sp and dp
        the pool is whole on every rank; native lanes raise under pp and sp
        (the JAX engine's rule)."""
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if native and self.device.type == "cuda" and (
                (32 % page_size) if page_size < 32 else (page_size % 32)):
            raise ValueError(
                f"page_size {page_size}: the paged kernels take sizes that divide 32 "
                "or are multiples of 32"
            )
        if native and (self.pp > 1 or self.sp > 1):
            raise ValueError("kv_native requires pp == 1 and sp == 1")
        if not native and self.batch_size < 2:
            raise ValueError("slab lanes need batch_size > 1 "
                             "(lanes park their writes in cache padding rows)")
        s = self.header.seq_len
        n_blocks = -(-s // page_size)
        if n_pages <= 0:
            n_pages = (self.batch_size + 2) * n_blocks + 1 if native else 2 * (s // page_size) + 1
        if n_pages < 2:
            raise ValueError(f"a pool needs >= 2 pages (page 0 is scratch), got {n_pages}")
        self._kv_page_size = page_size
        self._kv_pool_pages = n_pages
        self._kv_n_blocks = n_blocks
        self.kv_native = bool(native)
        self._page_table = np.zeros((self.batch_size, n_blocks), np.int32) if native else None
        self._page_writer = np.full(n_pages, -1, np.int32) if native and self.dp > 1 else None
        self._pt_dev = (torch.zeros((self.batch_size, n_blocks), dtype=torch.int32,
                                    device=self.device) if native else None)
        self._pt_dirty = False
        # free the old pool (and a native pool's slab) before the new ones
        # exist; the graphs hold pointers into them
        self.kv_pool = None
        if native:
            self.lane_cache = None
        self.graphs.clear()
        if not native:
            self._require_lanes()
        shape = pool_shard_shape(self.header, self.tp, n_pages, page_size, self.pp)
        self.kv_pool = {k: new_kv_leaf(shape, self.kv_dtype, self.device) for k in ("k", "v")}
        self.kv_pool_epoch += 1
        return n_pages

    def reset_kv_pool(self) -> None:
        """Zero the pool (an int8 pool's scales back to ones), in place, and
        every page-table row. The caller resets its host-side page
        accounting to match."""
        self._require_kv_pool()
        for leaf in self.kv_pool.values():
            reset_kv_leaf(leaf)
        if self._page_writer is not None:
            self._page_writer[:] = -1
        self.kv_pool_epoch += 1
        self.clear_all_lane_pages()

    @contextlib.contextmanager
    def _kv_pool_guard(self):
        """A dispatch that wrote the pool and raised leaves its bytes
        unknown: reset it in place (`reset_kv_pool`; the host-side page
        accounting is the manager's to reset), and in native mode, where the
        pool is the lanes' KV, move ``cache_epoch`` too; then re-raise. If
        the reset raises too (a CUDA error that broke the context), that
        error propagates, raised from the first, with the epochs moved all
        the same, so no caller retries against the pool."""
        try:
            yield
        except BaseException as e:
            self.recorder.record("error", error=str(e), error_type=type(e).__name__)
            self.recorder.postmortem("engine-step", e)
            try:
                self.reset_kv_pool()
            except Exception as reset_err:
                self.kv_pool_epoch += 1
                raise reset_err from e
            finally:
                if self.kv_native:
                    self.cache_epoch += 1
                    self._m_epochs.inc()
                    self.recorder.record("cache_epoch", epoch=self.cache_epoch, native=True)
            raise

    def _lane_guard(self):
        """The guard of a lane step: the pool's in native mode, the lanes'
        slab's otherwise."""
        return self._kv_pool_guard() if self.kv_native else self._slab_guard(self.lane_cache)

    def _fault(self, op: str):
        """The chaos plane's armed fault for this dispatch, if any
        (runtime/faults.py). Callers raise a transient one before their
        guard and a poison one inside it."""
        return self._draw(lambda: get_fault_plane().draw("dispatch", op=op))

    def adopt_pages(self, lane: int, page_ids: list[int]) -> None:
        """Point ``lane``'s page-table row at ``page_ids`` (slot i backs rows
        [i*ps, (i+1)*ps)); unfilled slots fall back to page 0. No device
        work but the table's copy before the next dispatch. Native mode."""
        self._require_kv_pool()
        if not self.kv_native:
            raise ValueError("adopt_pages requires kv_native mode (slab lanes adopt by kv_adopt)")
        self._check_lane(lane)
        if len(page_ids) > self._kv_n_blocks:
            raise ValueError(f"{len(page_ids)} pages exceed {self._kv_n_blocks} blocks")
        if any(not 0 <= p < self._kv_pool_pages for p in page_ids):
            raise ValueError(f"page ids outside the pool of {self._kv_pool_pages} pages")
        row = self._page_table[lane]
        row[:] = 0
        row[: len(page_ids)] = np.asarray(page_ids, np.int32)
        self._pt_dirty = True
        self._adopted.add(lane)

    def clear_lane_pages(self, lane: int) -> None:
        """Drop ``lane``'s page-table row (back to the scratch page)."""
        if self._page_table is not None:
            self._page_table[lane] = 0
            self._pt_dirty = True

    def clear_all_lane_pages(self) -> None:
        if self._page_table is not None:
            self._page_table[:] = 0
            self._pt_dirty = True

    def _page_table_dev(self) -> torch.Tensor:
        """The device copy of the page table, refreshed if the host's
        changed since the last dispatch."""
        if self._pt_dirty:
            self._pt_dev.copy_(torch.from_numpy(self._page_table))
            self._pt_dirty = False
        return self._pt_dev

    @torch.inference_mode()
    def kv_page_copy(self, src_ids: list[int], dst_ids: list[int]) -> None:
        """Copy pool pages ``src_ids[i]`` -> ``dst_ids[i]`` on the device, in
        every layer and every tensor of a leaf, an int8 pool's scales too
        (the COW fork of a mid-page adoption)."""
        self._require_kv_pool()
        n = len(src_ids)
        if n < 1 or len(dst_ids) != n:
            raise ValueError("src/dst page lists must match and be non-empty")
        fault = self._fault("kv_page_copy")
        if fault is not None and not fault.poison:
            raise fault
        moved = n * self.kv_page_bytes()
        with self._kv_pool_guard(), _Dispatch(self, "kv_page_copy", ("kv_page_copy", n),
                                              (0.0, 2.0 * moved), graphed=False, n_pages=n):
            if fault is not None:
                raise fault
            src = torch.tensor(src_ids, dtype=torch.int64, device=self.device)
            dst = torch.tensor(dst_ids, dtype=torch.int64, device=self.device)
            for leaf in self.kv_pool.values():
                for t in kv_tensors(leaf):
                    t[:, dst] = t[:, src]
        if self._page_writer is not None:
            self._page_writer[dst_ids] = self._page_writer[src_ids]
        self.kv_copy_pages += n
        self._m_kv_copy_bytes.inc(moved)

    def kv_page_bytes(self) -> int:
        """Device bytes of one pool page, summed over the k/v leaves (an
        int8 pool's scales included) and all layers (the JAX engine's
        ``_kv_page_bytes``)."""
        self._require_kv_pool()
        return sum(t[:, 0].numel() * t.element_size()
                   for leaf in self.kv_pool.values() for t in kv_tensors(leaf))

    @staticmethod
    def _kv_copy_chunks(n: int) -> list[tuple[int, int]]:
        """An n-page copy as (start, bucket) pieces of decreasing powers of
        two, largest first (the JAX engine's buckets, one compiled program
        each there; here each piece is one copy of every layer)."""
        out, start = [], 0
        while start < n:
            b = 1
            while b * 2 <= n - start:
                b *= 2
            out.append((start, b))
            start += b
        return out

    def _check_slab_copy(self, lane: int, n: int, start_page: int) -> None:
        self._require_kv_pool()
        self._check_lane(lane)
        if self.kv_native:
            raise ValueError("kv_adopt/kv_publish copy slab lanes' rows: pool-native lanes "
                             "adopt by page table (adopt_pages) and publish by ownership")
        if n < 1:
            raise ValueError("empty page list")
        if start_page < 0 or (start_page + n) * self._kv_page_size > self.header.seq_len:
            raise ValueError(f"pages [{start_page}, {start_page + n}) exceed seqLen "
                             f"{self.header.seq_len}")
        self._require_lanes()

    @torch.inference_mode()
    def kv_adopt(self, lane: int, page_ids: list[int]) -> None:
        """Copy pool pages into ``lane``'s slab rows ``[0, n*ps)``: the
        admission half of prefix sharing in slab mode (the JAX engine's
        ``kv_adopt``). Rows of a partial final page past the matched tokens
        hold the donor's tail; the suffix prefill overwrites them before any
        query can attend to them. Runs under the slab's guard: a failure
        zeroes the lanes' slab and moves ``cache_epoch``."""
        n = len(page_ids)
        self._check_slab_copy(lane, n, 0)
        fault = self._fault("kv_adopt")
        if fault is not None and not fault.poison:
            raise fault
        ps = self._kv_page_size
        with self._slab_guard(self.lane_cache), _Dispatch(
                self, "kv_adopt", ("kv_adopt", n), self._cost.kv_copy(n * ps), graphed=False,
                lane=lane, n_pages=n):
            if fault is not None:
                raise fault
            ids = torch.tensor(page_ids, dtype=torch.int64, device=self.device)
            if self._owns(lane):  # the lane's rows live on its dp group alone
                for start, bucket in self._kv_copy_chunks(n):
                    for name in ("k", "v"):
                        self._pages_to_rows(name, lane - self._lane0, start * ps,
                                            ids[start : start + bucket])
        self.kv_adopt_pages += n
        self._m_kv_copy_bytes.inc(n * self.kv_page_bytes())

    @torch.inference_mode()
    def kv_publish(self, lane: int, page_ids: list[int], start_page: int) -> None:
        """Copy ``lane``'s slab rows ``[start_page*ps, (start_page + n)*ps)``
        into the pool pages ``page_ids`` [n]: the finish half of prefix
        sharing in slab mode (the JAX engine's ``kv_publish``; the manager
        dedups against the radix tree first). Runs under the pool's guard: a
        failure zeroes the pool and moves ``kv_pool_epoch``, not
        ``cache_epoch`` (the lanes' slab is intact). Under dp the lane's
        group writes the pages and broadcasts them to the other groups."""
        n = len(page_ids)
        self._check_slab_copy(lane, n, start_page)
        fault = self._fault("kv_publish")
        if fault is not None and not fault.poison:
            raise fault
        ps = self._kv_page_size
        with self._kv_pool_guard(), _Dispatch(
                self, "kv_publish", ("kv_publish", n), self._cost.kv_copy(n * ps),
                graphed=False, lane=lane, n_pages=n, start_page=start_page):
            if fault is not None:
                raise fault
            ids = torch.tensor(page_ids, dtype=torch.int64, device=self.device)
            if self._owns(lane):
                for off, bucket in self._kv_copy_chunks(n):
                    for name in ("k", "v"):
                        self._rows_to_pages(name, lane - self._lane0, (start_page + off) * ps,
                                            ids[off : off + bucket])
            if self.dp > 1:
                self._share_pages(ids, self._group_of(lane))
        self.kv_publish_pages += n
        self._m_kv_copy_bytes.inc(n * self.kv_page_bytes())

    def _owns(self, lane: int) -> bool:
        """Whether this rank's dp group owns ``lane`` (always under dp = 1)."""
        return self._group_of(lane) == (self.mesh.dp.index if self.dp > 1 else 0)

    def _group_of(self, lane: int) -> int:
        """The dp group that owns ``lane``: l // (B / dp)."""
        return lane // (self.batch_size // self.dp)

    def _lane_span(self) -> slice:
        """The lanes of this rank's dp group, as a slice of the batch."""
        return slice(self._lane0, self._lane0 + self.batch_size // self.dp)

    def _share_pages(self, ids: torch.Tensor, owner: int) -> None:
        """Pool pages ``ids`` of dp group ``owner`` into every group's pool
        (one broadcast over dp a tensor of each leaf: the pages' bytes)."""
        for leaf in self.kv_pool.values():
            for t in kv_tensors(leaf):
                t[:, ids] = broadcast(t[:, ids].contiguous(), self.mesh.dp, owner)

    def _pool_row(self, lane: int, p: int) -> tuple[int, int]:
        """(pool page, page row) of native lane ``lane``'s position ``p``;
        a parked row (p < 0) is on the scratch page 0, row 0."""
        if p < 0:
            return 0, 0
        ps = self._kv_page_size
        return int(self._page_table[lane, p // ps]), p % ps

    def _share_pool_rows(self, written: list[list[int]], owner: int | None = None) -> None:
        """Native lanes under dp: the pool rows a dispatch wrote, copied from
        the group of each writing lane into every other group's pool, so
        that a page one group wrote reads the same on every group (a radix
        prefix adopted across groups). ``written[lane]``: the positions the
        lane wrote (< 0: a parked row, which wrote the scratch page). With
        ``owner`` (a lane chunk) one group wrote and broadcasts its rows;
        else every group wrote the same number of rows (a decode block, a
        verify pass) and one all-gather over dp carries them."""
        dp, bl = self.mesh.dp, self.batch_size // self.dp
        groups = [owner] if owner is not None else range(self.dp)
        idx = {}
        for g in groups:
            rows = [self._pool_row(lane, p) for lane in range(g * bl, (g + 1) * bl)
                    for p in written[lane]]
            self._page_writer[[pg for pg, _ in rows if pg]] = g
            idx[g] = torch.tensor(rows, dtype=torch.int64, device=self.device).reshape(-1, 2)
        mine = dp.index if owner is None else owner
        pg, pr = idx[mine][:, 0], idx[mine][:, 1]
        for leaf in self.kv_pool.values():
            for t in kv_tensors(leaf):
                rows = t[:, pg, :, pr].contiguous()  # [m, L, KH, hd or 1]
                if owner is not None:
                    rows = broadcast(rows, dp, owner)
                    if dp.index != owner:
                        t[:, pg, :, pr] = rows
                    continue
                every = all_gather(rows[None], dp, dim=0)
                for g in groups:
                    if g != dp.index:
                        t[:, idx[g][:, 0], :, idx[g][:, 1]] = every[g]

    def _count_cross_dp(self, lane: int, pos0: int) -> None:
        """The first chunk of a native lane since its page-table row changed
        reads the rows below ``pos0`` (its adopted prefix): count the pages
        of them that a lane of another dp group wrote
        (``kv_cross_dp_pages``, the replication's observable use)."""
        if lane not in self._adopted:
            return
        self._adopted.discard(lane)
        pages = self._page_table[lane, : -(-pos0 // self._kv_page_size)]
        writers = self._page_writer[pages]
        self.kv_cross_dp_pages += int(((writers >= 0) & (writers != self._group_of(lane))).sum())

    def _pages_to_rows(self, name: str, lane: int, row0: int, ids: torch.Tensor) -> None:
        """Pool pages ``ids`` into ``lane``'s slab rows from ``row0`` (``lane``
        the index in this rank's slab, its dp group's lanes): under
        sp the pool is whole on every rank and each rank takes the rows its
        shard owns (the cyclic layout: global row g at local row g // sp),
        an int8 leaf's values and scales alike."""
        slab, pool = self.lane_cache[name], self.kv_pool[name]
        if self.sp == 1:
            pages_to_rows(slab, pool, lane, row0, ids)
            return
        for dst, src in zip(kv_tensors(slab), kv_tensors(pool)):
            pages = src[:, ids]  # [L, n, KH/tp, ps, hd or 1]
            nl, n, kh, ps, last = pages.shape
            js, local = cyclic_rows(row0, n * ps, self.sp, self.mesh.sp.index)
            rows = pages.transpose(1, 2).reshape(nl, kh, n * ps, last)
            dst[:, lane, :, torch.tensor(local, device=self.device)] = (
                rows[:, :, torch.tensor(js, device=self.device)])

    def _rows_to_pages(self, name: str, lane: int, row0: int, ids: torch.Tensor) -> None:
        """``lane``'s slab rows from ``row0`` into the pool pages ``ids``:
        under sp the rows are gathered from every shard first (each shard
        sends the same span of local rows, which covers the range), and
        every rank writes the whole pages, an int8 leaf's values and scales
        alike."""
        slab, pool = self.lane_cache[name], self.kv_pool[name]
        if self.sp == 1:
            rows_to_pages(slab, pool, lane, row0, ids)
            return
        sp = self.sp
        n = ids.shape[0]
        lo, hi = row0 // sp, -(-(row0 + n * self._kv_page_size) // sp)
        for src, dst in zip(kv_tensors(slab), kv_tensors(pool)):
            nl, _, kh, ps, last = dst.shape
            part = src[:, lane, :, lo:hi].contiguous()  # [L, KH/tp, hi - lo, hd or 1]
            parts = all_gather(part[None], self.mesh.sp, dim=0)  # [sp, L, KH/tp, hi - lo, ..]
            rows = parts.permute(1, 2, 3, 0, 4).reshape(nl, kh, (hi - lo) * sp, last)
            rows = rows[:, :, row0 - lo * sp : row0 - lo * sp + n * ps]
            dst[:, ids] = rows.reshape(nl, kh, n, ps, last).transpose(1, 2)

    def _lane_key(self, *key) -> tuple:
        """A lane graph's key: ``("lane_...", ...)`` on the slab, with
        ``_paged`` in its head in native mode."""
        return (key[0] + "_paged",) + key[1:] if self.kv_native else key

    def _lane_forward(self, tokens: torch.Tensor, pos: torch.Tensor, logits_mode: str):
        """One forward of this rank's lanes (its dp group's, `_lane_span`;
        every lane under dp = 1) at positions ``pos`` [B/dp] (< 0: parked):
        through their page-table rows in native mode, on the lanes' slab
        otherwise. Returns the logits."""
        if self.kv_native:
            kw = dict(page_table=self._pt_dev[self._lane_span()])
            cache = self.kv_pool
        else:
            kw = dict(park=self._park)
            cache = self.lane_cache
        logits, _ = self._forward(tokens, pos, cache, logits_mode=logits_mode, **kw)
        return logits

    @torch.inference_mode()
    def prefill_lane_chunk(self, lane: int, tokens: list[int], pos0: int,
                           budget: int | None = None) -> int:
        """Write ONE bucket-shaped chunk of ``tokens`` (fill rows: the
        caller already dropped the prompt's final token) into ``lane``'s KV
        at ``pos0``; returns how many tokens it consumed. ``budget`` caps
        the chunk width. Bucket padding writes rows past the tokens, inside
        the lane's own rows (native: every slot from the match point on is
        private, the manager forks a shared mid-page boundary); later writes
        overwrite them before any query can see them."""
        self._require_lanes()
        self._check_lane(lane)
        n = len(tokens)
        if n < 1:
            raise ValueError("empty chunk")
        if pos0 < 0 or pos0 + n > self.header.seq_len:
            raise ValueError(f"{n} fill tokens at pos {pos0} exceed seqLen {self.header.seq_len}")
        fault = self._fault("prefill_lane_chunk")
        if fault is not None and not fault.poison:
            raise fault
        want = min(n, budget) if budget and budget > 0 else n
        bucket = self._bucket_for(want, pos0)
        width = min(bucket, want)
        cost = self._cost.forward(bucket, 0, pos0 + bucket, bucket, _pairs(bucket, pos0))
        key = ("lane_prefill_paged", bucket) if self.kv_native else ("lane_prefill", bucket, lane)
        with self._lane_guard(), _Dispatch(
                self, "prefill_lane_chunk", key, cost, lane=lane, pos=pos0, n_tokens=width,
                bucket=bucket):
            if fault is not None:
                raise fault
            chunk = tokens[:width] + [0] * (bucket - width)
            if self._owns(lane):  # a lane's rows live on its own dp group alone
                if self.kv_native:
                    self._lane_chunk(chunk, pos0, self._page_table_dev()[lane : lane + 1])
                else:
                    self._slab_lane_chunk(chunk, pos0, lane - self._lane0)
            if self.kv_native and self.dp > 1:
                self._count_cross_dp(lane, pos0)
                written = [[] for _ in range(self.batch_size)]
                written[lane] = list(range(pos0, pos0 + bucket))
                self._share_pool_rows(written, owner=self._group_of(lane))
        return width

    def _lane_chunk(self, tokens: list[int], pos: int, pt_row: torch.Tensor | None) -> None:
        """One lane-prefill chunk [1, T] at ``pos`` through the page-table
        row ``pt_row`` [1, n_blocks], copied into the graph's static row
        (``None``: an all-zero row, every write to the scratch page 0).
        The graph ``("lane_prefill_paged", T)``."""
        t = len(tokens)
        key = ("lane_prefill_paged", t)
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((1, t), I64), pos=((1,), I32), pt=((1, self._kv_n_blocks), I32)))
        self.graphs.put(b["tok"], tokens)
        self.graphs.put(b["pos"], pos)
        if pt_row is None:
            b["pt"].zero_()
        else:
            b["pt"].copy_(pt_row)
        self.graphs.run(key, lambda: self._forward(b["tok"], b["pos"], self.kv_pool,
                                                   logits_mode="none", page_table=b["pt"]))

    def _slab_lane_chunk(self, tokens: list[int], pos: int, lane: int) -> None:
        """One lane-prefill chunk [1, T] at ``pos`` (< 0: parked, its rows
        land in the lane's padding rows) on ``lane``'s rows of the lanes'
        slab alone (``lane``: its index in this rank's slab): the graph
        ``("lane_prefill", T, lane)``, one a lane, whose slab entries see
        that lane's [1, KH, S + pad, hd] rows."""
        t = len(tokens)
        key = ("lane_prefill", t, lane)
        b = self.graphs.buffers(key, lambda: self._static(tok=((1, t), I64), pos=((1,), I32)))
        self.graphs.put(b["tok"], tokens)
        self.graphs.put(b["pos"], pos)
        view = {name: kv_lane(leaf, lane) for name, leaf in self.lane_cache.items()}
        self.graphs.run(key, lambda: self._forward(b["tok"], self._pos(b["pos"], pos), view,
                                                   logits_mode="none", park=self._park))

    def prefill_lane(self, lane: int, tokens: list[int], pos0: int = 0) -> None:
        """Prefill one lane's prompt (all but the last token) chunk by
        chunk; the other lanes' rows are untouched."""
        self._check_lane(lane)
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prompt")
        if pos0 + n - 1 > self.header.seq_len:
            raise ValueError(f"prompt of {n} tokens at pos {pos0} exceeds seqLen "
                             f"{self.header.seq_len}")
        fills, p = tokens[:-1], pos0
        while fills:
            width = self.prefill_lane_chunk(lane, fills, p)
            fills = fills[width:]
            p += width

    @torch.inference_mode()
    def decode_lanes(
        self,
        tokens: list[int],
        pos: list[int],
        n_steps: int,
        active: list[bool] | None = None,
        temperature: list[float] | None = None,
        topp: list[float] | None = None,
        seeds: list[int | None] | None = None,
    ) -> list[list[int]]:
        """Decode ``n_steps`` tokens on every ACTIVE lane in one block, each
        lane at its own position with its own sampling settings
        (temperature 0: the argmax; a per-lane seed makes a sampled stream
        depend only on (seed, position)). Returns [n_steps][lanes]; parked
        lanes report 0. The block is clamped by the deepest live lane; a
        lane that fills the cache mid-block parks itself and reports 0 for
        the remaining rows (callers stop consuming a lane at its cap).
        Tokens stay on the device between steps: one readback a block."""
        self._require_lanes()
        b, seq_len = self.batch_size, self.header.seq_len
        if len(tokens) != b or len(pos) != b:
            raise ValueError("tokens/pos must have one entry per lane")
        if active is None:
            active = [True] * b
        live = [i for i, a in enumerate(active) if a]
        if not live:
            return []
        n_steps = min(n_steps, max(seq_len - pos[i] for i in live))
        if n_steps <= 0:
            return []
        if temperature is None:
            temperature = [self.temperature] * b
        if topp is None:
            topp = [self.sampler.topp] * b
        seed_vec = self._draw(lambda: self._lane_seeds(seeds))
        # every step's positions, -1 for parked lanes and past the cache:
        # one host-to-device copy a block
        cur = [[pos[j] + i if active[j] and 0 <= pos[j] + i < seq_len else -1 for j in range(b)]
               for i in range(n_steps)]
        sampled = any(active[j] and temperature[j] > 0.0 for j in range(b))
        fault = self._fault("decode_lanes")
        if fault is not None and not fault.poison:
            raise fault
        reads = sum(p + 1 for row in cur for p in row if p >= 0)
        live_rows = sum(p >= 0 for row in cur for p in row)
        cost = self._cost.forward(n_steps * b, n_steps * b, reads, live_rows, reads, n=n_steps)
        with self._lane_guard(), _Dispatch(
                self, "decode_lanes", self._lane_key("lane_block", n_steps, sampled), cost,
                n_tokens=n_steps, pos=max(pos[i] for i in live), n_steps=n_steps,
                n_live=len(live)) as d:
            if fault is not None:
                raise fault
            out = d.device(self._lane_block(tokens, cur, sampled, temperature, topp,
                                            seed_vec).tolist)
        self.lane_decode_steps += n_steps
        return out

    def _lane_seeds(self, seeds: list[int | None] | None) -> list[int]:
        """A decode block's seed a lane: unseeded lanes draw from an
        engine-lifetime stream (varies per call); a seeded lane's draws
        depend only on (seed, position)."""
        self._rng_calls += 1
        return [
            (s if s is not None else self._lane_seed_base + 1_000_003 * self._rng_calls + i)
            & 0x7FFFFFFF
            for i, s in enumerate(seeds or [None] * self.batch_size)
        ]

    def _lane_block(self, tokens: list[int], cur: list[list[int]], sampled: bool,
                    temperature: list[float], topp: list[float], seeds: list[int]):
        """Every lane's decode block in the graph ``("lane_block", n,
        sampled)`` (``lane_block_paged`` in native mode): tokens [B],
        positions ``cur`` [n][B] (-1: parked, reads nothing and writes to
        the scratch page or the padding rows), sampling settings [B] (read
        only when ``sampled``). Under dp the rank runs its group's lanes
        and the block's tokens are all-gathered over dp. Returns the static
        output [n, B] on the device, 0 for parked rows."""
        n, bsz = len(cur), self.batch_size
        key = self._lane_key("lane_block", n, sampled)
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((bsz, 1), I64), cur=((n, bsz), I32), temp=((bsz,), torch.float32),
            topp=((bsz,), torch.float32), seed=((bsz,), I64), out=((n, bsz), I64)))
        self.graphs.put(b["tok"], tokens)
        self.graphs.put(b["cur"], cur)
        if sampled:
            self.graphs.put(b["temp"], temperature)
            self.graphs.put(b["topp"], topp)
            self.graphs.put(b["seed"], seeds)
        if self.kv_native:
            self._page_table_dev()
        own = self._lane_span()

        def block():
            tok = b["tok"][own]
            for i in range(n):
                p = b["cur"][i][own]
                last = self._lane_forward(tok, p, "last")[:, -1, :]
                if sampled:
                    nxt = sample_per_lane(last, b["temp"][own], b["topp"][own], b["seed"][own], p)
                else:
                    nxt = torch.argmax(last, dim=-1)
                nxt = torch.where(p >= 0, nxt, 0)
                b["out"][i, own] = nxt
                tok = nxt[:, None]
            if self.dp > 1:  # every group's lanes' tokens on every rank
                b["out"].copy_(all_gather(b["out"][:, own].contiguous(), self.mesh.dp, dim=1))

        self.graphs.run(key, block)
        if self.kv_native and self.dp > 1:
            self._share_pool_rows([[row[j] for row in cur] for j in range(bsz)])
        return b["out"]

    @torch.inference_mode()
    def verify_lanes(self, rows: list[list[int]], pos: list[int],
                     active: list[bool]) -> list[list[int]]:
        """Verify each active lane's draft row in ONE forward (dllama_tpu's
        ``verify_lanes``). ``rows[l]`` is [pending token, draft_0 ..
        draft_{k-1}, pads] of one shared width t, fed at positions pos[l] ..
        pos[l] + t - 1; returns the greedy argmax grid [lanes][t] (inactive
        lanes report 0), in one readback. The caller accepts the longest
        draft prefix that agrees with the argmax of the row before plus one
        correction token, and rewinds the rest: the rejected rows' KV stays
        at or past the lane's rewound position, where the causal mask hides
        it until later writes overwrite it (why a publish of history[:pos]
        composes with rewinds). Inactive lanes are parked at -t: the stats
        kernel reads nothing for them and their rows land on the scratch
        page 0 (native) or in their padding rows (slab).

        Checked on the host: one width, 2 <= t <= the largest prefill
        bucket (the slab's padding), and pos + t <= seq_len for every live
        lane (on the card neither a page-table index past the table nor a
        row past the slab is checked). The graph ``("lane_verify", t)``
        (``lane_verify_paged`` in native mode)."""
        self._require_lanes()
        b, seq_len = self.batch_size, self.header.seq_len
        if len(rows) != b or len(pos) != b or len(active) != b:
            raise ValueError("rows/pos/active must have one entry per lane")
        t = len(rows[0])
        if t < 2:
            raise ValueError("verify rows need a pending token + >=1 draft")
        if any(len(r) != t for r in rows):
            raise ValueError("verify rows must share one bucketed width")
        if t > max(self.prefill_buckets):
            raise ValueError(f"verify width {t} exceeds the largest prefill bucket "
                             f"{max(self.prefill_buckets)}")
        live = [i for i, a in enumerate(active) if a]
        if not live:
            return []
        for i in live:
            if pos[i] < 0 or pos[i] + t > seq_len:
                raise ValueError(f"lane {i}: verify row at pos {pos[i]} width {t} "
                                 f"exceeds seqLen {seq_len}")
        fault = self._fault("verify_lanes")
        if fault is not None and not fault.poison:
            raise fault
        reads = sum(pos[i] + t for i in live)
        cost = self._cost.forward(b * t, b * t, reads, len(live) * t,
                                  sum(_pairs(t, pos[i]) for i in live))
        with self._lane_guard(), _Dispatch(
                self, "verify_lanes", self._lane_key("lane_verify", t), cost, t=t,
                pos=max(pos[i] for i in live), n_live=len(live)) as d:
            if fault is not None:
                raise fault
            out = d.device(self._lane_verify(
                rows, [pos[i] if active[i] else -t for i in range(b)]).tolist)
        self.lane_verify_steps += 1
        return out

    def _lane_verify(self, rows: list[list[int]], cur: list[int]) -> torch.Tensor:
        """Every lane's verify row [B, t] at positions ``cur`` [B] (-t:
        parked) in the graph ``("lane_verify", t)`` (``_paged`` in native
        mode): all logits, their argmax on the device, 0 for parked lanes
        (under dp: the group's lanes, the grid all-gathered over dp).
        Returns the static output [B, t] on the device."""
        t, bsz = len(rows[0]), self.batch_size
        key = self._lane_key("lane_verify", t)
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((bsz, t), I64), pos=((bsz,), I32), out=((bsz, t), I64)))
        self.graphs.put(b["tok"], rows)
        self.graphs.put(b["pos"], cur)
        if self.kv_native:
            self._page_table_dev()
        own = self._lane_span()

        def verify():
            pos = b["pos"][own]
            logits = self._lane_forward(b["tok"][own], pos, "all")
            b["out"][own] = torch.where(pos[:, None] >= 0, torch.argmax(logits, dim=-1), 0)
            if self.dp > 1:
                b["out"].copy_(all_gather(b["out"][own].contiguous(), self.mesh.dp, dim=0))

        self.graphs.run(key, verify)
        if self.kv_native and self.dp > 1:
            self._share_pool_rows([[p + r if p >= 0 else -1 for r in range(t)] for p in cur])
        return b["out"]

    def rehearse_admission(self, block_size: int, spec_k: int = 0) -> None:
        """Capture the admission path's graphs before serving (dllama_tpu's
        ``rehearse_admission``): every lane-prefill bucket (on the slab,
        each bucket for each lane), the greedy and sampled lane decode block
        of ``block_size`` steps and, with ``spec_k`` > 0, one verify graph
        per draft bucket (`spec_buckets(min(spec_k, largest prefill bucket -
        1))`, width 1 + bucket). Each first use runs with every lane parked
        (native: an all-zero page-table row, every write to the scratch
        page; slab: at -T, every write to the padding rows), so no lane's
        KV changes. With a draft model and ``spec_k`` > 0 also its
        catch-up buckets for each lane and its k-step blocks of the draft
        buckets, parked in the draft cache's padding rows. A no-op where
        graphs are off (the CPU among them)."""
        self._require_lanes()
        if not self.graphs.active:
            return
        bsz, n = self.batch_size, max(1, min(block_size, self.header.seq_len))
        with torch.inference_mode():
            for bucket in self.prefill_buckets:
                if self.kv_native:
                    self._lane_chunk([0] * bucket, 0, None)
                else:
                    for lane in range(bsz):
                        self._slab_lane_chunk([0] * bucket, -bucket, lane)
            for sampled in (False, True):
                self._lane_block([0] * bsz, [[-1] * bsz] * n, sampled, [1.0] * bsz,
                                 [1.0] * bsz, [0] * bsz)
            if spec_k > 0:
                for kb in spec_buckets(min(spec_k, max(self.prefill_buckets) - 1)):
                    self._lane_verify([[0] * (kb + 1)] * bsz, [-(kb + 1)] * bsz)
            if spec_k > 0 and self.has_draft_model:
                # the draft's catch-up buckets (each lane's) and its k-step
                # blocks sit on the serving path like the verify graphs;
                # parked, they write only the draft cache's padding rows
                for bucket in self.prefill_buckets:
                    if bucket <= self.draft_seq_len:
                        for lane in range(bsz):
                            self._draft_chunk([0] * bucket, -bucket, lane)
                for kb in spec_buckets(min(spec_k, max(self.prefill_buckets) - 1)):
                    self._draft_block([0] * bsz, [[-1] * bsz] * kb)
        self._sync()

    # -- the resident draft model (--speculation draft) ------------------------

    @property
    def has_draft_model(self) -> bool:
        return self._draft_params is not None

    @property
    def draft_seq_len(self) -> int:
        """The draft checkpoint's own context length (at most the
        target's): the scheduler asks for no draft past it."""
        return self._draft_header.seq_len if self._draft_header else 0

    def init_draft_model(self, model_path: str) -> None:
        """Load a Llama-family draft checkpoint beside the target (the JAX
        engine's ``init_draft_model``): dense weights in the engine's dtype
        (its products are plain ``torch.matmul``, as the JAX draft runs no
        Pallas matmul; its attention runs the slab kernels at its own
        shapes), its slab cache [L_d, B, KH_d, S_d + pad, hd_d] in the
        engine's dtype with the lanes' padding rows. Its vocab must be the
        target's: drafts are target token ids. Needs lanes. Under tp the
        draft is sharded like the target (its heads, columns and cache
        heads a rank), as the JAX engine shards it; under dp every group
        runs it for every lane (its cache is not split over dp); under pp
        and sp it raises, as the JAX engine's does."""
        if self.pp > 1 or self.sp > 1:
            raise ValueError("draft model requires pp == 1 and sp == 1 (the draft forward runs "
                             "on the flat mesh path)")
        if self.batch_size < 2:
            raise ValueError("per-lane serving needs batch_size > 1 "
                             "(lanes park their writes in cache padding rows)")
        reader = ModelReader(model_path, max_seq_len=self.header.seq_len)
        dh = reader.header
        if dh.vocab_size != self.header.vocab_size:
            raise ValueError(f"draft model vocab {dh.vocab_size} != target vocab "
                             f"{self.header.vocab_size}; the draft must share the target's "
                             "tokenizer")
        validate_tp(dh, self.tp)
        params = load_params(reader, dtype=self.dtype, device=self.device, weight_format="dense",
                             shard=(self.tp, self.mesh.tp.index) if self.tp > 1 else None)
        self._draft_header, self._draft_params = dh, params
        shape = lane_shard_shape(dh, self.tp, 1, self.batch_size, self._lane_pad)
        self.draft_cache = {n: new_kv_leaf(shape, self.dtype, self.device) for n in ("k", "v")}
        self.draft_cache_epoch += 1
        self._draft_cost = StepCostModel(dh, params, self.dtype.itemsize, False, tp=self.tp)
        self._m_spec_draft_ms = self.obs.histogram(
            "dllama_spec_draft_model_step_ms",
            "Wall milliseconds of one draft-model dispatch (catch-up prefill chunk or k-step "
            "propose block).",
            labelnames=("kind",),
            buckets=(0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000),
        )
        self.recorder.record("draft_model_loaded", path=model_path, seq_len=dh.seq_len,
                             vocab=dh.vocab_size)

    def _require_draft_model(self) -> None:
        if self._draft_params is None:
            raise ValueError("draft model not loaded (init_draft_model)")

    @contextlib.contextmanager
    def _draft_cache_guard(self):
        """`_slab_guard`'s draft twin (the JAX ``_draft_cache_guard``): a
        draft dispatch that raises leaves the draft cache's rows unknown, so
        it is zeroed in place and ``draft_cache_epoch`` moves (the
        scheduler's draft cursors restart); the target's caches and epochs
        are untouched. Drafts are verified by the target, so a lost draft
        cache costs acceptance, never bytes."""
        try:
            yield
        except BaseException as e:
            self.recorder.record("error", error=str(e), error_type=type(e).__name__, draft=True)
            try:
                for leaf in self.draft_cache.values():
                    reset_kv_leaf(leaf)
            except Exception as reset_err:
                raise reset_err from e
            finally:
                self.draft_cache_epoch += 1
                self.recorder.record("draft_cache_epoch", epoch=self.draft_cache_epoch)
            raise

    def _draft_bucket_for(self, n: int, pos: int) -> int:
        """`_bucket_for` against the draft's sequence length."""
        space = self._draft_header.seq_len - pos
        fitting = [b for b in self.prefill_buckets if b <= space]
        if not fitting:
            return max(min(space, n), 1)
        for b in fitting:
            if n <= b:
                return b
        return fitting[-1]

    @torch.inference_mode()
    def draft_prefill(self, lane: int, tokens: list[int], pos0: int) -> None:
        """Catch ``lane``'s draft rows up: write ``tokens`` (history the
        draft has not seen) at ``pos0``.., chunk by chunk in the draft's
        buckets, each chunk on that lane's rows alone (the graph
        ``("draft_prefill", T, lane)``). Rows past a later rewind are
        overwritten by the next catch-up before any draft query attends to
        them, as with the target's verify rewind."""
        self._require_draft_model()
        self._check_lane(lane)
        n = len(tokens)
        if n < 1:
            return
        dseq = self._draft_header.seq_len
        if pos0 < 0 or pos0 + n > dseq:
            raise ValueError(f"{n} draft fill tokens at pos {pos0} exceed draft seqLen {dseq}")
        t0 = time.perf_counter()
        fills, p = list(tokens), pos0
        while fills:
            bucket = self._draft_bucket_for(len(fills), p)
            width = min(bucket, len(fills))
            cost = self._draft_cost.forward(bucket, 0, p + bucket, bucket, _pairs(bucket, p))
            with self._draft_cache_guard(), _Dispatch(
                    self, "draft_prefill", ("draft_prefill", bucket, lane), cost, lane=lane,
                    pos=p, n_tokens=width, bucket=bucket):
                self._draft_chunk(fills[:width] + [0] * (bucket - width), p, lane)
            fills = fills[width:]
            p += width
        self._m_spec_draft_ms.labels(kind="prefill").observe(
            (time.perf_counter() - t0) * 1000)

    def _draft_chunk(self, tokens: list[int], pos: int, lane: int) -> None:
        """One draft catch-up chunk [1, T] at ``pos`` (< 0: parked, into the
        lane's padding rows) on ``lane``'s draft rows alone: the graph
        ``("draft_prefill", T, lane)``. No logits are computed."""
        t = len(tokens)
        key = ("draft_prefill", t, lane)
        b = self.graphs.buffers(key, lambda: self._static(tok=((1, t), I64), pos=((1,), I32)))
        self.graphs.put(b["tok"], tokens)
        self.graphs.put(b["pos"], pos)
        view = {name: kv_lane(leaf, lane) for name, leaf in self.draft_cache.items()}
        dh = self._draft_header
        self.graphs.run(key, lambda: forward(self._draft_params, dh, b["tok"], b["pos"], view,
                                             logits_mode="none", park=dh.seq_len,
                                             **self._mesh_kw()))

    @torch.inference_mode()
    def draft_propose(self, tokens: list[int], pos: list[int], active: list[bool],
                      k: int) -> list[list[int]]:
        """Propose up to ``k`` greedy draft tokens for every ACTIVE lane in
        one dispatch (the graph ``("draft_step", k)``): lane l feeds
        tokens[l] at pos[l] and runs k greedy steps through the draft.
        Returns [lanes][k]; inactive rows, and rows past the draft's
        context, report 0. Advisory: every token goes through the target's
        verify pass."""
        self._require_draft_model()
        bsz = self.batch_size
        if len(tokens) != bsz or len(pos) != bsz:
            raise ValueError("tokens/pos must have one entry per lane")
        live = [i for i, a in enumerate(active) if a]
        if not live or k < 1:
            return []
        dseq = self._draft_header.seq_len
        k = min(k, max(dseq - pos[i] for i in live))
        if k <= 0:
            return []
        cur = [[pos[j] + i if active[j] and 0 <= pos[j] + i < dseq else -1 for j in range(bsz)]
               for i in range(k)]
        reads = sum(p + 1 for row in cur for p in row if p >= 0)
        live_rows = sum(p >= 0 for row in cur for p in row)
        cost = self._draft_cost.forward(k * bsz, k * bsz, reads, live_rows, reads, n=k)
        t0 = time.perf_counter()
        with self._draft_cache_guard(), _Dispatch(self, "draft_step", ("draft_step", k), cost,
                                                  n_steps=k, n_live=len(live)) as d:
            out = d.device(self._draft_block(tokens, cur).tolist)
        self._m_spec_draft_ms.labels(kind="propose").observe((time.perf_counter() - t0) * 1000)
        return [[out[i][lane] for i in range(k)] for lane in range(bsz)]

    def _draft_block(self, tokens: list[int], cur: list[list[int]]) -> torch.Tensor:
        """The draft's greedy block in the graph ``("draft_step", n)``:
        tokens [B], positions ``cur`` [n][B] (-1: parked, writes its padding
        row and reads nothing); returns the static output [n, B], 0 for
        parked rows."""
        n, bsz = len(cur), self.batch_size
        key = ("draft_step", n)
        b = self.graphs.buffers(key, lambda: self._static(
            tok=((bsz, 1), I64), cur=((n, bsz), I32), out=((n, bsz), I64)))
        self.graphs.put(b["tok"], [[t] for t in tokens])
        self.graphs.put(b["cur"], cur)
        dh, params = self._draft_header, self._draft_params

        def block():
            tok = b["tok"]
            for i in range(n):
                p = b["cur"][i]
                logits, _ = forward(params, dh, tok, p, self.draft_cache, logits_mode="last",
                                    park=dh.seq_len, **self._mesh_kw())
                nxt = torch.where(p >= 0, torch.argmax(logits[:, -1, :], dim=-1), 0)
                b["out"][i] = nxt
                tok = nxt[:, None]

        self.graphs.run(key, block)
        return b["out"]

    def generate_batch(self, prompts: list[list[int]], max_steps: int,
                       block_size: int = 8) -> list[list[int]]:
        """Decode independent sequences, one per lane (``batch_size ==
        len(prompts)``); prompts may differ in length. Each lane prefills
        on its own and decodes from its own position; ``max_steps`` caps
        each lane's absolute position, as in `generate`. In native mode
        each lane gets the private pages ``1 + lane * n_blocks ...`` (the
        pool must hold ``batch_size * n_blocks + 1`` pages). Greedy or
        sampled per the engine temperature; returns the lanes' token
        lists."""
        if len(prompts) != self.batch_size:
            raise ValueError(f"{len(prompts)} prompts for batch_size {self.batch_size}")
        self._require_lanes()
        nb = self._kv_n_blocks
        if self.kv_native and self._kv_pool_pages < self.batch_size * nb + 1:
            raise ValueError(f"generate_batch needs {self.batch_size * nb + 1} pool pages, "
                             f"the pool has {self._kv_pool_pages}")
        max_pos = min(self.header.seq_len, max_steps)
        for lane, p in enumerate(prompts):
            if not p:
                raise ValueError(f"lane {lane}: empty prompt")
            if self.kv_native:
                self.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
            self.prefill_lane(lane, p)
        pos = [len(p) - 1 for p in prompts]
        tokens = [p[-1] for p in prompts]
        active = [pos[i] < max_pos for i in range(self.batch_size)]
        outs: list[list[int]] = [[] for _ in prompts]
        while any(active):
            rows = self.decode_lanes(tokens, pos, block_size, active)
            if not rows:
                break
            for row in rows:
                for lane, t in enumerate(row):
                    if active[lane]:
                        outs[lane].append(t)
                        pos[lane] += 1
                        tokens[lane] = t
                        if pos[lane] >= max_pos:
                            active[lane] = False
        return outs

    def occupancy(self) -> dict:
        """The engine's static share of a load snapshot: lane capacity,
        prefill buckets and the pool's shape."""
        return {
            "lanes_total": self.batch_size,
            "prefill_buckets": list(self.prefill_buckets),
            "kv_page_size": self._kv_page_size,
            "kv_pool_pages": self._kv_pool_pages,
        }
