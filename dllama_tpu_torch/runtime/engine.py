"""Single-stream inference engine: bucketed prefill + greedy decode.

Counterpart of the single-stream part of dllama_tpu/runtime/engine.py
(reference: src/app.cpp:170-230, dllama.cpp:13-116). PyTorch runs eagerly,
so there are no compiled programs: prefill walks the prompt in the same
bucketed chunks (`_bucket_for`, `_prefill_rows`) and greedy decoding runs
blocks of steps whose argmax stays on the device, with one host readback
per block (`decode_block`). Sampling with temperature > 0 uses the
reference-parity host sampler one step at a time (`decode_step`).

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; on the card
every matmul and attention goes through the port's CUDA kernels. Weight
formats: ``q40`` (int8 values + f16 scales), ``q40i4`` (packed nibbles),
``q40i8`` (q40 requantized on the device to grouped int8, G from
`pick_group`), ``dense``, and ``auto`` (q40 for a Q40 file on the card,
dense elsewhere).

Lanes (`init_kv_pool`, `prefill_lane_chunk`, `decode_lanes`,
`generate_batch`): ``batch_size`` independent streams, each at its own
position, whose KV lives in one shared page pool [L, P, KH, ps, hd] read
and written through per-lane page tables. Only pool-native lanes are
ported (ROADMAP A.7 holds the slab lanes). A decode block runs every lane
of the batch (idle lanes parked at position -1: they read nothing and
write to scratch page 0), so each lane's values are the same whatever the
others do. The host keeps the page table and copies it to the card when it
changes, not on every step. The single-stream path keeps its own slab
cache [L, 1, KH, S, hd].
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmHeader, ModelReader
from ..formats.quants import FloatType
from ..models import forward, init_kv_cache, load_params
from ..ops.int8_matmul import pick_group, requantize_params
from .sampler import Sampler, sample_per_lane

# Prefill chunk buckets (the reference's --nBatches role; the JAX engine
# compiles one program per bucket, the port keeps the same chunking).
PREFILL_BUCKETS = (1, 8, 32, 128, 512)


@dataclasses.dataclass
class StepStats:
    """Per-forward timing surface (reference: dllama.cpp:59-66,88-95)."""

    time_ms: float
    n_tokens: int


class InferenceEngine:
    """See module docstring: one slab-cache stream, plus ``batch_size``
    pool-native lanes once `init_kv_pool` has run."""

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
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.reader = ModelReader(model_path, max_seq_len=max_seq_len)
        self.header: LlmHeader = self.reader.header
        self.dtype = dtype
        self.temperature = temperature
        self.sampler = Sampler(self.header.vocab_size, temperature, topp, seed)
        self.prefill_buckets = tuple(
            b for b in PREFILL_BUCKETS if b <= self.header.seq_len
        ) or (1,)
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
        # q40i8 loads the file's Q40 blocks, then requantizes on the device
        self.params = load_params(
            self.reader, dtype=dtype, device=self.device,
            weight_format="q40" if weight_format == "q40i8" else weight_format,
        )
        self.i8_group = 0
        if weight_format == "q40i8":
            self.i8_group = pick_group(self.header)
            self.params = requantize_params(self.params, self.header, self.i8_group)
        self.cache = init_kv_cache(self.header, 1, dtype=dtype, device=self.device)
        # the lanes' page pool (init_kv_pool)
        self.kv_pool = None
        self.kv_pool_epoch = 0
        self._kv_page_size = 0
        self._kv_pool_pages = 0
        self._kv_n_blocks = 0
        self._page_table = None  # host [B, n_blocks] int32, the truth
        self._pt_dev = None  # its copy on the device
        self._pt_dirty = False
        # plain counters: pool pages copied on the device (the COW forks)
        # and decode steps run by decode_lanes (each one forward of B rows)
        self.kv_copy_pages = 0
        self.lane_decode_steps = 0
        self._lane_seed_base = seed
        self._rng_calls = 0

    def reset(self) -> None:
        """Drop KV state (new conversation)."""
        for t in self.cache.values():
            t.zero_()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _last_logits(self, tokens: list[list[int]], pos: int) -> torch.Tensor:
        """Forward a [1, T] chunk at ``pos``; f32 logits of its last row [1, V]."""
        arr = torch.tensor(tokens, dtype=torch.int64, device=self.device)
        logits, self.cache = forward(
            self.params, self.header, arr, pos, self.cache, logits_mode="last"
        )
        return logits[:, -1, :]

    def _bucket_for(self, n: int, pos: int) -> int:
        """Smallest bucket covering n tokens whose PADDED extent still fits
        in the cache (the padded rows are written too)."""
        space = self.header.seq_len - pos
        fitting = [b for b in self.prefill_buckets if b <= space]
        if not fitting:
            return max(space, 1)
        for b in fitting:
            if n <= b:
                return b
        return fitting[-1]

    def prefill(self, tokens: list[int], pos: int = 0) -> StepStats:
        """Run all but the last prompt token through the cache (the last
        token is the decode loop's first input, reference: dllama.cpp:38-68)."""
        return self._prefill_rows([tokens], pos)

    def _prefill_rows(self, rows: list[list[int]], pos: int = 0) -> StepStats:
        """Chunked, bucketed prefill; everything but the last token enters
        the cache."""
        n = len(rows[0])
        if n < 1:
            raise ValueError("empty prompt")
        if pos + n - 1 > self.header.seq_len:
            raise ValueError(
                f"prompt of {n} tokens at pos {pos} exceeds seqLen {self.header.seq_len}"
            )
        fills = [row[:-1] for row in rows]
        total_ms = 0.0
        p = pos
        while fills[0]:
            bucket = self._bucket_for(len(fills[0]), p)
            width = min(bucket, len(fills[0]))
            # padding tokens write garbage into cache rows [p+width,
            # p+bucket): the causal mask hides them until real tokens
            # overwrite those positions
            padded = [fill[:width] + [0] * (bucket - width) for fill in fills]
            fills = [fill[width:] for fill in fills]
            t0 = time.perf_counter()
            self._last_logits(padded, p)
            self._sync()
            total_ms += (time.perf_counter() - t0) * 1000
            p += width
        return StepStats(time_ms=total_ms, n_tokens=max(n - 1, 0))

    def _block_width(self, pos: int, block: int) -> int:
        """The full block whenever it fits the cache, else the space left."""
        if pos + block <= self.header.seq_len:
            return block
        return self.header.seq_len - pos

    def decode_step(self, token: int, pos: int) -> tuple[int, StepStats]:
        """Feed ``token`` at ``pos``; return the next token (argmax when
        temperature is 0, else the host sampler; dllama.cpp:74-99)."""
        if pos >= self.header.seq_len:
            raise ValueError(
                f"decode position {pos} out of range (seqLen {self.header.seq_len})"
            )
        t0 = time.perf_counter()
        last = self._last_logits([[token]], pos)
        if self.temperature == 0.0:
            nxt = int(torch.argmax(last[0]).item())
        else:
            nxt = self.sampler.sample(last[0].cpu().numpy())
        return nxt, StepStats(time_ms=(time.perf_counter() - t0) * 1000, n_tokens=1)

    @torch.inference_mode()
    def decode_block(self, token: int, pos: int, n_steps: int) -> list[int]:
        """Greedy-decode up to ``n_steps`` tokens: each step's argmax feeds
        the next step on the device, and the block's tokens come back to
        the host in one readback."""
        n_steps = self._block_width(pos, n_steps)
        if n_steps <= 0:
            return []
        tok = torch.tensor([[token]], dtype=torch.int64, device=self.device)
        out = torch.empty(n_steps, dtype=torch.int64, device=self.device)
        for i in range(n_steps):
            logits, self.cache = forward(
                self.params, self.header, tok, pos + i, self.cache, logits_mode="last"
            )
            tok = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
            out[i] = tok[0, 0]
        return out.tolist()

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
        the reference's --steps. Greedy decoding runs in blocks of
        ``block_size``; a stop mid-block leaves the block's later KV rows as
        garbage that the causal mask hides and later writes overwrite."""
        max_pos = min(self.header.seq_len, start_pos + max_steps)
        eval_stats = self.prefill(prompt_tokens, pos=start_pos)
        pos = start_pos + len(prompt_tokens) - 1
        token = prompt_tokens[-1]
        out_tokens: list[int] = []
        pred_ms = 0.0
        greedy = self.temperature == 0.0
        while pos < max_pos:
            t0 = time.perf_counter()
            if greedy and block_size > 1:
                n = self._block_width(pos, block_size)
                toks = self.decode_block(token, pos, n)[: max_pos - pos]
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

    # -- lanes over the paged KV pool ------------------------------------------

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

    def init_kv_pool(self, page_size: int, n_pages: int = 0, native: bool = True) -> int:
        """Allocate the shared KV page pool ``[L, n_pages, KH, page_size,
        hd]`` per k/v leaf. Page 0 is scratch: parked lanes and unfilled
        page-table slots point there. ``n_pages`` <= 0 picks one sequence
        per lane plus two shareable ones: ``(batch_size + 2) * n_blocks +
        1``. Returns the page count.

        The JAX engine also requires ``page_size`` <= its lane padding,
        because its parked lanes write into padding rows; the port has no
        padding rows (parked lanes write to page 0) and no such limit. On
        the card the paged kernels take page sizes that divide 32 or are
        multiples of 32. ``native=False`` (slab lanes adopting and
        publishing by copies) is not ported: ROADMAP A.7."""
        if not native:
            raise NotImplementedError(
                "slab-mode lanes (kv_adopt/kv_publish copies) are not ported: ROADMAP A.7; "
                "use init_kv_pool(native=True)"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if self.device.type == "cuda" and ((32 % page_size) if page_size < 32 else (page_size % 32)):
            raise ValueError(
                f"page_size {page_size}: the paged kernels take sizes that divide 32 "
                "or are multiples of 32"
            )
        n_blocks = -(-self.header.seq_len // page_size)
        if n_pages <= 0:
            n_pages = (self.batch_size + 2) * n_blocks + 1
        if n_pages < 2:
            raise ValueError(f"a pool needs >= 2 pages (page 0 is scratch), got {n_pages}")
        self._kv_page_size = page_size
        self._kv_pool_pages = n_pages
        self._kv_n_blocks = n_blocks
        self._page_table = np.zeros((self.batch_size, n_blocks), np.int32)
        self._pt_dev = torch.zeros((self.batch_size, n_blocks), dtype=torch.int32,
                                   device=self.device)
        self._pt_dirty = False
        self.kv_pool = None  # free the old pool before the new one exists
        h = self.header
        shape = (h.n_layers, n_pages, h.n_kv_heads, page_size, h.head_dim)
        self.kv_pool = {k: torch.zeros(shape, dtype=self.dtype, device=self.device)
                        for k in ("k", "v")}
        self.kv_pool_epoch += 1
        return n_pages

    def reset_kv_pool(self) -> None:
        """Zero the pool and every page-table row. The caller resets its
        host-side page accounting to match."""
        self._require_kv_pool()
        for t in self.kv_pool.values():
            t.zero_()
        self.kv_pool_epoch += 1
        self.clear_all_lane_pages()

    def adopt_pages(self, lane: int, page_ids: list[int]) -> None:
        """Point ``lane``'s page-table row at ``page_ids`` (slot i backs rows
        [i*ps, (i+1)*ps)); unfilled slots fall back to page 0. No device
        work but the table's copy before the next dispatch."""
        self._require_kv_pool()
        self._check_lane(lane)
        if len(page_ids) > self._kv_n_blocks:
            raise ValueError(f"{len(page_ids)} pages exceed {self._kv_n_blocks} blocks")
        if any(not 0 <= p < self._kv_pool_pages for p in page_ids):
            raise ValueError(f"page ids outside the pool of {self._kv_pool_pages} pages")
        row = self._page_table[lane]
        row[:] = 0
        row[: len(page_ids)] = np.asarray(page_ids, np.int32)
        self._pt_dirty = True

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
        every layer (the COW fork of a mid-page adoption)."""
        self._require_kv_pool()
        n = len(src_ids)
        if n < 1 or len(dst_ids) != n:
            raise ValueError("src/dst page lists must match and be non-empty")
        src = torch.tensor(src_ids, dtype=torch.int64, device=self.device)
        dst = torch.tensor(dst_ids, dtype=torch.int64, device=self.device)
        for t in self.kv_pool.values():
            t[:, dst] = t[:, src]
        self.kv_copy_pages += n

    @torch.inference_mode()
    def prefill_lane_chunk(self, lane: int, tokens: list[int], pos0: int,
                           budget: int | None = None) -> int:
        """Write ONE bucket-shaped chunk of ``tokens`` (fill rows: the
        caller already dropped the prompt's final token) into ``lane``'s
        pages at ``pos0``; returns how many tokens it consumed. ``budget``
        caps the chunk width. Bucket padding writes rows past the tokens,
        inside the lane's own pages (every slot from the match point on is
        private: the manager forks a shared mid-page boundary); later
        writes overwrite them before any query can see them."""
        self._require_kv_pool()
        self._check_lane(lane)
        n = len(tokens)
        if n < 1:
            raise ValueError("empty chunk")
        if pos0 < 0 or pos0 + n > self.header.seq_len:
            raise ValueError(f"{n} fill tokens at pos {pos0} exceed seqLen {self.header.seq_len}")
        want = min(n, budget) if budget and budget > 0 else n
        bucket = self._bucket_for(want, pos0)
        width = min(bucket, want)
        chunk = torch.tensor([tokens[:width] + [0] * (bucket - width)], dtype=torch.int64,
                             device=self.device)
        forward(self.params, self.header, chunk, pos0, self.kv_pool, logits_mode="none",
                page_table=self._page_table_dev()[lane : lane + 1])
        return width

    def prefill_lane(self, lane: int, tokens: list[int], pos0: int = 0) -> None:
        """Prefill one lane's prompt (all but the last token) chunk by
        chunk; the other lanes' pages are untouched."""
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
        self._require_kv_pool()
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
        self._rng_calls += 1
        # unseeded lanes draw from an engine-lifetime stream (varies per
        # call); a seeded lane's draws depend only on (seed, position)
        seed_vec = [
            (s if s is not None else self._lane_seed_base + 1_000_003 * self._rng_calls + i)
            & 0x7FFFFFFF
            for i, s in enumerate(seeds or [None] * b)
        ]
        dev = self.device
        # every step's positions, -1 for parked lanes and past the cache:
        # one host-to-device copy a block
        cur = torch.tensor(
            [[pos[j] + i if active[j] and 0 <= pos[j] + i < seq_len else -1 for j in range(b)]
             for i in range(n_steps)],
            dtype=torch.int32, device=dev,
        )
        sampled = any(active[j] and temperature[j] > 0.0 for j in range(b))
        if sampled:
            temps = torch.tensor(temperature, dtype=torch.float32, device=dev)
            topps = torch.tensor(topp, dtype=torch.float32, device=dev)
            seed_t = torch.tensor(seed_vec, dtype=torch.int64, device=dev)
        tok = torch.tensor([[t] for t in tokens], dtype=torch.int64, device=dev)
        out = torch.empty((n_steps, b), dtype=torch.int64, device=dev)
        pt = self._page_table_dev()
        for i in range(n_steps):
            logits, _ = forward(self.params, self.header, tok, cur[i], self.kv_pool,
                                logits_mode="last", page_table=pt)
            last = logits[:, -1, :]
            if sampled:
                nxt = sample_per_lane(last, temps, topps, seed_t, cur[i])
            else:
                nxt = torch.argmax(last, dim=-1)
            nxt = torch.where(cur[i] >= 0, nxt, 0)
            out[i] = nxt
            tok = nxt[:, None]
        self.lane_decode_steps += n_steps
        return out.tolist()

    def generate_batch(self, prompts: list[list[int]], max_steps: int,
                       block_size: int = 8) -> list[list[int]]:
        """Decode independent sequences, one per lane (``batch_size ==
        len(prompts)``); prompts may differ in length. Each lane gets the
        private pages ``1 + lane * n_blocks ...`` (the pool must hold
        ``batch_size * n_blocks + 1`` pages), prefills on its own and
        decodes from its own position; ``max_steps`` caps each lane's
        absolute position, as in `generate`. Greedy or sampled per the
        engine temperature; returns the lanes' token lists."""
        if len(prompts) != self.batch_size:
            raise ValueError(f"{len(prompts)} prompts for batch_size {self.batch_size}")
        self._require_kv_pool()
        nb = self._kv_n_blocks
        if self._kv_pool_pages < self.batch_size * nb + 1:
            raise ValueError(f"generate_batch needs {self.batch_size * nb + 1} pool pages, "
                             f"the pool has {self._kv_pool_pages}")
        max_pos = min(self.header.seq_len, max_steps)
        for lane, p in enumerate(prompts):
            if not p:
                raise ValueError(f"lane {lane}: empty prompt")
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
