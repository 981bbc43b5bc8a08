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
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..device import resolve_device
from ..formats.model_file import LlmHeader, ModelReader
from ..formats.quants import FloatType
from ..models import forward, init_kv_cache, load_params
from ..ops.int8_matmul import pick_group, requantize_params
from .sampler import Sampler

# Prefill chunk buckets (the reference's --nBatches role; the JAX engine
# compiles one program per bucket, the port keeps the same chunking).
PREFILL_BUCKETS = (1, 8, 32, 128, 512)


@dataclasses.dataclass
class StepStats:
    """Per-forward timing surface (reference: dllama.cpp:59-66,88-95)."""

    time_ms: float
    n_tokens: int


class InferenceEngine:
    """See module docstring. One sequence (batch 1)."""

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
    ):
        self.device = resolve_device(device)
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
