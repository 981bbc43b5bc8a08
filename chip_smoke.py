#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each fatal on failure (a non-zero exit and no result line):

1. The card (``nvidia-smi`` name and power limit, torch's device name) and
   the build of the seven CUDA sources from csrc/ (one nvcc each, in
   parallel), with its seconds.
2. Each kernel against its plain PyTorch version on the card at main-path
   shapes: Llama-8B (D 4096, F 14336, 32 heads, 8 KV heads, head dim 128,
   vocab 128256) for the three matmul kernels (Q40, packed nibbles, grouped
   int8 at G 512, and at Qwen3-30B-A3B's G 256) and attention, attention
   again at Qwen3-30B-A3B's 4 KV heads, and the four MoE kernels at A3B's
   D 2048, F 768, 128 experts, 8 active, with random routing. Each row: max
   normalized error max|k - p| / max|p|, kernel ms, plain ms, the bound
   (bytes over 3.35 TB/s or operations over the H100 SXM datasheet peak of
   their type) and one PyTorch library call's ms as a yardstick
   (torch.matmul on the dequantized weight, scaled_dot_product_attention;
   none for the MoE kernels: no single PyTorch call computes a routed
   SwiGLU MoE). The packed-nibble rows also hold the kernel against the Q40
   kernel on the unpacked twin (the same code but for the weight fetch:
   printed, with whether the bits are equal); the int8 rows at m = 512 also
   time ``torch._int_mm`` (cuBLASLt's int8 product, no group scales).
3. End to end, six runs on three random Q40 ``.m`` files (max_seq_len
   4096; each with a padded byte-level ``.t``, written with the port's
   writers to a temp dir of its own, deleted before the next), each the
   port's ``inference`` CLI path: a ~500-token prompt and 128 greedy
   tokens. llama-8b (32 layers) with ``--weight-format q40``, ``q40i4`` and
   ``q40i8``; qwen3-30b-a3b (48 layers) with ``auto`` (Q40 on the card) and
   ``q40i8`` (experts stay Q40); qwen3-30b-a3b at 4 layers with ``dense``
   (bf16 experts: full depth would be 60 GB of them). Load s, prefill ms,
   decode ms/token and tok/s, each kernel's launches in that run (the
   path's kernels must be > 0, and all equal what the shapes imply), the
   weight-read bound per token, the weight bytes and
   ``torch.cuda.memory_allocated`` on the card and, for the quantized runs,
   a decode profile. Whether the q40i4 and q40i8 greedy streams equal the
   q40 one is printed, not gated.
4. End-to-end parity for each path: one prefill and one decode step
   through the kernel path and through the plain path (``forward(...,
   plain=True)``) on the same weights: logits' normalized error and top-1
   agreement, and for Qwen3-MoE how many (layer, token) top-k expert sets
   the two paths chose differently. The float32 comparison is the gate; the
   bfloat16 ones are printed beside it. For q40i8 the gated plain run takes
   the kernel run's int8 activations, and the inputs of its int8 matmuls
   are gated too (see `parity`).
5. A ``{"kernels": [...]}`` JSON line; last, the device JSON line.

Imports nothing of JAX or dllama_tpu.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
BF16_FLOPS = 989e12  # H100 SXM datasheet, dense
F32_FLOPS = 67e12  # H100 SXM datasheet, outside the tensor cores
INT8_OPS = 1979e12  # H100 SXM datasheet, dense
# normalized error of kernels with f32 outputs from f32 inputs, or from
# bf16 inputs where no bf16 rounding follows a sum: kernel and plain version
# share every rounding and differ in sum order only. The largest reading on
# an H100 was 5.6e-6 (q40_matmul m=512 k=14336); a kernel that kept the
# dequantized weight in f32 where the plain version rounds it to bf16 reads
# ~1e-3
TOL = 1e-4
TOL_BF16_OUT = 2.0**-7  # bf16 outputs: one rounding step
# the MoE kernels' bf16 runs, whose f32 outputs follow a bf16 rounding of
# the SwiGLU hidden after a sum whose order differs: a few hidden units flip
# by one bf16 step. Set between the largest sound reading and what a kernel
# that skips a bf16 rounding reads (check_moe prints and gates both; the
# readings are in PERF.md)
TOL_MOE_BF16 = 5e-4
TOL_E2E = 2e-2  # f32 logits after the whole model (and q40i8's int8 inputs), kernel vs plain path
SEED = 0
PROMPT_TOKENS = 500
DECODE_TOKENS = 128
N_LAYERS = 32  # the whole llama-8b depth
MOE_LAYERS = 48  # the whole qwen3-30b-a3b depth (q40 path)
MOE_DENSE_LAYERS = 4  # dense path: bf16 experts are 1.26 GB a layer
# model file -> (its label, preset, layers, the weight formats run on it)
MODELS = [
    ("llama-8b", "llama-8b", N_LAYERS, ("q40", "q40i4", "q40i8")),
    ("qwen3-30b-a3b", "qwen3-30b-a3b", MOE_LAYERS, ("auto", "q40i8")),
    ("qwen3-30b-a3b", "qwen3-30b-a3b", MOE_DENSE_LAYERS, ("dense",)),
]

Q40_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
REPLACES = {
    "q40_matmul": "dllama_tpu/ops/quant_matmul.py:289",
    "q40i4_matmul": "dllama_tpu/ops/quant_matmul.py:334",
    "i8_matmul": "dllama_tpu/ops/int8_matmul.py:157",
    "flash_attention_stats": "dllama_tpu/ops/flash_attention.py:166",
    "flash_decode": "dllama_tpu/ops/flash_attention.py:404",
    "moe_active_experts": "dllama_tpu/ops/moe_kernel.py:213",
    "moe_active_experts_q40": "dllama_tpu/ops/moe_kernel.py:250",
    "moe_grouped_experts": "dllama_tpu/ops/moe_kernel.py:449",
    "moe_grouped_experts_q40": "dllama_tpu/ops/moe_kernel.py:563",
}
SOURCES = {
    "q40_matmul": "dllama_tpu_torch/csrc/q40_matmul.cu",
    "q40i4_matmul": "dllama_tpu_torch/csrc/q40i4_matmul.cu",
    "i8_matmul": "dllama_tpu_torch/csrc/i8_matmul.cu",
    "flash_attention_stats": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode": "dllama_tpu_torch/csrc/flash_decode.cu",
    "moe_active_experts": "dllama_tpu_torch/csrc/moe_active.cu",
    "moe_active_experts_q40": "dllama_tpu_torch/csrc/moe_active.cu",
    "moe_grouped_experts": "dllama_tpu_torch/csrc/moe_grouped.cu",
    "moe_grouped_experts_q40": "dllama_tpu_torch/csrc/moe_grouped.cu",
}
# the row of phase 2 whose times stand in the kernels line
KERNEL_ROW_SHAPE = {
    "q40_matmul": "m=1 k=4096 n=14336",
    "q40i4_matmul": "m=1 k=4096 n=14336",
    "i8_matmul": "m=1 k=4096 n=14336 G=512",
    "flash_attention_stats": "H=32 KH=8 T=512 S=4096 pos=3584",
    "flash_decode": "H=32 KH=8 S=4096 pos=4095",
    "moe_active_experts": "bf16 m=1",
    "moe_active_experts_q40": "bf16 m=1",
    "moe_grouped_experts": "bf16 N=512",
    "moe_grouped_experts_q40": "bf16 N=512",
}
MOE_SHAPE = dict(e=128, d=2048, f=768, k=8)  # Qwen3-30B-A3B experts


class SmokeError(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def bound(n_bytes: float, ops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) for n_bytes moved and ops done at ``peak``."""
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def norm_err(a, b) -> tuple[float, float]:
    """(max normalized error, max absolute error) of a against reference b."""
    d = (a.float() - b.float()).abs().max().item()
    return d / max(b.float().abs().max().item(), 1e-30), d


def time_ms(fn, device, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events. A 256 MB memset
    before each call evicts the 50 MB L2 (the main path finds its weights
    cold) and keeps the card busy while the host enqueues the call."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    fn()
    torch.cuda.synchronize(device)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def random_q40(n: int, k: int, device, gen):
    """A random Q40 weight [n, k]: values in [-8, 7], f16 scales of either sign."""
    import torch

    from dllama_tpu_torch.ops.quant_matmul import QuantWeight

    q = torch.randint(-8, 8, (n, k), dtype=torch.int8, device=device, generator=gen)
    d = ((torch.rand((n, k // 32), device=device, generator=gen) + 0.5) * 0.004).half()
    d = torch.where(torch.rand_like(d.float()) < 0.5, -d, d).contiguous()
    return QuantWeight(q, d)


def check_q40(device, gen, timed: bool = True) -> list[dict]:
    import torch

    from dllama_tpu_torch.ops.quant_matmul import dequant, qmatmul, qmatmul_ref

    rows = []
    for k, n in Q40_SHAPES:
        w = random_q40(n, k, device, gen)
        w_bf16 = dequant(w, torch.bfloat16)  # the library yardstick's operand
        for m in (1, 512):
            x = torch.randn((m, k), device=device, generator=gen).to(torch.bfloat16)
            kern, plain = qmatmul(x, w), qmatmul_ref(x, w)
            torch.cuda.synchronize(device)
            rel, absd = norm_err(kern, plain)
            require(rel <= TOL, f"q40_matmul m={m} k={k} n={n}: error {rel:.3e} > {TOL}")
            n_bytes = m * k * 2 + n * k + n * (k // 32) * 2 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k)
            row = dict(
                name="q40_matmul", shape=f"m={m} k={k} n={n}", err=rel, max_abs_err=absd,
                bound_ms=b_ms, bound_by=b_by,
            )
            if timed:
                row["ms"] = time_ms(lambda: qmatmul(x, w), device)
                row["plain_ms"] = time_ms(lambda: qmatmul_ref(x, w), device, reps=5)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, w_bf16.t()), device)
            rows.append(row)
        del w, w_bf16
    return rows


def _x_cases(k: int, n: int):
    """(m, dtype) of the matmul rows at one shape: bf16 x at m = 1 and 512,
    and f32 x too at llama-8b's w1/w3 shape."""
    import torch

    dtypes = [torch.bfloat16] + ([torch.float32] if (k, n) == (4096, 14336) else [])
    return [(m, dtype) for dtype in dtypes for m in (1, 512)]


def check_q40i4(device, gen, timed: bool = True) -> list[dict]:
    """The packed-nibble kernel against its plain version at the Q40 shapes,
    and against the Q40 kernel on the unpacked twin: the two share every
    line but the weight fetch, so their bits should be equal (printed)."""
    import torch

    from dllama_tpu_torch.ops.quant_matmul import (
        dequant,
        pack_nibbles,
        qmatmul,
        qmatmul_i4,
        qmatmul_ref,
    )

    rows = []
    for k, n in Q40_SHAPES:
        w = random_q40(n, k, device, gen)
        pw = pack_nibbles(w)
        for m, dtype in _x_cases(k, n):
            f32 = dtype == torch.float32
            x = torch.randn((m, k), device=device, generator=gen).to(dtype)
            kern, plain, twin = qmatmul_i4(x, pw), qmatmul_ref(x, pw), qmatmul(x, w)
            torch.cuda.synchronize(device)
            rel, absd = norm_err(kern, plain)
            shape = f"{'f32 ' if f32 else ''}m={m} k={k} n={n}"
            require(rel <= TOL, f"q40i4_matmul {shape}: error {rel:.3e} > {TOL}")
            n_bytes = m * k * x.element_size() + n * k // 2 + n * (k // 32) * 2 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, F32_FLOPS if f32 else BF16_FLOPS)
            row = dict(
                name="q40i4_matmul", shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                bound_by=b_by, twin_err=norm_err(kern, twin)[0], twin_equal=torch.equal(kern, twin),
            )
            if timed:
                dense = dequant(w, dtype)  # the library yardstick's operand
                row["ms"] = time_ms(lambda: qmatmul_i4(x, pw), device)
                row["plain_ms"] = time_ms(lambda: qmatmul_ref(x, pw), device, reps=5)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, dense.t()), device)
                del dense
            rows.append(row)
        del w, pw
    return rows


def check_i8(device, gen, timed: bool = True) -> list[dict]:
    """The grouped-int8 kernel against its plain version on the same
    quantized operands: G 512 at the Q40 shapes and G 256 (Qwen3-30B-A3B's)
    at k 2048 n 4096. Both form the same exact group dots, scaled alike and
    added in group order, so they should give the same bits (printed). The m = 512 rows
    also time torch._int_mm on xq and q (cuBLASLt's int8 product without
    the group scales), a yardstick that is printed, not gated."""
    import torch

    from dllama_tpu_torch.ops.int8_matmul import (
        i8matmul_2d,
        i8matmul_2d_ref,
        quantize_acts,
        requantize_q40,
    )

    rows = []
    for k, n, group in [(k, n, 512) for k, n in Q40_SHAPES] + [(2048, 4096, 256)]:
        w = requantize_q40(random_q40(n, k, device, gen), group)
        ng = k // group
        for m, dtype in _x_cases(k, n):
            f32 = dtype == torch.float32
            x = torch.randn((m, k), device=device, generator=gen).to(dtype)
            xq, sx = quantize_acts(x, group)
            kern, plain = i8matmul_2d(xq, sx, w), i8matmul_2d_ref(xq, sx, w)
            torch.cuda.synchronize(device)
            rel, absd = norm_err(kern, plain)
            shape = f"{'f32 ' if f32 else ''}m={m} k={k} n={n} G={group}"
            require(rel <= TOL, f"i8_matmul {shape}: error {rel:.3e} > {TOL}")
            n_bytes = m * k + m * ng * 4 + n * k + n * ng * 4 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, INT8_OPS)
            row = dict(
                name="i8_matmul", shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                bound_by=b_by, plain_equal=torch.equal(kern, plain),
            )
            if timed:
                dense = (w.q.float().view(n, ng, group) * w.s[..., None]).view(n, k).to(dtype)
                row["ms"] = time_ms(lambda: i8matmul_2d(xq, sx, w), device)
                row["plain_ms"] = time_ms(lambda: i8matmul_2d_ref(xq, sx, w), device, reps=5)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, dense.t()), device)
                del dense
                if m == 512:
                    qt = w.q.t()
                    row["int_mm_ms"] = time_ms(lambda: torch._int_mm(xq, qt), device)
            rows.append(row)
        del w
    return rows


def _sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call, with GQA in the call."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def check_attention(device, gen, timed: bool = True, h: int = 32, kh: int = 8) -> list[dict]:
    """Both attention kernels at h query heads over kh KV heads (llama-8b:
    32 / 8; qwen3-30b-a3b: 32 / 4)."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_ref,
        flash_decode,
        flash_decode_ref,
    )

    hd, t = 128, 512
    heads = f"H={h} KH={kh}"
    rows = []

    def cache(s):
        kk = torch.randn((1, kh, s, hd), device=device, generator=gen).to(torch.bfloat16)
        vv = torch.randn((1, kh, s, hd), device=device, generator=gen).to(torch.bfloat16)
        return kk, vv

    for s, pos in ((512, 0), (4096, 3584)):
        q = torch.randn((1, t, h, hd), device=device, generator=gen).to(torch.bfloat16)
        k, v = cache(s)
        got = flash_attention_stats(q, k, v, pos)
        ref = flash_attention_stats_ref(q, k, v, pos)
        torch.cuda.synchronize(device)
        errs = [norm_err(a, b) for a, b in zip(got, ref)]
        rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= TOL, f"flash_attention_stats S={s} pos={pos}: error {rel:.3e} > {TOL}")
        vis = sum(min(s, pos + i + 1) for i in range(t))
        n_bytes = q.numel() * 2 + 2 * kh * min(s, pos + t) * hd * 2 + h * t * (hd + 2) * 4
        b_ms, b_by = bound(n_bytes, 4.0 * hd * h * vis)
        row = dict(
            name="flash_attention_stats", shape=f"{heads} T={t} S={s} pos={pos}", err=rel,
            max_abs_err=absd, bound_ms=b_ms, bound_by=b_by,
        )
        if timed:
            qpos = pos + torch.arange(t, device=device)
            mask = torch.arange(pos + t, device=device)[None, :] <= qpos[:, None]
            qs = q.transpose(1, 2)
            ks, vs = k[:, :, : pos + t], v[:, :, : pos + t]
            row["ms"] = time_ms(lambda: flash_attention_stats(q, k, v, pos), device)
            row["plain_ms"] = time_ms(lambda: flash_attention_stats_ref(q, k, v, pos), device, 5)
            row["library_ms"] = time_ms(lambda: _sdpa(qs, ks, vs, mask), device)
        rows.append(row)

    k, v = cache(4096)
    for pos in (0, 511, 4095):
        q = torch.randn((1, 1, h, hd), device=device, generator=gen).to(torch.bfloat16)
        got, ref = flash_decode(q, k, v, pos), flash_decode_ref(q, k, v, pos)
        torch.cuda.synchronize(device)
        rel, absd = norm_err(got, ref)
        require(rel <= TOL_BF16_OUT, f"flash_decode pos={pos}: error {rel:.3e} > {TOL_BF16_OUT}")
        n_bytes = q.numel() * 2 * 2 + 2 * kh * (pos + 1) * hd * 2
        b_ms, b_by = bound(n_bytes, 4.0 * hd * h * (pos + 1))
        row = dict(
            name="flash_decode", shape=f"{heads} S=4096 pos={pos}", err=rel, max_abs_err=absd,
            bound_ms=b_ms, bound_by=b_by,
        )
        if timed:
            qs = q.transpose(1, 2)
            ks, vs = k[:, :, : pos + 1], v[:, :, : pos + 1]
            row["ms"] = time_ms(lambda: flash_decode(q, k, v, pos), device)
            row["plain_ms"] = time_ms(lambda: flash_decode_ref(q, k, v, pos), device, 5)
            row["library_ms"] = time_ms(lambda: _sdpa(qs, ks, vs, None), device)
        rows.append(row)
    return rows


def check_moe(device, gen, timed: bool = True) -> list[dict]:
    """The four MoE kernels against `moe_experts_ref` at the A3B expert
    shapes with random routing: active at m = 1 and 16, grouped at N = 17
    and 512, bf16 x over dense bf16 and Q40 experts, and f32 x at m = 16 and
    N = 512 (kernel and plain share every rounding there: TOL). Each bf16
    row also reads the plain version with one of its bf16 roundings
    skipped (the hidden's; for Q40 the dequantized weight's) against the
    sound one: such a fault must read above TOL_MOE_BF16, or the limit
    could not catch it."""
    from unittest import mock

    import torch

    from dllama_tpu_torch.ops import moe
    from dllama_tpu_torch.ops.quant_matmul import QuantWeight, dequant

    e, d, f, k = (MOE_SHAPE[key] for key in ("e", "d", "f", "k"))

    def q40(rows, cols):
        q = torch.randint(-8, 8, (e, rows, cols), dtype=torch.int8, device=device, generator=gen)
        sc = ((torch.rand((e, rows, cols // 32), device=device, generator=gen) + 0.5) * 0.004)
        sc = torch.where(torch.rand(sc.shape, device=device, generator=gen) < 0.5, -sc, sc)
        return QuantWeight(q, sc.half().contiguous())

    qw = [q40(f, d), q40(d, f), q40(f, d)]  # w1, w2, w3
    dense = {torch.bfloat16: [dequant(w, torch.bfloat16) for w in qw]}
    dense[torch.float32] = [w.float() for w in dense[torch.bfloat16]]
    cases = [
        ("moe_active_experts", 1, torch.bfloat16), ("moe_active_experts", 16, torch.bfloat16),
        ("moe_active_experts", 16, torch.float32),
        ("moe_active_experts_q40", 1, torch.bfloat16),
        ("moe_active_experts_q40", 16, torch.bfloat16),
        ("moe_active_experts_q40", 16, torch.float32),
        ("moe_grouped_experts", 17, torch.bfloat16), ("moe_grouped_experts", 512, torch.bfloat16),
        ("moe_grouped_experts", 512, torch.float32),
        ("moe_grouped_experts_q40", 17, torch.bfloat16),
        ("moe_grouped_experts_q40", 512, torch.bfloat16),
        ("moe_grouped_experts_q40", 512, torch.float32),
    ]
    rows = []
    for name, n, dtype in cases:
        quant = name.endswith("_q40")
        ws = qw if quant else dense[dtype]
        fn = getattr(moe, name)
        x = torch.randn((n, d), device=device, generator=gen).to(dtype)
        top_i = torch.rand((n, e), device=device, generator=gen).topk(k, dim=-1).indices.int()
        wts = torch.rand((n, k), device=device, generator=gen) + 0.1
        wts = wts / wts.sum(-1, keepdim=True)
        before = fn.launches
        got, ref = fn(x, *ws, top_i, wts), moe.moe_experts_ref(x, *ws, top_i, wts)
        torch.cuda.synchronize(device)
        require(fn.launches == before + 1, f"{name}: the wrapper did not launch its kernel")
        rel, absd = norm_err(got, ref)
        tol = TOL if dtype == torch.float32 else TOL_MOE_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        require(rel <= tol, f"{name} {tag} n={n}: error {rel:.3e} > {tol}")
        unrounded = {}
        if dtype == torch.bfloat16:
            # x in f32 over the bf16-rounded weights: the hidden is not rounded
            faults = {"hidden": moe.moe_experts_ref(x.float(), *dense[dtype], top_i, wts)}
            if quant:  # the dequantized weight kept exact in f32
                expert = moe._expert
                with mock.patch.object(moe, "_expert", lambda w, i, _: expert(w, i, torch.float32)):
                    faults["weight"] = moe.moe_experts_ref(x, *ws, top_i, wts)
            for what, fault in faults.items():
                unrounded[what] = norm_err(fault, ref)[0]
                require(unrounded[what] > tol, f"{name} bf16 n={n}: skipping the {what} rounding "
                        f"reads {unrounded[what]:.3e}, within the limit {tol}")
        n_exp = int(torch.unique(top_i).numel())
        w_bytes = sum((w.q.numel() + w.d.numel() * 2) if quant else w.numel() * w.element_size()
                      for w in ws) // e
        n_bytes = n_exp * w_bytes + x.numel() * x.element_size() + n * d * 4 + n * k * 8
        b_ms, b_by = bound(n_bytes, 6.0 * n * k * d * f)
        row = dict(
            name=name, shape=f"{tag} {'m' if 'active' in name else 'N'}={n}", err=rel,
            max_abs_err=absd, bound_ms=b_ms, bound_by=b_by, experts=n_exp, library_ms=None,
            unrounded=unrounded,
        )
        if timed:
            row["ms"] = time_ms(lambda: fn(x, *ws, top_i, wts), device)
            row["plain_ms"] = time_ms(lambda: moe.moe_experts_ref(x, *ws, top_i, wts), device, 5)
        rows.append(row)
    return rows


def write_tokenizer_file(path: str, vocab_size: int) -> None:
    """Byte-level `.t`: 256 byte tokens, padding tokens up to the model's
    vocab, then BOS and two EOS specials."""
    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer

    specials = [b"<s>", b"</s>", b"<|eot|>"]
    vocab = [bytes([i]) for i in range(256)]
    vocab += [f"<pad{i}>".encode() for i in range(256, vocab_size - len(specials))]
    bos = len(vocab)
    vocab += specials
    write_tokenizer(
        path,
        TokenizerData(
            vocab=vocab, scores=[0.0] * len(vocab), bos_id=bos, add_bos=True,
            eos_token_ids=[bos + 1, bos + 2], chat_template=None,
            max_token_length=max(len(v) for v in vocab),
        ),
    )


def prompt_text(n_bytes: int) -> str:
    base = (
        "Distributed inference splits a large language model across devices so that "
        "each one holds a slice of every weight matrix and the slices meet again in "
        "an all-reduce after the attention and feed-forward blocks. "
    )
    return (base * (n_bytes // len(base) + 1))[:n_bytes]


def model_file_bytes(preset: str | dict, n_layers: int | None, max_seq_len: int) -> int:
    from dllama_tpu_torch.formats.model_file import tensor_plan
    from dllama_tpu_torch.models.synthetic import PRESETS, make_header

    cfg = dict(PRESETS[preset]) if isinstance(preset, str) else dict(preset)
    if n_layers:
        cfg["n_layers"] = n_layers
    last = tensor_plan(make_header(cfg, max_seq_len))[-1]
    return last.offset + last.nbytes


def end_to_end(device: str, preset: str | dict, n_layers: int | None, prompt_tokens: int,
               decode_tokens: int, max_seq_len: int, seed: int, tmp: str,
               weight_format: str = "auto") -> dict:
    """Phase 3: write the model into tmp (unless a run before wrote it),
    run the port's inference CLI path."""
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    write_s = None
    if not os.path.exists(mp):
        need = model_file_bytes(preset, n_layers, max_seq_len)
        free = shutil.disk_usage(tmp).free
        require(free > need + (2 << 30),
                f"{preset}: {need / 1e9:.1f} GB model, {free / 1e9:.1f} GB free")
        t0 = time.perf_counter()
        h = write_synth_model(mp, preset, seed=seed, max_seq_len=max_seq_len, n_layers=n_layers)
        write_tokenizer_file(tp, h.vocab_size)
        write_s = time.perf_counter() - t0
    text = prompt_text(prompt_tokens - 1)  # one token per byte, plus BOS
    reset_launch_counts()
    res = cli.main([
        "inference", "--model", mp, "--tokenizer", tp, "--prompt", text,
        "--steps", str(prompt_tokens - 1 + decode_tokens), "--temperature", "0",
        "--device", device, "--seed", str(seed), "--weight-format", weight_format,
    ])
    counts = launch_counts()
    res.update(header=res["engine"].header, write_s=write_s, counts=counts, model_path=mp)
    return res


def forward_rows(n_prompt: int, n_decode: int) -> list[int]:
    """Rows of each forward the engine runs: the padded prefill buckets of
    all but the last prompt token, then one row a decoded token."""
    from dllama_tpu_torch.runtime.engine import PREFILL_BUCKETS as buckets

    rows, left = [], n_prompt - 1
    while left > 0:
        bucket = next((b for b in buckets if left <= b), buckets[-1])
        rows.append(bucket)
        left -= min(bucket, left)
    return rows + [1] * n_decode


# weight format -> the kernel of its attention, FFN and classifier matmuls
MATMUL_KERNEL = {"q40": "q40_matmul", "q40i4": "q40i4_matmul", "q40i8": "i8_matmul"}


def expected_launches(h, n_prompt: int, n_decode: int, weight_format: str) -> dict:
    """Launches the shapes imply. Per forward of n rows and L layers: the
    format's matmul kernel 7 a layer + the classifier (4 a layer for
    Qwen3-MoE, whose experts are not matmuls), none with dense weights; one
    attention a layer (stats for n > 1, decode for 1); for Qwen3-MoE one MoE
    kernel a layer, the active-experts one for n <= 16, else the grouped
    one, on Q40 experts under every quantized format."""
    from dllama_tpu_torch.ops import KERNELS
    from dllama_tpu_torch.ops.moe import MOE_KERNEL_MAX_TOKENS

    moe, n_l = h.is_moe, h.n_layers
    matmul = MATMUL_KERNEL.get(weight_format)
    want = dict.fromkeys(KERNELS, 0)
    for n in forward_rows(n_prompt, n_decode):
        if matmul:
            want[matmul] += (4 if moe else 7) * n_l + 1
        want["flash_attention_stats" if n > 1 else "flash_decode"] += n_l
        if moe:
            kind = "active" if n <= MOE_KERNEL_MAX_TOKENS else "grouped"
            want[f"moe_{kind}_experts{'_q40' if matmul else ''}"] += n_l
    return want


def nbytes(v) -> int:
    """Bytes of every tensor in v: a tensor, or a list, tuple (a quantized
    weight: values and scales) or dict of them."""
    import torch

    if torch.is_tensor(v):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple, dict)):
        return sum(nbytes(x) for x in (v.values() if isinstance(v, dict) else v))
    return 0


def weight_bytes(params, h) -> int:
    """Weight bytes one decoded token reads: every non-expert matmul weight
    (values and scales) and, in a MoE layer, the f32 gate and k of the E
    experts."""
    total = nbytes(params["wcls"])
    for lp in params["layers"]:
        total += sum(nbytes(lp[key]) for key in ("wq", "wk", "wv", "wo"))
        ffn = sum(nbytes(lp[key]) for key in ("w1", "w2", "w3"))
        if h.is_moe:
            total += nbytes(lp["moe_gate"]) + ffn * h.n_active_experts // h.n_experts
        else:
            total += ffn
    return total


class ActTape:
    """The int8 activations of one forward through the kernel path, handed
    to the plain path (``forward(..., act_quant=...)``). `record` quantizes
    as the engine does and keeps each int8 matmul's input x with its (xq,
    sx), in call order; `replay` gives the plain path the recorded (xq, sx)
    of the same call, and measures how far its own x lies from the
    recorded one (max normalized error over the calls) and how many of its
    int8 values would have rounded otherwise."""

    def __init__(self):
        self.calls, self.at, self.err, self.flips, self.values = [], 0, 0.0, 0, 0

    def record(self, x, group):
        from dllama_tpu_torch.ops.int8_matmul import quantize_acts

        xq, sx = quantize_acts(x, group)
        self.calls.append((x, xq, sx))
        return xq, sx

    def replay(self, x, group):
        from dllama_tpu_torch.ops.int8_matmul import quantize_acts

        require(self.at < len(self.calls), "act tape: more int8 matmuls than were recorded")
        x_rec, xq, sx = self.calls[self.at]
        self.at += 1
        require(x.shape == x_rec.shape, f"act tape: call {self.at} takes {tuple(x.shape)}, "
                f"recorded {tuple(x_rec.shape)}")
        self.err = max(self.err, norm_err(x, x_rec)[0])
        self.flips += int((quantize_acts(x, group)[0] != xq).sum())
        self.values += xq.numel()
        return xq, sx


KERNEL, PLAIN, SHARED = "kernel", "plain", "plain, shared int8 activations"


def parity(engine, prompt: list[int]) -> dict:
    """Phase 4: one prefill + one decode step through the kernel path and
    the plain path on the same weights, in float32 (where the two paths
    share every rounding and differ only in summation order) and in the
    engine's bfloat16. Returns the errors and top-1/top-5 agreement of
    each pair, and for a MoE model how many (layer, token) top-k expert
    sets the two paths chose differently (a near-tie flip swaps a whole
    expert's output). main() gates on the float32 pair only, since in
    bfloat16 a changed sum order flips roundings that the layers amplify
    to the size of bfloat16's own distance from float32 (printed as
    controls).

    With int8 weights (q40i8) the same happens in float32: each matmul
    quantizes its activations per group, a step function, so the last-bit
    differences of the attention and MoE kernels' sum order flip roundings
    that grow through the layers. For such an engine a third float32 run
    takes the plain path with the int8 activations of the kernel run
    (`ActTape`): the pair "f32 kernel vs plain, shared int8 activations" and
    the error of every int8 matmul's input x on that run (which the
    attention and MoE kernels' differences reach, but no flip amplifies)
    are the gate, and the count of roundings the plain path's own x would
    have flipped is printed. The all-plain pair is printed too."""
    import torch

    from dllama_tpu_torch.models import forward, init_kv_cache
    from dllama_tpu_torch.models import transformer
    from dllama_tpu_torch.ops.int8_matmul import Int8Weight, quantize_acts

    h, dev = engine.header, engine.device
    toks = torch.tensor([prompt], device=dev)
    int8 = isinstance(engine.params["wcls"], Int8Weight)

    def cast(p: dict, dtype) -> dict:
        """The params with every tensor held in the engine's dtype (the
        embedding, and dense matmul weights and experts) cast to dtype."""
        def leaf(v):
            return v.to(dtype) if torch.is_tensor(v) and v.dtype == engine.dtype else v
        out = {key: leaf(v) for key, v in p.items() if key != "layers"}
        out["layers"] = [{key: leaf(v) for key, v in lp.items()} for lp in p["layers"]]
        return out

    logits, routes, nxt = {}, {}, None
    route = transformer.moe_route
    tapes = {"prefill": ActTape(), "decode": ActTape()}

    def recording(key):
        def moe_route(x, gate, n_active):
            top_i, w = route(x, gate, n_active)
            routes.setdefault(key, []).append(top_i.sort(dim=-1).values)
            return top_i, w
        return moe_route

    def act_quant(dtype, kind, phase):
        if int8 and dtype == torch.float32 and kind != PLAIN:
            return tapes[phase].record if kind == KERNEL else tapes[phase].replay
        return quantize_acts

    runs = [(dtype, kind) for dtype in (torch.float32, torch.bfloat16) for kind in (KERNEL, PLAIN)]
    if int8:
        runs.append((torch.float32, SHARED))
    with torch.inference_mode():
        for dtype, kind in runs:
            params = cast(engine.params, dtype)
            transformer.moe_route = recording((dtype, kind))
            plain = kind != KERNEL
            try:
                cache = init_kv_cache(h, 1, dtype=dtype, device=dev)
                pre, cache = forward(params, h, toks, 0, cache, "last", plain=plain,
                                     act_quant=act_quant(dtype, kind, "prefill"))
                if nxt is None:  # every run decodes the same token
                    nxt = pre[:, -1].argmax(-1, keepdim=True)
                dec, _ = forward(params, h, nxt, len(prompt), cache, "last", plain=plain,
                                 act_quant=act_quant(dtype, kind, "decode"))
            finally:
                transformer.moe_route = route
            logits[dtype, kind] = (pre[0, -1].float(), dec[0, -1].float())
            del cache, params
    pairs = {
        "f32 kernel vs plain": ((torch.float32, KERNEL), (torch.float32, PLAIN)),
        "bf16 kernel vs plain": ((torch.bfloat16, KERNEL), (torch.bfloat16, PLAIN)),
        "bf16 plain vs f32 plain": ((torch.bfloat16, PLAIN), (torch.float32, PLAIN)),
        "bf16 kernel vs f32 plain": ((torch.bfloat16, KERNEL), (torch.float32, PLAIN)),
    }
    if int8:
        pairs[f"f32 kernel vs {SHARED}"] = ((torch.float32, KERNEL), (torch.float32, SHARED))

    def compare(a, b) -> dict:
        top5 = set(a.topk(5).indices.tolist()) & set(b.topk(5).indices.tolist())
        return dict(err=norm_err(a, b)[0], top1=int(a.argmax()) == int(b.argmax()),
                    top5_overlap=len(top5))

    res = {}
    for i, name in enumerate(("prefill", "decode")):
        for tag, (ka, kb) in pairs.items():
            res[name, tag] = compare(logits[ka][i], logits[kb][i])
        if int8:
            tape = tapes[name]
            require(tape.at == len(tape.calls),
                    f"act tape {name}: {tape.at} of {len(tape.calls)} recorded calls replayed")
            res[name, "int8 inputs"] = dict(err=tape.err, flips=tape.flips, values=tape.values,
                                            calls=len(tape.calls))
    del tapes
    for tag, (ka, kb) in pairs.items():
        if ka in routes and kb in routes and ka[1] == KERNEL and ka[0] == kb[0]:
            res["routing", tag] = dict(
                differ=sum(int((a != b).any(-1).sum()) for a, b in zip(routes[ka], routes[kb])),
                of=sum(int(a.shape[0]) for a in routes[ka]),
            )
    return res


def decode_profile(engine, token: int, pos: int, n_steps: int = 8) -> dict:
    """Device kernel time of one greedy decode block under torch.profiler:
    per-token device ms and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.decode_block(token, pos, n_steps)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.decode_block(token, pos, n_steps)
        torch.cuda.synchronize(engine.device)
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue  # a host op: its device time is its kernels', listed too
        if e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    require(bool(rows), "decode profile: the profiler reported no device time")
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {
        "device_ms_per_token": total / 1e3 / n_steps,
        "launches_per_token": sum(r[2] for r in rows) / n_steps,
        "top": [(k, us / 1e3 / n_steps, c // n_steps) for us, k, c in rows[:8]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from dllama_tpu_torch.ops import _build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s")
    for name, log in _build.ptxas_log.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", log))
        print(f"  ptxas {name}: {len(regs)} kernels, registers <= {max(regs, default=0)}, "
              f"spill stores {spills} B")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = (check_q40(device, gen) + check_q40i4(device, gen) + check_i8(device, gen)
            + check_attention(device, gen) + check_attention(device, gen, h=32, kh=4)
            + check_moe(device, gen))
    for r in rows:
        times = "".join(
            f" {key} {'none' if r[key] is None else format(r[key], '.4f')}"
            for key in ("ms", "plain_ms", "library_ms") if key in r
        )
        note = " (no single PyTorch call computes a routed SwiGLU MoE)" if "experts" in r else ""
        note += "".join(f"; {what} unrounded err {e:.2e}" for what, e in r.get("unrounded", {}).items())
        if "twin_err" in r:
            note += (f"; vs q40_matmul on the unpacked twin err {r['twin_err']:.2e}, "
                     f"bits equal {r['twin_equal']}")
        if "plain_equal" in r:
            note += f"; bits equal to plain {r['plain_equal']}"
        if "int_mm_ms" in r:
            note += f"; torch._int_mm {r['int_mm_ms']:.4f}"
        print(
            f"{r['name']:23s} {r['shape']:32s} err {r['err']:.2e}{times} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}){note}"
        )
    gc.collect()
    torch.cuda.empty_cache()

    from dllama_tpu_torch.models.synthetic import PRESETS

    counts, streams = {}, {}
    for model, preset, n_layers, formats in MODELS:
        depth = PRESETS[preset]["n_layers"]
        if n_layers < depth:
            print(f"{model}: depth cut to {n_layers} of {depth} layers (bf16 experts are "
                  f"1.26 GB a layer: the whole model would not fit the card)")
        with tempfile.TemporaryDirectory() as tmp:
            for weight_format in formats:
                label, counts_, tokens = run_path(model, preset, n_layers, weight_format, tmp)
                counts[label], streams[label] = counts_, tokens
                gc.collect()
                torch.cuda.empty_cache()
    for label in counts:
        model, fmt = label.rsplit(" ", 1)
        if fmt in ("q40i4", "q40i8") and f"{model} q40" in streams:
            a, b = streams[f"{model} q40"], streams[label]
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            print(f"{label} greedy stream equals the q40 one: {a == b}"
                  + ("" if first is None else f" (first of {len(a)} tokens to differ: {first})"))

    kernels = []
    for name in REPLACES:
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["shape"] == KERNEL_ROW_SHAPE[name])
        by_path = {label: c[name] for label, c in counts.items() if c[name]}
        require(bool(by_path), f"{name} was launched on no path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            max_norm_err=max(r["err"] for r in mine), shape=rep["shape"],
            ms=rep.get("ms"), plain_ms=rep.get("plain_ms"), bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep.get("library_ms"),
        ))
    print(f"smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def run_path(model: str, preset: str, n_layers: int, weight_format: str, tmp: str):
    """Phases 3 and 4 for one model and weight format: the CLI run, its
    launch counts against the shapes', for a quantized format the decode
    profile, and the parity gate. The model file lives in tmp (written by
    the first run on it). Returns the run's label, launch counts and greedy
    tokens."""
    import torch

    res = end_to_end(
        "cuda", preset, n_layers, PROMPT_TOKENS, DECODE_TOKENS, 4096, SEED, tmp, weight_format,
    )
    h, eng = res["header"], res["engine"]
    label = f"{model} {eng.weight_format}"
    n_dec = res["pred"].n_tokens
    require(n_dec == DECODE_TOKENS, f"{label}: decoded {n_dec} tokens, wanted {DECODE_TOKENS}")
    counts = res["counts"]
    want = expected_launches(h, len(res["prompt_tokens"]), n_dec, eng.weight_format)
    wb = weight_bytes(eng.params, h)
    written = "" if res["write_s"] is None else f"; written in {res['write_s']:.1f} s"
    group = f", int8 group {eng.i8_group}" if eng.i8_group else ""
    print(f"== {label}: {h.n_layers} layers, seq_len {h.seq_len}, weights {eng.weight_format}"
          f"{group}{written}")
    print(f"e2e {label} load_s {res['load_s']:.2f} prefill_ms {res['eval'].time_ms:.1f} "
          f"({res['eval'].n_tokens} tokens) decode_ms_per_token "
          f"{res['pred'].time_ms / n_dec:.3f} tok_s {n_dec * 1000 / res['pred'].time_ms:.2f}")
    print(f"weight bytes per token {wb} -> bound {wb / HBM_BYTES_PER_S * 1e3:.3f} ms/token")
    print(f"on the card after the run: weights {nbytes(eng.params) / 1e9:.3f} GB, "
          f"torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    print(f"launches {json.dumps(counts)} expected {json.dumps(want)}")
    for name, c in counts.items():
        require(c == want[name], f"{label} {name}: {c} launches, the shapes imply {want[name]}")
        if want[name]:
            require(c > 0, f"{label}: {name} was never launched on the main path")
    if eng.weight_format != "dense":
        prof = decode_profile(eng, res["tokens"][-1], len(res["prompt_tokens"]) - 1 + n_dec)
        host_ms = res["pred"].time_ms / n_dec
        print(f"decode profile: device kernel ms/token {prof['device_ms_per_token']:.3f}, "
              f"device launches/token {prof['launches_per_token']:.0f}, host ms/token "
              f"{host_ms:.3f} (unprofiled run), device busy share "
              f"{prof['device_ms_per_token'] / host_ms:.3f}")
        for name, ms, count in prof["top"]:
            print(f"  {ms:8.4f} ms/token {count:5d}x {name[:90]}")
    par = parity(eng, res["prompt_tokens"])
    for (name, tag), p in par.items():
        if name == "routing":
            print(f"parity routing, {tag}: {p['differ']} of {p['of']} (layer, token) top-k "
                  "expert sets differ")
        elif tag == "int8 inputs":
            print(f"parity {name} f32 {SHARED}: the inputs of {p['calls']} int8 matmuls err "
                  f"{p['err']:.3e} against the kernel path's; the plain path's own quantization "
                  f"would round {p['flips']} of {p['values']} int8 values otherwise")
        else:
            print(f"parity {name} {tag}: logits err {p['err']:.3e} top1 {p['top1']} "
                  f"top5_overlap {p['top5_overlap']}/5")
    # with int8 weights the gate shares the kernel path's int8 activations
    # with the plain path (see parity)
    int8 = ("prefill", "int8 inputs") in par
    gates = [f"f32 kernel vs {SHARED}", "int8 inputs"] if int8 else ["f32 kernel vs plain"]
    for name in ("prefill", "decode"):
        for gate in gates:
            err = par[name, gate]["err"]
            require(err <= TOL_E2E, f"{label} {name}: {gate} err {err:.3e} > {TOL_E2E}")
    return label, counts, res["tokens"]


if __name__ == "__main__":
    sys.exit(main())
