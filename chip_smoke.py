#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each fatal on failure (a non-zero exit and no result line):

1. The card (``nvidia-smi`` name and power limit, torch's device name) and
   the build of the three CUDA kernels from csrc/ (one nvcc each, in
   parallel), with its seconds.
2. Each kernel against its plain PyTorch version on the card at the Llama-8B
   main-path shapes (D 4096, F 14336, 32 heads, 8 KV heads, head dim 128,
   vocab 128256): max normalized error max|k - p| / max|p|, kernel ms,
   plain ms, the bound (bytes over 3.35 TB/s or flops over 989 TFLOP/s, H100
   SXM datasheet) and one PyTorch library call's ms as a yardstick
   (torch.matmul on the dequantized bf16 weight, scaled_dot_product_attention).
3. End to end: a random Q40 llama-8b ``.m`` (max_seq_len 4096) and a padded
   byte-level ``.t`` written with the port's writers to a temp dir, then the
   port's ``inference`` CLI path: a ~500-token prompt and 128 greedy tokens.
   Load s, prefill ms, decode ms/token and tok/s, each kernel's launches in
   that run (all must be > 0, and equal what the shapes imply) and the
   weight-read bound per token.
4. End-to-end parity: one prefill and one decode step through the kernel
   path and through the plain path (``forward(..., plain=True)``) on the
   same weights: logits' normalized error and top-1 agreement. The float32
   comparison is the gate; the bfloat16 ones are printed beside it.
5. A ``{"kernels": [...]}`` JSON line; last, the device JSON line.

Imports nothing of JAX or dllama_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
BF16_FLOPS = 989e12  # H100 SXM datasheet, dense
# normalized error of kernels with f32 outputs, where kernel and plain
# version share every rounding and differ in sum order only: the largest
# reading on an H100 was 5.6e-6 (q40_matmul m=512 k=14336); a kernel that
# kept the dequantized weight in f32 where the plain version rounds it to
# bf16 reads ~1e-3
TOL = 1e-4
TOL_BF16_OUT = 2.0**-7  # bf16 outputs: one rounding step of the largest value
TOL_E2E = 2e-2  # f32 logits after the whole model, kernel vs plain path
SEED = 0
PROMPT_TOKENS = 500
DECODE_TOKENS = 128
N_LAYERS = 32  # the whole llama-8b depth

Q40_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
REPLACES = {
    "q40_matmul": "dllama_tpu/ops/quant_matmul.py:289",
    "flash_attention_stats": "dllama_tpu/ops/flash_attention.py:166",
    "flash_decode": "dllama_tpu/ops/flash_attention.py:404",
}
SOURCES = {
    "q40_matmul": "dllama_tpu_torch/csrc/q40_matmul.cu",
    "flash_attention_stats": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode": "dllama_tpu_torch/csrc/flash_decode.cu",
}


class SmokeError(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
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


def check_q40(device, gen, timed: bool = True) -> list[dict]:
    import torch

    from dllama_tpu_torch.ops.quant_matmul import QuantWeight, dequant, qmatmul, qmatmul_ref

    rows = []
    for k, n in Q40_SHAPES:
        q = torch.randint(-8, 8, (n, k), dtype=torch.int8, device=device, generator=gen)
        d = ((torch.rand((n, k // 32), device=device, generator=gen) + 0.5) * 0.004).half()
        d = torch.where(torch.rand_like(d.float()) < 0.5, -d, d).contiguous()
        w = QuantWeight(q, d)
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
        del q, d, w, w_bf16
    return rows


def _sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call, with GQA in the call."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def check_attention(device, gen, timed: bool = True) -> list[dict]:
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_ref,
        flash_decode,
        flash_decode_ref,
    )

    h, kh, hd, t = 32, 8, 128, 512
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
            name="flash_attention_stats", shape=f"B=1 T={t} S={s} pos={pos}", err=rel,
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
            name="flash_decode", shape=f"B=1 S=4096 pos={pos}", err=rel, max_abs_err=absd,
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


def end_to_end(device: str, preset: str, n_layers: int | None, prompt_tokens: int,
               decode_tokens: int, max_seq_len: int, seed: int, tmp: str) -> dict:
    """Phase 3: write the model, run the port's inference CLI path."""
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    t0 = time.perf_counter()
    h = write_synth_model(mp, preset, seed=seed, max_seq_len=max_seq_len, n_layers=n_layers)
    write_tokenizer_file(tp, h.vocab_size)
    write_s = time.perf_counter() - t0
    text = prompt_text(prompt_tokens - 1)  # one token per byte, plus BOS
    reset_launch_counts()
    res = cli.main([
        "inference", "--model", mp, "--tokenizer", tp, "--prompt", text,
        "--steps", str(prompt_tokens - 1 + decode_tokens), "--temperature", "0",
        "--device", device, "--seed", str(seed),
    ])
    counts = launch_counts()
    res.update(header=h, write_s=write_s, counts=counts, model_path=mp)
    return res


def expected_launches(h, n_prompt: int, n_decode: int) -> dict:
    """Launches the shapes imply: per forward 7 matmuls a layer + the
    classifier, and one attention a layer (stats for T > 1, decode for 1)."""
    from dllama_tpu_torch.runtime.engine import PREFILL_BUCKETS as buckets

    chunks, left = 0, n_prompt - 1
    while left > 0:
        width = min(next((b for b in buckets if left <= b), buckets[-1]), left)
        chunks += 1
        left -= width
    return {
        "q40_matmul": (7 * h.n_layers + 1) * (chunks + n_decode),
        "flash_attention_stats": h.n_layers * chunks,
        "flash_decode": h.n_layers * n_decode,
    }


def weight_bytes(params) -> int:
    from dllama_tpu_torch.ops.quant_matmul import QuantWeight

    leaves = [params["wcls"]] + [w for lp in params["layers"] for w in lp.values()]
    return sum(
        w.q.numel() + w.d.numel() * 2 for w in leaves if isinstance(w, QuantWeight)
    )


def parity(engine, prompt: list[int]) -> dict:
    """Phase 4: one prefill + one decode step through the kernel path and
    the plain path on the same weights, in float32 (where the two paths
    share every rounding and differ only in summation order) and in the
    engine's bfloat16. Returns the errors and top-1/top-5 agreement of
    each pair; main() gates on the float32 pair only, since in bfloat16 a
    changed sum order flips roundings that 32 layers amplify to the size of
    bfloat16's own distance from float32 (printed as controls)."""
    import torch

    from dllama_tpu_torch.models import forward, init_kv_cache

    h, dev = engine.header, engine.device
    toks = torch.tensor([prompt], device=dev)
    logits, nxt = {}, None
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            params = dict(engine.params, embed=engine.params["embed"].to(dtype))
            for plain in (False, True):
                cache = init_kv_cache(h, 1, dtype=dtype, device=dev)
                pre, cache = forward(params, h, toks, 0, cache, "last", plain=plain)
                if nxt is None:  # every run decodes the same token
                    nxt = pre[:, -1].argmax(-1, keepdim=True)
                dec, _ = forward(params, h, nxt, len(prompt), cache, "last", plain=plain)
                logits[dtype, plain] = (pre[0, -1].float(), dec[0, -1].float())
                del cache
            del params
    res = {}
    for i, name in enumerate(("prefill", "decode")):
        for tag, (a, b) in {
            "f32 kernel vs plain": (logits[torch.float32, False][i], logits[torch.float32, True][i]),
            "bf16 kernel vs plain": (logits[torch.bfloat16, False][i], logits[torch.bfloat16, True][i]),
            "bf16 plain vs f32 plain": (logits[torch.bfloat16, True][i], logits[torch.float32, True][i]),
            "bf16 kernel vs f32 plain": (logits[torch.bfloat16, False][i], logits[torch.float32, True][i]),
        }.items():
            rel, _ = norm_err(a, b)
            top5 = set(a.topk(5).indices.tolist()) & set(b.topk(5).indices.tolist())
            res[name, tag] = dict(
                err=rel, top1=int(a.argmax()) == int(b.argmax()), top5_overlap=len(top5)
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = check_q40(device, gen) + check_attention(device, gen)
    for r in rows:
        times = "".join(
            f" {key} {r[key]:.4f}" for key in ("ms", "plain_ms", "library_ms") if key in r
        )
        print(
            f"{r['name']:22s} {r['shape']:24s} err {r['err']:.2e}{times} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
        )

    with tempfile.TemporaryDirectory() as tmp:
        res = end_to_end(
            "cuda", "llama-8b", N_LAYERS, PROMPT_TOKENS, DECODE_TOKENS, 4096, SEED, tmp,
        )
        h, eng = res["header"], res["engine"]
        n_dec = res["pred"].n_tokens
        require(n_dec == DECODE_TOKENS, f"decoded {n_dec} tokens, wanted {DECODE_TOKENS}")
        counts = res["counts"]
        want = expected_launches(h, len(res["prompt_tokens"]), n_dec)
        wb = weight_bytes(eng.params)
        print(f"model: llama-8b widths, {h.n_layers} of 32 layers, seq_len {h.seq_len}; "
              f"written in {res['write_s']:.1f} s")
        print(f"e2e load_s {res['load_s']:.2f} prefill_ms {res['eval'].time_ms:.1f} "
              f"({res['eval'].n_tokens} tokens) decode_ms_per_token "
              f"{res['pred'].time_ms / n_dec:.3f} tok_s {n_dec * 1000 / res['pred'].time_ms:.2f}")
        print(f"weight bytes per token {wb} -> bound {wb / HBM_BYTES_PER_S * 1e3:.3f} ms/token")
        print(f"launches {json.dumps(counts)} expected {json.dumps(want)}")
        for name, c in counts.items():
            require(c > 0, f"{name} was never launched on the main path")
            require(c == want[name], f"{name}: {c} launches, the shapes imply {want[name]}")
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
            print(f"parity {name} {tag}: logits err {p['err']:.3e} top1 {p['top1']} "
                  f"top5_overlap {p['top5_overlap']}/5")
        for name in ("prefill", "decode"):
            f32 = par[name, "f32 kernel vs plain"]["err"]
            require(f32 <= TOL_E2E, f"{name}: f32 logits kernel vs plain {f32:.3e} > {TOL_E2E}")

    kernels = []
    for name in REPLACES:
        mine = [r for r in rows if r["name"] == name]
        rep = mine[-1] if name != "q40_matmul" else next(
            r for r in mine if r["shape"] == "m=1 k=4096 n=14336"
        )
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=counts[name], max_abs_err=max(r["max_abs_err"] for r in mine),
            max_norm_err=max(r["err"] for r in mine), shape=rep["shape"],
            ms=rep.get("ms"), plain_ms=rep.get("plain_ms"), bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep.get("library_ms"),
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
