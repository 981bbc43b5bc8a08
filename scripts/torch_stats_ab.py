#!/usr/bin/env python3
"""The prefill stats kernel of two checkouts of the port, side by side on one card.

    python3 scripts/torch_stats_ab.py OLD_ROOT   # e.g. a parent unpacked by git archive under build/

Builds OLD_ROOT's ``csrc/flash_attention.cu`` beside this checkout's and
runs both through this checkout's wrapper (the old library's C entries in
place of the new ones), for every (q, cache) pair of types the stats take
(q f32 or bf16; the cache bf16, int8, f16 or f32) at llama-8b heads (H 32,
KH 8, hd 128): T 512 over S 4096 at pos 3584, and a verify pass's shape (B
4 + 1 parked, T 2 and 5, S 4608). Each row: the normalized error of each
build against the plain version, whether the two builds give equal bits,
and the times old, new, new, old (`chip_smoke.time_ms`, L2 flushed). Then
the 512-row prefill chunk of the ~500-token prompt on a llama-8b q40 file
(32 layers, written once under a temporary directory) with an f32 model
over a bf16 cache, a bf16 model over an f16 cache and a bf16 model over a
bf16 cache, each checkout in a process of its own, in the order old, new,
new, old: the graphed host ms of 5 runs after the capture. Prints the
card's name and power limit, one ``STATS`` line a row and one ``CHUNK``
line a run.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [(q, c) for q in ("bf16", "f32") for c in ("bf16", "int8", "f16", "f32")]
CHUNK_RUNS = (("float32", "bf16"), ("bfloat16", "f16"), ("bfloat16", None))


def stats_rows(old_root: str) -> None:
    """Both builds' stats on every pair, in this process."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from dllama_tpu_torch.ops import _build
    from dllama_tpu_torch.ops import flash_attention as fa

    so = os.path.join(tempfile.mkdtemp(), "flash_attention_old.so")
    src = os.path.join(old_root, "dllama_tpu_torch", "csrc", "flash_attention.cu")
    build = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_all()
    out, _ = build.communicate()
    cs.require(build.returncode == 0, f"nvcc failed for {src}:\n{out}")
    lib = ctypes.CDLL(so)
    old = {}
    for entry, (source, argtypes) in _build.SIGNATURES.items():
        if source == "flash_attention" and hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            old[entry] = fn
    new_load = _build.load

    def run(build_old: bool, fn):
        _build.load = (lambda entry: old[entry]) if build_old else new_load
        try:
            return fn()
        finally:
            _build.load = new_load

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    types = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}

    def cache(kn, shape):
        if kn == "int8":
            return cs.random_kv8(shape, dev, gen), cs.random_kv8(shape, dev, gen)
        return tuple(torch.randn(shape, device=dev, generator=gen).to(types[kn]) for _ in range(2))

    def err(got, ref):
        return max(cs.norm_err(a, b)[0] for a, b in zip(got, ref))

    for qn, kn in PAIRS:
        cases = [("T=512 S=4096 pos=3584", 1, 512, 4096, 3584)]
        cases += [(f"B=4+1 T={t} S=4608 pos=0,15,16,4090,-{t}", 5, t, 4608, (0, 15, 16, 4090, -t))
                  for t in (2, 5)]
        for label, b, t, s, pos in cases:
            q = torch.randn((b, t, 32, 128), device=dev, generator=gen).to(types[qn])
            k, v = cache(kn, (b, 8, s, 128))
            q_pos0 = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32,
                                                                     device=dev)

            def call():
                return fa.flash_attention_stats(q, k, v, q_pos0)

            a, o = run(False, call), run(True, call)
            ref = fa.flash_attention_stats_ref(q, k, v, q_pos0)
            torch.cuda.synchronize(dev)
            same = all(torch.equal(x, y) for x, y in zip(a, o))
            ms = [cs.time_ms(lambda w=w: run(w, call), dev) for w in (True, False, False, True)]
            print(f"STATS {qn}/{kn} {label}: err new {err(a, ref):.3e} old {err(o, ref):.3e}; "
                  f"bits equal {same}; ms old/new/new/old "
                  + " ".join(f"{x:.4f}" for x in ms), flush=True)
            del q, k, v
        torch.cuda.empty_cache()


def chunk_runs(root: str, tag: str, tmp: str) -> None:
    """The mixed-KV engines' prefill chunk with ``root``'s port, in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.ops import _build
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import Tokenizer

    _build.build_all()
    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    if not os.path.exists(tp):
        h = write_synth_model(mp, "llama-8b", seed=cs.SEED, max_seq_len=4096)
        cs.write_tokenizer_file(tp, h.vocab_size)
    tok = Tokenizer(tp)
    prompt = tok.encode(cs.prompt_text(cs.PROMPT_TOKENS - 1), is_start=True,
                        add_special_tokens=True)
    for dtype, kv in CHUNK_RUNS:
        eng = InferenceEngine(mp, dtype=getattr(torch, dtype), temperature=0.0, seed=cs.SEED,
                              weight_format="q40", device="cuda", kv_dtype=kv)
        eng.generate(prompt, max_steps=len(prompt) + 1)  # every chunk's graph captured
        ms = [eng.prefill(prompt).time_ms for _ in range(5)]
        print(f"CHUNK {tag} {dtype} model, {kv or 'bf16'} cache: graphed host ms "
              + " ".join(f"{x:.3f}" for x in ms) + f" (median {statistics.median(ms):.3f})",
              flush=True)
        cs.release_engine(eng)
        del eng
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--chunk":
        chunk_runs(sys.argv[2], os.path.basename(sys.argv[2].rstrip("/")), sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    old_root = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    stats_rows(old_root)
    with tempfile.TemporaryDirectory() as tmp:
        for root in (old_root, ROOT, ROOT, old_root):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--chunk", root, tmp],
                           check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
