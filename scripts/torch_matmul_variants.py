#!/usr/bin/env python3
"""Time the port's matmul kernels against other builds of them, side by side.

    python3 scripts/torch_matmul_variants.py [--before DIR] [--other NAME=DIR ...] [--variants]
                                             [--only gemv|i8] [--quick]

from the repository root, on an H100. Builds dllama_tpu_torch/csrc/ as it
stands ("as built"), with ``--variants`` each patched copy of it in
VARIANTS (one text substitution list each), with ``--before`` the csrc/
directory DIR (for instance a parent commit's, unpacked with ``git
archive``) and each ``--other`` csrc/ directory under its name, with the
port's nvcc flags, all in parallel, into build/matmul_variants/. Loads the
`q40_matmul`, `q40i4_matmul` and `i8_matmul` C entries of each with ctypes
and times them with chip_smoke.time_ms (L2 flushed before each launch) in
turns (before, the others, the others, before: the mean of a build's two
readings), and the as-built and before builds once more with the L2 left
clean (`time_clean`), at llama-8b's and qwen3-30b-a3b's shapes: the bf16
Q40 GEMVs at m = 1, 4 and 8, the int8 tile at m = 512 (G 512 and G 256,
with ``torch._int_mm`` beside it) and the int8 GEMV at m = 1. Each build's
output is held against the as-built one (normalized error). Prints the
card's name and power limit, one line a case, and last a JSON line of all
the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dllama_tpu_torch.ops import _build  # noqa: E402
from dllama_tpu_torch.ops.int8_matmul import quantize_acts, requantize_q40  # noqa: E402
from dllama_tpu_torch.ops.quant_matmul import pack_nibbles  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "matmul_variants")
SOURCES = ("q40_matmul", "q40i4_matmul", "i8_matmul")
# name -> [(file, old text, new text), ...] applied to a copy of csrc/
# what was tried against the committed kernels (PERF.md §6)
I4_FETCH = "    return ldg_stream(row + 32 * p + 16 * (t >> 1));"
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    "GEMV unroll 2": [("q40_gemm.cuh", "constexpr int MV_UNROLL = 4;", "constexpr int MV_UNROLL = 2;")],
    "GEMV 24 warps": [("q40_gemm.cuh", "constexpr int MV_MIN_WARPS = 132 * 48;",
                       "constexpr int MV_MIN_WARPS = 132 * 24;")],
    "i4 through L1": [("q40_gemm.cuh", I4_FETCH,
                       "    return __ldg(reinterpret_cast<const uint4*>(row + 32 * p + 16 * (t >> 1)));")],
    "i8 6 stages": [("i8_matmul.cu", "constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
                    ("i8_matmul.cu", "constexpr int SCALE_WIN = 32;", "constexpr int SCALE_WIN = 16;")],
    "i8 no setmaxnreg": [("i8_matmul.cu", "    setmaxnreg_dec<40>();\n", ""),
                         ("i8_matmul.cu", "  setmaxnreg_inc<232>();", "")],
    # diagnostic, wrong output: the group flush skipped (its drain and scaling)
    "i8 no flush": [("i8_matmul.cu", "        if ((kk + 1) % gsteps == 0) {", "        if (false) {")],
}
GEMV_SHAPES = [(4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024), (4096, 128256)]
GEMV_M = (1, 4, 8)
I8_TILE = [(4096, 14336, 512), (14336, 4096, 512), (4096, 1024, 512), (2048, 4096, 256),
           (2048, 512, 256), (4096, 2048, 256)]


def build(before: str | None, others: list[str], variants: bool) -> dict:
    """{build name: {source: loaded library}}, all sources built in parallel."""
    dirs = {"as built": _build.CSRC}
    for name, subs in (VARIANTS.items() if variants else ()):
        d = os.path.join(OUT_DIR, name.replace(" ", "_"))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for fname, a, b in subs:
            path = os.path.join(d, fname)
            src = open(path).read()
            if a not in src:
                raise SystemExit(f"variant {name}: text not found in {fname}: {a!r}")
            open(path, "w").write(src.replace(a, b))
        dirs[name] = d
    for spec in others:
        name, d = spec.split("=", 1)
        dirs[name] = os.path.abspath(d)
    if before:
        dirs["before"] = os.path.abspath(before)
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, d in dirs.items():
        for src in SOURCES:
            so = os.path.join(OUT_DIR, f"{name.replace(' ', '_')}-{src}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), so)
    libs: dict = {}
    for (name, src), (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} {src}:\n{out}")
        fn = getattr(ctypes.CDLL(so), src)
        fn.argtypes = _build.SIGNATURES[src][1]
        fn.restype = ctypes.c_int
        libs.setdefault(name, {})[src] = fn
    return libs


def time_clean(fn, device, reps: int = 20) -> float:
    """chip_smoke.time_ms with a clean L2: after the memset that evicts the
    cache, a read of another 256 MB evicts the memset's dirty lines too, so
    the timed call writes none of them back."""
    import statistics

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    clean = torch.ones(64 << 20, dtype=torch.float32, device=device)
    fn()
    torch.cuda.synchronize(device)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        clean.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", help="a csrc/ directory to build and time beside the current one")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another csrc/ directory to build and time, under NAME")
    ap.add_argument("--variants", action="store_true", help="also build and time VARIANTS")
    ap.add_argument("--only", choices=("gemv", "i8"), help="time one kernel family only")
    ap.add_argument("--quick", action="store_true", help="w1's shape and the int8 tile at G 512 only")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(args.before, args.other, args.variants)
    names = list(libs)
    order = names[::-1] + names if "before" in libs else names + names[::-1]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    stream = _build.stream(dev)
    results = []

    def run_case(label: str, src: str, call, out) -> None:
        outs = {}
        for name in names:  # each build's output; the timed calls below only launch
            call(libs[name][src])
            outs[name] = out.clone()
        torch.cuda.synchronize(dev)
        ref = outs["as built"]
        times: dict = {name: [] for name in names}
        for name in order:
            times[name].append(cs.time_ms(lambda: call(libs[name][src]), dev))
        row = {"case": label, "clean": {n: time_clean(lambda: call(libs[n][src]), dev)
                                         for n in ("as built", "before") if n in libs}}
        for name in names:
            row[name] = sum(times[name]) / len(times[name])
            row[f"{name} err"] = cs.norm_err(outs[name], ref)[0]
        results.append(row)
        print(label + "".join(f"; {name} {row[name]:.4f} ms (err {row[name + ' err']:.1e})"
                              for name in names)
              + "".join(f"; clean L2 {n} {v:.4f}" for n, v in row["clean"].items()), flush=True)

    gemv_shapes = [] if args.only == "i8" else GEMV_SHAPES[:1] if args.quick else GEMV_SHAPES
    for k, n in gemv_shapes:
        w = cs.random_q40(n, k, dev, gen)
        pw = pack_nibbles(w)
        for m in GEMV_M:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            out = torch.empty((m, n), dtype=torch.float32, device=dev)
            for src, vals in (("q40_matmul", w.q), ("q40i4_matmul", pw.qp)):
                def call(fn, vals=vals):
                    _build.check(fn(x.data_ptr(), vals.data_ptr(), w.d.data_ptr(), out.data_ptr(),
                                    m, n, k, 1, stream), src)
                run_case(f"{src} bf16 m={m} k={k} n={n}", src, call, out)
        del w, pw
    i8_cases = [(k, n, g, 512) for k, n, g in I8_TILE] + [(4096, 14336, 512, 1)]
    if args.quick:
        i8_cases = [c for c in i8_cases if c[2] == 512 and c[:2] != (4096, 1024)]
    if args.only == "gemv":
        i8_cases = []
    for k, n, group, m in i8_cases:
        w = requantize_q40(cs.random_q40(n, k, dev, gen), group)
        x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
        xq, sx = quantize_acts(x, group)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)

        def call(fn):
            _build.check(fn(xq.data_ptr(), sx.data_ptr(), w.q.data_ptr(), w.s.data_ptr(),
                            out.data_ptr(), m, n, k, group, stream), "i8_matmul")
        run_case(f"i8_matmul m={m} k={k} n={n} G={group}", "i8_matmul", call, out)
        if m == 512:
            qt = w.q.t()
            ms = cs.time_ms(lambda: torch._int_mm(xq, qt), dev)
            results[-1]["int_mm_ms"] = ms
            print(f"  torch._int_mm {ms:.4f} ms", flush=True)
        del w
    print(json.dumps({"device": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
