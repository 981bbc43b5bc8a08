#!/usr/bin/env python3
"""Time the port's matmul and MoE kernels against other builds of them, side by side.

    python3 scripts/torch_matmul_variants.py [--before DIR] [--other NAME=DIR ...] [--variants]
                                             [--only gemv,i8,i8gemv,moe,grouped,prefill] [--quick]

from the repository root, on an H100. Builds dllama_tpu_torch/csrc/ as it
stands ("as built"), with ``--variants`` each patched copy of it in
VARIANTS (one text substitution list each), with ``--before`` the csrc/
directory DIR (for instance a parent commit's, unpacked with ``git
archive``) and each ``--other`` csrc/ directory under its name, with the
port's nvcc flags, all in parallel, into build/matmul_variants/. Loads the
`q40_matmul`, `q40i4_matmul`, `i8_matmul`, `moe_active` and `moe_grouped`
C entries of each with ctypes and times them with chip_smoke.time_ms (L2
flushed before each launch) in turns (before, the others, the others, before: the mean of
a build's two readings), and the as-built and before builds once more with
the L2 left clean (chip_smoke.time_clean), at llama-8b's and
qwen3-30b-a3b's shapes: the bf16 Q40 GEMVs at m = 1, 4 and 8 (family
``gemv``), the int8 tile at m = 512 (G 512 and G 256, with
``torch._int_mm`` beside it; family ``i8``), the int8 GEMV at m = 1, 4 and
8 at w1 and m = 1 at the other llama-8b shapes and qwen3-30b-a3b's
attention projections (family ``i8gemv``, with ``torch.matmul`` on the
dequantized bf16 weight beside it), and the active-experts entry at
qwen3-30b-a3b's experts, Q40 at m = 1, 4 and 16 and dense bf16 at m = 1
and 16 (family ``moe``), and the grouped-experts entry there as the
wrapper runs it (its torch schedule, the launch, the torch combine; each
build at the rows of its own runs, read from its source), Q40 and dense,
bf16 at N = 17 and 512 with random routing and at N = 512 with every token
on the same 8 experts, f32 at N = 512 (family ``grouped``; beside the
dense bf16 N = 512 row, the same routed SwiGLU as three
``torch._grouped_mm`` calls, where the card's torch has it: a composite
of library calls, a yardstick only). Family ``prefill`` writes a random
qwen3-30b-a3b Q40 file (48 layers, ~18 GB, into a temporary directory)
and runs the engine's prefill of a 500-token prompt (one 512-row chunk)
under ``q40`` and ``q40i8`` with each build's grouped entry in turns: host
ms a run, and a device profile of one with the grouped kernels' share.
``--only`` takes a comma list of families and builds only their
sources. Each build's output is held against the as-built one
(normalized error). Prints the card's name and power limit, one line a
case, and last a JSON line of all the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dllama_tpu_torch.ops import _build  # noqa: E402
from dllama_tpu_torch.ops.int8_matmul import quantize_acts, requantize_q40  # noqa: E402
from dllama_tpu_torch.ops.quant_matmul import pack_nibbles  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "matmul_variants")
FAMILIES = {"gemv": ("q40_matmul", "q40i4_matmul"), "i8": ("i8_matmul",),
            "i8gemv": ("i8_matmul",), "moe": ("moe_active",), "grouped": ("moe_grouped",),
            "prefill": ("moe_grouped",)}
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
# (k, n, G, m) of the int8 GEMV rows
I8_GEMV = ([(4096, 14336, 512, m) for m in GEMV_M]
           + [(k, n, 512, 1) for k, n in GEMV_SHAPES[1:]]
           + [(k, n, 256, 1) for k, n, g in I8_TILE if g == 256])
MOE = dict(e=128, d=2048, f=768, k=8)  # qwen3-30b-a3b's experts
MOE_CASES = [(True, 1), (True, 4), (True, 16), (False, 1), (False, 16)]  # (Q40, m)
# (Q40, N, skewed routing, x dtype) of the grouped rows
GROUPED_CASES = [(q, n, skew, torch.bfloat16) for q in (True, False)
                 for n, skew in ((17, False), (512, False), (512, True))]
GROUPED_CASES += [(True, 512, False, torch.float32), (False, 512, False, torch.float32)]
PREFILL_TURNS = 4  # prefills a build, in turns


def run_rows(csrc: str) -> int:
    """Rows of a run (a tile) of the grouped kernels of the csrc/ directory
    ``csrc``: the constant its moe_grouped.cu marks as ops/moe.py GROUP_ROWS."""
    src = open(os.path.join(csrc, "moe_grouped.cu")).read()
    m = re.search(r"constexpr int \w+ = (\d+);\s*//[^\n]*GROUP_ROWS", src)
    if not m:
        raise SystemExit(f"{csrc}/moe_grouped.cu: no constant marked GROUP_ROWS")
    return int(m.group(1))


def grouped_with(fn, rows: int):
    """The grouped wrappers' body (ops/moe.py `_grouped`) over the C entry
    ``fn`` of a build whose runs hold ``rows`` rows: the schedule at those
    rows, hidden scratch of f32 size (either build's hidden fits), the
    combine. ``run.launch_only(...)`` takes the same arguments, does the
    schedule and allocations once, and returns a call that only launches."""
    from dllama_tpu_torch.ops import moe

    def prepare(x, w1, w2, w3, top_i, weights):
        quant = not torch.is_tensor(w1)
        e, f, k = moe._check("grouped", quant, x, w1, w2, w3, top_i, weights)
        n, d = x.shape
        x = x.contiguous()
        saved, moe.GROUP_ROWS = moe.GROUP_ROWS, rows
        try:
            s = moe.grouped_schedule(top_i, weights, e)
        finally:
            moe.GROUP_ROWS = saved
        max_tiles = s.tile_expert.shape[0]
        hidden = torch.empty((max_tiles * rows, f), dtype=torch.float32, device=x.device)
        out_rows = torch.empty((max_tiles * rows, d), dtype=torch.float32, device=x.device)
        args = (x.data_ptr(), *moe._pointers(quant, w1, w3, w2), s.row_token.data_ptr(),
                s.row_weight.data_ptr(), s.tile_expert.data_ptr(), s.n_tiles.data_ptr(),
                hidden.data_ptr(), out_rows.data_ptr(), max_tiles, d, f,
                int(x.dtype == torch.bfloat16), int(quant), _build.stream(x.device))

        def launch():
            _build.check(fn(*args), "moe_grouped")
        keep = (x, s, hidden, out_rows)  # alive while the launches may run
        return launch, lambda: out_rows.index_select(0, s.inv).view(n, k, d).sum(dim=1), keep

    def run(*a):
        launch, combine, _ = prepare(*a)
        launch()
        return combine()

    def launch_only(*a):
        launch, _, keep = prepare(*a)
        return lambda: (launch(), keep)[0]
    run.launch_only = launch_only
    return run


def build(before: str | None, others: list[str], variants: bool, sources) -> tuple[dict, dict]:
    """({build name: {source: loaded library}}, {build name: its csrc/
    directory}), all sources built in parallel."""
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
        for src in sources:
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
    return libs, dirs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", help="a csrc/ directory to build and time beside the current one")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another csrc/ directory to build and time, under NAME")
    ap.add_argument("--variants", action="store_true", help="also build and time VARIANTS")
    ap.add_argument("--only", default=",".join(FAMILIES),
                    help="comma list of the kernel families to time: " + ", ".join(FAMILIES))
    ap.add_argument("--quick", action="store_true", help="w1's shape and the int8 tile at G 512 only")
    args = ap.parse_args()
    only = args.only.split(",")
    if not set(only) <= set(FAMILIES):
        raise SystemExit(f"--only: families are {', '.join(FAMILIES)}")
    sources = sorted({src for f in only for src in FAMILIES[f]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs, dirs = build(args.before, args.other, args.variants, sources)
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
        row = {"case": label, "clean": {n: cs.time_clean(lambda: call(libs[n][src]), dev)
                                         for n in ("as built", "before") if n in libs}}
        for name in names:
            row[name] = sum(times[name]) / len(times[name])
            row[f"{name} err"] = cs.norm_err(outs[name], ref)[0]
        results.append(row)
        print(label + "".join(f"; {name} {row[name]:.4f} ms (err {row[name + ' err']:.1e})"
                              for name in names)
              + "".join(f"; clean L2 {n} {v:.4f}" for n, v in row["clean"].items()), flush=True)

    gemv_shapes = [] if "gemv" not in only else GEMV_SHAPES[:1] if args.quick else GEMV_SHAPES
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
    i8_cases = [(k, n, g, 512) for k, n, g in I8_TILE] if "i8" in only else []
    if "i8gemv" in only:
        i8_cases += I8_GEMV
    if args.quick:
        i8_cases = [c for c in i8_cases if c[2] == 512 and c[:2] != (4096, 1024)]
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
        else:
            dense = (w.q.float().view(n, k // group, group) * w.s[..., None]).view(n, k).to(x.dtype)
            ms = cs.time_ms(lambda: torch.matmul(x, dense.t()), dev)
            results[-1]["matmul_ms"] = ms
            print(f"  torch.matmul on the dequantized weight {ms:.4f} ms", flush=True)
            del dense
        del w
    if "moe" in only:
        moe_cases(run_case, dev, gen, stream)
    grouped = {name: grouped_with(libs[name]["moe_grouped"], run_rows(dirs[name]))
               for name in names if "moe_grouped" in libs[name]}
    if "grouped" in only:
        wrapper_of = {id(libs[name]["moe_grouped"]): grouped[name] for name in grouped}
        grouped_cases(run_case, results, grouped, wrapper_of, dev, gen)
    if "prefill" in only:
        prefill_turns(results, grouped, order, dev)
    print(json.dumps({"device": smi, "results": results}))
    return 0


def moe_cases(run_case, dev, gen, stream) -> None:
    """The active-experts C entry at `MOE`, random routing, bf16 x."""
    from dllama_tpu_torch.ops.quant_matmul import QuantWeight, dequant

    e, d, f, k = (MOE[key] for key in ("e", "d", "f", "k"))

    def q40(rows, cols):
        q = torch.randint(-8, 8, (e, rows, cols), dtype=torch.int8, device=dev, generator=gen)
        sc = (torch.rand((e, rows, cols // 32), device=dev, generator=gen) + 0.5) * 0.004
        return QuantWeight(q, sc.half().contiguous())

    qw = [q40(f, d), q40(d, f), q40(f, d)]  # w1, w2, w3
    for quant, m in MOE_CASES:
        ws = qw if quant else [dequant(w, torch.bfloat16) for w in qw]
        w1, w2, w3 = ws
        ptrs = ([w1.q, w1.d, w3.q, w3.d, w2.q, w2.d] if quant else [w1, None, w3, None, w2, None])
        ptrs = [None if t is None else t.data_ptr() for t in ptrs]
        x = torch.randn((m, d), device=dev, generator=gen).to(torch.bfloat16)
        top_i = torch.rand((m, e), device=dev, generator=gen).topk(k, dim=-1).indices.int()
        wts = torch.rand((m, k), device=dev, generator=gen) + 0.1
        wts = wts / wts.sum(-1, keepdim=True)
        hidden = torch.empty((m, k, f), dtype=torch.float32, device=dev)
        out = torch.empty((m, d), dtype=torch.float32, device=dev)

        def call(fn):
            _build.check(fn(x.data_ptr(), *ptrs, top_i.data_ptr(), wts.data_ptr(),
                            hidden.data_ptr(), out.data_ptr(), m, k, d, f, 1, int(quant), stream),
                         "moe_active")
        run_case(f"moe_active {'q40' if quant else 'dense'} bf16 m={m}", "moe_active", call, out)
        del ws



def grouped_cases(run_case, results, grouped, wrapper_of, dev, gen) -> None:
    """Each build's grouped wrapper (``grouped``; ``wrapper_of`` maps each
    build's C entry to it) at `MOE`, `GROUPED_CASES`; beside the dense bf16
    N = 512 row with random routing, `grouped_mm_swiglu`."""
    from dllama_tpu_torch.ops.quant_matmul import QuantWeight, dequant

    e, d, f, k = (MOE[key] for key in ("e", "d", "f", "k"))

    def q40(rows, cols):
        q = torch.randint(-8, 8, (e, rows, cols), dtype=torch.int8, device=dev, generator=gen)
        sc = (torch.rand((e, rows, cols // 32), device=dev, generator=gen) + 0.5) * 0.004
        return QuantWeight(q, sc.half().contiguous())

    qw = [q40(f, d), q40(d, f), q40(f, d)]  # w1, w2, w3
    for quant, n, skew, dtype in GROUPED_CASES:
        ws = qw if quant else [dequant(w, torch.bfloat16).to(dtype) for w in qw]
        x = torch.randn((n, d), device=dev, generator=gen).to(dtype)
        top_i = torch.rand((n, e), device=dev, generator=gen).topk(k, dim=-1).indices.int()
        if skew:  # the same k experts for every token
            chosen = torch.randperm(e, device=dev, generator=gen)[:k].int()
            top_i = chosen[torch.rand((n, k), device=dev, generator=gen).argsort(-1)]
        wts = torch.rand((n, k), device=dev, generator=gen) + 0.1
        wts = wts / wts.sum(-1, keepdim=True)
        out = torch.empty((n, d), dtype=torch.float32, device=dev)

        def call(fn):
            out.copy_(wrapper_of[id(fn)](x, *ws, top_i, wts))
        label = (f"moe_grouped {'q40' if quant else 'dense'} "
                 f"{'bf16' if dtype == torch.bfloat16 else 'f32'} N={n}{' skewed' if skew else ''}")
        run_case(label, "moe_grouped", call, out)
        launches = {i: wrapper_of[i].launch_only(x, *ws, top_i, wts) for i in wrapper_of}
        run_case(label + " (launches only: outputs not compared)", "moe_grouped",
                 lambda fn: launches[id(fn)](), out)
        del launches
        if not quant and dtype == torch.bfloat16 and n == 512 and not skew:
            if hasattr(torch, "_grouped_mm"):
                got = grouped_mm_swiglu(x, *ws, top_i, wts)
                err = cs.norm_err(got, grouped["as built"](x, *ws, top_i, wts))[0]
                ms = cs.time_ms(lambda: grouped_mm_swiglu(x, *ws, top_i, wts), dev)
                results[-1]["grouped_mm_composite_ms"] = ms
                print(f"  composite of library calls (3 torch._grouped_mm, silu*mul, combine) "
                      f"{ms:.4f} ms (err {err:.1e} against as built)", flush=True)
            else:
                print("  torch._grouped_mm: not in this torch", flush=True)
        del ws


def grouped_mm_swiglu(x, w1, w2, w3, top_i, wts):
    """The routed SwiGLU by library calls: the rows sorted by expert, three
    ``torch._grouped_mm`` over the experts' row offsets (bf16 out), silu *
    mul in bf16, the routing weight in f32 and the combine. A yardstick: the
    port never calls it."""
    import torch.nn.functional as F

    n, k = top_i.shape
    e, d = w1.shape[0], x.shape[1]
    flat = top_i.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = x[order // k]
    h1 = torch._grouped_mm(xs, w1.transpose(-2, -1), offs=offs)
    h3 = torch._grouped_mm(xs, w3.transpose(-2, -1), offs=offs)
    o = torch._grouped_mm(F.silu(h1) * h3, w2.transpose(-2, -1), offs=offs)
    rows = torch.empty((n * k, d), dtype=torch.float32, device=x.device)
    rows[order] = o.float() * wts.reshape(-1)[order, None]
    return rows.view(n, k, d).sum(dim=1)


def prefill_turns(results, grouped, order, dev) -> None:
    """qwen3-30b-a3b's prefill (one 512-row chunk) under q40 and q40i8 with
    each build's grouped wrapper in turns (`order`, twice): host ms of each
    run, then a device profile of one run a build with the grouped
    kernels' share of the chunk's device time."""
    from unittest import mock

    from dllama_tpu_torch.models import transformer
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    prompt = [1] + list(cs.prompt_text(cs.PROMPT_TOKENS - 1).encode())
    with tempfile.TemporaryDirectory() as tmp:
        mp = os.path.join(tmp, "model.m")
        write_synth_model(mp, "qwen3-30b-a3b", seed=cs.SEED, max_seq_len=4096)
        for fmt in ("auto", "q40i8"):
            eng = InferenceEngine(mp, max_seq_len=4096, weight_format=fmt, device=dev)
            host = {name: [] for name in grouped}
            for name in order * (PREFILL_TURNS // 2):
                with mock.patch.object(transformer, "moe_grouped_experts_q40", grouped[name]):
                    host[name].append(eng.prefill(prompt).time_ms)
            row = {"case": f"prefill qwen3-30b-a3b {eng.weight_format} 512-row chunk"}
            for name in grouped:
                with mock.patch.object(transformer, "moe_grouped_experts_q40", grouped[name]):
                    prof = cs.device_profile(eng, lambda: eng.prefill(prompt), 1)
                dev_ms = prof["device_ms_per_token"]
                share = sum(ms for key, ms, _ in prof["kernels"] if "grouped" in key)
                row[name] = dict(host_ms=host[name], device_ms=dev_ms, grouped_ms=share,
                                 launches=prof["launches_per_token"])
                runs = ", ".join(f"{v:.1f}" for v in host[name])
                print(f"{row['case']}; {name}: host ms {runs}; device ms {dev_ms:.3f}, launches "
                      f"{prof['launches_per_token']:.0f}, grouped kernels {share:.3f} ms (share "
                      f"{share / dev_ms:.3f})", flush=True)
                for key, ms, count in prof["top"][:5]:
                    print(f"    {ms:8.4f} ms {count:5d}x {key[:90]}", flush=True)
            results.append(row)
            del eng


if __name__ == "__main__":
    sys.exit(main())
