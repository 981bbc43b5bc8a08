#!/usr/bin/env python3
"""Time design variants of the port's decode attention kernel side by side.

    python3 scripts/torch_decode_variants.py     # from the repository root, on an H100

Copies dllama_tpu_torch/csrc/ into build/decode_variants/<name>/, patches
flash_decode.cu there (one text substitution list per variant), builds each
copy with the port's nvcc flags in parallel, loads the `flash_decode` and
`paged_flash_decode` C entries of each with ctypes and times them with
chip_smoke.time_ms (L2 flushed before each launch), in turns, at the
main path's shapes (llama-8b KH 8 and qwen3-30b-a3b KH 4, H 32, hd 128,
bf16; one lane at pos 0, 563 and 4095, and 4 lanes through a page table).
The diagnostic variants compute wrong outputs on purpose: "copy only"
streams the K/V tiles without the math, "math only" does the math on
tiles it never copies. Prints the card's name and power limit, one line a
case, and last a JSON line of all the times.
"""

from __future__ import annotations

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "decode_variants")
ADAPT = "  const int n_split = n_b * n_kh <= 8 ? MMA_WARPS : MMA_WARPS - 1;"
VARIANTS = {
    "as built": [],
    "4 warps": [(ADAPT, "  const int n_split = MMA_WARPS;")],
    "3 warps": [(ADAPT, "  const int n_split = MMA_WARPS - 1;")],
    "CUDA cores": [("    if (g_n <= 16) {\n      return launch_mma", "    if (false) {\n      return launch_mma")],
    "copy only": [("    const uint32_t ka = smem_addr(stage_of(it)), va = ka + TL::BYTES;\n",
                   "    if (true) continue;\n"
                   "    const uint32_t ka = smem_addr(stage_of(it)), va = ka + TL::BYTES;\n")],
    "math only": [("    if (tile_of(it) < hi)\n      load_tile<B16, HD, PAGED>",
                   "    if (false)\n      load_tile<B16, HD, PAGED>")],
}


def build() -> dict:
    procs, libs = {}, {}
    for name, subs in VARIANTS.items():
        d = os.path.join(OUT_DIR, name.replace(" ", "_"))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "flash_decode.cu")
        src = open(path).read()
        for a, b in subs:
            if a not in src:
                raise SystemExit(f"variant {name}: patch target not in flash_decode.cu: {a!r}")
            src = src.replace(a, b)
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "fd.so"), path]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    for name, (d, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name}: nvcc failed:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(d, "fd.so"))
        libs[name] = {}
        for entry in ("flash_decode", "paged_flash_decode"):
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry][1]
            fn.restype = ctypes.c_int
            libs[name][entry] = fn
    return libs


def cases(dev, gen) -> list:
    hd, st, out = 128, torch.cuda.current_stream().cuda_stream, []
    for kh in (8, 4):
        k, v = (torch.randn((1, kh, 4096, hd), device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        q = torch.randn((1, 1, 32, hd), device=dev, generator=gen).to(torch.bfloat16)
        for pos in (0, 563, 4095):
            p = torch.full((1,), pos, dtype=torch.int32, device=dev)
            o = torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), 0, o.data_ptr(), 1, 32,
                    kh, 4096, hd, hd ** -0.5, 1, st)
            out.append((f"slab KH={kh} B=1 pos={pos}", "flash_decode", args, (q, k, v, p, o)))
        (kp, vp), pt, _, _, _ = cs._paged_case(dev, gen, 32, kh, torch.bfloat16)
        for label, poss in (("0,15,16,4095", cs.PAGED_POS), ("500,510,520,530", (500, 510, 520, 530))):
            p = torch.tensor(poss, dtype=torch.int32, device=dev)
            q4 = torch.randn((4, 1, 32, hd), device=dev, generator=gen).to(torch.bfloat16)
            o = torch.empty_like(q4)
            args = (q4.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(), p.data_ptr(),
                    o.data_ptr(), 4, 32, kh, pt.shape[1], cs.PAGE, hd, hd ** -0.5, 1, st)
            out.append((f"paged KH={kh} B=4 pos={label}", "paged_flash_decode", args,
                        (q4, kp, vp, pt, p, o)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    names, rows = list(libs), []
    for label, entry, args, _keep in cases(dev, gen):
        times = {n: [] for n in names}
        for order in (names, names[::-1]):  # in turns: a, b, ..., then back
            for n in order:
                fn = libs[n][entry]
                cs.require(fn(*args) == 0, f"{n} {label}: launch failed")
                times[n].append(cs.time_ms(lambda: fn(*args), dev))
        best = {n: min(t) for n, t in times.items()}
        rows.append(dict(case=label, ms=best))
        print(f"{label:32s} " + " ".join(f"{n} {t:.4f}" for n, t in best.items()))
    print(json.dumps(dict(device=smi, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
