#!/usr/bin/env python3
"""The attention kernels of two checkouts of the port, side by side on one card.

    python3 scripts/torch_kernel_ab.py OLD_ROOT [NEW_ROOT]   # NEW_ROOT defaults to this checkout

Runs OLD, NEW, NEW, OLD, each in a process of its own from its root: it
builds that checkout's ``flash_attention`` and ``flash_decode`` sources
(ptxas's kernel count, registers and spill stores a source, and each kernel
that spills), then times the rows of ``chip_smoke.check_attention``,
``check_mixed``, ``check_paged_decode`` and ``check_slab_lanes`` (the
kernels' entries at the main path's shapes) with that checkout's
``chip_smoke.py``; a checkout that has them also runs
``check_attention_strided`` and ``check_decode_stats``, and times the f32
output dense product (``models.transformer._dense_f32``) of a bf16 weight
against the product of f32 copies. Prints the card's name and power limit
and one ``CMP`` line a row: the four times in ms, in run order.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

SOURCES = ("flash_attention", "flash_decode")
# (m, n, k) of a bf16 product with an f32 output: llama-8b's wo and w2 at
# tp = 2 for one row and a 512-row chunk, and its logits head
DENSE_SHAPES = ((1, 4096, 2048), (1, 4096, 7168), (512, 4096, 2048), (512, 4096, 7168),
                (1, 128256, 4096))


def probe(root: str, tag: str) -> None:
    """One checkout's build and rows (run from its root)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from dllama_tpu_torch.ops import _build

    started = {n: _build._start(n) for n in SOURCES}
    for n, s in started.items():
        if s is not None:
            _build._finish(n, s)
    for name, log in _build.ptxas_log.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", log))
        print(f"{tag} ptxas {name}: {len(regs)} kernels, registers <= {max(regs, default=0)}, "
              f"spill stores {spills} B", flush=True)
        for line in cs.ptxas_kernels(log):
            if not line.endswith("spill stores 0 B"):
                print(f"{tag}   {line}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    rows = (cs.check_attention(dev, gen) + cs.check_mixed(dev, gen)
            + cs.check_paged_decode(dev, gen) + cs.check_slab_lanes(dev, gen))
    new = hasattr(cs, "check_decode_stats")
    if new:
        rows += cs.check_attention_strided(dev, gen) + cs.check_decode_stats(dev, gen)
    for r in rows:
        if r["name"].startswith(("flash", "paged_flash")) and r.get("ms") is not None:
            print("ROW " + json.dumps(dict(name=r["name"], shape=r["shape"], ms=r["ms"])),
                  flush=True)
    if not new:
        return
    from dllama_tpu_torch.models.transformer import _dense_f32

    for m, n, k in DENSE_SHAPES:
        x = torch.randn(1, m, k, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(n, k, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        got = _dense_f32(x, w)
        ref = torch.matmul(x.float(), w.float().t())
        err = float((got - ref).abs().max() / ref.abs().max())
        cs.require(got.dtype == torch.float32 and err < 1e-3, f"dense_f32 m={m}: err {err:.3e}")
        ms = cs.time_ms(lambda: _dense_f32(x, w), dev)
        ms_copy = cs.time_ms(lambda: torch.matmul(x.float(), w.float().t()), dev)
        print(f"{tag} dense_f32 bf16 m={m} n={n} k={k}: f32 out, err vs the f32 copies' product "
              f"{err:.3e}; {ms:.4f} ms, with f32 copies of both {ms_copy:.4f} ms", flush=True)


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--probe":
        probe(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: this needs a CUDA card", file=sys.stderr)
        return 1
    old = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    new = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else here
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; temp dir "
          f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.1f} GB free of "
          f"{shutil.disk_usage(tempfile.gettempdir()).total / 1e9:.1f}", flush=True)
    order = (("old1", old), ("new1", new), ("new2", new), ("old2", old))
    times: dict[tuple, dict] = {}
    for tag, root in order:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--probe", root, tag],
                           capture_output=True, text=True, timeout=900)
        for line in p.stdout.splitlines():
            if line.startswith("ROW "):
                r = json.loads(line[4:])
                times.setdefault((r["name"], r["shape"]), {})[tag] = r["ms"]
            else:
                print(line)
        if p.returncode:
            print(p.stderr[-6000:], file=sys.stderr)
            return 1
        print(f"{tag} ({root}): {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi)
    for (name, shape), v in times.items():
        ms = " ".join("-" if v.get(t) is None else f"{v[t]:.4f}" for t, _ in order)
        print(f"CMP {name:30s} {shape:56s} old new new old: {ms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
