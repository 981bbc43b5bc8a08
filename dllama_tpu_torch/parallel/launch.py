"""Start the ranks of a tp x sp world on one host (``torch.multiprocessing``).

The port's counterpart of ``initialize_multihost`` (dllama_tpu/parallel/
mesh.py): where the JAX package runs one program over every chip, the port
runs one process a rank. `spawn` starts ``world`` ranks with the ``spawn``
start method; they meet through a ``file://`` rendezvous in a temporary
directory of their own (no port to collide on, so concurrent launches and
test workers stay apart), each runs ``target(World, *args)`` and sends its
result back to the parent, which returns them in rank order.

No rank outlives a failure. The process group has a timeout, so a
collective whose peer died or diverged raises within it; the parent waits
for the results under its own deadline, and the first rank that raises,
exits without a result, or outlasts the deadline ends the launch: its
peers are killed and the parent raises with that rank's traceback.

Before it starts the ranks the parent builds the CUDA kernels
(`ops._build.build_all`) when they run on the card, so the ranks load the
libraries and never race on ``build/torch_kernels/``.

The targets live in the port (the ranks import ``torch`` and the port,
nothing else): `cli_target` runs the CLI (cli.py spawns it when a run asks
for more than one rank without torchrun), `engine_target` runs a list of
engine jobs, `collective_target` and `ring_target` the collectives and the
ring on given arrays, `jobs_target` a mix of those on one world.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, NamedTuple

import numpy as np
import torch

from .mesh import DEFAULT_TIMEOUT_S, make_mesh, pick_backend, rank_device


class World(NamedTuple):
    """What a target learns of its rank: rank, world size, device, backend."""

    rank: int
    size: int
    device: torch.device
    backend: str


def _rank_main(rank: int, world: int, device: str, backend: str, init_file: str,
               timeout_s: float, target, args, results) -> None:
    import torch.distributed as dist

    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = target(World(rank, world, dev, backend), *args)
        results.put((rank, True, out))
    except BaseException:  # the parent ends the launch with this traceback
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    """Kill every rank still running (by its own process handle)."""
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def spawn(target, world: int, device: str = "cuda", backend: str | None = None, args=(),
          timeout_s: float = 600.0, pg_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``target(World, *args)`` on ranks 0 .. world - 1 and return their
    results in rank order (module docstring). ``device`` places the ranks
    as `mesh.rank_device` does (the card by default: it raises before any
    rank starts when the host has no card, or too few); ``backend``
    defaults to `mesh.pick_backend`'s rule. ``timeout_s`` bounds the whole launch, ``pg_timeout_s`` each
    collective."""
    import torch.multiprocessing as mp

    rank_device(device, world - 1)
    backend = backend or pick_backend(device, world)
    if torch.device(device).type == "cuda":
        from ..ops import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="dllama-rdzv-") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, device, backend, init_file, pg_timeout_s, target,
                                   tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"ranks {missing} gave no result within {timeout_s:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode not in (None, 0):
                            raise RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                               "and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
                got[rank] = out
        finally:
            if len(got) < world:
                _stop(procs)
        for p in procs:
            p.join(timeout=30)
        _stop(procs)
    return [got[r] for r in range(world)]


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else x


def cli_target(world: World, argv: list[str]):
    """The CLI on one rank, on the rank's device (cli.main prints on rank 0
    alone). Returns the run's tokens."""
    from .. import cli

    out = cli.main(list(argv) + ["--device", str(world.device)])
    if isinstance(out, dict):
        return {k: v for k, v in out.items() if k in ("tokens", "prompt_tokens")}
    return None


def engine_target(world: World, jobs: list[dict]) -> list[dict]:
    """Engine jobs on one world, each on its own `Mesh`: a dict of the
    engine's arguments (``tp``, ``sp``, ``model``, ``dtype`` "f32"/"bf16",
    ``weight_format``, ``buffer_float_type``, ``kv_dtype``, ``temperature``,
    ``seed``)
    and of what to run: ``logits`` (a token list: its prefill logits, all
    rows, from a fresh cache), ``step_logits`` (a prompt: its prefill, then
    the logits of one decode step of its last token), ``generate`` (a list
    of (prompt, steps, block_size, start_pos) calls in turn on one cache),
    ``timed_steps`` (n: that many decode steps after the generate calls,
    each bracketed by CUDA events on the card: the medians of a step's
    device ms, its collectives' host ms and bytes), ``perplexity`` (a token
    list). Each job's result holds what it ran, numpy or lists, and the
    kernel launches of the job (``launches``), the rank's layer weight
    bytes (``layer_bytes``) and its device's allocated bytes."""
    from ..obs.cost import param_bytes
    from ..ops import launch_counts, reset_launch_counts
    from ..runtime.engine import InferenceEngine

    out = []
    for job in jobs:
        reset_launch_counts()
        mesh = make_mesh(job.get("tp", 1), job.get("sp", 1), world.device, world.backend)
        eng = InferenceEngine(
            job["model"], dtype=torch.float32 if job.get("dtype", "f32") == "f32"
            else torch.bfloat16, temperature=job.get("temperature", 0.0),
            seed=job.get("seed", 12345), weight_format=job.get("weight_format", "dense"),
            device=world.device, tp=mesh.tp.size, sp=mesh.sp.size, mesh=mesh,
            buffer_float_type=job.get("buffer_float_type", "f32"), kv_dtype=job.get("kv_dtype"),
        )
        res: dict = {"i8_group": eng.i8_group, "buckets": list(eng.prefill_buckets),
                     "layer_bytes": param_bytes(eng.params, eng.header)["layers"]}
        if "logits" in job:
            res["logits"] = _np(eng.prompt_logits(job["logits"]))
        if "step_logits" in job:
            prompt = job["step_logits"]
            eng.reset()
            eng.prefill(prompt)
            res["step_logits"] = _np(eng.step_logits(prompt[-1], len(prompt) - 1))
        if "generate" in job:
            eng.reset()
            res["generate"] = []
            for prompt, steps, block, start in job["generate"]:
                toks, ev, pred = eng.generate(prompt, max_steps=steps, block_size=block,
                                              start_pos=start)
                res["generate"].append((toks, ev.n_tokens, pred.n_tokens))
        if "timed_steps" in job:
            res["timed"] = _timed_steps(eng, job["timed_steps"], res["generate"][-1][0],
                                        job["generate"][-1])
        if "perplexity" in job:
            res["perplexity"] = eng.perplexity(job["perplexity"])
        res["cache_shape"] = list(eng.cache["k"].shape)
        res["launches"] = launch_counts()
        if world.device.type == "cuda":
            res["allocated"] = torch.cuda.memory_allocated(world.device)
        out.append(res)
        del eng
    return out


def _timed_steps(eng, n: int, tokens: list[int], call) -> dict:
    """Medians over ``n`` decode steps continuing the last generate call:
    a step's device ms (CUDA events on the card, host ms on the CPU), the
    host ms and the bytes of its collectives (`collectives.STATS`)."""
    import statistics

    from .collectives import STATS

    prompt, _, _, start = call
    pos = start + len(prompt) - 1 + len(tokens)
    token = tokens[-1]
    dev_ms, coll_ms, coll_b = [], [], []
    for _ in range(n):
        STATS.reset()
        if eng.device.type == "cuda":
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            token, stats = eng.decode_step(token, pos)
            t1.record()
            t1.synchronize()
            dev_ms.append(t0.elapsed_time(t1))
        else:
            token, stats = eng.decode_step(token, pos)
            dev_ms.append(stats.time_ms)
        coll_ms.append(STATS.seconds * 1000)
        coll_b.append(STATS.bytes)
        pos += 1
    return {"device_ms": statistics.median(dev_ms), "collective_ms": statistics.median(coll_ms),
            "collective_bytes": statistics.median(coll_b), "calls": STATS.calls}


def collective_target(world: World, jobs: list[tuple]) -> list:
    """Collective jobs: (``"all_reduce"``, tp, quantized, x [world, ...]),
    (``"all_gather"``, tp, dim, x [world, ...]) or (``"shift"``, sp, x
    [world, ...]); rank r contributes x[r]. Returns each job's f32 result."""
    from . import collectives as c

    out = []
    for job in jobs:
        kind, n = job[0], job[1]
        mesh = make_mesh(n, world.size // n, world.device, world.backend)
        x = torch.as_tensor(job[-1][world.rank]).to(world.device)
        if kind == "all_reduce":
            out.append(_np(c.all_reduce(x, mesh.tp, job[2])))
        elif kind == "all_gather":
            out.append(_np(c.all_gather(x, mesh.tp, job[2])))
        else:
            out.append(_np(c.ring_shift(x, mesh.tp)))
    return out


def ring_target(world: World, jobs: list[tuple]) -> list:
    """Ring attention jobs: (q [B, T, H, hd], k, v [B, KH, S, hd], q_pos0,
    cyclic), every rank a whole copy; returns each job's gathered output."""
    from .ring_attention import ring_attention

    mesh = make_mesh(1, world.size, world.device, world.backend)
    out = []
    for q, k, v, q_pos0, cyclic in jobs:
        args = [torch.as_tensor(np.asarray(a)).to(world.device) for a in (q, k, v)]
        out.append(_np(ring_attention(*args, mesh.sp, q_pos0, cyclic)))
    return out


def jobs_target(world: World, jobs: list[tuple]) -> list:
    """Jobs of the targets above on one world, in order: (``"engine"``,
    dict), (``"collective"``, tuple) or (``"ring"``, tuple)."""
    targets = {"engine": engine_target, "collective": collective_target, "ring": ring_target}
    return [targets[kind](world, [job])[0] for kind, job in jobs]
