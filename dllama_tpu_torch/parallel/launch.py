"""Start the ranks of a pp x dp x sp x tp world on one host (``torch.multiprocessing``).

The port's counterpart of ``initialize_multihost`` (dllama_tpu/parallel/
mesh.py): where the JAX package runs one program over every chip, the port
runs one process a rank. `spawn` starts ``world`` ranks with the ``spawn``
start method; they meet through a ``file://`` rendezvous in a temporary
directory of their own (no port to collide on, so concurrent launches and
test workers stay apart), each runs ``target(World, *args)`` and sends its
result back to the parent, which returns them in rank order.

A rank on the CPU runs one intra-op thread: the ranks of a world (and
of worlds started side by side) share the host's cores, and more threads
than cores starve the ranks that wait in a collective.

No rank outlives a failure. The process group has a timeout, so a
collective whose peer died or diverged raises within it; the parent waits
for the results under its own deadline, and the first rank that raises,
exits without a result, or outlasts the deadline ends the launch: its
peers are killed and the parent raises with that rank's traceback.

Before it starts the ranks the parent builds the CUDA kernels
(`ops._build.build_all`) when they run on the card, so the ranks load the
libraries and never race on ``build/torch_kernels/``.

`lead` is the launch of a server or a chat (runtime/api_server.py,
cli.py): the calling process is rank 0 (it keeps its stdin, its signals and
its port) and starts the other ranks as children, each running a
follower target (`follower_target`: the same engine, then
parallel/control.follow). A child that fails ends the launch: its
traceback on stderr, the other children killed, and this process exits 1.

The targets live in the port (the ranks import ``torch`` and the port,
nothing else): `cli_target` runs the CLI (cli.py spawns it when a run asks
for more than one rank without torchrun), `engine_target` runs a list of
engine jobs, `lane_target` lists of lane jobs (every rank runs the same
calls), `serve_target` servers whose rank 0 answers given requests while
the other ranks follow, `collective_target` and `ring_target` the
collectives and the ring on given arrays, `moe_target` the MoE FFN on the
ranks' expert slices, `jobs_target` a mix of those on one world.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, NamedTuple

import numpy as np
import torch

from .mesh import DEFAULT_TIMEOUT_S, make_mesh, pick_backend, rank_device, shape_str


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
        else:  # the ranks share the host's cores: one intra-op thread each
            torch.set_num_threads(1)
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


LEAD_JOIN_S = 600.0  # `lead`: how long the followers may take to end after rank 0


def lead(target, follower, world: int, device: str = "cuda", args=()):
    """Run ``target(World, *args)`` here as rank 0 of ``world`` ranks and
    ``follower(World, *args)`` on ranks 1 .. world - 1, children started
    with the ``spawn`` method (module docstring); returns (rank 0's result,
    the followers' results in rank order)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    rank_device(device, world - 1)
    backend = pick_backend(device, world)
    if torch.device(device).type == "cuda":
        from ..ops import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, Any] = {}
    done = threading.Event()
    with tempfile.TemporaryDirectory(prefix="dllama-rdzv-") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, device, backend, init_file, DEFAULT_TIMEOUT_S,
                                   follower, tuple(args), results))
                 for r in range(1, world)]
        for p in procs:
            p.start()
        watcher = threading.Thread(target=_watch, args=(procs, results, got, done),
                                   daemon=True, name="dllama-rank-watch")
        watcher.start()
        dev = rank_device(device, 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=0,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        try:
            out = target(World(0, world, dev, backend), *args)
            deadline = time.monotonic() + LEAD_JOIN_S
            while len(got) < world - 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            missing = sorted(set(range(1, world)) - set(got))
            if missing:
                raise TimeoutError(f"ranks {missing} did not end within {LEAD_JOIN_S:.0f} s of "
                                   "rank 0")
        finally:
            done.set()
            watcher.join(timeout=1.0)  # it polls every 0.2 s
            if dist.is_initialized():
                dist.destroy_process_group()
            _stop(procs)
    return out, [got[r] for r in range(1, world)]


def _watch(procs, results, got: dict, done: threading.Event) -> None:
    """`lead`'s watch over its children: collect their results, and end
    the whole launch at the first that fails or exits without one."""
    while not done.is_set():
        try:
            rank, ok, out = results.get(timeout=0.2)
        except queue_mod.Empty:
            dead = [(r + 1, p.exitcode) for r, p in enumerate(procs)
                    if r + 1 not in got and p.exitcode not in (None, 0)]
            if not dead or done.is_set():
                continue
            msg = f"rank {dead[0][0]} exited with code {dead[0][1]} and no result"
        else:
            if ok:
                got[rank] = out
                continue
            msg = f"rank {rank} of {len(procs) + 1} failed:\n{out}"
        print(msg, file=sys.stderr, flush=True)
        sys.stdout.flush()
        _stop(procs)
        os._exit(1)


def lead_command(run, module: str, argv: list[str], device: str, tp: int, sp: int,
                 pp: int = 1, dp: int = 1):
    """The launch of a server (``module`` "server") or a chat ("cli") over
    pp x dp x sp x tp ranks: print the ranks line, run ``run()`` here as
    rank 0 (stage 0, dp group 0) and the other ranks as followers of the
    same command line (`follower_target`). Returns ``run()``'s result."""
    world = tp * sp * pp * dp
    print(f"🔗 Ranks: {world} ({shape_str(tp, sp, pp, dp)}), backend "
          f"{pick_backend(device, world)}, device {device}", flush=True)
    return lead(lambda w, *_: run(), follower_target, world, device, args=(module, list(argv)))[0]


def follower_target(world: World, module: str, argv: list[str]):
    """A follower rank of a server (``module`` "server") or a chat ("cli"):
    the engine of the same arguments on this rank's device, built with
    stdout silenced (rank 0 alone prints), then parallel/control.follow to
    rank 0's ``stop``. Returns follow's summary."""
    from ..cli import _build_parser, load_engine
    from .control import follow

    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        if module == "server":
            from ..runtime.api_server import build_parser

            args = build_parser().parse_args(argv)
        else:
            args = _build_parser().parse_args(argv)
        args.device = str(world.device)
        engine, _ = load_engine(args)
    return follow(engine, engine.mesh)


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


def _mesh_of(world: World, job: dict):
    """The `Mesh` of a job's ``tp``, ``sp``, ``pp`` and ``dp`` (each 1 by
    default) over this world."""
    return make_mesh(job.get("tp", 1), job.get("sp", 1), world.device, world.backend,
                     pp=job.get("pp", 1), dp=job.get("dp", 1))


def _axes(mesh) -> dict:
    """The engine's mesh arguments from a `Mesh`."""
    return dict(tp=mesh.tp.size, sp=mesh.sp.size, pp=mesh.pp.size, dp=mesh.dp.size,
                mesh=mesh if mesh.world > 1 else None)


def engine_target(world: World, jobs: list[dict]) -> list[dict]:
    """Engine jobs on one world, each on its own `Mesh`: a dict of the
    engine's arguments (``tp``, ``sp``, ``pp``, ``dp``, ``batch_size``,
    ``model``, ``dtype`` "f32"/"bf16",
    ``weight_format``, ``buffer_float_type``, ``kv_dtype``, ``temperature``,
    ``seed``)
    and of what to run: ``logits`` (a token list: its prefill logits, all
    rows, from a fresh cache), ``step_logits`` (a prompt: its prefill, then
    the logits of one decode step of its last token), ``generate`` (a list
    of (prompt, steps, block_size, start_pos) calls in turn on one cache),
    ``forward`` (a list of (tokens, n_micro): each one `models.forward` of
    every row from a fresh cache in n_micro sequence waves, its logits and
    the rank's K/V cache after it), ``generate_batch`` (prompts and
    max_steps: one prompt a lane),
    ``timed_steps`` (n: that many decode steps after the generate calls,
    each bracketed by CUDA events on the card: the medians of a step's
    device ms, its collectives' host ms and bytes), ``perplexity`` (a token
    list). Each job's result holds what it ran, numpy or lists, and the
    kernel launches of the job (``launches``), the rank's layer weight
    bytes (``layer_bytes``) and expert bytes (``expert_bytes``) and its
    device's allocated bytes."""
    from ..obs.cost import param_bytes
    from ..ops import launch_counts, reset_launch_counts
    from ..runtime.engine import InferenceEngine

    out = []
    for job in jobs:
        reset_launch_counts()
        mesh = _mesh_of(world, job)
        eng = InferenceEngine(
            job["model"], dtype=torch.float32 if job.get("dtype", "f32") == "f32"
            else torch.bfloat16, temperature=job.get("temperature", 0.0),
            seed=job.get("seed", 12345), weight_format=job.get("weight_format", "dense"),
            device=world.device, buffer_float_type=job.get("buffer_float_type", "f32"),
            kv_dtype=job.get("kv_dtype"), batch_size=job.get("batch_size", 1), **_axes(mesh),
        )
        weights = param_bytes(eng.params, eng.header)
        res: dict = {"i8_group": eng.i8_group, "buckets": list(eng.prefill_buckets),
                     "layer_bytes": weights["layers"], "expert_bytes": weights["experts"],
                     "stage": mesh.pp.index, "dp_group": mesh.dp.index}
        if "logits" in job:
            res["logits"] = _np(eng.prompt_logits(job["logits"]))
        if "forward" in job:
            res["forward"] = [_forward_job(eng, toks, n_micro) for toks, n_micro in job["forward"]]
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
        if "generate_batch" in job:
            prompts, steps = job["generate_batch"]
            res["generate_batch"] = eng.generate_batch(prompts, steps)
        if "timed_steps" in job:
            res["timed"] = _timed_steps(eng, job["timed_steps"], res["generate"][-1][0],
                                        job["generate"][-1])
        if "perplexity" in job:
            res["perplexity"] = eng.perplexity(job["perplexity"])
        res["cache_shape"] = list(eng.cache["k"].shape)
        res["launches"] = launch_counts()
        res["allocated"] = (torch.cuda.memory_allocated(world.device)
                            if world.device.type == "cuda" else 0)
        out.append(res)
        del eng
    return out


@torch.inference_mode()
def _forward_job(eng, tokens: list[int], n_micro: int):
    """(logits [T, V], {"k", "v": the rank's cache values}) of one forward of
    ``tokens`` at 0 from a fresh cache on the engine's mesh, in ``n_micro``
    waves."""
    from ..models import forward
    from ..ops.kv_cache import kv_tensors

    eng.reset()
    tok = torch.tensor([tokens], dtype=torch.int64, device=eng.device)
    kw = dict(eng._mesh_kw(len(tokens)), n_micro=n_micro)
    logits, cache = forward(eng.params, eng.header, tok, 0, eng.cache, logits_mode="all", **kw)
    # a copy: the next forward rewrites the engine's cache in place
    return _np(logits[0]), {k: _np(kv_tensors(v)[0].clone()) for k, v in cache.items()}


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
    cyclic), every rank a whole copy, k and v dense or each an int8 pair
    (values, row scales [B, KH, S, 1]); returns each job's gathered output.
    A sixth element ``shards`` (the rows of each rank's KV shard) runs
    `ring_attention_local` on those rows, rank i's queries the i-th
    T/world of q at ``q_pos0 + i T/world``."""
    from ..ops.kv_cache import QuantKV, kv_rows
    from .collectives import all_gather
    from .ring_attention import ring_attention, ring_attention_local

    mesh = make_mesh(1, world.size, world.device, world.backend)

    def dev(a):
        if isinstance(a, (tuple, list)):
            return QuantKV(*(torch.as_tensor(np.asarray(x)).to(world.device) for x in a))
        return torch.as_tensor(np.asarray(a)).to(world.device)

    out = []
    for q, k, v, q_pos0, cyclic, *shards in jobs:
        q, k, v = dev(q), dev(k), dev(v)
        if not shards:
            out.append(_np(ring_attention(q, k, v, mesh.sp, q_pos0, cyclic)))
            continue
        rows = torch.as_tensor(shards[0][world.rank], device=world.device)
        tq = q.shape[1] // world.size
        z = ring_attention_local(q[:, world.rank * tq:(world.rank + 1) * tq].contiguous(),
                                 kv_rows(k, rows), kv_rows(v, rows), q_pos0 + world.rank * tq,
                                 rows.numel(), mesh.sp, cyclic)
        out.append(_np(all_gather(z, mesh.sp, dim=1)))
    return out


def moe_target(world: World, jobs: list[dict]) -> list[dict]:
    """`models.transformer.moe_ffn` jobs on a tp axis of the whole world:
    a dict of ``x`` [B, T, D], ``gate`` [E, D], the whole experts ``w1``,
    ``w2``, ``w3`` in the port's layout (an array, or a Q40 pair (values,
    scales)), ``k`` and optional ``dedup``, ``sync_quant`` and ``dtype``
    ("f32" or "bf16": x's type and the dense experts'). Each rank runs the
    FFN on its F/tp slices (parallel/sharding.py) and returns the output and
    the two-tier tally it added."""
    import types

    from ..models.transformer import moe_ffn
    from ..ops.moe import tier_tally
    from ..ops.quant_matmul import QuantWeight
    from .sharding import role_of, shard_tensor

    mesh = make_mesh(world.size, 1, world.device, world.backend)

    def dev(a):
        if isinstance(a, (tuple, list)):
            return QuantWeight(*(torch.as_tensor(np.asarray(x)).to(world.device) for x in a))
        return torch.as_tensor(np.asarray(a)).to(world.device)

    out = []
    for job in jobs:
        dtype = torch.float32 if job.get("dtype", "f32") == "f32" else torch.bfloat16
        lp = {"moe_gate": dev(job["gate"])}
        for w in ("w1", "w2", "w3"):
            leaf = dev(job[w])
            leaf = leaf if isinstance(leaf, QuantWeight) else leaf.to(dtype)
            lp[w] = shard_tensor(leaf, role_of(w), mesh.tp.size, mesh.tp.index)
        h = types.SimpleNamespace(n_active_experts=job["k"])
        tally = tier_tally(world.device)
        before = tally.clone()
        y = moe_ffn(dev(job["x"]).to(dtype), lp, h, False, job.get("dedup", False), mesh.tp,
                    job.get("sync_quant", False))
        out.append({"out": _np(y), "tally": (tally - before).tolist(),
                    "w1_shape": list(getattr(lp["w1"], "q", lp["w1"]).shape)})
    return out


def _job_engine(world: World, job: dict):
    """The engine of a lane or server job on this rank, and its mesh (the
    two-tier tally zeroed)."""
    from ..ops.moe import tier_tally
    from ..runtime.engine import DEFAULT_PREFILL_BUCKETS, InferenceEngine

    mesh = _mesh_of(world, job)
    eng = InferenceEngine(
        job["model"], dtype=torch.float32 if job.get("dtype", "f32") == "f32" else torch.bfloat16,
        temperature=job.get("temperature", 0.0), seed=job.get("seed", 12345),
        weight_format=job.get("weight_format", "dense"), device=world.device,
        kv_dtype=job.get("kv_dtype"), batch_size=job.get("batch_size", 1),
        prefill_buckets=tuple(job.get("buckets", DEFAULT_PREFILL_BUCKETS)),
        moe_decode_dedup=job.get("moe_decode_dedup", "auto"), **_axes(mesh),
    )
    tier_tally(world.device).zero_()
    return eng, mesh


def _rank_facts(eng) -> dict:
    """What a job reports of a rank besides its answers: its stage and dp
    group, its epochs, kernel launches and the two-tier tally (Qwen3-MoE's
    dedup: layer-steps on the grouped tier, layer-steps in two tiers), the
    shapes of its lanes' slab and pool and a page's bytes."""
    from ..ops import launch_counts
    from ..ops.moe import tier_tally

    mesh = eng.mesh
    return {
        "stage": mesh.pp.index if mesh is not None else 0,
        "dp_group": mesh.dp.index if mesh is not None else 0,
        "cache_epoch": eng.cache_epoch, "kv_pool_epoch": eng.kv_pool_epoch,
        "kv_cross_dp_pages": eng.kv_cross_dp_pages,
        "draft_cache_epoch": eng.draft_cache_epoch, "launches": launch_counts(),
        "tier_tally": tier_tally(eng.device).tolist(),
        "lane_shape": None if eng.lane_cache is None else list(eng.lane_cache["k"].shape),
        "pool_shape": None if eng.kv_pool is None else list(
            getattr(eng.kv_pool["k"], "q", eng.kv_pool["k"]).shape),
        "page_bytes": eng.kv_page_bytes() if eng.kv_pool is not None else 0,
        "allocated": (torch.cuda.memory_allocated(eng.device) if eng.device.type == "cuda"
                      else 0),
    }


def _tokens_of(out):
    """A call's return as plain data: token lists and ints, None else."""
    if isinstance(out, (list, int)):
        return out
    if isinstance(out, tuple) and out and isinstance(out[0], int):
        return out[0]
    return None


def lane_target(world: World, jobs: list[dict]) -> list[dict]:
    """Lane jobs, every rank running the same calls (the deterministic
    program of `engine_target`): a dict of the engine's arguments (those of
    `engine_target` and ``batch_size``, ``buckets``) and ``script``, a list
    of (method, args) engine calls made in turn. Each call's tokens come
    back in ``script`` (an error as ("error", its type, its message),
    which ends nothing), with `_rank_facts`."""
    from ..ops import reset_launch_counts

    out = []
    for job in jobs:
        reset_launch_counts()
        eng, _ = _job_engine(world, job)
        calls = []
        for name, args in job["script"]:
            try:
                calls.append(_tokens_of(getattr(eng, name)(*args)))
            except Exception as e:  # a refusal the job checks for
                calls.append(("error", type(e).__name__, str(e)))
        out.append(dict(script=calls, **_rank_facts(eng)))
        del eng
        _release(world.device)
    return out


def ask(url: str, payload: dict, timeout: float = 600.0):
    """One completion from a server at ``url``, streamed or not: its
    content, or ("error", the HTTP status or "stream", the error body)."""
    return ask_counted(url, payload, timeout)[0]


def ask_counted(url: str, payload: dict, timeout: float = 600.0):
    """`ask`'s answer and the completion's token count (the response's
    ``usage``; None for a stream or an error)."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/v1/chat/completions", method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
    except urllib.error.HTTPError as e:
        return ("error", e.code, e.read().decode()), None
    if not payload.get("stream"):
        body = json.loads(raw)
        return body["choices"][0]["message"]["content"], body["usage"]["completion_tokens"]
    content = ""
    for line in raw.split("\r\n"):
        if line.startswith("data: {"):
            chunk = json.loads(line[6:])
            if "error" in chunk:
                return ("error", "stream", json.dumps(chunk["error"])), None
            content += (chunk["choices"][0].get("delta") or {}).get("content") or ""
    return content, None


def ask_all(url: str, payloads: list[dict], concurrent: bool = True, counted: bool = False):
    """`ask` each payload, from one thread each (``concurrent``) or in turn;
    with ``counted`` each answer with its token count (`ask_counted`)."""
    fn = ask_counted if counted else ask
    if not concurrent:
        return [fn(url, p) for p in payloads]
    answers: list = [None] * len(payloads)

    def one(i):
        answers[i] = fn(url, payloads[i])

    threads = [threading.Thread(target=one, args=(i,), daemon=True, name=f"dllama-ask-{i}")
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers


def serve_target(world: World, jobs: list[dict]) -> list[dict]:
    """Server jobs: every rank builds the engine of the job (`lane_target`'s
    arguments); rank 0 controls (parallel/control.Controller) a server
    (runtime/api_server.serve with the job's ``serve`` arguments) on a free
    localhost port and asks it each payload of ``requests`` (``rounds``
    times, each after ``idle_s`` seconds of silence, all at once), then
    stops; every other rank follows. Each
    rank's result: the control plane's ``summary`` (its digest of the
    tokens returned), `_rank_facts`, and on rank 0 the ``answers`` of each
    round, their ``tokens`` (None for a stream), the round's wall seconds and
    the server's ``health``.
    ``control_timeout_s`` is the control group's timeout."""
    import json
    import urllib.request

    from ..ops import reset_launch_counts
    from ..runtime import faults
    from .control import Controller, follow

    out = []
    for job in jobs:
        reset_launch_counts()
        eng, mesh = _job_engine(world, job)
        timeout_s = job.get("control_timeout_s", DEFAULT_TIMEOUT_S)
        res: dict = {}
        if world.rank == 0:
            from ..runtime.api_server import serve
            from ..tokenizer import Tokenizer

            ctl = Controller(eng, mesh, timeout_s=timeout_s)
            srv = serve(eng, Tokenizer(job["tokenizer"]), host="127.0.0.1", port=0,
                        **job.get("serve", {}))
            srv_thread = threading.Thread(target=srv.serve_forever, daemon=True,
                                          name="dllama-serve")
            srv_thread.start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                res["answers"], res["tokens"], res["wall_s"] = [], [], []
                for _ in range(job.get("rounds", 1)):
                    time.sleep(job.get("idle_s", 0.0))
                    t0 = time.perf_counter()
                    got = ask_all(url, job["requests"], counted=True)
                    res["wall_s"].append(time.perf_counter() - t0)
                    res["answers"].append([a for a, _ in got])
                    res["tokens"].append([n for _, n in got])
                with urllib.request.urlopen(url + "/v1/health", timeout=60) as r:
                    res["health"] = json.loads(r.read())
            finally:
                srv.shutdown()
                srv_thread.join()
                srv.server_close()
                res["summary"] = ctl.stop()
                faults.set_fault_plane("")
        else:
            res["summary"] = follow(eng, mesh, timeout_s=timeout_s)
        out.append(dict(res, **_rank_facts(eng)))
        del eng
        _release(world.device)
    return out


def _release(device: torch.device) -> None:
    """Give a dropped job's device memory back before the next job builds
    its engine."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def jobs_target(world: World, jobs: list[tuple]) -> list:
    """Jobs of the targets above on one world, in order: (``"engine"``,
    dict), (``"lanes"``, dict), (``"serve"``, dict), (``"collective"``,
    tuple), (``"ring"``, tuple) or (``"moe"``, dict)."""
    targets = {"engine": engine_target, "lanes": lane_target, "serve": serve_target,
               "collective": collective_target, "ring": ring_target, "moe": moe_target}
    return [targets[kind](world, [job])[0] for kind, job in jobs]
