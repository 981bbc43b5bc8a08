"""The engine's step programs as CUDA graphs: captured once a shape, replayed.

Counterpart of the JAX engine's compile cache (``_compiled`` and
``_compile_lock`` in dllama_tpu/runtime/engine.py), which holds one
AOT-compiled program a shape. The port launches the same kernels and torch
ops from Python; `StepGraphs` records one shape's launches into a CUDA
graph and replays it, so a block of forwards costs the host one launch.
Keys follow the JAX program keys: ``("block", n, greedy)``, ``("prefill",
t, paged)``, ``("score", t)``, ``("lane_prefill_paged", t)``,
``("lane_block_paged", n, sampled)``, ``("lane_verify_paged", t)``,
``("step", greedy)``.

A step reads its inputs from static buffers (`buffers`: tokens, the base
position, the lanes' positions, a page-table row, temperatures, top-p
values, seeds), which the engine fills with `put` before a run, and writes
what its caller reads into static outputs. Both are allocated outside the
graphs' memory pool: every graph shares one pool, so a tensor made inside
a capture is scratch that the next replay of another graph may overwrite.

The first run of a key is eager and does the real work: it builds and
loads the kernels' libraries, and the launchers set their shared-memory
attributes. Then the key is captured (a capture runs nothing) and every
later run replays it. A capture or replay that fails raises; nothing falls
back to the eager path.

The kernel wrappers count their launches in Python attributes (``ops``
``KERNELS``), which a replay does not move and a capture would move for
kernels that never ran. So a capture leaves the counters as they were and
keeps what the step added as the graph's tally, and each replay adds the
tally: the counts stay those of an eager run.

Graphs run only on a CUDA device and only while ``enabled`` (the engine's
``cuda_graphs``); otherwise every run is eager. On the CPU ``enabled`` is
ignored. Like the engine that owns it, a `StepGraphs` serves one thread
at a time.

Every capture keeps its ``cudaGraph_t`` (``CUDAGraph(keep_graph=True)``)
and instantiates it at the end of the capture, which is what PyTorch
does by default. While ``inspect`` is set (the engine's ``DLLAMA_XLALINT``
is not off), the kept graph's nodes are read through the CUDA driver
(analysis/graphlint.py `read_graph`) into ``nodes`` and the sizes of the
pool blocks the capture left allocated (what outlives it) into
``pool_blocks``, after the graph is stored. A read that fails is kept in
``read_errors`` for the capture hook, and the graph stands.
``lint_seconds`` holds what reading (and the engine's lint,
`on_capture`) added to each capture.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..ops import KERNELS, launch_counts


def _add_launches(tally: dict[str, int], sign: int = 1) -> None:
    for name, n in tally.items():
        KERNELS[name].launches += sign * n


class StepGraphs:
    """One engine's graphs, static buffers and capture statistics."""

    def __init__(self, device: torch.device, enabled: bool = True):
        self.device = device
        self.enabled = enabled
        self._graphs: dict = {}  # key -> (replayable graph, launch tally)
        self._buffers: dict = {}  # key -> dict of static tensors
        self._pool = None
        self.capture_s = 0.0  # seconds spent capturing
        self.capture_seconds: dict = {}  # key -> its capture's seconds
        self.replays = 0
        # called as on_capture(key, seconds) after each capture (the
        # engine's compile counter and flight recorder)
        self.on_capture: Callable | None = None
        # called once, right before the next run's replay or eager step,
        # then cleared (the engine's dispatch timing starts there)
        self.before_run: Callable | None = None
        # graph inspection for the lint (module docstring): key -> node list,
        # the pool blocks its capture left allocated, the exception a read
        # raised, the seconds reading and linting took
        self.inspect = False
        self.nodes: dict = {}
        self.pool_blocks: dict = {}
        self.read_errors: dict = {}
        self.lint_seconds: dict = {}

    @property
    def active(self) -> bool:
        return self.enabled and self.device.type == "cuda"

    @property
    def n_graphs(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        """Every key run so far, captured or eager."""
        return list(dict.fromkeys([*self._buffers, *self._graphs]))

    def count(self, kind: str) -> int:
        """Graphs whose key starts with ``kind``."""
        return sum(1 for key in self._graphs if key[0] == kind)

    def clear(self) -> None:
        """Drop every graph and buffer (the tensors they point at changed),
        and the pool with them: later captures take a new one. A block that
        a capture allocated and something outlives the graphs with (cuBLAS
        keeps the workspace of a dense product captured on the capture
        stream, as the draft model's are) keeps the old pool alive with no
        graph, and a capture into such a pool fails inside the caching
        allocator."""
        self._graphs.clear()
        self._buffers.clear()
        self.capture_seconds.clear()
        self.nodes.clear()
        self.pool_blocks.clear()
        self.read_errors.clear()
        self.lint_seconds.clear()
        self._pool = None

    def buffers(self, key, make: Callable[[], dict]) -> dict:
        """The static buffers of ``key``, made by ``make()`` on first use."""
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = make()
        return bufs

    def put(self, dst: torch.Tensor, values) -> None:
        """Fill a static input from host values: a copy from pinned memory
        on the card (the host allocator keeps the pinned block until the
        copy has run), a plain copy on the CPU."""
        src = torch.as_tensor(np.asarray(values), dtype=dst.dtype).reshape(dst.shape)
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def run(self, key, step: Callable[[], None]) -> None:
        """Run ``step`` as the graph of ``key``: eager on its first use (and
        whenever graphs are off), captured after that first use, replayed
        on every later run."""
        hook, self.before_run = self.before_run, None
        if hook is not None:
            hook()
        if not self.active:
            step()
            return
        entry = self._graphs.get(key)
        if entry is not None:
            graph, tally = entry
            graph.replay()
            _add_launches(tally)
            self.replays += 1
            return
        step()
        self._capture(key, step)

    def _capture(self, key, step: Callable[[], None]) -> None:
        """Capture ``step`` as the graph of ``key`` and keep it before it is
        read and before the capture hook runs: a hook that raises (a strict
        lint) fails this run, and the graph still holds its share of the
        pool, which later captures use."""
        before = launch_counts()
        inspect = self.inspect and self.device.type == "cuda"
        t0 = time.perf_counter()
        blocks0 = self._read(key, self._pool_block_set) if inspect else None
        lint_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            graph = self._record(step)
        finally:
            after = launch_counts()
            tally = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            _add_launches(tally, -1)
            dt = time.perf_counter() - t0
            self.capture_s += dt
            self.capture_seconds[key] = dt
        self._graphs[key] = graph, tally
        if inspect:
            from ..analysis.graphlint import read_graph

            t0 = time.perf_counter()
            nodes = self._read(key, lambda: read_graph(graph.raw_cuda_graph()))
            if nodes is not None:
                self.nodes[key] = nodes
            blocks = self._read(key, self._pool_block_set) if blocks0 is not None else None
            if blocks is not None:
                self.pool_blocks[key] = sorted(s for _, s in blocks - blocks0)
            self.lint_seconds[key] = lint_s + time.perf_counter() - t0
        if self.on_capture is not None:
            self.on_capture(key, self.capture_seconds[key])

    def _read(self, key, read: Callable):
        """One read of a capture's inspection, or None when it raised: the
        exception is kept in ``read_errors`` for the capture hook."""
        try:
            return read()
        except Exception as e:  # dlint: disable=silent-except — handed to the capture hook, which records it (xlalint_error) or raises it in strict mode
            self.read_errors.setdefault(key, e)
            return None

    def _record(self, step: Callable[[], None]):
        """Capture ``step`` into a CUDA graph in the shared pool, kept for
        reading, and instantiate it: the graph a replay runs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            step()
        graph.instantiate()
        return graph

    def _pool_block_set(self) -> set:
        """(address, bytes) of every allocated block in the graphs' pool."""
        out = set()
        if self._pool is None:
            return out
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", ())) != tuple(self._pool):
                continue
            addr = seg["address"]
            for block in seg["blocks"]:
                if block["state"] != "inactive":
                    out.add((addr, block["size"]))
                addr += block["size"]
        return out

    def buffer_bytes(self) -> int:
        """Bytes of every key's static buffers."""
        return sum(t.numel() * t.element_size() for bufs in self._buffers.values()
                   for t in bufs.values())

    def pool_bytes(self) -> int:
        """Bytes the graphs' pool holds on the card (0 before any capture)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))
