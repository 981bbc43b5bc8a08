"""The collectives of tensor, sequence, pipeline and data parallelism, on ``torch.distributed``.

Counterpart of dllama_tpu/parallel/collectives.py, whose q80 sync buffer
is the reference's (--buffer-float-type q80; src/llm.cpp:195): each rank
quantizes its partial sum to int8 with one f32 scale a 32-block, the
ranks all-gather those blocks and each sums the dequantized shards
locally, in rank order, as the reference's OP_MERGE_ADD does
(src/nn/nn-cpu-ops.cpp:920-957). Payload: 1.125 B an element against the
exact sum's 4. No kernel of the TPU package stands behind this module.

* `all_reduce` — the f32 SUM over an axis (JAX ``psum``), or its q80 form
  (``psum_q80``); the result is f32 whatever x's type, so a partial sum is
  never rounded before it is summed;
* `all_reduce_max` — the MAX (``pmax``);
* `all_gather` — the axis's tensors concatenated along a dim, in axis order;
* `ring_shift` — each rank's tensor to the next one on the axis, i -> i + 1
  (``ppermute``, the ring attention's hop);
* `stage_send` / `stage_recv` — a pipeline stage's activation to the next
  stage and from the previous one (the ``ppermute`` hop of dllama_tpu's
  ``forward_pp``), the send returning a handle to wait on, so that a stage
  hands on wave after wave while the next one still computes;
* `broadcast` — one rank's tensor to every rank of the axis (the last
  stage's hidden rows to every stage, the psum of ``forward_pp``'s exit
  register; a dp group's pool rows to the other groups).

Routes by backend. Under NCCL the tensors stay on the card (the shift by
``batch_isend_irecv``). Under gloo with CUDA tensors every collective copies
its input to a host buffer, runs on the host and copies the result back: the
gloo backend's own route, chosen by the backend, never a recovery from a
failed call (gloo runs point-to-point on host tensors only). A size-1 axis
moves nothing.

`STATS` counts, for every collective a rank issues, its wall seconds on the
host (under gloo with CUDA tensors from the moment the rank's own kernels
before it have finished: the copies, the transfer and the wait for the
peers; under NCCL the launch; for a stage's send its copy and its post,
the send completing while the stage computes on) and its bytes
by the same model as ``utils.telemetry.ici_traffic_per_token``: a ring
all-reduce sends ``2 (n - 1) / n`` of its payload a rank, an all-gather
``(n - 1)`` times a rank's share, a shift or a stage's send its tensor (a
receive counts nothing: its bytes are the sender's), a broadcast its
tensor on the rank that sends it.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from .mesh import Axis

Q_BLOCK = 32


@dataclasses.dataclass
class CollectiveStats:
    """Collectives a rank issued since `reset`: calls, host seconds, bytes."""

    calls: int = 0
    seconds: float = 0.0
    bytes: float = 0.0

    def reset(self) -> None:
        self.calls, self.seconds, self.bytes = 0, 0.0, 0.0

    def add(self, seconds: float, nbytes: float) -> None:
        self.calls += 1
        self.seconds += seconds
        self.bytes += nbytes


STATS = CollectiveStats()


def quantize_q80_blocks(x: torch.Tensor):
    """Per-32-block symmetric int8 quantization along the LAST axis:
    (q int8 [..., n], scale f32 [..., n // 32]), scale = amax / 127 and
    q = round(x / scale) (half to even) clipped to [-127, 127]; an all-zero
    block gives scale 0 and q 0. The JAX function's arithmetic in f32."""
    *lead, n = x.shape
    if n % Q_BLOCK:
        raise ValueError(f"last dim {n} not divisible by {Q_BLOCK}")
    xf = x.float().reshape(*lead, n // Q_BLOCK, Q_BLOCK)
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q.reshape(*lead, n), scale


def dequantize_q80_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_q80_blocks`; f32 [..., n]."""
    *lead, n = q.shape
    qf = q.float().reshape(*lead, n // Q_BLOCK, Q_BLOCK)
    return (qf * scale[..., None]).reshape(*lead, n)


def _clock(x: torch.Tensor, axis: Axis) -> float:
    """The start of a collective on the host clock: under gloo a CUDA
    tensor's stream is drained first, so the rank's own kernels before the
    collective are not counted as its time."""
    if axis.backend == "gloo" and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return time.perf_counter()


def _host(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The tensor a collective runs on: x itself, or a host copy of a CUDA
    tensor under gloo (module docstring)."""
    return x.cpu() if axis.backend == "gloo" and x.is_cuda else x


def _gather(x: torch.Tensor, axis: Axis) -> list[torch.Tensor]:
    """The axis's tensors of x's shape, in axis order, on x's device."""
    src = _host(x.contiguous(), axis)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return [p.to(x.device) for p in parts]


def all_reduce(x: torch.Tensor, axis: Axis, quantized: bool = False) -> torch.Tensor:
    """Sum of x over the axis's ranks, f32 (``psum_maybe_quantized``): the
    exact f32 SUM, or with ``quantized`` the q80 sync (module docstring).
    Every rank gets the same bits."""
    xf = x.float()
    if axis.size == 1:
        return xf
    t0 = _clock(xf, axis)
    if quantized:
        q, scale = quantize_q80_blocks(xf)
        qs, ss = _gather(q, axis), _gather(scale, axis)
        out = dequantize_q80_blocks(qs[0], ss[0])
        for qi, si in zip(qs[1:], ss[1:]):
            out = out + dequantize_q80_blocks(qi, si)
        nbytes = (axis.size - 1) * (q.numel() + 4 * scale.numel())
    else:
        buf = _host(xf.contiguous(), axis)
        if buf is xf:
            buf = xf.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
        out = buf.to(x.device)
        nbytes = 2 * (axis.size - 1) / axis.size * 4 * xf.numel()
    STATS.add(time.perf_counter() - t0, nbytes)
    return out


def all_reduce_max(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise max of x over the axis's ranks (``pmax``)."""
    if axis.size == 1:
        return x
    t0 = _clock(x, axis)
    buf = _host(x.contiguous(), axis)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=axis.group)
    STATS.add(time.perf_counter() - t0,
              2 * (axis.size - 1) / axis.size * x.numel() * x.element_size())
    return buf.to(x.device)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The axis's tensors concatenated along ``dim`` in axis order
    (``lax.all_gather(..., tiled=True)``)."""
    if axis.size == 1:
        return x
    t0 = _clock(x, axis)
    out = torch.cat(_gather(x, axis), dim=dim)
    STATS.add(time.perf_counter() - t0, (axis.size - 1) * x.numel() * x.element_size())
    return out


def ring_shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The tensor of the previous rank on the axis: rank i sends x to rank
    i + 1 and receives rank i - 1's (``ppermute`` with perm i -> i + 1)."""
    if axis.size == 1:
        return x
    t0 = _clock(x, axis)
    src = _host(x.contiguous(), axis)
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, axis.next_rank(), axis.group),
           dist.P2POp(dist.irecv, buf, axis.prev_rank(), axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    STATS.add(time.perf_counter() - t0, x.numel() * x.element_size())
    return buf.to(x.device)


class _Sent:
    """A stage send in flight: its request and the tensor it reads (a host
    copy under gloo, kept alive until the send completes)."""

    def __init__(self, req, buf):
        self.req, self.buf = req, buf

    def wait(self) -> None:
        if self.req is not None:
            self.req.wait()
            self.req = self.buf = None


def stage_send(x: torch.Tensor, axis: Axis) -> _Sent:
    """Send x to the next rank on the pipeline axis (no wrap: the last stage
    sends nothing) and return the send's handle; the caller waits on it
    before the tensor changes or the forward returns. Sends and receives
    between two stages pair in the order they are issued."""
    if axis.index == axis.size - 1:
        raise ValueError("the last stage sends nothing on")
    t0 = _clock(x, axis)
    src = _host(x.contiguous(), axis)
    req = dist.isend(src, axis.ranks[axis.index + 1], group=axis.group)
    STATS.add(time.perf_counter() - t0, x.numel() * x.element_size())
    return _Sent(req, src)


def stage_recv(shape, dtype, device, axis: Axis) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` the previous stage sent, on
    ``device`` (stage 0 receives nothing)."""
    if axis.index == 0:
        raise ValueError("stage 0 receives nothing")
    dev = torch.device(device)
    t0 = time.perf_counter()
    host = axis.backend == "gloo" and dev.type == "cuda"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else dev)
    dist.recv(buf, axis.ranks[axis.index - 1], group=axis.group)
    STATS.add(time.perf_counter() - t0, 0.0)
    return buf.to(dev)


def broadcast(x: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """The tensor of the axis's rank ``src`` (an index on the axis) on every
    rank of it: x is read on ``src`` and gives the shape and type elsewhere."""
    if axis.size == 1:
        return x
    t0 = _clock(x, axis)
    buf = _host(x.contiguous(), axis)
    if buf is x and axis.index != src:
        buf = x.clone()
    dist.broadcast(buf, axis.ranks[src], group=axis.group)
    nbytes = x.numel() * x.element_size()
    STATS.add(time.perf_counter() - t0, nbytes if axis.index == src else 0.0)
    return buf.to(x.device)
