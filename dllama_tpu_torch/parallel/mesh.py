"""The ranks of tensor, sequence, pipeline and data parallelism on ``torch.distributed``.

Counterpart of dllama_tpu/parallel/mesh.py. The JAX package runs one SPMD
program over a ``(pp, dp, sp, tp)`` device mesh, pp outermost; the port runs
one process a rank, ``pp * dp * sp * tp`` of them, each with its own slice
of the weights and of the KV cache, and the collectives of
parallel/collectives.py between them. Rank ``r`` sits at ``tp = r % tp``,
``sp = (r // tp) % sp``, ``dp = (r // (tp sp)) % dp`` and ``pp = r // (tp
sp dp)``: tp innermost, as in ``make_mesh``. `Mesh` holds one process group
for each axis of more than one rank that a rank belongs to.

`init_distributed` joins a rank to its world: from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) when it is set, else from its arguments
(parallel/launch.py passes a ``file://`` rendezvous). Placement:
``device="cuda"`` puts rank r on ``cuda:{local_rank}`` and raises when the
host has too few cards; an explicit ``cuda:N`` puts every rank there;
``cpu`` puts every rank on the CPU. The backend follows a rule fixed
before the process group starts (`pick_backend`): ``nccl`` when every rank
on the host has a card of its own, ``gloo`` when ranks share a card (NCCL
does not run two ranks on one device) or on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..formats.model_file import LlmHeader, read_llm_header

DEFAULT_TIMEOUT_S = 120.0


def validate_tp(h: LlmHeader, tp: int) -> None:
    """Mirror the reference's shardability constraints (src/app.cpp:236-240
    requires nNodes ≤ nKvHeads and 2^n nodes; the dimension divisibility
    asserts live in its slicers, src/nn/nn-core.cpp:211-243)."""
    if tp < 1 or (tp & (tp - 1)) != 0:
        raise ValueError(f"tp must be a power of two, got {tp}")
    if tp > h.n_kv_heads:
        raise ValueError(
            f"tp={tp} exceeds nKvHeads={h.n_kv_heads} (the KV cache shards "
            "by kv head, like the reference's sliceKvCache)"
        )
    for name, dim in [
        ("dim", h.dim),
        ("qDim", h.q_dim),
        ("kvDim", h.kv_dim),
        ("hiddenDim", h.ff_dim),
        ("vocabSize", h.vocab_size),
    ]:
        if dim % tp != 0:
            raise ValueError(f"{name}={dim} not divisible by tp={tp}")


def validate_sp(h: LlmHeader, sp: int) -> None:
    """The JAX engine's sequence-parallel checks: a power of two, and shards
    that tile the cache's sequence axis."""
    if sp < 1 or (sp & (sp - 1)) != 0:
        raise ValueError(f"sp must be a power of two >= 1, got {sp}")
    if sp > 1 and h.seq_len % sp != 0:
        raise ValueError(f"seqLen {h.seq_len} not divisible by sp={sp}")


def validate_pp(h: LlmHeader, pp: int) -> None:
    """Any pp >= 1 that divides the layer count works (dllama_tpu's
    ``pipeline.validate_pp``, its messages): stages hold equal layer
    ranges, and nothing asks for a power of two."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if pp > 1 and h.n_layers % pp != 0:
        raise ValueError(
            f"nLayers={h.n_layers} not divisible by pp={pp} (stages hold "
            "equal layer ranges)"
        )


def auto_tp(model_path: str, n_devices: int | None = None) -> int:
    """Largest power-of-two tp that both the device count (the host's cards:
    ``torch.cuda.device_count()``, 1 without one) and the model's
    shardability constraints allow (mirrors the reference's nNodes <=
    nKvHeads rule, src/app.cpp:236-238)."""
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1)
    h = read_llm_header(model_path)
    tp = 1
    while tp * 2 <= n_devices:
        try:
            validate_tp(h, tp * 2)
        except ValueError:
            break
        tp *= 2
    return tp


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """A rank's device: ``cuda`` -> ``cuda:{local_rank}`` (raises when the
    host has fewer cards), ``cuda:N`` -> that card for every rank, ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain PyTorch versions")
    index = local_rank if dev.index is None else dev.index
    n = torch.cuda.device_count()
    if index >= n:
        raise RuntimeError(
            f"rank {local_rank} on this host needs cuda:{index}, but the host has {n} card(s); "
            "pass an explicit --device cuda:N to put every rank on one card")
    return torch.device("cuda", index)


def pick_backend(device: str | torch.device, ranks_on_host: int) -> str:
    """``nccl`` when every rank on the host has a card of its own (``cuda``
    placement, one card a local rank), ``gloo`` when the ranks share a card
    (an explicit ``cuda:N``) or run on the CPU. Fixed before the process
    group starts: never chosen by catching NCCL's refusal."""
    dev = torch.device(device)
    if dev.type == "cuda" and (dev.index is None or ranks_on_host == 1):
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Axis:
    """One mesh axis as a rank sees it: its size, this rank's index on it,
    the global ranks along it (in axis order) and their process group
    (None for a size-1 axis)."""

    size: int
    index: int
    ranks: tuple
    group: object = None
    backend: str = "gloo"

    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.size]


def _unit_axis() -> Axis:
    return Axis(1, 0, (0,))


@dataclasses.dataclass
class Mesh:
    """A rank of a ``(pp, dp, sp, tp)`` mesh (tp innermost): its world,
    rank, device, backend and the axes it belongs to."""

    world: int
    rank: int
    tp: Axis
    sp: Axis
    device: torch.device
    backend: str
    pp: Axis = dataclasses.field(default_factory=_unit_axis)
    dp: Axis = dataclasses.field(default_factory=_unit_axis)


def shape_str(tp: int, sp: int, pp: int = 1, dp: int = 1) -> str:
    """The ranks line's shape: ``tp=2 x sp=1``, then dp and pp past 1."""
    out = f"tp={tp} x sp={sp}"
    out += f" x dp={dp}" if dp > 1 else ""
    return out + (f" x pp={pp}" if pp > 1 else "")


# the mesh's axes, innermost first: each axis's stride is the product of the sizes before it
_AXES = ("tp", "sp", "dp", "pp")


def make_mesh(tp: int, sp: int, device, backend: str = "gloo", pp: int = 1,
              dp: int = 1) -> Mesh:
    """This rank's `Mesh` over the started world (one rank without a
    process group). Every rank calls it with the same sizes: each axis
    group is made by every rank, in one order (axis by axis, innermost
    first, groups by their first rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = {"tp": tp, "sp": sp, "dp": dp, "pp": pp}
    if world != tp * sp * dp * pp:
        raise ValueError(f"need {tp * sp * dp * pp} ranks ({shape_str(tp, sp, pp, dp)}), "
                         f"have {world}")
    strides, n = {}, 1
    for name in _AXES:
        strides[name] = n
        n *= sizes[name]

    def index(r: int, name: str) -> int:
        return (r // strides[name]) % sizes[name]

    def ranks_of(r: int, name: str) -> tuple:
        base = r - index(r, name) * strides[name]
        return tuple(base + i * strides[name] for i in range(sizes[name]))

    axes = {}
    for name in _AXES:
        groups = {}
        if sizes[name] > 1:
            for r in range(world):
                if index(r, name) == 0:
                    ranks = ranks_of(r, name)
                    groups[ranks] = dist.new_group(list(ranks))
        mine = ranks_of(rank, name)
        axes[name] = Axis(sizes[name], index(rank, name), mine, groups.get(mine), backend)
    return Mesh(world=world, rank=rank, device=torch.device(device), backend=backend, **axes)


def _env_int(name: str, default: int | None) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def torchrun_env() -> bool:
    """Whether this process runs under torchrun (its rank variables set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(
    tp: int = 1,
    sp: int = 1,
    device="cuda",
    pp: int = 1,
    dp: int = 1,
    rank: int | None = None,
    world: int | None = None,
    local_rank: int | None = None,
    local_world: int | None = None,
    init_method: str | None = None,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    verbose: bool = True,
) -> Mesh:
    """Join this process to a world of ``pp * dp * sp * tp`` ranks and return its
    `Mesh` (module docstring: torchrun's environment first, then the
    arguments; placement and the backend rule). The process group's
    timeout bounds every collective: a peer that died or diverged fails
    the call within ``timeout_s`` instead of hanging it. Rank 0 prints the
    world, the backend and its device."""
    env = torchrun_env()
    rank = rank if rank is not None else (_env_int("RANK", 0) if env else 0)
    n = tp * sp * pp * dp
    world = world if world is not None else (_env_int("WORLD_SIZE", 1) if env else n)
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK", rank)
    local_world = (local_world if local_world is not None
                   else _env_int("LOCAL_WORLD_SIZE", world))
    if world != n:
        raise ValueError(f"need {n} ranks ({shape_str(tp, sp, pp, dp)}), have {world}")
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or pick_backend(device, local_world)
    if world > 1 and not dist.is_initialized():
        if init_method is None and not env:
            raise ValueError("init_distributed: more than one rank needs torchrun's environment "
                             "or an init_method (parallel/launch.py gives a file:// one)")
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    if verbose and rank == 0 and world > 1:
        print(f"🔗 Ranks: {world} ({shape_str(tp, sp, pp, dp)}), backend {backend}, rank 0 on "
              f"{dev}", flush=True)
    return make_mesh(tp, sp, dev, backend, pp=pp, dp=dp)


def spans_hosts() -> bool:
    """Whether the ranks span more than one host (torchrun's ``WORLD_SIZE``
    past its ``LOCAL_WORLD_SIZE``): the regime the q80 sync buffer is for."""
    world = _env_int("WORLD_SIZE", 1)
    return world > _env_int("LOCAL_WORLD_SIZE", world)
