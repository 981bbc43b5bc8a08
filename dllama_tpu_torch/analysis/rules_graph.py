"""The captured-graph rules behind graphlint.

The port's counterpart of dllama_tpu/analysis/rules_hlo.py. Each rule sees
one :class:`~.graphlint.GraphProgram` — a captured graph's node list, the
engine's KV planes, the blocks the capture took from the graphs' pool,
the key's launch budget and the engine-derived
:class:`~.graphlint.GraphPolicy` — and yields
:class:`~.graphlint.HloFinding`s whose messages are value-free (counts,
sizes and kernel names ride in the ``detail`` field), so baseline
fingerprints survive a change of shapes or library. The rule names are
xlalint's, so the two packages' findings read alike.

What the rules rely on (read from captured graphs on an H100 with
PyTorch's cuBLAS):

* kernel nodes carry the function's (mangled) name: the port's kernels
  (``dllama::q40::gemv_mma_kernel<...>``, the attention kernels),
  PyTorch's elementwise and reduction kernels, cuBLAS (``nvjet_*`` for
  bf16 products, ``sm80_xmma_gemm_f32f32_f32f32_*`` and
  ``gemvx::kernel<int, int, float, float, ...>`` for f32 ones), NCCL
  (``ncclDevKernel_*``);
* a PyTorch ``copy_`` between device tensors is a device-to-device
  memcpy node, one to pinned host memory a device-to-host memcpy node;
* a host callback is a host node.
"""

from __future__ import annotations

import re
from typing import Iterable

from .graphlint import GraphProgram, HloFinding, HloRule

#: cuBLAS / CUTLASS kernels whose products read and write f32 (SIMT or
#: TF32): sgemm, the xmma f32 tiles, f32 GEMVs, cuBLAS's templated GEMMs
#: at float (``gemmSN_TN_kernel<float, ...>``)
F32_GEMM_RE = re.compile(
    r"sgemm|f32f32_f32f32|tf32|s1688gemm|gemm_f32|_sss_|gemv\w*?I[il]{2}ffff"
    r"|gemm\w*?_kernelIf",
    re.IGNORECASE,
)
_NCCL_RE = re.compile(
    r"nccl\w*?(AllReduce|AllGather|ReduceScatter|Broadcast|AllToAll|SendRecv|Send|Recv|Reduce)",
    re.IGNORECASE,
)
#: the caching allocator's block granularity (a plane-sized request is
#: rounded up to it)
BLOCK_ROUND = 512
#: planes below this size are left to the memcpy check: a block a capture
#: keeps can be cuBLAS's workspace (runtime/graphs.py `clear`), whose size
#: may equal a small model's plane
PLANE_BLOCK_MIN_BYTES = 64 << 20


def kernel_names(prog: GraphProgram) -> list[str]:
    return [n.name for n in prog.nodes if n.kind == "kernel"]


def collective_kernels(prog: GraphProgram) -> list[tuple[str, str]]:
    """(collective op, kernel name) of every NCCL kernel node."""
    out = []
    for name in kernel_names(prog):
        if "nccl" in name.lower():
            m = _NCCL_RE.search(name)
            out.append((m.group(1) if m else "nccl", name))
    return out


def f32_gemm_kernels(prog: GraphProgram) -> list[str]:
    return [name for name in kernel_names(prog) if F32_GEMM_RE.search(name)]


def _round_block(nbytes: int) -> int:
    return -(-nbytes // BLOCK_ROUND) * BLOCK_ROUND


def plane_copies(prog: GraphProgram) -> list[tuple[int, int]]:
    """(memcpy bytes, plane bytes) of every memcpy that reads or writes a
    whole KV plane: it starts inside a plane and moves at least its bytes."""
    hits = []
    for n in prog.nodes:
        if n.kind != "memcpy":
            continue
        for addr, size in prog.kv_planes:
            inside = any(addr <= p < addr + size for p in (n.src_ptr, n.dst_ptr) if p)
            if inside and n.nbytes >= size:
                hits.append((n.nbytes, size))
                break
    return hits


def plane_sized_blocks(prog: GraphProgram) -> list[int]:
    """Blocks the capture left allocated in the graphs' pool (a tensor that
    outlives the capture, such as a copied cache) at the size of a KV plane
    of at least `PLANE_BLOCK_MIN_BYTES`."""
    sizes = {_round_block(size) for _, size in prog.kv_planes
             if size >= PLANE_BLOCK_MIN_BYTES}
    return [b for b in prog.pool_blocks if b in sizes]


# -- rules ------------------------------------------------------------------

class CollectiveCensusRule(HloRule):
    """Only the policy's collectives: a one-rank engine's graph holds no
    NCCL kernel (parallel engines run eagerly over gloo and capture no
    graph today)."""

    name = "hlo-collective-census"
    description = (
        "captured graphs hold only their policy's collectives: no NCCL "
        "kernel in a one-rank engine's graph"
    )

    def check(self, prog: GraphProgram) -> Iterable[HloFinding]:
        allowed = prog.policy.allowed_collectives
        seen: dict[str, list[str]] = {}
        for op, name in collective_kernels(prog):
            if "nccl" not in allowed and op not in allowed:
                seen.setdefault(op, []).append(name)
        for op, names in sorted(seen.items()):
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message=f"collective '{op}' not allowed in {prog.family} graphs",
                detail=f"{len(names)} kernel node(s): {names[0][:80]}",
            )


class DonationRule(HloRule):
    """The KV cache is updated in place: no memcpy node moves a whole KV
    plane, and the capture leaves no block of a plane's size allocated in
    the graphs' pool (a copied cache is silent double memory, as a dropped
    donation is in the JAX program)."""

    name = "hlo-donation"
    description = (
        "the KV cache stays in place: no memcpy of a whole KV plane and no "
        "plane-sized block left allocated in the graphs' pool"
    )

    def check(self, prog: GraphProgram) -> Iterable[HloFinding]:
        copies = plane_copies(prog)
        if copies:
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message="KV plane copied: a memcpy node moves a whole KV plane "
                        "(the cache is not updated in place)",
                detail=f"{len(copies)} memcpy node(s), {copies[0][0]} B of a "
                       f"{copies[0][1]} B plane",
            )
        blocks = plane_sized_blocks(prog)
        if blocks:
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message="capture left a block of a KV plane's size allocated "
                        "in the graphs' pool",
                detail=f"{len(blocks)} block(s) of {blocks[0]} B",
            )


class HostRoundTripRule(HloRule):
    """Captured graphs never leave the device: no host node (a host
    callback runs on a CPU thread inside the replay) and no memcpy to or
    from host memory."""

    name = "hlo-host"
    description = "no host nodes and no memcpy to or from host memory in captured graphs"

    def check(self, prog: GraphProgram) -> Iterable[HloFinding]:
        if not prog.policy.forbid_host:
            return
        hosts = [n for n in prog.nodes if n.kind == "host"]
        if hosts:
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message="host-transfer op 'host-node'",
                detail=f"{len(hosts)} host node(s)",
            )
        moved: dict[str, list[int]] = {}
        for n in prog.nodes:
            if n.kind == "memcpy" and "host" in (n.src, n.dst):
                moved.setdefault(f"{n.src}-to-{n.dst}", []).append(n.nbytes)
        for way, sizes in sorted(moved.items()):
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message=f"host-transfer memcpy '{way}'",
                detail=f"{len(sizes)} memcpy node(s), {sum(sizes)} B",
            )


class DtypePolicyRule(HloRule):
    """A bf16 engine's graphs run no f32 GEMM: every weight product goes
    through the port's kernels at their bf16 instantiations, so a cuBLAS
    or CUTLASS f32 product means a 16-bit weight was upcast. The products
    of the file's own f32 weights (the MoE router's gate) are allowed, up
    to the program's ``f32_gemm_allowance``."""

    name = "hlo-dtype"
    description = (
        "a bf16 engine's captured graphs run no f32 GEMM (cuBLAS/CUTLASS f32 "
        "kernels on an upcast 16-bit path)"
    )

    def check(self, prog: GraphProgram) -> Iterable[HloFinding]:
        if not prog.policy.forbid_f32_gemm:
            return
        hits = f32_gemm_kernels(prog)
        if len(hits) > prog.f32_gemm_allowance:
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message="16-bit float path upcast to an f32 GEMM "
                        "(cuBLAS/CUTLASS f32 kernel)",
                detail=f"{len(hits)} node(s), {prog.f32_gemm_allowance} allowed: " + ", ".join(
                    sorted({h[:60] for h in hits})[:4]),
            )


class CostBudgetRule(HloRule):
    """The graph's kernel nodes stay under the launch budget of its key's
    forwards, its layers and their per-layer tally
    (`graphlint.launch_budget`): launches are what the port pays for
    between its kernels."""

    name = "hlo-cost-budget"
    description = (
        "a captured graph's kernel nodes stay under the launch budget of its "
        "key's forwards, layers and per-layer tally (graphlint.launch_budget)"
    )

    def check(self, prog: GraphProgram) -> Iterable[HloFinding]:
        if prog.kernel_budget <= 0:
            return
        n = len(kernel_names(prog))
        if n > prog.kernel_budget:
            yield HloFinding(
                rule=self.name, path=prog.path, line=1,
                message=f"kernel nodes exceed the {prog.family} launch budget",
                detail=f"{n} > {prog.kernel_budget} kernel nodes",
            )


__all__ = [
    "CollectiveCensusRule",
    "CostBudgetRule",
    "DonationRule",
    "DtypePolicyRule",
    "F32_GEMM_RE",
    "HostRoundTripRule",
    "collective_kernels",
    "f32_gemm_kernels",
    "kernel_names",
    "plane_copies",
    "plane_sized_blocks",
]
