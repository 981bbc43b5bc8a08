"""The startup memory report and the interconnect traffic of the rank mesh.

Counterpart of two functions of dllama_tpu/utils/telemetry.py:

* `memory_report` — params and KV cache bytes, total and per rank, in the
  JAX report's accounting (the reference's printRequiredMemory,
  nn-core.cpp:175-189): norms, RoPE tables and gates whole on every rank,
  the embedding split over tp (vocab rows) and replicated over the other
  axes, everything else divided by the ranks. A port rank holds slices,
  so the totals are put together from its own tensors (``tp`` times its
  split leaves, ``pp`` times its stage's layers, ``pp * tp * sp`` times its
  cache shard);
* `ici_traffic_per_token` — the analytic bytes a rank sends a decoded token
  under tp and pp (the CLI's Sent/Recv columns; the reference counted its
  socket bytes, nn-network.cpp:524-539). parallel/collectives.py counts the
  bytes of the collectives a rank really issues by the same model.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..formats.model_file import LlmHeader
from ..obs.cost import nbytes


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GB", 1024**3), ("MB", 1024**2), ("kB", 1024)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


@dataclass
class MemoryReport:
    params_bytes: int
    cache_bytes: int
    n_devices: int
    replicated_bytes: int = 0
    tp_sharded_bytes: int = 0  # embed: split over tp, replicated elsewhere
    tp: int = 1

    @property
    def total_bytes(self) -> int:
        return self.params_bytes + self.cache_bytes

    @property
    def per_device_bytes(self) -> int:
        # the JAX report's division: replicated leaves whole on every rank,
        # the embedding over tp only, everything else over every rank
        n = max(self.n_devices, 1)
        tp = max(self.tp, 1)
        sharded = self.total_bytes - self.replicated_bytes - self.tp_sharded_bytes
        return self.replicated_bytes + self.tp_sharded_bytes // tp + sharded // n

    def print(self) -> None:
        print(f"💾 Params: {_fmt_bytes(self.params_bytes)}")
        print(f"💾 KV cache: {_fmt_bytes(self.cache_bytes)}")
        print(
            f"💾 Total: {_fmt_bytes(self.total_bytes)} "
            f"(~{_fmt_bytes(self.per_device_bytes)}/chip over "
            f"{self.n_devices} chip(s))"
        )


_REPLICATED_KEYS = {
    "final_norm", "rope_cos", "rope_sin",
    "att_norm", "ffn_norm", "q_norm", "k_norm", "moe_gate",
}


def memory_report(params: dict, cache: dict, tp: int = 1, sp: int = 1, pp: int = 1,
                  dp: int = 1) -> MemoryReport:
    """The JAX report (module docstring) from one rank's ``params`` (its tp
    slices of its stage's layers) and ``cache`` (its shard)."""
    top = sum(nbytes(params[k]) for k in _REPLICATED_KEYS if k in params)
    layer_repl = sum(nbytes(lp[k]) for lp in params["layers"] for k in _REPLICATED_KEYS
                     if k in lp)
    layers = nbytes(params["layers"]) - layer_repl
    embed = nbytes(params["embed"])
    head = nbytes(params) - top - embed - nbytes(params["layers"])
    replicated = top + pp * layer_repl
    return MemoryReport(
        params_bytes=replicated + tp * (embed + head + pp * layers),
        cache_bytes=pp * tp * sp * nbytes(cache),
        n_devices=pp * dp * tp * sp,
        replicated_bytes=replicated,
        tp_sharded_bytes=tp * embed,
        tp=tp,
    )


def ici_traffic_per_token(h: LlmHeader, tp: int, activation_bytes: float = 2.0,
                          include_logits: bool = True, pp: int = 1,
                          pp_activation_bytes: float | None = None) -> int:
    """Analytic bytes a rank sends a decoded token under tp and pp (the JAX
    function): two all-reduces of a [dim]
    activation a layer (after the column-split ``wo`` and ``w2``, where the
    reference ran SYNC_NODE_SLICES + MERGE_ADD, llm.cpp:403,554), each
    sending 2 (tp - 1) / tp of its payload a rank; one more for the
    vocab-split embedding's row; and the logits' all-gather, vocab / tp
    f32 from each of the other ranks. ``activation_bytes``: 4 for the f32
    all-reduce, 1.125 for the q80 sync buffer (int8 and an f32 scale a
    32-block). Under pp: one [dim] hand-off a pipeline tick (pp ticks a
    decoded token) and the exit psum over the stages, ``2 (pp - 1) / pp``
    of a [dim] row, in ``pp_activation_bytes`` (default
    ``activation_bytes``): the hand-offs carry the stage register's model
    type, never the q80 buffer. The JAX model counts its SPMD schedule's
    pp ticks and its psum; the port sends pp - 1 hand-offs and one
    broadcast from the last stage (parallel/collectives.STATS counts
    those)."""
    total = 0.0
    if tp > 1:
        ring = 2 * (tp - 1) / tp
        total += h.n_layers * 2 * h.dim * activation_bytes * ring
        total += h.dim * activation_bytes * ring
        if include_logits:
            total += h.vocab_size * 4 * (tp - 1) / tp
    if pp > 1:
        ppb = activation_bytes if pp_activation_bytes is None else pp_activation_bytes
        total += pp * h.dim * ppb  # tick hand-offs
        total += 2 * (pp - 1) / pp * h.dim * ppb  # exit psum
    return int(total)
