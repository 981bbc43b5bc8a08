"""Step cost and HBM roofline accounting from the port's own layouts.

The JAX package's ``obs/cost.py`` reads XLA's ``cost_analysis()`` of each
compiled program and a TPU peak table. The port runs CUDA graphs of its
own kernels and has no compiled program to ask, so this module works the
counts out from the shapes a step implies:

* the weights a forward reads, from the engine's own parameter tensors
  (values and scales, one ``nbytes`` each: `param_bytes`), or for a header
  and a weight format alone from the port's device layouts
  (`weight_bytes_per_token`): Q40 is int8 values and f16 scales, 1.0625 B
  a weight; packed nibbles 0.5625 B; grouped int8 1 + 4/G B; dense the
  activation type's bytes. A MoE layer reads its f32 gate and the active
  experts' share of its experts;
* the KV rows a step reads and writes, the slab or the lanes' pages
  (`kv_row_bytes`: K and V of one row in one layer, an int8 cache's f32
  row scales included);
* the operations: two a weight a row, and four a head dimension for each
  (query row, attended row) pair (QK and PV).

`StepCostModel` turns one dispatch into (flops, bytes) that way; the
engine accumulates them with its step seconds per graph key and publishes
the fraction of the HBM roofline a kind achieved (``cost_report``).

The peaks come from the card's name (``torch.cuda.get_device_name``),
from NVIDIA's public H100 datasheet: the SXM card ("H100 80GB HBM3") at
3.35 TB/s, 989 TFLOP/s bf16 dense and 1,979 TOP/s int8; the PCIe card at
2.0 TB/s and the NVL card at 3.9 TB/s (their compute peaks are not in the
table). Any other card, and the CPU, give None, and every roofline figure
downstream degrades to "unavailable" rather than a made-up fraction.

`roofline_fraction`, `analytic_step_seconds`, `roofline_report` and
`print_roofline_report` keep the JAX module's signatures and None rules
(``roofline_report`` and ``print_roofline_report`` also take the engine's
``params``, to count the tensors as they are, and the dense type's bytes).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..formats.model_file import LlmHeader

# (lowercase markers that must all appear in the card's name, HBM bytes/s,
# bf16 dense FLOP/s, int8 dense OP/s); the first row that matches wins
CARD_PEAKS = (
    (("h100", "nvl"), 3.9e12, None, None),
    (("h100", "pcie"), 2.0e12, None, None),
    (("h100", "hbm3"), 3.35e12, 989e12, 1979e12),
)
Q40_BLOCK = 32


def _card_peaks(device=None) -> tuple | None:
    """The `CARD_PEAKS` row of ``device`` (a torch device, an index or
    None for the current CUDA device), or None off the card or for a card
    the table does not know."""
    import torch

    if device is not None and not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    try:
        name = torch.cuda.get_device_name(device).lower()
    except Exception:
        return None
    for markers, *peaks in CARD_PEAKS:
        if all(m in name for m in markers):
            return tuple(peaks)
    return None


def hbm_peak_bytes_per_s(device=None) -> float | None:
    """HBM peak of the card, or None when unknown (CPU, another card)."""
    peaks = _card_peaks(device)
    return None if peaks is None else peaks[0]


def bf16_peak_flops(device=None) -> float | None:
    """Dense bf16 tensor-core peak of the card, or None when unknown."""
    peaks = _card_peaks(device)
    return None if peaks is None else peaks[1]


def int8_peak_ops(device=None) -> float | None:
    """Dense int8 tensor-core peak of the card, or None when unknown."""
    peaks = _card_peaks(device)
    return None if peaks is None else peaks[2]


def roofline_fraction(
    bytes_accessed: float, step_seconds: float, peak_bytes_per_s: float | None
) -> float | None:
    """Fraction of the HBM roofline a measured step achieved: achieved
    bytes/s over peak. None when any input is missing/degenerate."""
    if (
        peak_bytes_per_s is None
        or peak_bytes_per_s <= 0
        or step_seconds <= 0
        or bytes_accessed <= 0
    ):
        return None
    return (bytes_accessed / step_seconds) / peak_bytes_per_s


def analytic_step_seconds(
    bytes_accessed: float | None, peak_bytes_per_s: float | None
) -> float | None:
    """Bandwidth-bound lower bound on one dispatch's wall time: the step's
    bytes pushed through the card's HBM peak; None when the bytes or the
    peak are unknown (the CPU)."""
    if (
        bytes_accessed is None
        or bytes_accessed <= 0
        or peak_bytes_per_s is None
        or peak_bytes_per_s <= 0
    ):
        return None
    return float(bytes_accessed) / float(peak_bytes_per_s)


def nbytes(v) -> int:
    """Bytes of every tensor in v: a tensor, or a list, tuple (a quantized
    weight: values and scales) or dict of them."""
    import torch

    if torch.is_tensor(v):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple, dict)):
        return sum(nbytes(x) for x in (v.values() if isinstance(v, dict) else v))
    return 0


def param_bytes(params: dict, h: "LlmHeader") -> dict:
    """The weight bytes one forward reads, from the tensors themselves:
    ``layers`` (every non-expert matmul weight, values and scales, and a
    MoE layer's f32 gate), ``experts`` (all of every MoE layer's experts;
    a forward reads the share its rows route to) and ``cls`` (the
    classifier, read only by a forward that computes logits)."""
    out = {"layers": 0, "experts": 0, "cls": nbytes(params["wcls"])}
    for lp in params["layers"]:
        out["layers"] += sum(nbytes(lp[key]) for key in ("wq", "wk", "wv", "wo"))
        ffn = sum(nbytes(lp[key]) for key in ("w1", "w2", "w3"))
        if h.is_moe:
            out["layers"] += nbytes(lp["moe_gate"])
            out["experts"] += ffn
        else:
            out["layers"] += ffn
    return out


def _matrix_bytes(n: int, k: int, weight_format: str, i8_group: int, dtype_bytes: int) -> int:
    """Device bytes of an [n, k] matmul weight in the port's layout."""
    if weight_format == "q40":
        return n * k + 2 * n * (k // Q40_BLOCK)
    if weight_format == "q40i4":
        return n * k // 2 + 2 * n * (k // Q40_BLOCK)
    if weight_format == "q40i8":
        return n * k + 4 * n * (k // i8_group)
    return dtype_bytes * n * k


def layout_bytes(h: "LlmHeader", weight_format: str, i8_group: int = 512,
                 dtype_bytes: int = 2) -> dict:
    """`param_bytes` from the header and the port's device layouts alone:
    q40 int8 values + f16 scales a 32-block; q40i4 packed nibbles + f16
    scales; q40i8 int8 + an f32 scale a group of ``i8_group`` (MoE experts
    stay q40, as ``requantize_params`` and ``load_params`` keep them); dense
    ``dtype_bytes`` a weight."""
    d, f = h.dim, h.ff_dim
    att = [(h.q_dim, d), (h.kv_dim, d), (h.kv_dim, d), (d, h.q_dim)]
    layer = sum(_matrix_bytes(n, k, weight_format, i8_group, dtype_bytes) for n, k in att)
    ffn_format = "q40" if h.is_moe and weight_format in ("q40i4", "q40i8") else weight_format
    ffn = sum(_matrix_bytes(n, k, ffn_format, i8_group, dtype_bytes)
              for n, k in ((f, d), (d, f), (f, d)))
    if h.is_moe:
        layer += 4 * h.n_experts * d  # the f32 gate
        experts = h.n_layers * h.n_experts * ffn
    else:
        layer += ffn
        experts = 0
    return {
        "layers": h.n_layers * layer,
        "experts": experts,
        "cls": _matrix_bytes(h.vocab_size, d, weight_format, i8_group, dtype_bytes),
    }


def weight_bytes_per_token(
    h: "LlmHeader", weight_format: str, i8_group: int = 512, params: dict | None = None,
    dtype_bytes: int = 2,
) -> int:
    """Bytes of weights a single decode step must read: every matmul
    weight once, the classifier included (MoE: the attention weights, the
    f32 gate and the active experts' share). From ``params`` when given
    (`param_bytes`), else from the port's layouts (`layout_bytes`)."""
    b = param_bytes(params, h) if params is not None else layout_bytes(
        h, weight_format, i8_group, dtype_bytes)
    experts = b["experts"] * h.n_active_experts // h.n_experts if h.is_moe else 0
    return int(b["layers"] + b["cls"] + experts)


def kv_row_bytes(h: "LlmHeader", kv_elem_bytes: int, quantized: bool) -> int:
    """Bytes of one cache row's K and V in one layer over every KV head
    (an int8 cache's f32 row scales included)."""
    per_head = h.head_dim * kv_elem_bytes + (4 if quantized else 0)
    return 2 * h.n_kv_heads * per_head


class StepCostModel:
    """(flops, bytes) of a dispatch of forwards, from an engine's weights
    and cache type (see the module docstring). A forward reads the layer
    weights once, the classifier when it computes logits, and in a MoE
    model at most min(E, rows x k) experts a layer (the routing is not
    read back, so that is what the rows could route to)."""

    def __init__(self, h: "LlmHeader", params: dict, kv_elem_bytes: int, quantized_kv: bool,
                 tp: int = 1, sp: int = 1, pp: int = 1):
        self.h = h
        # a rank of a pp x sp x tp mesh counts its own work: its weight
        # slices (``params`` are the rank's), 1/tp of the products and of
        # the KV heads, 1/sp of the cache rows and attention pairs, and its
        # stage's L/pp layers
        self.tp, self.sp = tp, sp
        self.n_layers = h.n_layers // pp
        self.w = param_bytes(params, h)
        self.kv_row = kv_row_bytes(h, kv_elem_bytes, quantized_kv) // tp
        d, f = h.dim, h.ff_dim
        att = 2 * d * h.q_dim + 2 * d * h.kv_dim
        self.elems_layer = self.n_layers * (att + (0 if h.is_moe else 3 * d * f)) // tp
        # one expert a layer, over the layers: its F/tp slice under tp
        self.elems_expert = self.n_layers * 3 * d * f // tp
        self.elems_cls = h.vocab_size * d // tp

    def forward(self, rows: int, logit_rows: int, kv_read: int, kv_write: int,
                attn_pairs: int, n: int = 1) -> tuple[float, float]:
        """``n`` forwards computing ``rows`` rows in all, ``logit_rows`` of
        them through the classifier, reading ``kv_read`` and writing
        ``kv_write`` cache rows (summed over lanes and forwards) and
        attending ``attn_pairs`` (query row, cache row) pairs."""
        h = self.h
        flops = 2.0 * rows * self.elems_layer + 2.0 * logit_rows * self.elems_cls
        flops += 4.0 * self.n_layers * h.n_heads // self.tp * h.head_dim * attn_pairs / self.sp
        nbytes_ = n * self.w["layers"] + (n * self.w["cls"] if logit_rows else 0)
        if h.is_moe:
            n_exp = min(h.n_experts, -(-rows // n) * h.n_active_experts)
            nbytes_ += n * (self.w["experts"] * n_exp // h.n_experts)
            flops += 2.0 * rows * h.n_active_experts * self.elems_expert
        nbytes_ += self.n_layers * self.kv_row * (kv_read + kv_write) / self.sp
        return flops, float(nbytes_)

    def kv_copy(self, rows: int) -> tuple[float, float]:
        """A copy of ``rows`` K/V rows of every layer between the lanes'
        slab and the pool (`InferenceEngine.kv_adopt` / ``kv_publish``):
        each row read once and written once, no operations."""
        return 0.0, float(2 * self.n_layers * self.kv_row * rows)


def extract_cost(acc) -> dict | None:
    """{flops, bytes_accessed} of one dispatch of a graph key: the mean
    over its settled dispatches, from the engine's accumulator ``[n,
    device seconds, flops, bytes]`` (the counterpart of the JAX function
    that reads an executable's ``cost_analysis()``). None before any."""
    if not acc or acc[0] <= 0:
        return None
    n = acc[0]
    return {"flops": acc[2] / n, "bytes_accessed": acc[3] / n}


def roofline_report(
    h: "LlmHeader", weight_format: str, tp: int = 1, pp: int = 1,
    i8_group: int = 512, spec_k: int = 0, params: dict | None = None,
    dtype_bytes: int = 2, device=None,
) -> dict:
    """Analytic decode roofline for this model and format: weight-read
    bytes per token (the port runs one card: ``tp`` and ``pp`` divide as in
    the JAX module) and, when the card's HBM peak is known, the ms/token
    floor and tok/s ceiling. With speculation on (``spec_k`` > 0) one
    verify pass emits up to ``spec_k + 1`` tokens a lane."""
    shards = max(tp, 1) * max(pp, 1)
    per_chip = weight_bytes_per_token(h, weight_format, i8_group, params, dtype_bytes) // shards
    peak = hbm_peak_bytes_per_s(device)
    rep: dict = {
        "weight_bytes_per_token_per_chip": per_chip,
        "hbm_peak_bytes_per_s": peak,
        "min_ms_per_token": None,
        "max_tok_s_per_chip": None,
        "spec_tokens_per_pass_floor": None,
        "spec_tokens_per_pass_ceiling": None,
    }
    if peak:
        rep["min_ms_per_token"] = per_chip / peak * 1000.0
        rep["max_tok_s_per_chip"] = peak / per_chip if per_chip else None
    if spec_k > 0:
        rep["spec_tokens_per_pass_floor"] = 1.0
        rep["spec_tokens_per_pass_ceiling"] = float(spec_k + 1)
    return rep


def print_roofline_report(
    h: "LlmHeader", weight_format: str, tp: int = 1, pp: int = 1,
    i8_group: int = 512, spec_k: int = 0, params: dict | None = None,
    dtype_bytes: int = 2, device=None,
) -> dict:
    """Startup roofline printout (cli.load_engine); returns the report."""
    rep = roofline_report(h, weight_format, tp=tp, pp=pp, i8_group=i8_group, spec_k=spec_k,
                          params=params, dtype_bytes=dtype_bytes, device=device)
    gb = rep["weight_bytes_per_token_per_chip"] / 1e9
    if rep["hbm_peak_bytes_per_s"]:
        print(
            f"📐 Roofline: {gb:.3f} GB weight reads/token/chip @ "
            f"{rep['hbm_peak_bytes_per_s'] / 1e9:.0f} GB/s HBM peak -> "
            f">= {rep['min_ms_per_token']:.2f} ms/token "
            f"(<= {rep['max_tok_s_per_chip']:.1f} tok/s/chip)"
        )
    else:
        print(
            f"📐 Roofline: {gb:.3f} GB weight reads/token/chip "
            f"(HBM peak unknown on {device or 'this device'!s}; no tok/s ceiling)"
        )
    if rep["spec_tokens_per_pass_ceiling"] is not None:
        print(
            f"📐 Speculation: 1 weight pass emits 1.0..."
            f"{rep['spec_tokens_per_pass_ceiling']:.1f} tokens (k="
            f"{spec_k}; live: dllama_spec_tokens_per_weight_pass)"
        )
    return rep
