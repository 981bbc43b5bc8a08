"""graphlint: static analysis over the CUDA graphs the engine captures.

The port's counterpart of dllama_tpu/analysis/xlalint.py. The JAX lint
reads the compiled HLO of every program in the engine's compile cache;
the port runs each step as a CUDA graph (runtime/graphs.py), so its
"program" is one key's captured graph, read on the card as a list of
nodes (:class:`GraphNode`): kernels by name, memcpy kinds and sizes,
memsets, host nodes, event nodes. The rules (:mod:`.rules_graph`) read
only that list and the key's :class:`GraphProgram` facts, so CPU tests
feed them synthetic node lists.

The graph is read through the CUDA driver (`read_graph`): `StepGraphs`
captures every graph with ``torch.cuda.CUDAGraph(keep_graph=True)`` and
instantiates it, lint or no lint, and while the lint is on reads
``raw_cuda_graph()`` with ``cuGraphGetNodes``, ``cuGraphNodeGetType``, the
kernel, memcpy and memset node parameters and ``cuFuncGetName`` /
``cuKernelGetName`` (reading changes nothing a replay runs).

The rules keep xlalint's names, so findings and fingerprints read alike:
``hlo-host`` (host nodes and host memcpys), ``hlo-donation`` (the in-place
cache: no memcpy of a whole KV plane, no block of a plane's size left
allocated in the graphs' pool), ``hlo-collective-census`` (no NCCL kernel in a
one-rank engine's graph), ``hlo-dtype`` (no f32 GEMM in a bf16 engine)
and ``hlo-cost-budget`` (kernel nodes against the launches the key's
shapes imply).

Three surfaces run it, as in the JAX package: ``python -m
dllama_tpu_torch.analysis --hlo`` (a tiny engine on the card, its
admission graphs, ``xlalint-torch-baseline.json``), the engine itself
(every capture is linted as it lands: ``DLLAMA_XLALINT`` warn by
default, ``strict`` raises :class:`XlalintError`, ``0``/``off``
disables; new findings count in ``dllama_xlalint_findings_total``) and
``GET /v1/debug/xlalint`` on the server.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import pathlib
import tempfile
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Iterable

from .core import Finding, apply_baseline, load_baseline

if TYPE_CHECKING:  # engine types only for annotations; torch stays lazy
    from ..runtime.engine import InferenceEngine

XLALINT_BASELINE_NAME = "xlalint-torch-baseline.json"

#: kernel launches a layer of one forward, by weight format: a layer with
#: a dense FFN, and one with a mixture of experts. Each is the widest key
#: kind's, a prefill chunk's (a decode row's is ~6 fewer). From the census
#: that chip_smoke.py prints (``graphlint`` lines, NVIDIA H100): llama-8b
#: q40 70 a chunk and 64 a decode row, q40i4 the same, q40i8 150, the
#: dense llama-1b draft 66; qwen3-30b-a3b q40 111, dense 107, q40i8 158
LAYER_LAUNCHES = {"dense": 70, "q40": 70, "q40i4": 70, "q40i8": 150}
MOE_LAYER_LAUNCHES = {"dense": 111, "q40": 111, "q40i4": 111, "q40i8": 160}
#: what the int8 KV cache adds a layer (the rows' quantization and scales)
KV_INT8_LAYER_LAUNCHES = 24
#: what the two-tier MoE decode (``moe_decode_dedup``) adds a MoE layer:
#: the active-experts tier beside the grouped one, and the tier's tally
#: (qwen3-30b-a3b q40, 8 layers: 961 a 4-lane decode step, 915 a 128-row chunk)
MOE_DEDUP_LAYER_LAUNCHES = 16
#: launches once a forward: the embedding, the final norm, the classifier,
#: the argmax or the on-device sampler (16 greedy, 147 sampled at most)
FORWARD_LAUNCHES = 150
#: the one slack of the launch budget
LAUNCH_SLACK = 1.25
#: f32 GEMM kernel nodes one product on an f32 weight of the file may
#: launch (a split-K product is its GEMM and its reduction): the
#: Qwen3-MoE router's gate [E, D] is f32 in the file, so its product is
#: f32 in a bf16 engine too, as in the JAX package
F32_NODES_PER_F32_WEIGHT = 4


class XlalintError(RuntimeError):
    """Raised (under ``DLLAMA_XLALINT=strict``) when a freshly captured
    graph carries a new finding."""


@dataclass(frozen=True)
class GraphNode:
    """One node of a captured graph, as the rules see it. ``kind`` is one
    of ``kernel``, ``memcpy``, ``memset``, ``host``, ``graph``, ``empty``,
    ``event_wait``, ``event_record``, ``mem_alloc``, ``mem_free``,
    ``conditional`` or ``other``; a memcpy's ``src``/``dst`` are
    ``device`` or ``host`` and its pointers the bytes' addresses."""

    kind: str
    name: str = ""
    nbytes: int = 0
    src: str = ""
    dst: str = ""
    src_ptr: int = 0
    dst_ptr: int = 0


@dataclass(frozen=True)
class GraphPolicy:
    """Declarative per-key policy the graph rules check."""

    #: reject host nodes and memcpys to or from host memory
    forbid_host: bool = True
    #: collective kernel families allowed (empty: a one-rank engine)
    allowed_collectives: frozenset = frozenset()
    #: reject f32 GEMMs (the engine computes in bf16)
    forbid_f32_gemm: bool = False


@dataclass(frozen=True)
class GraphProgram:
    """One captured graph, as the rules see it."""

    name: str  # graph key, stringified
    family: str  # engine step kind: decode_block, decode_lanes, ...
    nodes: tuple  # GraphNode, ...
    policy: GraphPolicy
    #: (address, bytes) of every KV plane the engine holds in place
    kv_planes: tuple = ()
    #: sizes of the blocks the capture left allocated in the graphs' pool
    pool_blocks: tuple = ()
    kernel_budget: int = 0  # 0 = no ceiling
    tokens: int = 1  # tokens one replay computes (the census' unit)
    #: f32 GEMM nodes the file's own f32 weights account for (the MoE gates)
    f32_gemm_allowance: int = 0

    @property
    def path(self) -> str:
        """Pseudo-path findings anchor to (stable across runs)."""
        return f"graph://{self.family}/{self.name}"

    def census(self) -> dict:
        """Nodes by kind, kernel nodes and kernel nodes per token."""
        by_kind: dict[str, int] = {}
        for n in self.nodes:
            by_kind[n.kind] = by_kind.get(n.kind, 0) + 1
        kernels = by_kind.get("kernel", 0)
        return {"nodes": dict(sorted(by_kind.items())), "kernel_nodes": kernels,
                "tokens": self.tokens, "kernel_nodes_per_token": kernels / max(self.tokens, 1)}


@dataclass(frozen=True)
class HloFinding(Finding):
    """A Finding with a free-form ``detail`` that is RENDERED but not
    fingerprinted — raw counts and sizes go here so the baseline stays
    stable while the report stays concrete."""

    detail: str = ""

    def render(self) -> str:
        base = super().render()
        return f"{base} [{self.detail}]" if self.detail else base


class HloRule:
    """Base class for captured-graph rules (see rules_graph)."""

    name = ""
    description = ""

    def check(self, prog: GraphProgram) -> Iterable[Finding]:
        return ()


def all_hlo_rules() -> list:
    """Every registered graph rule, instantiated."""
    from .rules_graph import (
        CollectiveCensusRule,
        CostBudgetRule,
        DonationRule,
        DtypePolicyRule,
        HostRoundTripRule,
    )

    return [
        CollectiveCensusRule(),
        DonationRule(),
        HostRoundTripRule(),
        DtypePolicyRule(),
        CostBudgetRule(),
    ]


def lint_programs(
    programs: Iterable[GraphProgram], rules: Iterable[HloRule] | None = None
) -> list[Finding]:
    findings: list[Finding] = []
    rule_list = list(rules) if rules is not None else all_hlo_rules()
    for prog in programs:
        for rule in rule_list:
            findings.extend(rule.check(prog))
    findings.sort(key=lambda f: (f.path, f.rule, f.message))
    return findings


# -- reading a graph on the card -------------------------------------------

_NODE_KINDS = {
    0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
    6: "event_wait", 7: "event_record", 10: "mem_alloc", 11: "mem_free",
    13: "conditional",
}
_MEMORY_HOST, _MEMORY_DEVICE, _MEMORY_UNIFIED = 1, 2, 4
_POINTER_ATTRIBUTE_MEMORY_TYPE = 2
_P, _U, _S = ctypes.c_void_p, ctypes.c_uint, ctypes.c_size_t


class _KernelParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", _P), ("grid", _U * 3), ("block", _U * 3), ("smem", _U),
                ("kernelParams", _P), ("extra", _P), ("kern", _P), ("ctx", _P)]


class _Memcpy3D(ctypes.Structure):  # CUDA_MEMCPY3D
    _fields_ = [
        ("srcXInBytes", _S), ("srcY", _S), ("srcZ", _S), ("srcLOD", _S),
        ("srcMemoryType", ctypes.c_int), ("srcHost", _P), ("srcDevice", ctypes.c_uint64),
        ("srcArray", _P), ("reserved0", _P), ("srcPitch", _S), ("srcHeight", _S),
        ("dstXInBytes", _S), ("dstY", _S), ("dstZ", _S), ("dstLOD", _S),
        ("dstMemoryType", ctypes.c_int), ("dstHost", _P), ("dstDevice", ctypes.c_uint64),
        ("dstArray", _P), ("reserved1", _P), ("dstPitch", _S), ("dstHeight", _S),
        ("WidthInBytes", _S), ("Height", _S), ("Depth", _S),
    ]


class _MemsetParams(ctypes.Structure):  # CUDA_MEMSET_NODE_PARAMS
    _fields_ = [("dst", ctypes.c_uint64), ("pitch", _S), ("value", _U),
                ("elementSize", _U), ("width", _S), ("height", _S)]


_driver = None


def _cuda_driver():
    """libcuda, loaded once (the process already holds it through torch)."""
    global _driver
    if _driver is None:
        _driver = ctypes.CDLL("libcuda.so.1")
    return _driver


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def _memory_side(cu, kind: int, host_ptr, dev_ptr) -> tuple[str, int]:
    """("host" or "device", address) of one end of a memcpy."""
    ptr = int(dev_ptr or host_ptr or 0)
    if kind == _MEMORY_UNIFIED and ptr:
        mt = ctypes.c_uint(0)
        if cu.cuPointerGetAttribute(ctypes.byref(mt), _POINTER_ATTRIBUTE_MEMORY_TYPE,
                                    ctypes.c_uint64(ptr)) == 0:
            kind = mt.value
    return ("host" if kind == _MEMORY_HOST else "device"), ptr


def read_graph(raw_graph: int) -> list[GraphNode]:
    """The nodes of a ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``),
    child graphs flattened, through the CUDA driver."""
    cu = _cuda_driver()
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    handles = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, handles, ctypes.byref(n)), "cuGraphGetNodes")
    names: dict[int, str] = {}
    out: list[GraphNode] = []
    for h in handles:
        node = ctypes.c_void_p(h)
        t = ctypes.c_int()
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(t)), "cuGraphNodeGetType")
        kind = _NODE_KINDS.get(t.value, "other")
        if kind == "kernel":
            kp = _KernelParams()
            _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(kp)),
                   "cuGraphKernelNodeGetParams")
            handle = kp.func or kp.kern or 0
            name = names.get(handle)
            if name is None:
                s = ctypes.c_char_p()
                if kp.func:
                    cu.cuFuncGetName(ctypes.byref(s), ctypes.c_void_p(kp.func))
                if not s.value and kp.kern:
                    cu.cuKernelGetName(ctypes.byref(s), ctypes.c_void_p(kp.kern))
                name = names[handle] = s.value.decode() if s.value else "?"
            out.append(GraphNode("kernel", name=name))
        elif kind == "memcpy":
            m = _Memcpy3D()
            _check(cu.cuGraphMemcpyNodeGetParams(node, ctypes.byref(m)),
                   "cuGraphMemcpyNodeGetParams")
            src, sp = _memory_side(cu, m.srcMemoryType, m.srcHost, m.srcDevice)
            dst, dp = _memory_side(cu, m.dstMemoryType, m.dstHost, m.dstDevice)
            nbytes = m.WidthInBytes * max(m.Height, 1) * max(m.Depth, 1)
            out.append(GraphNode("memcpy", nbytes=nbytes, src=src, dst=dst,
                                 src_ptr=sp, dst_ptr=dp))
        elif kind == "memset":
            ms = _MemsetParams()
            _check(cu.cuGraphMemsetNodeGetParams(node, ctypes.byref(ms)),
                   "cuGraphMemsetNodeGetParams")
            out.append(GraphNode("memset", nbytes=ms.elementSize * ms.width * max(ms.height, 1),
                                 dst="device", dst_ptr=int(ms.dst)))
        elif kind == "graph":
            child = ctypes.c_void_p()
            _check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            out.extend(read_graph(child.value))
        else:
            out.append(GraphNode(kind))
    return out


# -- engine integration -----------------------------------------------------

def _key_forwards_tokens(key: tuple, batch: int) -> tuple[int, int]:
    """(forwards one replay runs, tokens it computes) of a graph key."""
    kind, n = key[0], int(key[1]) if len(key) > 1 and isinstance(key[1], int) else 1
    if kind == "block":
        return n, n
    if kind in ("lane_block", "lane_block_paged", "draft_step"):
        return n, n * batch
    if kind in ("lane_verify", "lane_verify_paged"):
        return 1, n * batch
    if kind == "step":
        return 1, 1
    return 1, n  # prefill, score, lane and draft prefill chunks: one forward, n rows


def layer_launches(weight_format: str, moe: bool = False, kv_int8: bool = False,
                   dedup: bool = False) -> int:
    """The per-layer tally of an engine's forwards (module constants)."""
    n = (MOE_LAYER_LAUNCHES if moe else LAYER_LAUNCHES)[weight_format]
    if moe and dedup:
        n += MOE_DEDUP_LAYER_LAUNCHES
    return n + (KV_INT8_LAYER_LAUNCHES if kv_int8 else 0)


def launch_budget(forwards: int, layers: int, per_layer: int) -> int:
    """The kernel-node ceiling of a graph of ``forwards`` forwards over
    ``layers`` layers of ``per_layer`` launches each (`layer_launches`):
    the tallies times the slack."""
    return forwards * int(LAUNCH_SLACK * (layers * per_layer + FORWARD_LAUNCHES))


def engine_policy(engine: "InferenceEngine") -> GraphPolicy:
    """The policy of THIS engine's graphs: host traffic is always
    forbidden, collectives allowed only past one rank (none captures
    them today), f32 GEMMs forbidden when the engine computes in bf16."""
    import torch

    return GraphPolicy(
        allowed_collectives=frozenset() if engine.world == 1 else frozenset({"nccl"}),
        forbid_f32_gemm=engine.dtype == torch.bfloat16,
    )


def kv_planes(engine: "InferenceEngine") -> tuple:
    """(address, bytes) of every KV plane the engine updates in place:
    the single stream's cache, the lanes' slab, the page pool and the
    draft model's cache, each plane's values and an int8 plane's scales."""
    from ..ops.kv_cache import kv_tensors

    planes = []
    for cache in (engine.cache, engine.lane_cache, engine.kv_pool, engine.draft_cache):
        for leaf in (cache or {}).values():
            for t in kv_tensors(leaf):
                if t.is_cuda:
                    planes.append((t.data_ptr(), t.numel() * t.element_size()))
    return tuple(planes)


def engine_program(engine: "InferenceEngine", key: tuple) -> GraphProgram | None:
    """The GraphProgram of one captured key, or None when the key has no
    graph that was read (eager runs, the CPU, a capture with the lint off)."""
    graphs = engine.graphs
    nodes = graphs.nodes.get(key)
    if nodes is None:
        return None
    import torch

    draft = key[0] in ("draft_prefill", "draft_step")
    header = engine._draft_header if draft else engine.header
    layers = header.n_layers
    forwards, tokens = _key_forwards_tokens(key, engine.batch_size)
    moe = header.n_experts > 0
    gates = layers if moe else 0
    # the draft model is dense, its cache in the engine's dtype
    per_layer = (layer_launches("dense") if draft else layer_launches(
        engine.weight_format, moe, engine.kv_dtype == torch.int8, engine.moe_decode_dedup))
    return GraphProgram(
        name=str(key),
        family=engine._key_kind(key),
        nodes=tuple(nodes),
        policy=engine_policy(engine),
        kv_planes=kv_planes(engine),
        pool_blocks=tuple(graphs.pool_blocks.get(key, ())),
        kernel_budget=launch_budget(forwards, layers, per_layer),
        tokens=tokens,
        f32_gemm_allowance=F32_NODES_PER_F32_WEIGHT * forwards * gates,
    )


def engine_programs(engine: "InferenceEngine") -> tuple[list[GraphProgram], list[str]]:
    """(lintable programs, skipped keys): every key the engine has run,
    the ones with no graph read (eager runs, the CPU) reported as
    skipped, never silently dropped."""
    programs: list[GraphProgram] = []
    skipped: list[str] = []
    for key in engine.graphs.keys():
        prog = engine_program(engine, key)
        if prog is None:
            skipped.append(str(key))
        else:
            programs.append(prog)
    return programs, skipped


def repo_root() -> pathlib.Path:
    # analysis/ -> dllama_tpu_torch/ -> repo root (same rule as __main__)
    return pathlib.Path(__file__).resolve().parent.parent.parent


def default_baseline_path() -> pathlib.Path:
    return repo_root() / XLALINT_BASELINE_NAME


def lint_engine_report(engine: "InferenceEngine", baseline: set | None = None) -> dict:
    """The ``engine.xlalint_report()`` / ``GET /v1/debug/xlalint``
    payload: every finding split new-vs-baselined, plus each graph's
    census, so an operator sees what was checked (and what was skipped
    for having no graph)."""
    if baseline is None:
        baseline = load_baseline(default_baseline_path())
    programs, skipped = engine_programs(engine)
    findings = lint_programs(programs)
    new, baselined, stale = apply_baseline(findings, baseline)
    # a copy first: the engine's thread may capture while a handler reads
    lint_s = {str(k): s for k, s in dict(engine.graphs.lint_seconds).items()}
    return {
        "n_programs": len(programs),
        "skipped": skipped,
        "new_findings": [f.render() for f in new],
        "baselined_findings": [f.render() for f in baselined],
        "stale_baseline_entries": sorted(stale),
        "programs": [
            dict(name=p.name, family=p.family, kernel_budget=p.kernel_budget,
                 lint_seconds=lint_s.get(p.name),
                 **p.census())
            for p in programs
        ],
    }


def lint_engine_key(engine: "InferenceEngine", key: tuple,
                    baseline: set | None = None) -> list[Finding]:
    """New (non-baselined) findings for ONE just-captured graph — the
    per-capture hook the engine calls."""
    if baseline is None:
        baseline = load_baseline(default_baseline_path())
    prog = engine_program(engine, key)
    if prog is None:
        return []
    new, _, _ = apply_baseline(lint_programs([prog]), baseline)
    return new


# -- CLI (--hlo mode) -------------------------------------------------------

_TINY_CFG = dict(dim=512, hidden_dim=1024, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=64,
                 vocab_size=1024, seq_len=256, rope_theta=500000.0)


def build_cli_engine() -> "InferenceEngine":
    """The tiny engine the ``--hlo`` CLI lints, on the card: a random Q40
    file, bf16, 4 pool-native lanes, every admission graph captured
    (`rehearse_admission`, speculation buckets included), and the single
    stream's prefill buckets and decode blocks."""
    # no double-reporting: the CLI prints findings itself
    os.environ.setdefault("DLLAMA_XLALINT", "0")
    import torch

    from ..models.synthetic import write_synth_model
    from ..runtime.engine import InferenceEngine

    d = tempfile.mkdtemp(prefix="graphlint-")
    mp = os.path.join(d, "tiny.m")
    write_synth_model(mp, _TINY_CFG, max_seq_len=_TINY_CFG["seq_len"])
    engine = InferenceEngine(mp, dtype=torch.bfloat16, batch_size=4, device="cuda",
                             prefill_buckets=(1, 8, 32))
    engine.graphs.inspect = True
    engine.init_kv_pool(page_size=16, native=True)
    engine.rehearse_admission(block_size=8, spec_k=2)
    engine.generate(list(range(1, 40)), 16)
    return engine


def run_hlo_cli(args: Any) -> int:
    """``python -m dllama_tpu_torch.analysis --hlo``: build the tiny engine
    on the card, lint every captured graph, apply/maintain the baseline.
    Exit codes match dlint: 0 clean, 1 new findings, 2 no CUDA."""
    import sys

    import torch

    if not torch.cuda.is_available():
        print("--hlo reads captured CUDA graphs: it needs a CUDA card "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    engine = build_cli_engine()
    programs, skipped = engine_programs(engine)
    findings = lint_programs(programs)

    baseline_path = (
        pathlib.Path(args.baseline) if args.baseline else default_baseline_path()
    )
    if args.update_baseline:
        write_baseline_fingerprints(baseline_path, (f.fingerprint() for f in findings))
        print(f"xlalint baseline written: {len(findings)} finding(s) -> {baseline_path}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(baseline_path)
    new, baselined, stale = apply_baseline(findings, baseline)

    if args.prune:
        kept = baseline - stale
        write_baseline_fingerprints(baseline_path, kept)
        print(
            f"xlalint baseline pruned: {len(stale)} stale entr"
            f"{'y' if len(stale) == 1 else 'ies'} removed, "
            f"{len(kept)} kept -> {baseline_path}"
        )
        return 0

    for f in new:
        print(f.render())
    if not args.quiet:
        for p in programs:
            print(f"graph {p.name}: {json.dumps(p.census())}")
        if stale:
            print(
                f"note: {len(stale)} stale xlalint baseline entr"
                f"{'y' if len(stale) == 1 else 'ies'} no longer match any "
                f"finding — prune with --hlo --prune"
            )
        print(
            f"xlalint: {len(programs)} captured graphs ({len(skipped)} "
            f"skipped: no graph), {len(all_hlo_rules())} rules, {len(new)} new "
            f"finding(s), {len(baselined)} baselined"
        )
    return 1 if new else 0


def write_baseline_fingerprints(path: pathlib.Path, fingerprints: Iterable[str]) -> None:
    """Rewrite a baseline file from raw fingerprints (the --prune path,
    where stale entries have no live Finding to round-trip through)."""
    data = {
        "comment": (
            "graphlint baseline: fingerprints of pre-existing captured-graph "
            "findings allowed to persist. Regenerate with "
            "`python -m dllama_tpu_torch.analysis --hlo --update-baseline`; "
            "prune stale entries with `--hlo --prune`."
        ),
        "findings": sorted(set(fingerprints)),
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def make_program(
    nodes: Iterable[GraphNode],
    *,
    name: str = "toy",
    family: str = "decode_lanes",
    policy: GraphPolicy | None = None,
    kv_planes: tuple = (),
    pool_blocks: tuple = (),
    kernel_budget: int = 0,
    tokens: int = 1,
    f32_gemm_allowance: int = 0,
) -> GraphProgram:
    """Convenience constructor for tests and ad-hoc linting of one node
    list (seeded-violation fixtures build programs through this)."""
    return GraphProgram(
        name=name, family=family, nodes=tuple(nodes),
        policy=policy if policy is not None else GraphPolicy(),
        kv_planes=tuple(kv_planes), pool_blocks=tuple(pool_blocks),
        kernel_budget=kernel_budget, tokens=tokens, f32_gemm_allowance=f32_gemm_allowance,
    )


def replace_policy(prog: GraphProgram, **changes: Any) -> GraphProgram:
    """A program with its policy fields replaced (tests tighten one knob
    at a time)."""
    return dataclasses.replace(prog, policy=dataclasses.replace(prog.policy, **changes))


__all__ = [
    "GraphNode", "GraphPolicy", "GraphProgram", "HloFinding", "HloRule", "XlalintError",
    "all_hlo_rules", "launch_budget", "layer_launches", "lint_programs", "make_program", "read_graph",
]
