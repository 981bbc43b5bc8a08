"""The captured-graph lint of the port (analysis/graphlint.py, rules_graph.py),
the counterpart of tests/test_xlalint.py.

* Each rule fires on a synthetic node list seeded with one violation and a
  policy gates it; the node lists use kernel names read from graphs
  captured on an H100 (cuBLAS f32 and bf16 products, the port's kernels).
* Findings keep raw numbers out of their fingerprints; the baseline
  helpers prune; ``--hlo --list-rules`` lists the rules and ``--hlo``
  refuses a host without CUDA.
* The engine on the CPU: ``xlalint_report()`` has the JAX report's keys
  and lists every key as skipped; the capture hook warns, raises in strict
  mode and does nothing when off, through `StepGraphs` itself with a
  stand-in capture; the server answers ``/v1/debug/xlalint`` with the JAX
  server's keys.
"""

import json
import pathlib
import subprocess
import sys
import threading
import types
import urllib.request

import pytest
import torch

from dllama_tpu.analysis.xlalint import lint_engine_report as jax_lint_engine_report
from dllama_tpu_torch.analysis import graphlint
from dllama_tpu_torch.analysis.core import apply_baseline, load_baseline
from dllama_tpu_torch.analysis.graphlint import (
    GraphNode,
    GraphPolicy,
    HloFinding,
    XlalintError,
    all_hlo_rules,
    launch_budget,
    lint_programs,
    make_program,
    replace_policy,
    write_baseline_fingerprints,
)
from dllama_tpu_torch.analysis.rules_graph import (
    CollectiveCensusRule,
    CostBudgetRule,
    DonationRule,
    DtypePolicyRule,
    HostRoundTripRule,
)
from dllama_tpu_torch.obs.metrics import get_registry
from dllama_tpu_torch.obs.recorder import get_recorder
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.graphs import StepGraphs

from helpers import make_tiny_model, make_tiny_tokenizer

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
CLI = [sys.executable, "-m", "dllama_tpu_torch.analysis", "--hlo"]

# kernel names as they read in graphs captured on an H100 (torch 2.11, cuBLAS 12.8)
Q40_GEMV = ("_ZN6dllama3q4015gemv_mma_kernelINS0_10Int8ValuesELi16EEEvPK13__nv_bfloat16PKhPK"
            "6__halfPfiii")
BF16_GEMM = "nvjet_tst_64x8_64x16_4x1_v_bz_TNT"
BF16_F32_OUT = "nvjet_tss_64x8_64x16_4x1_v_bz_TNT"
F32_GEMMS = (
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_"
    "alignc4_execute_kernel__5x_cublas",
    "_ZN7cutlass7Kernel2I41cutlass_80_simt_sgemm_64x64_8x5_tn_align1EEvNT_6ParamsE",
    "_ZN8internal5gemvx6kernelIiiffffLb0ELb1ELb1ELb0ELi7ELb0E18cublasGemvParamsExIi30cublasGemvT",
    "_Z16gemmSN_TN_kernelIfLi128ELi16ELi2ELi4ELi8ELi9ELb0E30cublasGemvTensorStridedBatchedIKfE",
)
ELEMENTWISE = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEESt5arrayIPc"
               "Lm1EEEEviT0_T1_")
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
PLANE = (0x7F0000000000, 1 << 20)  # (address, bytes) of a KV plane
BIG_PLANE = (0x7F1000000000, 256 << 20)  # a llama-8b single-stream plane's size


def kernel(name):
    return GraphNode("kernel", name=name)


def memcpy(nbytes, src="device", dst="device", src_ptr=0x7E0000000000, dst_ptr=0x7E1000000000):
    return GraphNode("memcpy", nbytes=nbytes, src=src, dst=dst, src_ptr=src_ptr, dst_ptr=dst_ptr)


HEALTHY = (kernel(Q40_GEMV), kernel(BF16_GEMM), kernel(BF16_F32_OUT), kernel(ELEMENTWISE),
           memcpy(16384), GraphNode("memset", nbytes=64, dst="device"))


def _findings(nodes, rule, **kw):
    return lint_programs([make_program(nodes, **kw)], [rule])


def test_healthy_graph_is_quiet_under_every_rule():
    prog = make_program(HEALTHY, policy=GraphPolicy(forbid_f32_gemm=True), kv_planes=(PLANE,),
                        pool_blocks=(4096, 1 << 19), kernel_budget=4)
    assert lint_programs([prog]) == []
    census = prog.census()
    assert census["nodes"] == {"kernel": 4, "memcpy": 1, "memset": 1}
    assert census["kernel_nodes"] == 4 and census["kernel_nodes_per_token"] == 4.0


def test_host_rule_fires_and_its_policy_gates():
    nodes = HEALTHY + (GraphNode("host"), memcpy(4096, dst="host"), memcpy(64, src="host"))
    msgs = sorted(f.message for f in _findings(nodes, HostRoundTripRule()))
    assert msgs == ["host-transfer memcpy 'device-to-host'",
                    "host-transfer memcpy 'host-to-device'", "host-transfer op 'host-node'"]
    assert not _findings(nodes, HostRoundTripRule(), policy=GraphPolicy(forbid_host=False))


def test_donation_rule_fires_on_a_copied_plane_and_a_plane_sized_block():
    addr, size = PLANE
    whole = memcpy(size, src_ptr=addr)  # the clone of a plane: reads all of it
    into = memcpy(4096, dst_ptr=addr + 8192)  # a row written into the plane: fine
    fs = _findings(HEALTHY + (whole, into), DonationRule(), kv_planes=(PLANE,))
    assert [f.message for f in fs] == [
        "KV plane copied: a memcpy node moves a whole KV plane (the cache is not updated in place)"]
    assert not _findings(HEALTHY + (into,), DonationRule(), kv_planes=(PLANE,))
    big = BIG_PLANE[1]
    fs = _findings(HEALTHY, DonationRule(), kv_planes=(PLANE, BIG_PLANE),
                   pool_blocks=(512, big))
    assert [f.message for f in fs] == [
        "capture left a block of a KV plane's size allocated in the graphs' pool"]
    # a small plane's size is left to the memcpy check (cuBLAS's workspace
    # can match it), and no planes held in place means nothing to check
    assert not _findings(HEALTHY, DonationRule(), kv_planes=(PLANE,), pool_blocks=(size,))
    assert not _findings(HEALTHY + (whole,), DonationRule(), pool_blocks=(big,))


def test_collective_rule_fires_in_a_one_rank_graph_only():
    fs = _findings(HEALTHY + (kernel(NCCL),), CollectiveCensusRule(), family="decode_block")
    assert [f.message for f in fs] == ["collective 'AllReduce' not allowed in decode_block graphs"]
    allowed = GraphPolicy(allowed_collectives=frozenset({"nccl"}))
    assert not _findings(HEALTHY + (kernel(NCCL),), CollectiveCensusRule(), policy=allowed)


@pytest.mark.parametrize("name", F32_GEMMS, ids=["xmma", "cutlass-simt", "gemvx", "gemmSN"])
def test_dtype_rule_fires_on_f32_products_in_a_bf16_engine(name):
    bf16 = GraphPolicy(forbid_f32_gemm=True)
    fs = _findings(HEALTHY + (kernel(name),), DtypePolicyRule(), policy=bf16)
    assert [f.message for f in fs] == [
        "16-bit float path upcast to an f32 GEMM (cuBLAS/CUTLASS f32 kernel)"]
    # an f32 engine's graphs, and the products of the file's f32 weights
    assert not _findings(HEALTHY + (kernel(name),), DtypePolicyRule())
    assert not _findings(HEALTHY + (kernel(name),), DtypePolicyRule(), policy=bf16,
                         f32_gemm_allowance=1)


def test_cost_budget_rule_fires_over_the_launch_budget():
    per_layer = graphlint.layer_launches("q40")
    budget = launch_budget(1, 2, per_layer)
    assert budget == int(graphlint.LAUNCH_SLACK * (2 * per_layer + graphlint.FORWARD_LAUNCHES))
    assert launch_budget(8, 2, per_layer) == 8 * budget
    over = tuple(kernel(ELEMENTWISE) for _ in range(budget + 1))
    fs = _findings(over, CostBudgetRule(), family="prefill", kernel_budget=budget)
    assert [f.message for f in fs] == ["kernel nodes exceed the prefill launch budget"]
    assert fs[0].detail == f"{budget + 1} > {budget} kernel nodes"
    assert not _findings(over[:budget], CostBudgetRule(), kernel_budget=budget)
    assert not _findings(over, CostBudgetRule())  # 0: no ceiling


# kernel nodes of graphs captured on an H100 (chip_smoke.py's census):
# (weight format, MoE, int8 KV, layers, kernel nodes of one forward)
CENSUS = (
    ("q40", False, False, 32, 2270),  # llama-8b, a verify pass (the widest key)
    ("q40", False, False, 32, 2195),  # llama-8b, a sampled 4-lane step
    ("q40", False, True, 32, 3024),  # llama-8b over the int8 pool, a 512-row chunk
    ("q40i4", False, False, 4, 296),
    ("q40i8", False, False, 4, 615),
    ("q40", True, False, 8, 917),  # qwen3-30b-a3b, a 512-row score
    ("dense", True, False, 4, 444),
    ("q40i8", True, False, 4, 647),
    ("dense", False, False, 16, 1067),  # the llama-1b draft, a chunk
)


@pytest.mark.parametrize("fmt,moe,kv_int8,layers,nodes", CENSUS)
def test_launch_budget_holds_the_census_and_not_its_double(fmt, moe, kv_int8, layers, nodes):
    budget = launch_budget(1, layers, graphlint.layer_launches(fmt, moe, kv_int8))
    assert nodes <= budget < 2 * nodes


def test_layer_tally_by_format_kv_and_moe():
    tally = graphlint.layer_launches
    assert tally("q40") == tally("q40i4") == tally("dense") < tally("q40i8")
    assert tally("q40", kv_int8=True) == tally("q40") + graphlint.KV_INT8_LAYER_LAUNCHES
    assert tally("q40", moe=True) > tally("q40")
    assert tally("q40", moe=True, dedup=True) == (tally("q40", moe=True)
                                                  + graphlint.MOE_DEDUP_LAYER_LAUNCHES)
    assert tally("q40", dedup=True) == tally("q40")  # no experts, one tier
    with pytest.raises(KeyError):
        tally("q80")


def test_key_forwards_and_tokens():
    fwd = graphlint._key_forwards_tokens
    assert fwd(("block", 8, True), 4) == (8, 8)
    assert fwd(("lane_block_paged", 8, False), 4) == (8, 32)
    assert fwd(("draft_step", 4), 4) == (4, 16)
    assert fwd(("lane_verify_paged", 3), 4) == (1, 12)
    assert fwd(("prefill", 512, False), 4) == (1, 512)
    assert fwd(("lane_prefill", 32, 2), 4) == (1, 32)
    assert fwd(("step", True), 4) == (1, 1)


def test_findings_fingerprints_and_baseline_prune(tmp_path):
    over = tuple(kernel(ELEMENTWISE) for _ in range(10))
    f = _findings(over, CostBudgetRule(), name="('prefill', 8, False)", family="prefill",
                  kernel_budget=5)[0]
    assert isinstance(f, HloFinding)
    assert f.path == "graph://prefill/('prefill', 8, False)"
    assert f.render().endswith("[10 > 5 kernel nodes]")
    assert "10" not in f.fingerprint()
    drifted = HloFinding(rule=f.rule, path=f.path, line=1, message=f.message, detail="other")
    assert drifted.fingerprint() == f.fingerprint()
    bp = tmp_path / "xlalint-torch-baseline.json"
    write_baseline_fingerprints(bp, [f.fingerprint(), "r::p::gone"])
    new, old, stale = apply_baseline([f], load_baseline(bp))
    assert not new and old == [f] and stale == {"r::p::gone"}
    write_baseline_fingerprints(bp, load_baseline(bp) - stale)
    assert json.loads(bp.read_text())["findings"] == [f.fingerprint()]
    assert json.loads((REPO_ROOT / graphlint.XLALINT_BASELINE_NAME).read_text())["findings"] == []


def test_replace_policy_tightens_one_knob():
    prog = make_program(HEALTHY + (kernel(F32_GEMMS[0]),))
    assert not lint_programs([prog])
    assert lint_programs([replace_policy(prog, forbid_f32_gemm=True)])


def test_hlo_cli_lists_rules_and_needs_cuda():
    proc = subprocess.run(CLI + ["--list-rules"], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [line.split()[0] for line in proc.stdout.splitlines()] == [
        r.name for r in all_hlo_rules()]
    assert [r.name for r in all_hlo_rules()] == [
        "hlo-collective-census", "hlo-donation", "hlo-host", "hlo-dtype", "hlo-cost-budget"]
    if not torch.cuda.is_available():
        proc = subprocess.run(CLI, cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2 and "needs a CUDA card" in proc.stderr


# -- the engine and the server, on the CPU ----------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphlint")
    mp, tp = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, cfg=dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4,
                                 head_dim=16, vocab_size=288, seq_len=128))
    make_tiny_tokenizer(tp, chat_template="<|start_header_id|>", pad_to=288)
    return mp, tp


@pytest.fixture(scope="module")
def engine(files):
    eng = InferenceEngine(files[0], dtype=torch.float32, device="cpu", batch_size=2)
    eng.generate([1, 2, 3, 4, 5], 6)
    return eng


def _jax_report_keys() -> set:
    """The top-level keys of the JAX engine's report (an engine with an
    empty compile cache) plus its ``mode``, as `xlalint_report` adds it."""
    fake = types.SimpleNamespace(_compile_lock=threading.Lock(), _compiled={}, header=None,
                                 tp=1, batch_size=1, prefill_buckets=(8,), dtype=None)
    return set(jax_lint_engine_report(fake, baseline=set())) | {"mode"}


def test_engine_report_has_the_jax_keys_and_skips_every_cpu_key(engine):
    rep = engine.xlalint_report()
    assert set(rep) == _jax_report_keys()
    assert rep["mode"] == "warn" and rep["n_programs"] == 0 and rep["programs"] == []
    assert rep["new_findings"] == [] and rep["stale_baseline_entries"] == []
    assert set(rep["skipped"]) == {str(k) for k in engine.graphs.keys()}
    assert any(k.startswith("('prefill'") for k in rep["skipped"])
    assert any(k.startswith("('block'") for k in rep["skipped"])


class _StandInGraph:
    def raw_cuda_graph(self):
        return 1

    def instantiate(self):
        pass

    def replay(self):
        pass


class InspectedGraphs(StepGraphs):
    """Graphs on a "cuda" device whose capture only runs the step and whose
    node list is given: the engine's capture hook and lint run as they do
    on the card."""

    def __init__(self, nodes):
        super().__init__(torch.device("cuda"))
        self.given = nodes

    def _record(self, step):
        step()
        return _StandInGraph()

    def _pool_block_set(self):
        return set()


def test_capture_hook_warns_raises_in_strict_mode_and_is_off_when_off(files, monkeypatch):
    monkeypatch.setattr(graphlint, "read_graph", lambda raw: list(g.given))
    eng = InferenceEngine(files[0], dtype=torch.float32, device="cpu")
    per_layer = graphlint.layer_launches(eng.weight_format)
    over = [kernel(ELEMENTWISE)] * (launch_budget(1, eng.header.n_layers, per_layer) + 1)
    g = InspectedGraphs(over)
    counter, recorder = get_registry(), get_recorder()
    counter.enable()
    recorder.enable()
    for mode, key in (("strict", ("prefill", 901, False)), ("warn", ("prefill", 902, False)),
                      ("off", ("prefill", 903, False))):
        eng._xlalint_mode = mode
        eng.graphs = g
        n0 = eng._m_xlalint.value
        events0 = len(recorder.events("xlalint"))
        if mode == "strict":
            with pytest.raises(XlalintError, match=r"\[hlo-cost-budget\]"):
                g.run(key, lambda: None)
        else:
            g.run(key, lambda: None)
        assert g.n_graphs == {"strict": 1, "warn": 2, "off": 3}[mode]  # kept either way
        moved = eng._m_xlalint.value - n0
        assert moved == (0 if mode == "off" else 1)
        assert len(recorder.events("xlalint")) - events0 == (0 if mode == "off" else 1)
        assert (key in g.nodes) == (mode != "off")
    # the graph a strict capture kept replays without a second lint
    eng._xlalint_mode = "strict"
    g.run(("prefill", 901, False), lambda: None)
    assert g.replays == 1
    rep = eng.xlalint_report()
    assert rep["n_programs"] == 2 and len(rep["new_findings"]) == 2
    assert str(("prefill", 903, False)) in rep["skipped"]
    assert {p["name"] for p in rep["programs"]} == {"('prefill', 901, False)",
                                                   "('prefill', 902, False)"}
    assert all(p["lint_seconds"] is not None for p in rep["programs"])


def test_capture_hook_records_a_lint_that_fails(files, monkeypatch):
    def broken(engine, key, baseline=None):
        raise RuntimeError("lint bug")

    monkeypatch.setattr(graphlint, "read_graph", lambda raw: [kernel(ELEMENTWISE)])
    monkeypatch.setattr(graphlint, "lint_engine_key", broken)
    eng = InferenceEngine(files[0], dtype=torch.float32, device="cpu")
    eng.graphs = InspectedGraphs([])
    recorder = get_recorder()
    recorder.enable()
    n0 = len(recorder.events("xlalint_error"))
    eng.graphs.run(("prefill", 904, False), lambda: None)  # warn: the capture stands
    assert len(recorder.events("xlalint_error")) == n0 + 1
    eng._xlalint_mode = "strict"
    with pytest.raises(RuntimeError, match="lint bug"):
        eng.graphs.run(("prefill", 905, False), lambda: None)


def test_a_failed_graph_read_keeps_the_graph_and_is_recorded(files, monkeypatch):
    def broken(raw):
        raise RuntimeError("driver read failed")

    monkeypatch.setattr(graphlint, "read_graph", broken)
    eng = InferenceEngine(files[0], dtype=torch.float32, device="cpu")
    g = eng.graphs = InspectedGraphs([])
    recorder = get_recorder()
    recorder.enable()
    n0 = len(recorder.events("xlalint_error"))
    key = ("prefill", 906, False)
    g.run(key, lambda: None)  # warn: the capture stands, the read is recorded
    assert g.n_graphs == 1 and key not in g.nodes and not g.read_errors
    errors = recorder.events("xlalint_error")
    assert len(errors) == n0 + 1 and "driver read failed" in str(errors[-1])
    assert str(key) in eng.xlalint_report()["skipped"]
    g.run(key, lambda: None)  # the kept graph replays
    assert g.replays == 1
    eng._xlalint_mode = "strict"
    with pytest.raises(RuntimeError, match="driver read failed"):
        g.run(("prefill", 907, False), lambda: None)
    assert g.n_graphs == 2 and not g.read_errors  # kept before the hook raised
    # a failed snapshot of the pool is handled the same way
    monkeypatch.setattr(graphlint, "read_graph", lambda raw: [kernel(ELEMENTWISE)])
    monkeypatch.setattr(InspectedGraphs, "_pool_block_set",
                        lambda self: (_ for _ in ()).throw(RuntimeError("snapshot failed")))
    eng._xlalint_mode = "warn"
    g.run(("prefill", 908, False), lambda: None)
    assert g.n_graphs == 3 and ("prefill", 908, False) in g.nodes
    assert "snapshot failed" in str(recorder.events("xlalint_error")[-1])


def test_env_knob_sets_the_mode_and_inspection(files, monkeypatch):
    for value, mode, inspect in (("strict", "strict", True), (" OFF ", "off", False),
                                 ("0", "0", False)):
        monkeypatch.setenv("DLLAMA_XLALINT", value)
        eng = InferenceEngine(files[0], dtype=torch.float32, device="cpu")
        assert eng._xlalint_mode == mode and eng.graphs.inspect is inspect
    monkeypatch.delenv("DLLAMA_XLALINT")
    eng = InferenceEngine(files[0], dtype=torch.float32, device="cpu")
    assert eng._xlalint_mode == "warn" and eng.graphs.inspect


def test_server_answers_debug_xlalint_with_the_jax_keys(files, engine):
    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.tokenizer import Tokenizer

    srv = serve(engine, Tokenizer(files[1]), host="127.0.0.1", port=0, kv_page_size=8)
    t = threading.Thread(target=srv.serve_forever, daemon=True, name="dllama-test-serve")
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/debug/xlalint"
        with urllib.request.urlopen(url, timeout=60) as r:
            rep = json.loads(r.read())
    finally:
        srv.shutdown()
        t.join()
        srv.server_close()
    assert set(rep) == _jax_report_keys()
    assert rep["mode"] == "warn" and rep["n_programs"] == 0 and rep["new_findings"] == []
