"""The port's CUDA-graph plumbing on CPU (runtime/graphs.py and the engine
paths that run through it). Exact comparisons throughout (bit equality):

* ``forward`` with the position as a device tensor gives the int form's
  logits and cache bit for bit: slab prefill, slab decode and paged, on a
  tiny Llama and a tiny Qwen3-MoE;
* the launch bookkeeping, driven by a fake capture and replay: the first
  run is eager and counts, a capture leaves the counters as they were, a
  replay adds the captured tally, a failed capture raises with the
  counters unchanged, and ``cuda_graphs=True`` on the CPU captures nothing;
* ``rehearse_admission`` is a no-op on the CPU that leaves the pool's
  bytes unchanged, and with graphs forced on (fake capture) its first
  uses write the scratch page only and capture every lane-prefill bucket
  and both lane decode blocks;
* with a fake replay that runs the step captured on a key's first use
  (so a call's inputs reach it only through the static buffers, as they
  reach a CUDA graph), the engine's streams, perplexity and lanes equal
  the eager engine's.
"""

import pytest
import torch

from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.models import forward, init_kv_cache, load_params
from dllama_tpu_torch.ops import flash_decode, launch_counts, qmatmul, reset_launch_counts
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.graphs import StepGraphs

from helpers import make_tiny_model

ARCHS = {"llama": LlmArch.LLAMA, "qwen3_moe": LlmArch.QWEN3_MOE}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    out = {}
    for name, arch in ARCHS.items():
        out[name] = str(d / f"{name}.m")
        make_tiny_model(out[name], arch=arch)
    return out


def _params(mp):
    reader = ModelReader(mp)
    return reader.header, load_params(reader, dtype=torch.float32, device="cpu",
                                      weight_format="q40")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_tensor_pos_equals_int_pos_slab(models, arch):
    h, params = _params(models[arch])
    prompt = torch.tensor([[3, 17, 5, 9, 40, 41, 2, 8, 77, 12]])
    caches = [init_kv_cache(h, 1, device="cpu") for _ in range(2)]
    outs = []
    for cache, as_tensor in zip(caches, (False, True)):
        def pos(p):
            return torch.tensor([p], dtype=torch.int32) if as_tensor else p

        pre, _ = forward(params, h, prompt[:, :7], pos(0), cache, "all")
        mid, _ = forward(params, h, prompt[:, 7:], pos(7), cache, "all")  # a chunk at pos > 0
        dec, _ = forward(params, h, prompt[:, :1], pos(10), cache, "last")
        outs.append((pre, mid, dec))
    for a, b in zip(*outs):
        _same(a, b)
    for key in ("k", "v"):
        _same(caches[0][key], caches[1][key])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_tensor_pos_equals_int_pos_paged(models, arch):
    h, params = _params(models[arch])
    ps, nb = 4, h.seq_len // 4
    pt = (1 + torch.arange(2 * nb, dtype=torch.int32)).reshape(2, nb)
    shape = (h.n_layers, 2 * nb + 1, h.n_kv_heads, ps, h.head_dim)
    pools = [{k: torch.zeros(shape) for k in ("k", "v")} for _ in range(2)]
    chunk = torch.tensor([[3, 17, 5, 9, 40], [41, 2, 8, 77, 12]])
    outs = []
    for pool, as_tensor in zip(pools, (False, True)):
        pos = torch.tensor([6, 6], dtype=torch.int32) if as_tensor else 6
        pre, _ = forward(params, h, chunk, pos, pool, "all", page_table=pt)
        lanes = torch.tensor([11, -1], dtype=torch.int32)  # lane 1 parked
        dec, _ = forward(params, h, chunk[:, :1], lanes, pool, "last", page_table=pt)
        outs.append((pre, dec))
    for a, b in zip(*outs):
        _same(a, b)
    for key in ("k", "v"):
        _same(pools[0][key], pools[1][key])


def test_slab_int_pos_is_bounds_checked(models):
    h, params = _params(models["llama"])
    cache = init_kv_cache(h, 1, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        forward(params, h, torch.tensor([[1, 2]]), h.seq_len - 1, cache, "last")


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class FakeGraphs(StepGraphs):
    """Graphs forced on with a capture that only runs the step (moving the
    counters as the wrappers do under a real capture) and a replay that
    runs nothing."""

    active = True

    def __init__(self, device=torch.device("cpu"), fail=False):
        super().__init__(device)
        self.fail = fail
        self.recorded = []

    def _record(self, step):
        step()
        if self.fail:
            raise RuntimeError("capture failed")
        self.recorded.append(_FakeGraph())
        return self.recorded[-1]


def _counting_step(calls):
    def step():
        calls.append(1)
        qmatmul.launches += 2
        flash_decode.launches += 1
    return step


def test_capture_holds_counters_and_replay_adds_tally():
    reset_launch_counts()
    g, calls = FakeGraphs(), []
    step = _counting_step(calls)
    g.run(("block", 8, True), step)  # eager first use (counts), then the capture
    assert len(calls) == 2 and g.n_graphs == 1
    assert launch_counts()["q40_matmul"] == 2 and launch_counts()["flash_decode"] == 1
    for i in range(3):  # replays: the step does not run, its tally is added
        g.run(("block", 8, True), step)
    assert len(calls) == 2 and g.recorded[0].replays == 3 and g.replays == 3
    assert launch_counts()["q40_matmul"] == 8 and launch_counts()["flash_decode"] == 4
    g.run(("block", 4, True), step)  # another shape: its own first use and capture
    assert len(calls) == 4 and g.n_graphs == 2 and g.count("block") == 2
    assert launch_counts()["q40_matmul"] == 10
    reset_launch_counts()


def test_failed_capture_raises_with_counters_unchanged():
    reset_launch_counts()
    g, calls = FakeGraphs(fail=True), []
    with pytest.raises(RuntimeError, match="capture failed"):
        g.run(("step", True), _counting_step(calls))
    assert len(calls) == 2 and g.n_graphs == 0
    assert launch_counts()["q40_matmul"] == 2  # the eager first use only
    reset_launch_counts()


def test_cuda_graphs_on_cpu_capture_nothing(models):
    eng = InferenceEngine(models["llama"], dtype=torch.float32, temperature=0.0,
                          device="cpu", cuda_graphs=True)
    assert eng.cuda_graphs and not eng.graphs.active
    eng.generate([1, 2, 3, 4], max_steps=20, block_size=8)
    eng.perplexity([5, 6, 7, 8, 9])
    assert eng.graphs.n_graphs == 0 and eng.graphs.replays == 0
    assert eng.graphs.pool_bytes() == 0


def _lane_engine(mp):
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu",
                          batch_size=2)
    eng.init_kv_pool(4, native=True)
    gen = torch.Generator().manual_seed(0)
    for t in eng.kv_pool.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    return eng


def test_rehearse_admission_on_cpu_is_a_noop(models):
    eng = _lane_engine(models["llama"])
    before = {k: t.clone() for k, t in eng.kv_pool.items()}
    eng.rehearse_admission(8)
    for k in before:
        _same(before[k], eng.kv_pool[k])
    assert eng.graphs.n_graphs == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rehearse_admission_writes_scratch_page_only(models, arch):
    eng = _lane_engine(models[arch])
    eng.graphs = FakeGraphs()
    before = {k: t.clone() for k, t in eng.kv_pool.items()}
    eng.rehearse_admission(8)
    for k in before:  # pages 1.. are the lanes' and the tree's: untouched
        _same(before[k][:, 1:], eng.kv_pool[k][:, 1:])
    keys = set(eng.graphs._graphs)
    assert keys == ({("lane_prefill_paged", b) for b in eng.prefill_buckets}
                    | {("lane_block_paged", 8, False), ("lane_block_paged", 8, True)})
    # a later admission replays what the rehearsal captured
    eng.adopt_pages(0, list(range(1, 1 + eng._kv_n_blocks)))
    eng.prefill_lane_chunk(0, [5, 6, 7], 0)
    eng.decode_lanes([7, 0], [3, 0], 8, [True, False])
    assert eng.graphs.replays == 2 and eng.graphs.n_graphs == len(keys)


class ReplayingGraphs(FakeGraphs):
    """Graphs forced on whose replay runs the step captured on the key's
    first use, not the caller's: like a CUDA graph, it sees a call's
    inputs only through the static buffers."""

    def _record(self, step):
        graph = _FakeGraph()
        graph.replay = step
        return graph


def _engines(mp, **kw):
    eager = InferenceEngine(mp, dtype=torch.float32, device="cpu", **kw)
    graphed = InferenceEngine(mp, dtype=torch.float32, device="cpu", **kw)
    graphed.graphs = ReplayingGraphs()
    return eager, graphed


@pytest.mark.parametrize("arch", list(ARCHS))
def test_replayed_single_stream_equals_eager(models, arch):
    for temperature in (0.0, 0.9):
        eager, graphed = _engines(models[arch], temperature=temperature, seed=3)
        for block in (8, 1):  # decode blocks (the last one narrower), decode_step
            for eng in (eager, graphed):
                eng.set_seed(3)
            want = eager.generate([1, 2, 3, 4, 5], max_steps=64, block_size=block)[0]
            got = graphed.generate([1, 2, 3, 4, 5], max_steps=64, block_size=block)[0]
            assert got == want and len(got) == 60
        # a second prompt: every bucket and block shape replays with new inputs
        for eng in (eager, graphed):
            eng.set_seed(5)
        assert (graphed.generate(list(range(9, 30)), max_steps=50)[0]
                == eager.generate(list(range(9, 30)), max_steps=50)[0])
    assert graphed.graphs.replays > 0
    for prompt in ([3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2]):
        assert graphed.perplexity(prompt) == eager.perplexity(prompt)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_replayed_lanes_equal_eager(models, arch):
    eager, graphed = _engines(models[arch], temperature=0.0, batch_size=2)
    for eng in (eager, graphed):
        eng.init_kv_pool(4, native=True)
        eng.rehearse_admission(8)
    assert eager.graphs.n_graphs == 0 and graphed.graphs.n_graphs > 0
    prompts = [[5, 9, 13, 17, 21, 25, 29], [2 + (i * 7) % 250 for i in range(23)]]
    assert graphed.generate_batch(prompts, 50) == eager.generate_batch(prompts, 50)
    # lanes at other positions and pages, one parked, sampled with seeds
    for eng in (eager, graphed):
        nb = eng._kv_n_blocks
        eng.adopt_pages(1, list(range(1, 1 + nb)))
        eng.adopt_pages(0, list(range(1 + nb, 1 + 2 * nb)))
        eng.prefill_lane(1, prompts[0])
    rows = [eng.decode_lanes([29, 0], [6, 0], 8, [False, True], [0.0, 0.8], [1.0, 0.9],
                             seeds=[None, 11]) for eng in (eager, graphed)]
    assert rows[0] == rows[1]
    assert graphed.graphs.replays > 0
