"""The port's engine and CLI options on CPU against the JAX package's, f32
on tiny ``.m`` files:

* a float KV type unlike the model's (``kv_dtype`` f32, f16, bf16 under
  either dtype): the plain attention functions on mixed q and cache types
  against the TPU kernels in interpret mode (which upcast q, K and V to f32
  inside the kernel) at `TOL`; the f32 engine with a bf16 or f16 cache
  against the JAX engine with the same ``kv_dtype`` (equal greedy streams,
  perplexities within f32 tolerance), on the slab, on slab lanes and on
  pool-native lanes; graphs replayed; the names validated;
* ``prefill_buckets`` and ``--nbatches`` / ``--n-batches``: the buckets the
  CLI builds against the JAX CLI's;
* the parity flags: ``--nthreads`` and ``--net-turbo`` accepted and
  ignored, ``--gpu-index`` / ``--gpu-segments`` refused naming the flag and
  ``--device``, the ``worker`` mode explained.

Tolerances: `TOL` (atol and rtol 1e-5) for f32 outputs (the same values,
summed in another order); a bf16 decode output within one bf16 rounding
step (`TOL_BF16`) of the kernel's, both rounding the same f32 value.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import cli as jcli
from dllama_tpu.ops import flash_attention as JF
from dllama_tpu.ops.flash_attention import paged_flash_decode as jpaged_decode
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch import cli
from dllama_tpu_torch.ops import flash_attention as TF
from dllama_tpu_torch.ops import launch_counts
from dllama_tpu_torch.runtime.engine import DEFAULT_PREFILL_BUCKETS, InferenceEngine

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_graphs import ReplayingGraphs

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_BF16 = dict(atol=1e-5, rtol=2.0**-7)
CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
PROMPT = [2 + (i * 7) % 250 for i in range(23)]
# (q's type, the cache's type): every pair but equal types
PAIRS = [("f32", "bf16"), ("f32", "f16"), ("bf16", "f16"), ("bf16", "f32")]
T_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
J_TYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, name):
    """The same values in type ``name`` for the port and for JAX."""
    t = torch.from_numpy(x).to(T_TYPES[name])
    return t, jnp.asarray(t.float().numpy()).astype(J_TYPES[name])


# -- the plain versions against the TPU kernels in interpret mode -----------


@pytest.mark.parametrize("qn,kn", PAIRS)
@pytest.mark.parametrize("q_pos0", [[0, 9], [16, -16]])
def test_mixed_stats_match_interpret_kernel(qn, kn, q_pos0):
    q, k, v = _arrays(3, (2, 16, 4, 16), (2, 2, 32, 16), (2, 2, 32, 16))
    (qt, qj), (kt, kj), (vt, vj) = _both(q, qn), _both(k, kn), _both(v, kn)
    got = TF.flash_attention_stats(qt, kt, vt, q_pos0)
    want = JF.flash_attention_stats(qj, kj, vj, jnp.asarray(q_pos0, jnp.int32), jnp.int32(0),
                                    block_t=8, block_s=8, interpret=True)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("qn,kn", PAIRS)
def test_mixed_decode_matches_interpret_kernel(qn, kn):
    q, k, v = _arrays(5, (3, 1, 8, 16), (3, 2, 32, 16), (3, 2, 32, 16))
    (qt, qj), (kt, kj), (vt, vj) = _both(q, qn), _both(k, kn), _both(v, kn)
    pos = [0, 13, 31]
    got = TF.flash_decode(qt, kt, vt, pos)
    want = JF.flash_decode(qj, kj, vj, jnp.asarray(pos, jnp.int32), block_s=8, interpret=True)
    assert got.dtype == qt.dtype  # the output in q's type, as the TPU kernel casts it
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **(TOL if qn == "f32" else TOL_BF16))


@pytest.mark.parametrize("qn,kn", PAIRS)
def test_mixed_paged_decode_and_stats_match_interpret_kernels(qn, kn):
    rng = np.random.default_rng(11)
    ps, nb, b, kh, g, hd = 4, 6, 3, 2, 4, 16
    k, v = (rng.standard_normal((1 + b * nb, kh, ps, hd)).astype(np.float32) for _ in range(2))
    pt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    pos = np.asarray([-1, ps, nb * ps - 1], np.int32)
    q = rng.standard_normal((b, 1, kh * g, hd)).astype(np.float32)
    (qt, qj), (kt, kj), (vt, vj) = _both(q, qn), _both(k, kn), _both(v, kn)
    got = TF.paged_flash_decode(qt, kt, vt, torch.from_numpy(pt), torch.from_numpy(pos))
    want = jpaged_decode(qj, kj, vj, jnp.asarray(pt), jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **(TOL if qn == "f32" else TOL_BF16))
    assert torch.all(got[0] == 0)  # the parked lane
    # the paged stats against the TPU stats kernel on each lane's gathered rows
    t = 5
    qc = rng.standard_normal((b, t, kh * g, hd)).astype(np.float32)
    (qct, qcj) = _both(qc, qn)
    q_pos0 = np.asarray([ps + 3, -t, 0], np.int32)
    got = TF.paged_flash_attention_stats(qct, kt, vt, torch.from_numpy(pt),
                                         torch.from_numpy(q_pos0))
    kd, vd = (x[pt].transpose(0, 2, 1, 3, 4).reshape(b, kh, nb * ps, hd) for x in (kj, vj))
    want = JF.flash_attention_stats(qcj, kd, vd, jnp.asarray(q_pos0), jnp.int32(0),
                                    block_t=t, block_s=8, interpret=True)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).reshape(a.shape), **TOL)


def test_cpu_mixed_pairs_launch_nothing():
    q, k, v = _arrays(7, (1, 1, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))
    before = launch_counts()
    TF.flash_decode(torch.from_numpy(q), *(torch.from_numpy(x).half() for x in (k, v)), 5)
    TF.flash_attention_stats(torch.from_numpy(q).bfloat16(),
                             *(torch.from_numpy(x) for x in (k, v)), 0)
    assert launch_counts() == before


# -- the engine with a float cache unlike its dtype ---------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine_options")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, cfg=CFG)
    make_tiny_tokenizer(tp_, pad_to=CFG["vocab_size"])
    return mp, tp_


def _engine(mp, kv, **kw):
    return InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu",
                           kv_dtype=kv, **kw)


def _jengine(mp, kv, **kw):
    return JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, kv_dtype=kv, **kw)


@pytest.mark.parametrize("kv", ["bf16", "f16"])
def test_f32_engine_mixed_kv_slab_matches_jax(files, kv):
    mp, _ = files
    eng, jeng = _engine(mp, kv), _jengine(mp, kv)
    assert eng.cache["k"].dtype == T_TYPES[kv] and eng.kv_dtype != eng.dtype
    for block in (8, 1):
        eng.reset()
        jeng.reset()
        want = jeng.generate(PROMPT, max_steps=48, block_size=block)[0]
        assert eng.generate(PROMPT, max_steps=48, block_size=block)[0] == want
    nll, ppl, n = eng.perplexity(PROMPT)
    jnll, jppl, jn = jeng.perplexity(PROMPT)
    assert n == jn
    np.testing.assert_allclose([nll, ppl], [jnll, jppl], **TOL)
    # a cache of another type is another stream: bf16 rows differ from f32 ones
    f32 = _engine(mp, None).perplexity(PROMPT)[0]
    assert f32 != nll


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "f16"])
def test_f32_engine_mixed_kv_lanes_match_jax(files, kv, native):
    mp, _ = files
    prompts = [PROMPT, PROMPT[:9], [5, 9, 13]]
    eng, jeng = _engine(mp, kv, batch_size=3), _jengine(mp, kv, batch_size=3)
    if native:  # each lane on its private pages (generate_batch's), in the cache's type
        eng.init_kv_pool(4, n_pages=3 * 16 + 1, native=True)
        assert eng.kv_pool["k"].dtype == T_TYPES[kv]
    got = eng.generate_batch(prompts, max_steps=40, block_size=4)
    assert got == jeng.generate_batch(prompts, max_steps=40, block_size=4)  # JAX slab lanes
    if not native:
        assert eng.lane_cache["k"].dtype == T_TYPES[kv]
    # each lane's stream equals the single-stream engine's with the same cache type
    solo = _engine(mp, kv)
    for p, lane in zip(prompts, got):
        solo.reset()
        assert solo.generate(p, max_steps=40)[0] == lane


def test_bf16_engine_with_f16_and_f32_caches(files):
    """A bf16 engine keeps a cache of f16 or f32, as the JAX engine does;
    its rows are written in the cache's type."""
    mp, _ = files
    for kv, want in (("f16", torch.float16), ("f32", torch.float32), (None, torch.bfloat16)):
        e = InferenceEngine(mp, dtype=torch.bfloat16, temperature=0.0, device="cpu", kv_dtype=kv)
        assert e.kv_dtype == want and e.cache["k"].dtype == want
        out = e.generate(PROMPT[:7], max_steps=16)[0]
        assert len(out) == 16 - 6 and e.cache["k"][:, 0, :, :6].abs().sum() > 0


def test_replayed_mixed_kv_engine_equals_eager(files):
    mp, _ = files
    eager, graphed = _engine(mp, "bf16", batch_size=2), _engine(mp, "bf16", batch_size=2)
    graphed.graphs = ReplayingGraphs()
    for block in (8, 1):
        for e in (eager, graphed):
            e.reset()
        want = eager.generate(PROMPT, max_steps=40, block_size=block)[0]
        assert graphed.generate(PROMPT, max_steps=40, block_size=block)[0] == want
    prompts = [PROMPT, [4, 5, 6]]
    assert graphed.generate_batch(prompts, 30) == eager.generate_batch(prompts, 30)
    assert graphed.graphs.replays > 0


def test_kv_dtype_name_validation(files):
    mp, _ = files
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(mp, kv_dtype="int4", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        JEngine(mp, kv_dtype="int4", dtype=jnp.float32)
    for name in ("f32", "f16", "bf16", "int8"):
        e = InferenceEngine(mp, kv_dtype=name, dtype=torch.float32, device="cpu")
        assert e.kv_dtype == {"f32": torch.float32, "f16": torch.float16,
                              "bf16": torch.bfloat16, "int8": torch.int8}[name]


# -- prefill buckets and --nbatches -----------------------------------------------


def _parse(parser_fn, argv):
    p = argparse.ArgumentParser()
    parser_fn(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv,want", [([], 32), (["--nbatches", "8"], 8),
                                       (["--n-batches", "128"], 128), (["--nbatches", "1"], 1)])
def test_nbatches_buckets_match_jax_cli(files, argv, want):
    mp, tp_ = files
    base = ["--model", mp, "--tokenizer", tp_]
    args = cli._build_parser().parse_args(["inference"] + base + argv + ["--device", "cpu",
                                                                         "--dtype", "f32"])
    jargs = jcli._build_parser().parse_args(["inference"] + base + argv)
    assert args.nbatches == jargs.nbatches == want
    buckets = tuple(sorted({1, jargs.nbatches, 512}))
    eng, _ = cli.load_engine(args)
    assert eng.prefill_buckets == JEngine(mp, tp=1, dtype=jnp.float32,
                                          prefill_buckets=buckets).prefill_buckets
    # the filter keeps buckets that fit the model's 64 rows, as the JAX engine's does
    assert eng.prefill_buckets == tuple(b for b in buckets if b <= CFG["seq_len"])


def test_default_buckets_and_chunking_match_jax(files):
    mp, _ = files
    assert DEFAULT_PREFILL_BUCKETS == (1, 8, 32, 128, 512)
    for buckets in ((8, 32), (8,), (32, 1)):
        eng = _engine(mp, None, prefill_buckets=buckets)
        jeng = _jengine(mp, None, prefill_buckets=buckets)
        assert eng.prefill_buckets == jeng.prefill_buckets
        assert ([eng._bucket_for(n, p) for n in (1, 7, 9, 40) for p in (0, 30, 60)]
                == [jeng._bucket_for(n, p) for n in (1, 7, 9, 40) for p in (0, 30, 60)])
        want = jeng.generate(PROMPT, max_steps=50)[0]
        assert eng.generate(PROMPT, max_steps=50)[0] == want


# -- the parity flags -------------------------------------------------------------


def _cli_args(files, *extra):
    mp, tp_ = files
    return ["inference", "--model", mp, "--tokenizer", tp_, "--prompt", "hello",
            "--steps", "12", "--temperature", "0", "--device", "cpu", "--dtype", "f32",
            *extra]


def test_cli_accepts_and_ignores_nthreads_and_net_turbo(files, capsys):
    base = cli.main(_cli_args(files))["tokens"]
    got = cli.main(_cli_args(files, "--nthreads", "4", "--net-turbo", "0"))["tokens"]
    assert got == base
    jargs = jcli._build_parser().parse_args(["inference", "--nthreads", "4", "--net-turbo", "0"])
    assert (jargs.nthreads, jargs.net_turbo) == (4, 0)


@pytest.mark.parametrize("flag", [["--gpu-index", "0"], ["--gpu-segments", "0:1"]])
def test_cli_rejects_gpu_flags(files, flag):
    with pytest.raises(SystemExit) as e:
        cli.main(_cli_args(files, *flag))
    msg = str(e.value)
    assert flag[0] in msg and "--device" in msg and e.value.code != 0
    with pytest.raises(SystemExit) as je:  # the JAX CLI refuses it too, naming the TPU
        jcli._resolve_tp(jcli._build_parser().parse_args(["inference"] + flag))
    assert "TPU" in str(je.value)


def test_cli_worker_mode_explains():
    with pytest.raises(SystemExit) as e:
        cli.main(["worker"])
    assert "SPMD" in str(e.value) and e.value.code != 0
    with pytest.raises(SystemExit) as je:
        jcli.main(["worker"])
    assert "SPMD" in str(je.value)
