"""Lanes, the KV pool, verify and the draft model under tensor and sequence
parallelism on CPU, against the JAX engine at the same mesh.

The port's ranks are processes over gloo (parallel/launch.py); each world
size is spawned once for the module (`world2`, `world4`) and runs its lane
jobs in turn (`lane_target`: every rank makes the same engine calls). The
JAX engine runs the same calls on the 8 host devices tests/conftest.py
sets. Each script is a list of engine calls whose token returns are
compared: greedy streams, verify grids and draft proposals must be equal
to the JAX engine's at the same mesh, to the port's one-rank engine, and
on every rank (f32 throughout). The cases:

* ``generate_batch`` at tp 2 x sp 2 with two lanes of different lengths
  (tests/test_parallel.py's ``test_lanes_with_sp_mesh``);
* pool-native lanes at tp 2: page tables, a shared prefix of two whole
  pages and a copy-on-write fork of the page it parts in, two lanes
  decoding at their own positions, then a verify pass with a parked lane
  (the same with an int8 pool);
* slab lanes at sp 2 (and at tp 2 x sp 2): a publish of a lane's rows into
  pool pages (gathered over the sequence shards), an adopt of them into
  another lane (each shard takes the rows it owns), decode blocks with a
  parked lane, a verify pass with a parked lane. The JAX engine's own slab
  copies under sp read and write its cyclic rows as if they were in
  sequence order, so its streams part from its sp = 1 streams after an
  adopt; a script with copies is held to the JAX engine at sp 1, and the
  same lanes with no copies to the JAX engine at sp 2;
* q40i4 and q40i8 lanes at tp 2;
* the draft model at tp 2 (catch-up chunks and a greedy proposal);
* ``chat --tp 2`` on stdin (its own process rank 0, the other rank
  following its dispatches, parallel/control.py) prints what the JAX
  ``run_chat`` prints at tp 2, from the chat banner on.
"""

import io
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import cli as jcli
from dllama_tpu.formats import FloatType
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch.parallel.launch import jobs_target, spawn
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import REPO_ROOT, make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
CFG_Q = dict(CFG, dim=128, hidden_dim=256)  # q40 under tp 2: dims of 32 * tp
SPAWN = dict(timeout_s=300, pg_timeout_s=60)
P0 = list(range(3, 23))  # 20 tokens
P1 = P0[:18] + [50, 51, 52, 53]  # parts from P0 mid-way through its third page
PROMPTS = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4]]  # tests/test_parallel.py's


def native_script():
    """Two native lanes on pages of 8 rows: lane 1 shares lane 0's first
    two pages, forks the third (18 tokens in common), then both decode and
    verify with a third lane parked."""
    lane0 = list(range(1, 9))
    lane1 = [1, 2, 9, 10, 11, 12, 13, 14]
    return [
        ("init_kv_pool", (8, 0, True)),
        ("adopt_pages", (0, lane0)),
        ("prefill_lane", (0, P0)),
        ("decode_lanes", ([P0[-1], 0, 0], [19, 0, 0], 4, [True, False, False])),
        ("adopt_pages", (1, lane1)),
        ("kv_page_copy", ([3], [9])),
        ("prefill_lane", (1, P1[18:], 18)),
        ("decode_lanes", ([7, P1[-1], 0], [23, 21, 0], 6, [True, True, False])),
        ("verify_lanes", ([[5, 6, 7], [8, 9, 10], [0, 0, 0]], [29, 27, 0],
                          [True, True, False])),
        ("decode_lanes", ([11, 12, 0], [32, 30, 0], 3, [True, True, False])),
    ]


def slab_script():
    """Three slab lanes: lane 0 prefills and decodes, publishes its first
    two pages; lane 1 adopts them and prefills its own tail; both decode
    with lane 2 parked, then verify with lane 2 parked (a width of 4: the
    JAX engine under sp splits a verify row's queries over sp)."""
    return [
        ("init_kv_pool", (8, 0, False)),
        ("prefill_lane", (0, P0)),
        ("decode_lanes", ([P0[-1], 0, 0], [19, 0, 0], 4, [True, False, False])),
        ("kv_publish", (0, [1, 2], 0)),
        ("kv_adopt", (1, [1, 2])),
        ("prefill_lane", (1, P1[16:], 16)),
        ("decode_lanes", ([7, P1[-1], 0], [23, 21, 0], 6, [True, True, False])),
        ("verify_lanes", ([[5, 6, 7, 8], [8, 9, 10, 11], [0, 0, 0, 0]], [29, 27, 0],
                          [True, True, False])),
        ("decode_lanes", ([11, 12, 0], [33, 31, 0], 3, [True, True, False])),
    ]


def slab_verify_script():
    """Slab lanes with no copies: two prompts, decode blocks and a verify
    pass (width 4), lane 2 parked throughout."""
    return [
        ("prefill_lane", (0, P0)),
        ("prefill_lane", (1, P1)),
        ("decode_lanes", ([P0[-1], P1[-1], 0], [19, 21, 0], 4, [True, True, False])),
        ("verify_lanes", ([[5, 6, 7, 8], [8, 9, 10, 11], [0, 0, 0, 0]], [23, 25, 0],
                          [True, True, False])),
        ("decode_lanes", ([11, 12, 0], [27, 29, 0], 3, [True, True, False])),
    ]


def draft_script(draft):
    return [
        ("init_draft_model", (draft,)),
        ("draft_prefill", (0, P0[:-1], 0)),
        ("draft_prefill", (1, P1[:-1], 0)),
        ("draft_propose", ([P0[-1], P1[-1]], [19, 21], [True, True], 4)),
        ("draft_prefill", (0, [9, 9], 19)),
        ("draft_propose", ([7, P1[-1]], [21, 21], [True, False], 3)),
    ]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_lanes")
    out = {"dense": str(d / "dense.m"), "q40": str(d / "q40.m"), "chat": str(d / "chat.m"),
           "tok": str(d / "t.t")}
    make_tiny_model(out["dense"], weight_type=FloatType.F32, cfg=CFG)
    make_tiny_model(out["q40"], cfg=CFG_Q)
    make_tiny_model(out["chat"], weight_type=FloatType.F32, cfg=dict(CFG, seq_len=128))
    make_tiny_tokenizer(out["tok"], chat_template="<|start_header_id|>", pad_to=288)
    return out


def _job(model, tp, sp, script, **kw):
    return ("lanes", dict(model=model, tp=tp, sp=sp, script=script, **kw))


# (name, tp, sp, job arguments past the model and mesh); the scripts above
def _cases(files):
    dense, q40 = files["dense"], files["q40"]
    gen = [("generate_batch", (PROMPTS, 16))]
    return {
        2: [
            ("native-tp2", dense, 2, 1, native_script(), dict(batch_size=3)),
            ("native-int8-tp2", dense, 2, 1, native_script(), dict(batch_size=3,
                                                                     kv_dtype="int8")),
            ("slab-sp2", dense, 1, 2, slab_script(), dict(batch_size=3)),
            ("slab-verify-sp2", dense, 1, 2, slab_verify_script(), dict(batch_size=3)),
            ("slab-tp2", dense, 2, 1, slab_script(), dict(batch_size=3)),
            ("q40i4-tp2", q40, 2, 1, gen, dict(batch_size=2, weight_format="q40i4")),
            ("q40i8-tp2", q40, 2, 1, gen, dict(batch_size=2, weight_format="q40i8")),
            ("draft-tp2", dense, 2, 1, draft_script(dense), dict(batch_size=2)),
        ],
        4: [
            ("batch-tp2sp2", dense, 2, 2, gen, dict(batch_size=2)),
            ("slab-tp2sp2", dense, 2, 2, slab_script(), dict(batch_size=3)),
        ],
    }


@pytest.fixture(scope="module")
def world2(files):
    jobs = [_job(m, tp, sp, sc, **kw) for _, m, tp, sp, sc, kw in _cases(files)[2]]
    return spawn(jobs_target, 2, "cpu", args=(jobs,), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    jobs = [_job(m, tp, sp, sc, **kw) for _, m, tp, sp, sc, kw in _cases(files)[4]]
    return spawn(jobs_target, 4, "cpu", args=(jobs,), **SPAWN)


def _plain(x):
    """Token returns as plain Python data (the JAX engine's ints are numpy)."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.integer, int)):
        return int(x)
    return None


def _run_script(eng, script):
    out = []
    for name, args in script:
        ret = getattr(eng, name)(*args)
        out.append(_plain(ret) if isinstance(ret, (list, int, np.integer)) else None)
    return out


def _jax_script(model, tp, sp, script, batch_size, weight_format="dense", kv_dtype=None):
    eng = JEngine(model, tp=tp, sp=sp, dtype=jnp.float32, temperature=0.0,
                  batch_size=batch_size, weight_format=weight_format, kv_dtype=kv_dtype)
    return _run_script(eng, script)


def _port_script(model, script, batch_size, weight_format="dense", kv_dtype=None):
    eng = InferenceEngine(model, dtype=torch.float32, temperature=0.0, device="cpu",
                          batch_size=batch_size, weight_format=weight_format, kv_dtype=kv_dtype)
    return _run_script(eng, script)


def _same_on_every_rank(results, i):
    first = results[0][i]
    for other in results[1:]:
        assert other[i]["script"] == first["script"]
        assert other[i]["cache_epoch"] == first["cache_epoch"]
    return first


CASES = [(2, i, c[0]) for i, c in enumerate(_cases({"dense": "", "q40": ""})[2])] + \
        [(4, i, c[0]) for i, c in enumerate(_cases({"dense": "", "q40": ""})[4])]


@pytest.mark.parametrize("world,i,name", CASES, ids=[c[2] for c in CASES])
def test_lanes_match_jax_and_one_rank(files, world2, world4, world, i, name):
    _, model, tp, sp, script, kw = _cases(files)[world][i]
    res = _same_on_every_rank(world2 if world == 2 else world4, i)
    assert not any(isinstance(r, tuple) and r and r[0] == "error" for r in res["script"]), res
    got = [r for r in res["script"]]
    # the JAX engine's slab copies under sp move slab rows in their cyclic
    # order as if it were the sequence order (its own stream parts from its
    # sp = 1 stream after an adopt): a script with copies is held to the JAX
    # engine at sp 1 (ROADMAP C)
    copies = any(name in ("kv_adopt", "kv_publish") for name, _ in script)
    want_jax = _jax_script(model, tp, 1 if copies else sp, script, **kw)
    assert got == want_jax
    assert got == _port_script(model, script, **kw)
    if res["lane_shape"] is not None:  # [L, B, KH/tp, (S + pad)/sp, hd], pad 32
        assert res["lane_shape"] == [2, kw["batch_size"], 4 // tp, (64 + 32) // sp, 16]
    if res["pool_shape"] is not None:  # [L, P, KH/tp, ps, hd], whole over sp
        assert res["pool_shape"][2:] == [4 // tp, 8, 16]


def test_chat_tp2_matches_jax_run_chat(files, monkeypatch, capsys):
    turns = "hello there\nand one more thing\n"
    argv = ["chat", "--model", files["chat"], "--tokenizer", files["tok"], "--temperature", "0",
            "--dtype", "f32", "--weight-format", "dense", "--chat-template", "llama3", "--tp", "2"]
    monkeypatch.setattr("sys.stdin", io.StringIO(turns))
    jcli.run_chat(jcli._build_parser().parse_args(argv))
    want = capsys.readouterr().out
    want = want[want.index("💬 Chat mode"):]
    proc = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv, "--device", "cpu"],
                          input=turns, capture_output=True, text=True, timeout=300,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = proc.stdout[proc.stdout.index("💬 Chat mode"):]
    assert got == want
    assert got.count("👱 You: ") == 2 and "🤖 Assistant: " in got
