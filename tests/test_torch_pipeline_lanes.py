"""Lanes, the KV pool, the server, the chat and the CLI under pipeline stages
and dp lane shards on CPU, against the JAX package at the same mesh.

The port's ranks are processes over gloo (parallel/launch.py); one world
of 2 ranks and one of 4 are spawned for the module and run their jobs in
turn (`lane_target`: every rank makes the same engine calls; `serve_target`:
rank 0 serves and controls, the other ranks follow, parallel/control.py).
The JAX engine and servers run on the 8 host devices tests/conftest.py
sets. f32 and greedy throughout; token returns and answers must be equal:

* lane scripts on 4 lanes, so that dp 2 puts lanes 0-1 on group 0 and 2-3
  on group 1: pool-native lanes at dp 2 (and dp 2 x tp 2) where lane 2
  reads two whole pages lane 0 wrote on the other group and a
  copy-on-write fork of the page they part in, then decodes and verifies;
  slab lanes at dp 2, pp 2, pp 2 x dp 2 and pp 2 x sp 2 where lane 0
  publishes its first pages and lane 2 adopts them, then decode blocks and
  a verify pass with parked lanes. Each against the JAX engine at the same
  mesh (at sp 1 for pp 2 x sp 2: the JAX slab copies under sp, ROADMAP C)
  and the port's one-rank engine, and equal on every rank;
* servers: slab lanes at pp 2, pool-native lanes at dp 2, the serialized
  batch-1 server at pp 2 and slab lanes at pp 2 x dp 2, each answer equal
  to the JAX server's at the same mesh, every rank's control digest equal
  (each rank's commands are rank 0's, whatever its stage or dp group);
* ``chat --pp 2`` on stdin against the JAX ``run_chat`` at pp 2, from the
  chat banner on;
* ``inference --pp 2 --dp 2 --batch-size 2``: its Eval/Pred lines (the
  Sent/Recv columns with the pipeline's hand-offs) and text against the
  JAX CLI's, and the ranks and the ``Dp``/``Pp`` banner lines.
"""

import io
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import cli as jcli
from dllama_tpu.formats import FloatType
from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.parallel.launch import ask_all, jobs_target, spawn
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import REPO_ROOT, make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=4, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
SPAWN = dict(timeout_s=400, pg_timeout_s=60)
P0 = list(range(3, 23))  # 20 tokens
P1 = P0[:18] + [50, 51, 52, 53]  # parts from P0 mid-way through its third page
REQUESTS = [{"messages": [{"role": "user", "content": f"request {i}: " + "hello world " * i}],
             "max_tokens": 10, "temperature": 0} for i in range(4)]


def _on(*lanes):
    return [i in lanes for i in range(4)]


def native_dp_script():
    """Pool-native lanes on pages of 8 rows: lane 0 (dp group 0) prefills
    and decodes; lane 2 (group 1) adopts lane 0's first two pages and a
    copy of its third (18 tokens in common), prefills its tail; both
    decode and verify, lanes 1 and 3 parked."""
    lane0 = list(range(1, 9))
    lane2 = [1, 2, 9, 10, 11, 12, 13, 14]
    return [
        ("init_kv_pool", (8, 0, True)),
        ("adopt_pages", (0, lane0)),
        ("prefill_lane", (0, P0)),
        ("decode_lanes", ([P0[-1], 0, 0, 0], [19, 0, 0, 0], 4, _on(0))),
        ("adopt_pages", (2, lane2)),
        ("kv_page_copy", ([3], [9])),
        ("prefill_lane", (2, P1[18:], 18)),
        ("decode_lanes", ([7, 0, P1[-1], 0], [23, 0, 21, 0], 6, _on(0, 2))),
        ("verify_lanes", ([[5, 6, 7], [0] * 3, [8, 9, 10], [0] * 3], [29, 0, 27, 0], _on(0, 2))),
        ("decode_lanes", ([11, 0, 12, 0], [32, 0, 30, 0], 3, _on(0, 2))),
    ]


def slab_dp_script():
    """Slab lanes: lane 0 prefills, decodes and publishes its first two
    pages; lane 2 adopts them and prefills its tail; both decode and verify
    (width 4), lanes 1 and 3 parked."""
    return [
        ("init_kv_pool", (8, 0, False)),
        ("prefill_lane", (0, P0)),
        ("decode_lanes", ([P0[-1], 0, 0, 0], [19, 0, 0, 0], 4, _on(0))),
        ("kv_publish", (0, [1, 2], 0)),
        ("kv_adopt", (2, [1, 2])),
        ("prefill_lane", (2, P1[16:], 16)),
        ("decode_lanes", ([7, 0, P1[-1], 0], [23, 0, 21, 0], 6, _on(0, 2))),
        ("verify_lanes", ([[5, 6, 7, 8], [0] * 4, [8, 9, 10, 11], [0] * 4], [29, 0, 27, 0],
                          _on(0, 2))),
        ("decode_lanes", ([11, 0, 12, 0], [33, 0, 31, 0], 3, _on(0, 2))),
    ]


# (name, mesh, script)
LANES = {
    2: [("native-dp2", dict(dp=2), native_dp_script()),
        ("slab-dp2", dict(dp=2), slab_dp_script()),
        ("slab-pp2", dict(pp=2), slab_dp_script())],
    4: [("slab-pp2dp2", dict(pp=2, dp=2), slab_dp_script()),
        ("native-dp2tp2", dict(dp=2, tp=2), native_dp_script()),
        ("slab-pp2sp2", dict(pp=2, sp=2), slab_dp_script())],
}
# (name, mesh, batch size, serve arguments)
SERVERS = {
    2: [("serve-slab-pp2", dict(pp=2), 4, dict(kv_native=False)),
        ("serve-native-dp2", dict(dp=2), 4, dict(kv_native=True)),
        ("serve-single-pp2", dict(pp=2), 1, {})],
    4: [("serve-slab-pp2dp2", dict(pp=2, dp=2), 4, dict(kv_native=False))],
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline_lanes")
    out = {"model": str(d / "m.m"), "server": str(d / "s.m"), "tok": str(d / "t.t")}
    make_tiny_model(out["model"], weight_type=FloatType.F32, cfg=CFG)
    make_tiny_model(out["server"], weight_type=FloatType.F32, cfg=dict(CFG, seq_len=384))
    make_tiny_tokenizer(out["tok"], chat_template="<|start_header_id|>", pad_to=288)
    return out


def _jobs(files, world):
    jobs = [("lanes", dict(model=files["model"], script=script, batch_size=4, **mesh))
            for _, mesh, script in LANES[world]]
    jobs += [("serve", dict(model=files["server"], tokenizer=files["tok"], batch_size=b,
                            requests=REQUESTS, serve=dict(serve), **mesh))
             for _, mesh, b, serve in SERVERS[world]]
    return jobs


@pytest.fixture(scope="module")
def world2(files):
    return spawn(jobs_target, 2, "cpu", args=(_jobs(files, 2),), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    return spawn(jobs_target, 4, "cpu", args=(_jobs(files, 4),), **SPAWN)


def _plain(x):
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


@pytest.mark.parametrize("world,i", [(w, i) for w in LANES for i in range(len(LANES[w]))],
                         ids=[c[0] for w in LANES for c in LANES[w]])
def test_lanes_match_jax_and_one_rank(files, world2, world4, world, i):
    name, mesh, script = LANES[world][i]
    results = world2 if world == 2 else world4
    got = results[0][i]["script"]
    for r in results:
        assert r[i]["script"] == got and r[i]["cache_epoch"] == 0
    assert not any(isinstance(x, tuple) and x and x[0] == "error" for x in got), got
    # the JAX engine's slab copies under sp move cyclic rows as sequence
    # rows (ROADMAP C, reference-side): a script with copies is held to it
    # at sp 1
    jmesh = dict(mesh, sp=1) if "sp" in mesh else mesh
    jeng = JEngine(files["model"], dtype=jnp.float32, temperature=0.0, batch_size=4, **jmesh)
    assert got == _run_script(jeng, script)
    one = InferenceEngine(files["model"], dtype=torch.float32, temperature=0.0, device="cpu",
                          batch_size=4)
    assert got == _run_script(one, script)
    pp, dp, tp, sp = (mesh.get(k, 1) for k in ("pp", "dp", "tp", "sp"))
    for r in results:
        if r[i]["lane_shape"] is not None:  # [L/pp, B/dp, KH/tp, (S + pad)/sp, hd], pad 32
            assert r[i]["lane_shape"] == [4 // pp, 4 // dp, 4 // tp, (64 + 32) // sp, 16]
        if "native" in name and dp > 1:  # lane 2 read 3 pages lane 0's group wrote
            assert r[i]["kv_cross_dp_pages"] == 3
        # the pool: the stage's layers, every page on every dp group
        assert r[i]["pool_shape"][:3] == [4 // pp, 49 if "native" in name else 17, 4 // tp]


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _jax_answers(files, mesh, batch_size, serve):
    tok = JTokenizer(files["tok"])
    eng = JEngine(files["server"], tokenizer=tok, dtype=jnp.float32, temperature=0.0,
                  batch_size=batch_size, **mesh)
    srv = japi.serve(eng, tok, host="127.0.0.1", port=0, **serve)
    try:
        return ask_all(_start(srv), REQUESTS)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("world,i", [(w, i) for w in SERVERS for i in range(len(SERVERS[w]))],
                         ids=[c[0] for w in SERVERS for c in SERVERS[w]])
def test_servers_match_jax(files, world2, world4, world, i):
    name, mesh, batch_size, serve = SERVERS[world][i]
    results = world2 if world == 2 else world4
    jobs = [r[len(LANES[world]) + i] for r in results]
    first = jobs[0]
    for other in jobs[1:]:
        assert other["summary"] == first["summary"]
        assert other["cache_epoch"] == 0
    assert first["summary"]["commands"] > 0 and first["summary"]["returns"] > 0
    answers = first["answers"][0]
    assert all(isinstance(a, str) for a in answers), answers
    assert answers == _jax_answers(files, mesh, batch_size, serve)
    par = first["health"]["parallel"]
    assert par == {"tp": 1, "sp": 1, "backend": "gloo", "ranks": world,
                   **{k: n for k, n in mesh.items() if n > 1}}
    # every stage of a dp group launches the same kernels: the layers split
    # evenly and every stage computes the logits head
    by_group: dict = {}
    for r in jobs:
        by_group.setdefault(r["dp_group"], []).append(r["launches"])
    for launches in by_group.values():
        assert all(x == launches[0] for x in launches)


def test_chat_pp2_matches_jax_run_chat(files, monkeypatch, capsys):
    turns = "hello there\nand one more thing\n"
    argv = ["chat", "--model", files["server"], "--tokenizer", files["tok"], "--temperature",
            "0", "--dtype", "f32", "--weight-format", "dense", "--chat-template", "llama3",
            "--pp", "2", "--max-seq-len", "128"]
    monkeypatch.setattr("sys.stdin", io.StringIO(turns))
    jcli.run_chat(jcli._build_parser().parse_args(argv))
    want = capsys.readouterr().out
    want = want[want.index("💬 Chat mode"):]
    proc = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv, "--device", "cpu"],
                          input=turns, capture_output=True, text=True, timeout=300,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "(tp=1 x sp=1 x pp=2)" in proc.stdout and "💡 Pp: 2 pipeline stages" in proc.stdout
    got = proc.stdout[proc.stdout.index("💬 Chat mode"):]
    assert got == want
    assert got.count("👱 You: ") == 2 and "🤖 Assistant: " in got


def _cli_summary(out: str) -> dict:
    lines = out.splitlines()
    pred = [l for l in lines if l.startswith("🔶 Pred")]
    ev = [l for l in lines if l.startswith("🔷️ Eval")]
    sent = [re.search(r"Sent\s*(\d+) kB Recv\s*(\d+) kB", l).groups() for l in ev + pred]
    text = "".join(l.split(" | ", 2)[2] for l in pred)
    counts = re.findall(r"^\s+nTokens: (\d+)$", out, re.M)
    return dict(sent=sent, text=text, counts=counts, eval_tokens=ev[0].rsplit("(", 1)[1])


def test_cli_inference_pp2_dp2_matches_jax_cli(files, capsys):
    argv = ["inference", "--model", files["server"], "--tokenizer", files["tok"], "--prompt",
            "hello world", "--steps", "20", "--temperature", "0", "--dtype", "f32", "--pp", "2",
            "--dp", "2", "--batch-size", "2"]
    jcli.run_inference(jcli._build_parser().parse_args(argv + ["--sync-measure", "off"]))
    want = _cli_summary(capsys.readouterr().out)
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv, "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "🔗 Ranks: 4 (tp=1 x sp=1 x dp=2 x pp=2), backend gloo" in r.stdout
    assert "💡 Dp: 2 lane shards" in r.stdout and "💡 Pp: 2 pipeline stages" in r.stdout
    assert _cli_summary(r.stdout) == want
