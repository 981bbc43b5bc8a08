"""Serving under tensor and sequence parallelism on CPU: rank 0 controls, the
other ranks follow (parallel/control.py), against the JAX servers.

One module-scoped world of 2 gloo ranks and one of 4 run their server
jobs in turn (parallel/launch.serve_target: every rank builds the engine,
rank 0 serves the job's requests on a localhost port and the other ranks
follow until it stops). f32 throughout, greedy; the answers are compared
byte for byte:

* pool-native lanes at tp 2, and the serialized batch-1 server at tp 2,
  against the JAX lane and batch-1 servers at tp 2 on the 8 host devices;
* slab lanes at sp 2 and at tp 2 x sp 2 against the JAX slab server at
  tp 1: the JAX engine's slab copies under sp move its cyclic rows as if
  they were in sequence order (tests/test_torch_parallel_lanes.py), and
  every request here adopts the chat template's published prefix;
* n-gram speculation at tp 2, shared speculation at sp 2 and the draft
  model at tp 2 against the JAX server with speculation off (an int8 pool
  at tp 2 is held to the JAX engine in tests/test_torch_parallel_lanes.py);
* a decode poison at tp 2: every answer equals the fault-free one and
  every rank's ``cache_epoch`` moved once;
* on every rank the control plane's digest of the tokens every mirrored
  call returned is rank 0's, over the same number of commands.

Then the launches: a world whose process-group and control timeouts are 5 s
stays idle for 8 s between two rounds (the heartbeat keeps the followers);
the server's own command line at --tp 2 (this process group's rank 0 in a
subprocess) answers, reports tp, sp and the backend, and drains on
``POST /v1/drain`` (and at --sp 2 on SIGTERM) with every rank exiting 0; a
follower that raises ends the server with that rank's traceback (``chat``
under --tp 2 is held to the JAX ``run_chat`` in
tests/test_torch_parallel_lanes.py).
"""

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import pytest

from dllama_tpu.formats import FloatType
from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.parallel.launch import ask_all, jobs_target, spawn

from helpers import REPO_ROOT, make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
REQUESTS = [{"messages": [{"role": "user", "content": f"request {i}: " + "hello world " * i}],
             "max_tokens": 12, "temperature": 0} for i in range(5)]
SPAWN = dict(timeout_s=300, pg_timeout_s=60)
POISON = "dispatch:op=decode_lanes:nth=2:kind=poison"
LIMIT = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_server")
    out = {"model": str(d / "model.m")}
    make_tiny_model(out["model"], weight_type=FloatType.F32, cfg=CFG)
    out["tok"] = str(d / "t.t")
    make_tiny_tokenizer(out["tok"], chat_template="<|start_header_id|>", pad_to=288)
    return out


def _job(files, tp, sp, batch_size=4, **serve):
    return ("serve", dict(model=files["model"], tokenizer=files["tok"], tp=tp, sp=sp,
                          batch_size=batch_size, requests=REQUESTS, serve=serve,
                          kv_dtype=serve.pop("kv_dtype", None)))


def _world2_jobs(files):
    return [
        _job(files, 2, 1, kv_native=True),
        _job(files, 1, 2, kv_native=False),
        _job(files, 2, 1, batch_size=1),
        _job(files, 2, 1, kv_native=True, faults=POISON),
        _job(files, 2, 1, kv_native=True, speculation="ngram"),
        _job(files, 1, 2, kv_native=False, speculation="shared"),
        _job(files, 2, 1, kv_native=False, speculation="draft", draft_model=files["model"]),
    ]


@pytest.fixture(scope="module")
def world2(files):
    return spawn(jobs_target, 2, "cpu", args=(_world2_jobs(files),), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    return spawn(jobs_target, 4, "cpu", args=([_job(files, 2, 2, kv_native=False)],), **SPAWN)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _jax_answers(files, tp, batch_size, **kw):
    tok = JTokenizer(files["tok"])
    eng = JEngine(files["model"], tokenizer=tok, tp=tp, dtype=jnp.float32, temperature=0.0,
                  batch_size=batch_size)
    srv = japi.serve(eng, tok, host="127.0.0.1", port=0, **kw)
    try:
        return ask_all(_start(srv), REQUESTS)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def truth(files):
    """The JAX servers' answers: native lanes and batch 1 at tp 2, slab
    lanes at tp 1."""
    return {"native": _jax_answers(files, 2, 4, kv_native=True),
            "single": _jax_answers(files, 2, 1),
            "slab": _jax_answers(files, 1, 4, kv_native=False)}


def _ranks(results, i):
    """Job i's results on every rank, after the control plane's check: each
    follower ran rank 0's commands and returned the same tokens."""
    jobs = [r[i] for r in results]
    for other in jobs[1:]:
        assert other["summary"] == jobs[0]["summary"]
        assert other["cache_epoch"] == jobs[0]["cache_epoch"]
    assert jobs[0]["summary"]["commands"] > 0 and jobs[0]["summary"]["returns"] > 0
    return jobs


# (world, job index, the truth its answers equal, the cache epoch it ends at)
CASES = {
    "native-tp2": (2, 0, "native", 0),
    "slab-sp2": (2, 1, "slab", 0),
    "single-tp2": (2, 2, "single", 0),
    "poison-tp2": (2, 3, "native", 1),
    "ngram-tp2": (2, 4, "native", 0),
    "shared-sp2": (2, 5, "slab", 0),
    "draft-tp2": (2, 6, "slab", 0),
    "slab-tp2sp2": (4, 0, "slab", 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_server_answers_match_jax(world2, world4, truth, case):
    world, i, want, epoch = CASES[case]
    jobs = _ranks(world2 if world == 2 else world4, i)
    answers = jobs[0]["answers"][0]
    assert all(isinstance(a, str) for a in answers), answers
    assert answers == truth[want]
    assert [j["cache_epoch"] for j in jobs] == [epoch] * world
    health = jobs[0]["health"]
    tp, sp = (2, 2) if world == 4 else (1, 2) if "sp2" in case else (2, 1)
    assert health["parallel"] == {"tp": tp, "sp": sp, "backend": "gloo", "ranks": world}
    if jobs[0]["pool_shape"] is not None:  # every rank holds its KV heads of every page
        assert all(j["pool_shape"][2] == 4 // tp for j in jobs)
        assert len({j["page_bytes"] for j in jobs}) == 1


def test_heartbeat_outlives_the_timeouts(files):
    """Process-group and control timeouts of 5 s, and 8 s of silence
    between two rounds: the heartbeats keep the followers in their receive,
    and the second round's answers equal the first's."""
    job = _job(files, 2, 1, batch_size=2, kv_native=False)[1]
    job.update(rounds=2, idle_s=8.0, control_timeout_s=5.0, requests=REQUESTS[:2])
    res = spawn(jobs_target, 2, "cpu", args=([("serve", job)],), timeout_s=300, pg_timeout_s=5)
    first, second = res[0][0]["answers"]
    assert first == second and all(isinstance(a, str) for a in first)
    assert res[1][0]["summary"] == res[0][0]["summary"]


# -- the server's and the chat's own launch ----------------------------------------


def _launch(args, **kw):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT, **kw)


def _server_url(proc) -> tuple[str, str]:
    """Read the server's stdout until its URL line: (the URL, what it read)."""
    deadline = time.monotonic() + LIMIT
    lines = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("Server URL: "):
            url = line.split("Server URL: ", 1)[1].strip().rstrip("/").rsplit("/v1", 1)[0]
            return url, "".join(lines)
    proc.kill()
    raise AssertionError("no server URL:\n" + "".join(lines) + proc.stderr.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=LIMIT) as r:
        return json.loads(r.read())


def _server_args(files, *extra):
    return ["-m", "dllama_tpu_torch.runtime.api_server", "--model", files["model"],
            "--tokenizer", files["tok"], "--dtype", "f32", "--temperature", "0", "--host",
            "127.0.0.1", "--port", "0", "--batch-size", "4", "--device", "cpu", *extra]


@pytest.mark.parametrize("mesh,stop", [("--tp", "drain"), ("--sp", "sigterm")])
def test_server_main_serves_and_drains(files, truth, mesh, stop):
    native = "1" if mesh == "--tp" else "0"
    proc = _launch(_server_args(files, mesh, "2", "--kv-native", native))
    try:
        url, head = _server_url(proc)
        assert ask_all(url, REQUESTS) == truth["native" if mesh == "--tp" else "slab"]
        health = _get(url, "/v1/health")
        assert health["parallel"] == {"tp": 2 if mesh == "--tp" else 1,
                                      "sp": 2 if mesh == "--sp" else 1,
                                      "backend": "gloo", "ranks": 2}
        memory = _get(url, "/v1/debug/memory")
        assert memory["rank"]["rank"] == 0 and "rank 0's own bytes" in memory["rank"]["note"]
        if stop == "drain":
            req = urllib.request.Request(url + "/v1/drain", data=b"", method="POST")
            urllib.request.urlopen(req, timeout=LIMIT).read()
        else:
            proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=LIMIT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    assert "🔗 Ranks: 2" in head and "backend gloo" in head
    assert "💡 Tp: " in head and "💡 Sp: " in head


FAILING_FOLLOWER = """
import sys
sys.path.insert(0, {root!r})
from dllama_tpu_torch.parallel.launch import follower_target, lead
from dllama_tpu_torch.runtime import api_server

good, bad = {good!r}, {bad!r}
if __name__ == "__main__":
    lead(lambda w, *_: api_server._serve_main(api_server.build_parser().parse_args(good)),
         follower_target, 2, "cpu", args=("server", bad))
"""


def test_failed_follower_ends_the_server(files, tmp_path):
    """The follower's engine holds 64 positions where rank 0's holds 384:
    its pool is smaller, so the first request's page table names pages it
    does not have, the follower raises, and the launch ends with its
    traceback and exit code 1."""
    good = _server_args(files, "--tp", "2", "--kv-native", "1")[2:]
    bad = good + ["--max-seq-len", "64"]
    script = tmp_path / "failing.py"
    script.write_text(FAILING_FOLLOWER.format(root=REPO_ROOT, good=good, bad=bad))
    proc = _launch([str(script)])

    def ask_the_dying_server():
        try:
            ask_all(url, REQUESTS[:1], concurrent=False)
        except OSError:
            pass  # the launch ends under it

    try:
        url, _ = _server_url(proc)
        threading.Thread(target=ask_the_dying_server, daemon=True).start()
        out, err = proc.communicate(timeout=LIMIT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 1
    assert "rank 1 of 2 failed" in err and "ValueError" in err, err[-4000:]
