"""The port's replica fleet (dllama_tpu_torch.fleet) on CPU against the JAX
fleet (dllama_tpu.fleet), f32, over tests/test_fleet.py's tiny model:

* the pure units on seeded inputs against the JAX functions: the affinity
  key, ring ownership under add and remove, the spread, ``plan_route``'s
  spills, the registry's state machine on a fake fetch, both knob
  resolvers, the Prometheus parse, relabel and quantile, the stitching,
  the ledger, and the fleet anomaly rule degrading the router's health;
* the replica side of the contract on the port's lane server against the
  JAX lane server: ``include_tokens`` frames (slab and pool-native lanes,
  with and without the EOS detector's holdback), ``replica`` in health,
  the trace headers adopted and ``trace_adopt`` recorded, ``sse_flush``
  faults scoped by ``op``, replica-tagged spans;
* the live fleet: a module-scoped port fleet beside a module-scoped JAX
  fleet over the same files; each twin of a tests/test_fleet.py live test
  runs the same script through both routers and compares bytes, finish
  reasons, usage, plan targets, metric deltas, ``/v1/fleet`` and health.
  The drain test comes last (a drain is permanent for the fixture);
* the subprocess launcher and the router's ``main``.

The module leaves the process-wide state of both packages as it found it:
the fault planes, the metrics registries (families and values), the flight
recorders and the span trackers (`_process_globals`)."""

import copy
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import http.client
import numpy as np
import pytest

import dllama_tpu.fleet.affinity as jaff
import dllama_tpu.fleet.obs as jfobs
import dllama_tpu.fleet.replicas as jrep
import dllama_tpu.fleet.router as jrouter
import dllama_tpu.obs.metrics as jmetrics
import dllama_tpu.obs.recorder as jrecorder
import dllama_tpu.obs.spans as jspans
import dllama_tpu.runtime.faults as jfaults
import dllama_tpu_torch.fleet.affinity as aff
import dllama_tpu_torch.fleet.obs as fobs
import dllama_tpu_torch.fleet.replicas as rep
import dllama_tpu_torch.fleet.router as router
import dllama_tpu_torch.obs.metrics as pmetrics
import dllama_tpu_torch.obs.recorder as precorder
import dllama_tpu_torch.obs.spans as pspans
import dllama_tpu_torch.runtime.faults as pfaults

from helpers import REPO_ROOT, make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
LIMIT = 180  # seconds any one request, join or wait may take
SIDES = ("jax", "port")


# -- the process-wide state both packages share between test modules -----------


def _registry_state(reg):
    with reg._lock:
        fams = {}
        for name, fam in reg._families.items():
            fams[name] = (fam, {key: (child, {s: copy.copy(getattr(child, s))
                                              for s in child.__slots__ if s != "_family"})
                                for key, child in fam._children.items()})
        return fams, dict(reg._refresh_hooks)


def _restore_registry(reg, state):
    fams, hooks = state
    with reg._lock:
        reg._families.clear()
        for name, (fam, children) in fams.items():
            reg._families[name] = fam
            fam._children.clear()
            for key, (child, slots) in children.items():
                for s, v in slots.items():
                    setattr(child, s, v)
                fam._children[key] = child
        reg._refresh_hooks.clear()
        reg._refresh_hooks.update(hooks)


def _recorder_state(r):
    with r._lock:
        return (list(r._ring), r._seq, dict(r._context_providers), r.enabled, r.postmortem_dir)


def _restore_recorder(r, state):
    ring, seq, providers, enabled, pm_dir = state
    with r._lock:
        r._ring.clear()
        r._ring.extend(ring)
        r._seq = seq
    r._context_providers.clear()
    r._context_providers.update(providers)
    r.enabled, r.postmortem_dir = enabled, pm_dir


def _spans_state(t):
    with t._lock:
        return (list(t._ring), t._total, t._dropped, t.enabled, t._sink_path)


def _restore_spans(t, state):
    ring, total, dropped, enabled, sink = state
    with t._lock:
        t._ring.clear()
        t._ring.extend(ring)
        t._total, t._dropped = total, dropped
    t.enabled, t._sink_path = enabled, sink


PACKAGES = ((jmetrics, jrecorder, jspans, jfaults), (pmetrics, precorder, pspans, pfaults))


@pytest.fixture(scope="module", autouse=True)
def _process_globals():
    """Snapshot, then restore after the module's last test, every
    process-wide singleton the fleets touch in both packages."""
    saved = [(_registry_state(m.get_registry()), _recorder_state(r.get_recorder()),
              _spans_state(s.get_span_tracker()), f._PLANE) for m, r, s, f in PACKAGES]
    yield
    for (m, r, s, f), (reg, rec, spans, plane) in zip(PACKAGES, saved):
        _restore_registry(m.get_registry(), reg)
        _restore_recorder(r.get_recorder(), rec)
        _restore_spans(s.get_span_tracker(), spans)
        f._PLANE = plane


# -- pure units against the JAX functions -------------------------------------


@pytest.mark.parametrize("k", [1, 3, 8, 32, 64])
def test_prefix_key_matches_jax(k):
    rng = np.random.default_rng(k)
    for _ in range(50):
        toks = [int(t) for t in rng.integers(0, 2**31, size=int(rng.integers(1, 80)))]
        assert aff.prefix_affinity_key(toks, k) == jaff.prefix_affinity_key(toks, k)
    # the first k ids only: a tail change keeps the key, a change inside moves it
    toks = list(range(1, k + 6))
    assert aff.prefix_affinity_key(toks + [9, 9], k) == aff.prefix_affinity_key(toks, k)
    assert aff.prefix_affinity_key([0] + toks[1:], k) != aff.prefix_affinity_key(toks, k)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            aff.prefix_affinity_key([1], bad)
        with pytest.raises(ValueError):
            jaff.prefix_affinity_key([1], bad)


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_ring_ownership_matches_jax_under_add_remove(n):
    names = [f"r{i}" for i in range(n)]
    rng = np.random.default_rng(100 + n)
    keys = [aff.prefix_affinity_key([int(t) for t in rng.integers(0, 50000, size=8)])
            for _ in range(1000)]
    ring, jring = aff.HashRing(names), jaff.HashRing(names)

    def orders(r):
        return [r.order(k) for k in keys]

    before = orders(ring)
    assert before == orders(jring)
    assert all(sorted(o) == names for o in before)
    victim = names[n // 2]
    ring.remove(victim)
    jring.remove(victim)
    after = orders(ring)
    assert after == orders(jring)
    # consistent hashing: only the victim's keys move
    for b, a in zip(before, after):
        assert a[0] == (b[0] if b[0] != victim else b[1])
    ring.add(victim)
    jring.add(victim)
    assert orders(ring) == before == orders(jring)
    assert ring.names == jring.names == frozenset(names)
    assert aff.HashRing().order(keys[0]) == jaff.HashRing().order(keys[0]) == []
    with pytest.raises(ValueError):
        aff.HashRing(vnodes=0)


def test_ring_spread_matches_jax():
    ring, jring = aff.HashRing([f"r{i}" for i in range(3)]), jaff.HashRing(
        [f"r{i}" for i in range(3)])
    owners = [ring.order(aff.prefix_affinity_key([i, 2 * i, 3 * i]))[0] for i in range(300)]
    assert owners == [jring.order(jaff.prefix_affinity_key([i, 2 * i, 3 * i]))[0]
                      for i in range(300)]
    counts = {n: owners.count(n) for n in set(owners)}
    assert len(counts) == 3 and all(c > 30 for c in counts.values()), counts


def _views(mod, spec):
    return {name: mod.ReplicaView(name=name, base_url=f"http://x/{name}", state=st,
                                  max_streams=ms, in_flight=inf)
            for name, (st, ms, inf) in spec.items()}


PLAN_CASES = [
    {"r0": ("draining", 0, 0), "r1": ("degraded", 0, 0), "r2": ("healthy", 2, 2),
     "r3": ("healthy", 0, 0)},
    {"r0": ("healthy", 0, 0), "r1": ("healthy", 0, 0), "r2": ("healthy", 0, 0),
     "r3": ("healthy", 0, 0)},
    {"r0": ("degraded", 4, 1), "r1": ("dead", 0, 0), "r2": ("healthy", 4, 4),
     "r3": ("degraded", 0, 0)},
    {"r0": ("dead", 0, 0), "r2": ("draining", 0, 0), "r3": ("dead", 0, 0)},
    {"r0": ("healthy", 3, 3), "r1": ("healthy", 3, 2), "r2": ("degraded", 0, 0),
     "r3": ("draining", 0, 0)},
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_route_matches_jax(case):
    spec = PLAN_CASES[case]
    for order in (["r0", "r1", "r2", "r3"], ["r3", "r2", "r1", "r0"], ["r2", "r0", "r3", "r1"]):
        p = aff.plan_route(order, _views(rep, spec))
        j = jaff.plan_route(order, _views(jrep, spec))
        assert (p.target, p.candidates, p.skipped, p.spill_reason) == (
            j.target, j.candidates, j.skipped, j.spill_reason)
    assert aff.plan_route([], {}).target is None and aff.plan_route([], {}).spill_reason is None


def test_registry_state_machine_matches_jax():
    payloads = {
        "http://a": {"status": "ok", "capacity": {"max_streams": 4, "in_flight": 1, "lanes": 2,
                                                  "parked": 0, "kv_native": True}},
        "http://b": {"status": "degraded", "degraded_reasons": ["watchdog"]},
        "http://c": {"status": "draining"},
    }
    boom = set()

    def fetch(url):
        if url in boom:
            raise OSError("down")
        return payloads[url]

    t = [0.0]
    names = {"a": "http://a", "b": "http://b", "c": "http://c"}
    regs = [m.ReplicaRegistry(names, fetch=fetch, clock=lambda: t[0], fail_threshold=2)
            for m in (jrep, rep)]
    seq0 = [r.recorder.total_recorded for r in regs]

    def both(fn):
        out = [fn(r) for r in regs]
        assert out[0] == out[1], out
        return out[1]

    def views(r):
        return {k: (v.state, v.max_streams, v.in_flight, v.lanes, v.parked, v.kv_native,
                    v.degraded_reasons, v.saturated) for k, v in r.views().items()}

    steps = [
        lambda: None,
        lambda: boom.add("http://a"),
        lambda: None,
        lambda: boom.clear(),
        lambda: payloads["http://a"]["capacity"].update(in_flight=4),
        lambda: boom.update({"http://b", "http://c"}),
        lambda: None,
        lambda: boom.clear(),
    ]
    for i, step in enumerate(steps):
        t[0] = float(i)
        step()
        both(lambda r: r.poll_once())
        both(views)
    assert both(views)["a"][-1] is True  # in_flight 4 of 4: saturated
    both(lambda r: r.mark_dead("a", "connect"))
    assert both(lambda r: r.poll_once())["a"] == rep.HEALTHY
    both(lambda r: r.mark_draining("b"))
    assert both(views)["b"][0] == rep.DRAINING
    assert both(lambda r: r.poll_once())["b"] == rep.DEGRADED
    both(lambda r: r.snapshot())
    assert both(lambda r: (r.names, r.urls(), r.url_of("c")))[2] == "http://c"
    # the same transitions recorded, in order
    both(lambda r: [(e["replica"], e["prev"], e["state"], e["reason"])
                    for e in r.recorder.events("replica_state")
                    if e["seq"] >= seq0[regs.index(r)]])
    with pytest.raises(ValueError):
        rep.ReplicaRegistry({})


KNOB_ENVS = [
    {},
    {"DLLAMA_FLEET_AFFINITY_K": "7", "DLLAMA_FLEET_STALL_S": "9.5"},
    {"DLLAMA_FLEET_FAILOVER_MAX": "-2", "DLLAMA_FLEET_POLL_S": "0.25"},
]


@pytest.mark.parametrize("env", range(len(KNOB_ENVS)))
def test_fleet_knobs_match_jax(env, monkeypatch):
    for k, v in KNOB_ENVS[env].items():
        monkeypatch.setenv(k, v)
    for args in [(), (3, None, 1.0), (None, 5, None, 4.0)]:
        assert router.resolve_fleet_knobs(*args) == jrouter.resolve_fleet_knobs(*args)
    for mod in (router, jrouter):
        with pytest.raises(ValueError):
            mod.resolve_fleet_knobs(affinity_k=0)


OBS_ENVS = [
    {},
    {"DLLAMA_FLEET_OBS_INTERVAL_S": "0.5", "DLLAMA_FLEET_OBS_LEDGER": "64"},
    {"DLLAMA_FLEET_OBS_RETENTION_S": "60"},
]


@pytest.mark.parametrize("env", range(len(OBS_ENVS)))
def test_fleet_obs_knobs_match_jax(env, monkeypatch):
    for k, v in OBS_ENVS[env].items():
        monkeypatch.setenv(k, v)
    for args in [(), (2.0, 60.0), (None, None, 8)]:
        assert fobs.resolve_fleet_obs_knobs(*args) == jfobs.resolve_fleet_obs_knobs(*args)
    for mod in (fobs, jfobs):
        for bad in (dict(interval_s=0.0), dict(ledger_cap=0)):
            with pytest.raises(ValueError):
                mod.resolve_fleet_obs_knobs(**bad)


def _prom_text(seed):
    rng = np.random.default_rng(seed)
    bounds = sorted(set(np.round(rng.uniform(0.001, 0.5, size=6), 4).tolist()))
    cum, lines = 0, ["# HELP dllama_tpot_seconds per-token latency",
                     "# TYPE dllama_tpot_seconds histogram"]
    for b in bounds:
        cum += int(rng.integers(0, 20))
        lines.append(f'dllama_tpot_seconds_bucket{{le="{b}"}} {cum}')
    lines.append(f'dllama_tpot_seconds_bucket{{le="+Inf"}} {cum + int(rng.integers(0, 3))}')
    lines += [
        f'dllama_slo_goodput_tokens_per_s{{window="1m"}} {rng.uniform(0, 100):.3f}',
        f"dllama_lanes_active {int(rng.integers(0, 4))}",
        'dllama_router_requests_total{replica="r0",outcome="ok"} 3',
        'dllama_fleet_replicas{state="healthy"} 2',
        'dllama_http_requests_total{path="/v1/chat/completions"} 5',
        "dllama_bad_value{a=\"b\"} notanumber",
        "garbage line",
        "",
    ]
    return "\n".join(lines)


@pytest.mark.parametrize("seed", range(4))
def test_prom_parse_relabel_quantile_match_jax(seed):
    text = _prom_text(seed)
    series = fobs.parse_prom_text(text)
    assert series == jfobs.parse_prom_text(text)
    assert ("dllama_router_requests_total", {"replica": "r0", "outcome": "ok"}, 3.0) in series
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        assert fobs.histogram_quantile(series, "dllama_tpot_seconds", q) == \
            jfobs.histogram_quantile(series, "dllama_tpot_seconds", q)
    assert fobs.histogram_quantile(series, "dllama_absent", 0.5) is None
    for skip in ((), ("dllama_router_",), ("dllama_router_", "dllama_fleet_")):
        out = fobs.relabel_prom_text(text, "r1", skip_prefixes=skip)
        assert out == jfobs.relabel_prom_text(text, "r1", skip_prefixes=skip)
        assert "# HELP" not in out and 'dllama_lanes_active{replica="r1"}' in out
    # the JAX test's literal interpolation
    lit = ('dllama_tpot_seconds_bucket{le="0.01"} 4\n'
           'dllama_tpot_seconds_bucket{le="0.02"} 10\n'
           'dllama_tpot_seconds_bucket{le="+Inf"} 10\n')
    p50 = fobs.histogram_quantile(fobs.parse_prom_text(lit), "dllama_tpot_seconds", 0.5)
    assert abs(p50 - (0.01 + (1 / 6) * 0.01)) < 1e-9


def _ledger_script(mod):
    ledger = mod.RequestLedger(capacity=3)
    ledger.open("a", "trace-a")
    ledger.touch("a", "r0")
    ledger.touch("a", "r0")
    ledger.failover("a", from_replica="r0", reason="eof", emitted_tokens=3)
    ledger.close_failover("a", "r1", 0.25)
    ledger.touch("a", "r1")
    ledger.failover("a", from_replica="r1", reason="retryable:x", emitted_tokens=7, gap_s=0.5,
                    to_replica="r2")
    ledger.close_failover("a", "r0", 9.0)  # the last hop is closed already
    ledger.touch("zz", "r0")  # unknown ids are ignored
    out = [ledger.get("a")]
    for rid in ("b", "c", "d"):
        ledger.open(rid, f"t-{rid}")
    out += [ledger.get("a"), ledger.recent(), ledger.recent(1), ledger.get("zz")]
    return out


def test_request_ledger_matches_jax():
    got = _ledger_script(fobs)
    assert got == _ledger_script(jfobs)
    assert got[0]["replicas"] == ["r0", "r1"] and got[0]["failovers"][0] == {
        "from": "r0", "to": "r1", "reason": "eof", "emitted_tokens": 3, "gap_s": 0.25}
    assert got[1] is None and [r["request_id"] for r in got[2]] == ["d", "c", "b"]


def test_stitch_timelines_matches_jax():
    rng = np.random.default_rng(7)
    router_trace = {
        "traceEvents": [{"ph": "X", "pid": 6, "tid": -1, "ts": float(rng.uniform(0, 1e6)),
                         "dur": 5.0, "name": n} for n in ("tokenize", "relay", "failover")],
        "dllama": {"epoch_unix": 1000.0},
    }
    frags = []
    for i, name in enumerate(("r0", "r1")):
        frags.append((name, {
            "traceEvents": [{"ph": "M", "pid": 100 * (i + 1), "tid": 0, "name": "process_name",
                             "args": {"name": f"{name}/http"}}]
            + [{"ph": "X", "pid": 100 * (i + 1), "tid": 0, "ts": float(rng.uniform(0, 1e6)),
                "dur": 3.0, "name": "queue"} for _ in range(3)],
            "dllama": {"epoch_unix": 1000.0 + 2.5 * (i + 1)},
        }))
    frags.append(("r2", {"traceEvents": [{"ph": "X", "ts": 1.0, "dur": 1.0, "name": "x"}]}))
    merged = fobs.stitch_timelines(router_trace, frags)
    assert merged == jfobs.stitch_timelines(router_trace, frags)
    assert merged["dllama"]["sources"] == {"router": 3, "r0": 3, "r1": 3, "r2": 1}
    q = [e for e in merged["traceEvents"] if e.get("pid") == 100 and e["ph"] == "X"]
    assert q[0]["ts"] == round(frags[0][1]["traceEvents"][1]["ts"] + 2.5e6, 3)


def _fake_scrape(goodput, p50_ms):
    le = p50_ms * 2.0 / 1000.0
    return (f'dllama_slo_goodput_tokens_per_s{{window="1m"}} {goodput}\n'
            f'dllama_tpot_seconds_bucket{{le="{le}"}} 10\n'
            'dllama_tpot_seconds_bucket{le="+Inf"} 10\n')


def _anomaly_script(side, tok_path):
    """The JAX test's fake-clock fleet anomaly: equal replicas warm the
    baselines, then r1's TPOT p50 pulls away and the skew rule degrades the
    router's health. Returns the health payloads and store reads."""
    if side == "jax":
        from dllama_tpu.obs.metrics import MetricsRegistry
        from dllama_tpu.obs.recorder import FlightRecorder
        from dllama_tpu.tokenizer import Tokenizer
        rmod, omod, regmod = jrouter, jfobs, jrep
    else:
        from dllama_tpu_torch.obs.metrics import MetricsRegistry
        from dllama_tpu_torch.obs.recorder import FlightRecorder
        from dllama_tpu_torch.tokenizer import Tokenizer
        rmod, omod, regmod = router, fobs, rep
    clock = {"t": 0.0}
    replicas = regmod.ReplicaRegistry({"r0": "http://r0", "r1": "http://r1"},
                                      fetch=lambda url: {"status": "ok"},
                                      clock=lambda: clock["t"])
    replicas.poll_once()
    skew = {"r1": 10.0}

    def fetch(url):
        return _fake_scrape(50.0, 10.0 if "//r0" in url else skew["r1"])

    fo = omod.FleetObs(replicas, registry=MetricsRegistry(), recorder=FlightRecorder(),
                       fetch=fetch, clock=lambda: clock["t"], interval_s=1.0)
    state = rmod.RouterState(replicas, Tokenizer(tok_path), fleet_obs=fo)
    out = []

    def health():
        h = state.health_payload()
        h.pop("uptime_s")
        return h

    try:
        for _ in range(40):
            clock["t"] += 1.0
            fo.sampler.sample_once(clock["t"])
        out += [fo.monitor.degraded, health(),
                fo.store.latest("dllama_fleet_goodput_tokens_per_s"),
                fo.store.latest('dllama_fleet_replica_tpot_p50_ms{replica="r1"}'),
                fo.render_fleet()]
        skew["r1"] = 300.0
        clock["t"] += 1.0
        fo.sampler.sample_once(clock["t"])
        out += [fo.monitor.degraded, fo.monitor.active_signals(), health()]
    finally:
        fo.close()
    return out


def test_fleet_anomaly_degrades_router_health_as_jax(tmp_path):
    tp_ = str(tmp_path / "t.t")
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    got = _anomaly_script("port", tp_)
    assert got == _anomaly_script("jax", tp_)
    assert got[0] is False and got[1]["status"] == "ok" and got[1]["degraded_reasons"] == []
    assert got[2] == 100.0 and got[3] == 10.0
    assert '{replica="r0",window="1m"} 50.0' in got[4]
    assert got[5] is True and "fleet_tpot_skew" in got[6]
    assert got[7]["status"] == "degraded"
    assert "fleet_anomaly:fleet_tpot_skew" in got[7]["degraded_reasons"]


def test_retry_after_parse_matches_jax():
    for v in (None, "3", "0", "-2", "2.7", "soon", 5, "Wed, 21 Oct 2015 07:28:00 GMT"):
        assert router._retry_after_s(v) == jrouter._retry_after_s(v)


# -- entry points without a card -------------------------------------------------


def test_launchers_default_to_cuda_and_raise_without_a_card(files):
    import torch

    from dllama_tpu_torch.fleet import launch

    if torch.cuda.is_available():  # pragma: no cover - a machine with a card
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.launch_inprocess_fleet(*files, n_replicas=1)
    with pytest.raises(SystemExit, match="cuda"):
        launch.main(["--model", files[0], "--tokenizer", files[1]])


# -- the replica side of the contract: the port's lane server against JAX's ----


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fleet")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, cfg=CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    return mp, tp_


@pytest.fixture(scope="module")
def fleets(files):
    """side -> the in-process fleet of that package: two replicas of two
    lanes each, f32, greedy, seed 3 (the JAX one on its default device,
    the port's on the CPU), the JAX fleet test's knobs."""
    from dllama_tpu.fleet.launch import launch_inprocess_fleet as jlaunch
    from dllama_tpu_torch.fleet.launch import launch_inprocess_fleet

    out = {"jax": jlaunch(*files, n_replicas=2, batch_size=2)}
    try:
        out["port"] = launch_inprocess_fleet(*files, n_replicas=2, batch_size=2, device="cpu")
    except BaseException:
        out["jax"].close()
        raise
    # the replicas' watchdogs stop and the anomaly monitors (each replica's
    # and the routers') watch no rules here: whether a tiny replica's
    # wall-clock series trip one, or a JAX compile on a loaded CPU outlasts
    # the decode-stall threshold, is timing, and a degraded affinity target
    # would change where a request lands. The fleet rule has its fake-clock
    # test above.
    for h in out.values():
        for _, srv in h.replicas:
            srv.state.watchdog.stop()
        monitors = [srv.state.anomaly for _, srv in h.replicas] + [h.router.state.fleet.monitor]
        for mon in monitors:
            with mon._lock:
                mon.rules.clear()
                for st in mon._state.values():
                    st.active = False
    yield out
    for h in out.values():
        h.close()


@pytest.fixture(scope="module")
def native_server(files):
    """A pool-native port replica (the lane mode the fleet's replicas do not
    run by default), named ``rn``."""
    import torch

    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import Tokenizer

    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=2)
    srv = serve(eng, Tokenizer(files[1]), host="127.0.0.1", port=0, kv_native=True,
                replica_id="rn")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()
    srv.server_close()


def _post(url, payload, headers=None, timeout=LIMIT):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})},
                                 method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return r.read().decode()


def _metric(text, name, labels=None):
    pattern = re.escape(name) + (re.escape(labels) if labels else "") + r" ([0-9.e+-]+)"
    m = re.search(pattern, text)
    return float(m.group(1)) if m else 0.0


def _events(raw):
    return [json.loads(line[len("data: "):]) for line in raw.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def _frames(raw):
    """(delta text, dllama_tokens, dllama_piece) of every non-final frame,
    and the finish reasons."""
    evs = _events(raw)
    assert all("error" not in e for e in evs), evs
    frames = [((e["choices"][0].get("delta") or {}).get("content"), e.get("dllama_tokens"),
               e.get("dllama_piece")) for e in evs if not e["choices"][0].get("finish_reason")]
    finish = [e["choices"][0]["finish_reason"] for e in evs
              if e["choices"][0].get("finish_reason")]
    return frames, finish


def _stream(url, payload, headers=None):
    payload = dict(payload, stream=True)
    with _post(url, payload, headers) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        raw = r.read().decode()
        hdrs = {k.lower(): v for k, v in r.headers.items()}
    assert raw.rstrip().endswith("data: [DONE]"), raw[-300:]
    frames, finish = _frames(raw)
    assert len(finish) == 1, raw
    return "".join(f[0] or "" for f in frames), finish[0], hdrs


def _replica_url(fleets, side, name):
    return fleets[side].replica_urls[name]


MSG = [{"role": "user", "content": "tell me about the tokens"}]


def _token_stream(url, **kw):
    with _post(url, {"messages": MSG, "max_tokens": 14, "temperature": 0, "stream": True,
                     "include_tokens": True, **kw}) as r:
        return _frames(r.read().decode())


@pytest.mark.parametrize("holdback", [False, True])
@pytest.mark.parametrize("mode", ["slab", "native"])
def test_include_tokens_frames_match_jax_lane_server(fleets, native_server, files, mode,
                                                     holdback):
    """The same greedy request with ``include_tokens`` on the JAX lane server
    (its default slab lanes) and on the port's (slab: a fleet replica;
    native: ``native_server``): equal frames, delta text, token ids and
    pieces, and finish reasons. Cumulative ``dllama_tokens`` are the
    generated ids, cumulative ``dllama_piece`` their exact text, also when a
    stop string's partial match holds text back in the EOS detector."""
    from dllama_tpu_torch.tokenizer import Tokenizer

    jurl = _replica_url(fleets, "jax", "r0")
    url = _replica_url(fleets, "port", "r0") if mode == "slab" else native_server[0]
    plain, _ = _token_stream(jurl)
    kw = {}
    if holdback:
        # a stop string whose first two characters recur in the text but
        # which never matches whole: every partial match is held back
        text = "".join(f[0] for f in plain)
        assert len(text) >= 4
        kw["stop"] = [text[2:4] + "\x07"]
    want = _token_stream(jurl, **kw)
    got = _token_stream(url, **kw)
    assert got == want
    frames, finish = got
    assert finish and finish[0] in ("stop", "length")
    texts = "".join(f[0] for f in frames)
    ids = [t for f in frames for t in f[1]]
    pieces = "".join(f[2] for f in frames)
    # the ids are the greedy generation's, the pieces their decoded text
    all_ids = [t for f in plain for t in f[1]]
    assert ids == all_ids[:len(ids)] and ids
    dec = Tokenizer(files[1]).stream_decoder()
    assert pieces == "".join(dec.decode(t) or "" for t in ids)
    assert pieces.startswith(texts)
    if holdback:
        assert len(frames) < len(plain), "the stop string held nothing back"


def test_plain_delta_with_include_tokens_is_text_and_no_tokens(fleets):
    """A resume's public-prompt echo and a non-include stream: without the
    flag the frames carry no dllama_* keys on either server."""
    for side in SIDES:
        with _post(_replica_url(fleets, side, "r0"),
                   {"messages": MSG, "max_tokens": 4, "temperature": 0, "stream": True}) as r:
            frames, _ = _frames(r.read().decode())
        assert frames and all(f[1] is None and f[2] is None for f in frames), side


def test_replica_health_names_the_replica(fleets, native_server):
    caps = {}
    for side in SIDES:
        for name, url in fleets[side].replica_urls.items():
            h = _get(url + "/v1/health")
            assert h["replica"] == name and h["status"] == "ok"
            caps[(side, name)] = _settled(h["capacity"])
    for name in ("r0", "r1"):
        assert caps[("port", name)] == caps[("jax", name)]
        assert caps[("port", name)]["lanes"] == 2
    assert _get(native_server[0] + "/v1/health")["replica"] == "rn"
    assert "replica" not in _get(native_server[0] + "/v1/health")["capacity"]


@pytest.mark.parametrize("resumed", [False, True])
def test_trace_headers_adopted_as_jax(fleets, resumed):
    """The router's identity headers on a replica: the response and the
    request's trace record carry them, ``trace_adopt`` names the replica
    and whether the request resumes, and the request's spans are tagged
    with the replica."""
    out = {}
    for side in SIDES:
        h = fleets[side]
        url = h.replica_urls["r1"]
        rid, trace = f"req-hdr{int(resumed)}{side}", f"trace-hdr{int(resumed)}{side}"
        body = {"messages": MSG, "max_tokens": 4, "temperature": 0}
        if resumed:
            body = {"resume_tokens": h.router.state.prompt_tokens(MSG) + [5, 6],
                    "max_tokens": 4, "temperature": 0}
        with _post(url, body, {"x-dllama-trace": trace, "x-dllama-request": rid}) as r:
            data = json.loads(r.read())
        assert data["dllama"]["request_id"] == rid
        state = dict(h.replicas)["r1"].state
        recs = [x for x in state.tracer.records() if x.get("request_id") == rid]
        assert recs and all(x["trace_id"] == trace for x in recs)
        rec = (jrecorder if side == "jax" else precorder).get_recorder()
        adopts = [e for e in rec.events() if e["kind"] == "trace_adopt"
                  and e.get("trace_id") == trace]
        assert len(adopts) == 1
        ev = {k: v for k, v in adopts[0].items() if k not in ("t", "seq")}
        assert ev["replica"] == "r1" and ev["resumed"] is resumed and ev["request_id"] == rid
        tl = _get(f"{url}/v1/debug/timeline?request_id={rid}&replica=r1")
        xs = [e for e in tl["traceEvents"] if e.get("ph") == "X"]
        assert xs and all(e["args"].get("request_id") == rid for e in xs)
        other = _get(f"{url}/v1/debug/timeline?request_id={rid}&replica=r0")
        assert not [e for e in other["traceEvents"] if e.get("ph") == "X"]
        out[side] = (data["choices"], data["usage"],
                     {k: v for k, v in ev.items() if k not in ("trace_id", "request_id")},
                     recs[-1]["finish_reason"])
    assert out["port"] == out["jax"]


def _read_all(url, payload):
    """A stream read to its end: (complete, text). A stream a fault cut has
    no ``[DONE]`` (the server closed the connection mid-body)."""
    try:
        with _post(url, dict(payload, stream=True)) as r:
            raw = r.read().decode()
    except (http.client.IncompleteRead, ConnectionError) as e:
        raw = getattr(e, "partial", b"").decode("utf-8", "replace")
    return raw.rstrip().endswith("data: [DONE]"), raw


def test_sse_flush_fault_scoped_to_its_replica_as_jax(fleets):
    """``sse_flush:op=r1`` cuts a stream on r1 and never on r0, on both
    packages' replicas."""
    body = {"messages": MSG, "max_tokens": 6, "temperature": 0}
    out = {}
    for side, faults in (("jax", jfaults), ("port", pfaults)):
        plane = faults.set_fault_plane("sse_flush:op=r1:nth=1:n=1")
        try:
            r0 = _read_all(_replica_url(fleets, side, "r0"), body)[0]
            fired_r0 = plane.schedules[0].injected
            r1 = _read_all(_replica_url(fleets, side, "r1"), body)[0]
            fired_r1 = plane.schedules[0].injected
        finally:
            faults.set_fault_plane("")
        out[side] = (r0, fired_r0, r1, fired_r1)
    assert out["port"] == out["jax"] == (True, 0, False, 1)


# -- the live fleet: each tests/test_fleet.py live test through both routers ----


def _settled(cap):
    """A capacity block less ``in_flight``: a stream's lane frees just after
    its client read ``[DONE]``, so a poll may still count it."""
    assert cap["in_flight"] >= 0
    return {k: v for k, v in cap.items() if k != "in_flight"}


def _route(h, msgs):
    st = h.router.state
    return st.route(st.prompt_tokens(msgs))


def test_router_tokenization_matches_replica(fleets):
    msgs = [{"role": "user", "content": "hello world, count my tokens"}]
    out = {}
    for side in SIDES:
        h = fleets[side]
        with _post(h.router_url, {"messages": msgs, "max_tokens": 2, "temperature": 0}) as r:
            data = json.loads(r.read())
        assert data["usage"]["prompt_tokens"] == len(h.router.state.prompt_tokens(msgs))
        assert r.headers["x-dllama-request"].startswith("req-")
        out[side] = (h.router.state.prompt_tokens(msgs), data["usage"], data["choices"])
    assert out["port"] == out["jax"]


UNARY_PROMPTS = ["the quick brown", "zebra", "a much longer prompt about many things"]


@pytest.mark.parametrize("prompt", UNARY_PROMPTS)
def test_unary_through_router_matches_jax(fleets, prompt):
    msgs = [{"role": "user", "content": prompt}]
    out = {}
    for side in SIDES:
        with _post(fleets[side].router_url,
                   {"messages": msgs, "max_tokens": 8, "temperature": 0}) as r:
            data = json.loads(r.read())
        out[side] = (data["choices"], data["usage"], _route(fleets[side], msgs).target)
    assert out["port"] == out["jax"]


def test_affinity_routes_repeated_prefix_to_one_replica(fleets):
    msgs = [{"role": "user", "content": "the affinity prompt"}]
    out = {}
    for side in SIDES:
        url = fleets[side].router_url
        before = _scrape(url)
        answers = []
        for _ in range(3):
            with _post(url, {"messages": msgs, "max_tokens": 3, "temperature": 0}) as r:
                answers.append(json.loads(r.read())["choices"])
        after = _scrape(url)
        hits = (_metric(after, "dllama_router_affinity_hits_total")
                - _metric(before, "dllama_router_affinity_hits_total"))
        radix = (_metric(after, "dllama_prefix_cache_hits_total")
                 - _metric(before, "dllama_prefix_cache_hits_total"))
        assert hits == 3.0 and radix >= 2.0, side
        out[side] = (answers, hits, _route(fleets[side], msgs).target)
    assert out["port"] == out["jax"]


def test_fleet_endpoint_aggregates(fleets):
    out = {}
    for side in SIDES:
        fl = _get(fleets[side].router_url + "/v1/fleet")
        assert set(fl["replicas"]) == {"r0", "r1"}
        assert fl["aggregate"]["lanes_total"] == 4
        assert fl["aggregate"]["states"].get("healthy") == 2
        for r in fl["replicas"].values():
            assert r["state"] == "healthy" and r["health"]["capacity"]["lanes"] == 2
        out[side] = (fl["router"], _settled(fl["aggregate"]),
                     {n: sorted(r) for n, r in fl["replicas"].items()},
                     {n: _settled(r["health"]["capacity"]) for n, r in fl["replicas"].items()})
    assert out["port"] == out["jax"]


def test_router_health(fleets):
    out = {}
    for side in SIDES:
        h = _get(fleets[side].router_url + "/v1/health")
        assert h.pop("uptime_s") >= 0
        out[side] = h
    assert out["port"] == out["jax"]
    assert out["port"]["status"] == "ok" and out["port"]["role"] == "router"
    assert out["port"]["replicas"] == {"r0": "healthy", "r1": "healthy"}


def test_router_models_and_dashboard(fleets):
    for side in SIDES:
        url = fleets[side].router_url
        models = _get(url + "/v1/models")
        assert models["data"][0]["id"] == "dllama-fleet"
        with urllib.request.urlopen(url + "/dashboard", timeout=30) as r:
            assert "dllama_fleet_goodput_tokens_per_s" in r.read().decode()
        assert _get(url + "/healthz") == {"status": "ok"}


STORY = {"messages": [{"role": "user", "content": "tell me a story"}], "max_tokens": 16,
         "temperature": 0}


def test_midstream_failover_byte_identical(fleets):
    """Kill the serving replica at its 3rd SSE flush: the router resumes the
    stream on the sibling, the client reads the fault-free bytes, and the
    JAX fleet's bytes, with one failover and one death counted on each."""
    out = {}
    for side, faults in (("jax", jfaults), ("port", pfaults)):
        url = fleets[side].router_url
        base = _stream(url, STORY)[:2]
        target = _route(fleets[side], STORY["messages"]).target
        before = _scrape(url)
        faults.set_fault_plane(f"sse_flush:op={target}:nth=3:n=1")
        try:
            ft = _stream(url, STORY)[:2]
        finally:
            faults.set_fault_plane("")
        after = _scrape(url)
        died = f'{{replica="{target}",outcome="died"}}'
        deltas = (_metric(after, "dllama_router_failovers_total")
                  - _metric(before, "dllama_router_failovers_total"),
                  _metric(after, "dllama_router_requests_total", died)
                  - _metric(before, "dllama_router_requests_total", died))
        assert ft == base and deltas == (1.0, 1.0), side
        out[side] = (base, ft, target, deltas)
    assert out["port"] == out["jax"]


def test_trace_propagation_and_stitched_timeline(fleets):
    """A seeded mid-stream failover leaves the router's trace id in both
    replicas' trace records, and /v1/fleet/timeline stitches the router's
    fragment with both replicas' into one trace: the relay spans do not
    overlap and the gap is the router's ``failover`` span; the same shape
    as the JAX fleet's."""
    p = {"messages": [{"role": "user", "content": "stitch my timeline"}], "max_tokens": 16,
         "temperature": 0}
    shapes = {}
    for side, faults, recorder in (("jax", jfaults, jrecorder), ("port", pfaults, precorder)):
        h = fleets[side]
        url = h.router_url
        victim = _route(h, p["messages"]).target
        sibling = next(n for n in h.replica_urls if n != victim)
        faults.set_fault_plane(f"sse_flush:op={victim}:nth=3:n=1")
        try:
            text, _, headers = _stream(url, p)
        finally:
            faults.set_fault_plane("")
        assert text
        rid, trace = headers["x-dllama-request"], headers["x-dllama-trace"]
        assert rid.startswith("req-") and trace.startswith("trace-")
        by_name = dict(h.replicas)
        for name in (victim, sibling):
            recs = [r for r in by_name[name].state.tracer.records()
                    if r.get("request_id") == rid]
            assert recs and all(r["trace_id"] == trace for r in recs), (side, name)
        tl = _get(f"{url}/v1/fleet/timeline?request_id={rid}")
        d = tl["dllama"]
        assert d["trace_id"] == trace and d["replicas"] == [victim, sibling]
        assert "fetch_errors" not in d
        assert d["sources"]["router"] > 0 and d["sources"][victim] > 0
        assert d["sources"][sibling] > 0
        xs = [e for e in tl["traceEvents"] if e.get("ph") == "X"]
        router_names = {e["name"] for e in xs if e.get("pid", 0) < 100}
        assert {"tokenize", "route_plan", "relay", "failover",
                "catch_up_synthesis"} <= router_names
        relays = sorted((e for e in xs if e["name"] == "relay"), key=lambda e: e["ts"])
        assert len(relays) == 2
        assert relays[0]["args"]["replica"] == victim
        assert relays[0]["args"]["outcome"] == "died"
        assert relays[1]["args"]["replica"] == sibling and relays[1]["args"]["resumed"] is True
        (fail,) = [e for e in xs if e["name"] == "failover"]
        assert fail["args"]["from_replica"] == victim and fail["args"]["to_replica"] == sibling
        eps = 1.0
        assert relays[0]["ts"] + relays[0]["dur"] <= relays[1]["ts"] + eps
        assert fail["ts"] >= relays[0]["ts"] + relays[0]["dur"] - eps
        assert fail["ts"] + fail["dur"] <= relays[1]["ts"] + relays[1]["dur"] + eps
        assert d["failovers"][0]["from"] == victim and d["failovers"][0]["to"] == sibling
        assert d["failovers"][0]["gap_s"] > 0
        rep_events = [e for e in xs if e.get("pid", 0) >= 100]
        assert rep_events and all(e["args"].get("request_id") == rid for e in rep_events)
        assert _metric(_scrape(url), "dllama_router_failover_gap_seconds_count") >= 1.0
        dump = _get(url + "/v1/fleet/debug/recorder")
        assert set(dump["replicas"]) == {"r0", "r1"}
        assert all("events" in r for r in dump["replicas"].values())
        events = dump["router"]["events"]
        fo = [e for e in events if e["kind"] == "router_failover"][-1]
        assert fo["trace_id"] == trace and fo["request_id"] == rid
        adopts = [e for e in events if e["kind"] == "trace_adopt" and e.get("trace_id") == trace]
        assert {e.get("replica") for e in adopts} == {victim, sibling}
        assert any(e.get("resumed") for e in adopts)
        shapes[side] = (text, victim, sibling, sorted(router_names), fo["reason"],
                        d["failovers"][0]["emitted_tokens"], len(adopts))
    assert shapes["port"] == shapes["jax"]


def test_router_fleet_metrics_reexport(fleets):
    out = {}
    for side in SIDES:
        h = fleets[side]
        state = h.router.state
        assert state.fleet.scrape_once() == {"r0": True, "r1": True}
        m = _scrape(h.router_url)
        assert re.search(r'dllama_http_requests_total\{replica="r0",', m), m[:2000]
        assert re.search(r'dllama_http_requests_total\{replica="r1",', m)
        assert _metric(m, "dllama_fleet_replicas", '{state="healthy"}') == 2.0
        assert _metric(m, "dllama_fleet_goodput_tokens_per_s") >= 0.0
        assert _metric(m, "dllama_fleet_tpot_skew_ms") >= 0.0
        assert _metric(m, "dllama_fleet_scrapes_total", '{outcome="ok"}') >= 2.0
        for name in ("r0", "r1"):
            assert re.search(r"dllama_fleet_replica_tpot_p50_ms\{replica=\"%s\"\}" % name, m)
        idx = _get(h.router_url + "/v1/debug/series")
        assert "dllama_fleet_goodput_tokens_per_s" in idx["names"]
        assert idx["anomaly"]["degraded"] is False
        q = _get(h.router_url + "/v1/debug/series?name=dllama_fleet_goodput_tokens_per_s"
                 "&window=600")
        assert q["points"], q
        # the router's own families, by name and type
        fams = {line.split()[2]: line.split()[3] for line in m.splitlines()
                if line.startswith("# TYPE ") and line.split()[2].startswith(
                    ("dllama_router_", "dllama_fleet_"))}
        relabeled = sorted({line.split("{")[0] for line in m.splitlines()
                            if 'replica="r0"' in line and line.startswith("dllama_")
                            and not line.startswith(("dllama_router_", "dllama_fleet_"))})
        out[side] = (fams, relabeled)
    assert out["port"][0] == out["jax"][0]
    # the serving families both replicas export, re-exported by both routers
    common = set(out["port"][1]) & set(out["jax"][1])
    for fam in ("dllama_http_requests_total", "dllama_requests_finished_total",
                "dllama_prefix_cache_hits_total", "dllama_lanes_total"):
        assert any(f == fam for f in common), fam


def test_fleet_chaos_every_stream_completes(fleets):
    """Four concurrent streams while one replica drops two of them
    mid-flight: every client reads its fault-free bytes, on both fleets, and
    the fleets' bytes agree."""
    prompts = [{"messages": [{"role": "user", "content": f"chaos stream {i}"}],
                "max_tokens": 12, "temperature": 0} for i in range(4)]
    out = {}
    for side, faults in (("jax", jfaults), ("port", pfaults)):
        url = fleets[side].router_url
        baseline = [_stream(url, p)[:2] for p in prompts]
        victim = _route(fleets[side], prompts[0]["messages"]).target
        results, errors = [None] * len(prompts), []

        def run(i, url=url, results=results, errors=errors):
            try:
                results[i] = _stream(url, prompts[i])[:2]
            except Exception as e:  # noqa: BLE001 - collected and asserted below
                errors.append((i, repr(e)))

        faults.set_fault_plane(f"sse_flush:op={victim}:nth=2:n=2")
        try:
            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=LIMIT)
        finally:
            faults.set_fault_plane("")
        assert not errors and results == baseline, (side, errors)
        out[side] = baseline
    assert out["port"] == out["jax"]


def test_router_unavailable_answers_retryable_503(fleets, files):
    """A router over replicas that refuse connections answers the
    structured retryable 503 with Retry-After, stream or not, as JAX's."""
    from dllama_tpu.tokenizer import Tokenizer as JTokenizer
    from dllama_tpu_torch.tokenizer import Tokenizer

    port = _free_ports(1)
    out = {}
    for side, rmod, regmod, tok in (("jax", jrouter, jrep, JTokenizer),
                                    ("port", router, rep, Tokenizer)):
        reg = regmod.ReplicaRegistry({"r0": f"http://127.0.0.1:{port}"}, fail_threshold=1)
        srv = rmod.serve_router(reg, tok(files[1]), host="127.0.0.1", port=0,
                                start_poller=False)
        # the first poll seeded the replica as dead
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            res = []
            for stream in (False, True):
                try:
                    _post(url, {"messages": MSG, "max_tokens": 2, "stream": stream})
                except urllib.error.HTTPError as e:
                    res.append((e.code, e.headers.get("Retry-After"), json.loads(e.read())))
            res.append(_get(url + "/v1/health")["status"])
        finally:
            srv.shutdown()
            srv.server_close()
        out[side] = res
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 503 and out["port"][0][2]["error"]["retryable"] is True


def _free_ports(n):
    """A base port whose n consecutive ports are free on 127.0.0.1."""
    rng = np.random.default_rng(os.getpid())
    for _ in range(200):
        base = int(rng.integers(20000, 60000 - n))
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


def _wait_up(url, proc, timeout=LIMIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"process exited with {proc.returncode}"
        try:
            return _get(url + "/v1/health", timeout=5)
        except OSError:
            time.sleep(0.25)
    raise AssertionError(f"{url} never answered")


def _port_closed(port):
    with socket.socket() as s:
        return s.connect_ex(("127.0.0.1", port)) != 0


def test_router_main_serves_the_fleet(fleets, files, tmp_path):
    """``python -m dllama_tpu_torch.fleet.router`` in front of the port
    fleet's replicas answers a greedy request with the in-process router's
    answer."""
    port = _free_ports(1)
    cmd = [sys.executable, "-m", "dllama_tpu_torch.fleet.router", "--host", "127.0.0.1",
           "--port", str(port), "--tokenizer", files[1]]
    for name, url in fleets["port"].replica_urls.items():
        cmd += ["--replica", f"{name}={url}"]
    log = open(tmp_path / "router.log", "w")
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port}"
        assert _wait_up(url, proc)["role"] == "router"
        body = {"messages": [{"role": "user", "content": "zebra"}], "max_tokens": 8,
                "temperature": 0}
        with _post(url, body) as r:
            got = json.loads(r.read())["choices"]
        with _post(fleets["port"].router_url, body) as r:
            assert got == json.loads(r.read())["choices"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()


def test_subprocess_launcher_serves_and_drains_on_sigterm(files, tmp_path):
    """``python -m dllama_tpu_torch.fleet.launch --device cpu``: two replica
    processes answer ``/v1/health`` with their names, one stream through the
    router completes, and SIGTERM to the launcher drains each replica (its
    own SIGTERM) and stops every process."""
    # the replicas sample (the server's default temperature): a tokenizer
    # padded to the model's vocab decodes any id they draw
    tp_ = str(tmp_path / "t.t")
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>", pad_to=CFG["vocab_size"])
    base = _free_ports(3)
    rport = base + 2
    cmd = [sys.executable, "-m", "dllama_tpu_torch.fleet.launch", "--model", files[0],
           "--tokenizer", tp_, "--n-replicas", "2", "--base-port", str(base),
           "--port", str(rport), "--batch-size", "2", "--device", "cpu"]
    log_path = tmp_path / "launch.log"
    log = open(log_path, "w")
    # its own session: a failed test kills the launcher and its replicas by
    # their group id
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        url = f"http://127.0.0.1:{rport}"
        health = _wait_up(url, proc)
        assert health["role"] == "router"
        assert set(health["replicas"]) == {"r0", "r1"}
        for i in range(2):
            h = _get(f"http://127.0.0.1:{base + i}/v1/health")
            assert h["replica"] == f"r{i}" and h["capacity"]["lanes"] == 2
        text, finish, hdrs = _stream(url, {"messages": MSG, "max_tokens": 6})
        assert finish in ("stop", "length") and hdrs["x-dllama-request"].startswith("req-")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=LIMIT) == 0
    finally:
        try:  # whatever of the fleet is left, after a failure
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        log.close()
    out = log_path.read_text()
    assert "Replica r0 healthy after" in out and "Replica r1 healthy after" in out, out[-2000:]
    assert all(_port_closed(p) for p in (base, base + 1, rport)), out[-2000:]


def test_drain_rolling_restart_last(fleets):
    """LAST live test (a drain is permanent for the fixtures): drain the
    affinity target through each router while a stream is in flight on it
    (its first decode block held until the drain is forwarded);
    the stream finishes, the replica reports draining, then drained with
    nothing in flight, and later requests land on the sibling; the answers
    and router counts agree across the fleets."""
    msgs = [{"role": "user", "content": "the affinity prompt"}]
    out = {}
    for side, recorder in (("jax", jrecorder), ("port", precorder)):
        h = fleets[side]
        url = h.router_url
        victim = _route(h, msgs).target
        sibling = next(n for n in h.replica_urls if n != victim)
        state = dict(h.replicas)[victim].state
        sched = state.scheduler
        # the victim's first decode block waits for the drain: the stream
        # is in flight, on a lane, when the drain begins
        entered, release = threading.Event(), threading.Event()
        step = sched._step_block

        def gated_step(step=step, entered=entered, release=release):
            entered.set()
            assert release.wait(LIMIT)
            step()

        sched._step_block = gated_step
        hold = []

        def long_stream(url=url, hold=hold):
            hold.append(_stream(url, {"messages": msgs, "max_tokens": 24,
                                      "temperature": 0})[:2])

        t = threading.Thread(target=long_stream)
        t.start()
        try:
            assert entered.wait(LIMIT), side
            assert any(ls is not None for ls in sched.lanes)
            req = urllib.request.Request(f"{url}/v1/drain?replica={victim}", data=b"",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                first = json.loads(r.read())
        finally:
            release.set()
            del sched._step_block
        assert first["status"] == "draining" and first["replica"] == victim
        assert first["in_flight"] >= 1 and first["drained"] is False
        t.join(timeout=LIMIT)
        assert hold, "in-flight stream must finish during drain"
        assert state.drained.wait(timeout=LIMIT)
        req = urllib.request.Request(f"{h.replica_urls[victim]}/v1/drain", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            poll = json.loads(r.read())
        assert poll["drained"] and poll["in_flight"] == 0
        events = _get(h.replica_urls[victim] + "/v1/debug/recorder")["events"]
        kinds = [e["kind"] for e in events]
        assert "drain_begin" in kinds and "drained" in kinds
        drained_ev = [e for e in events if e["kind"] == "drained"][-1]
        assert drained_ev["in_flight"] == 0 and drained_ev["drain_s"] >= 0
        h.registry.poll_once()
        assert h.registry.views()[victim].state == rep.DRAINING
        before = _scrape(url)
        after_drain = [_stream(url, {"messages": msgs, "max_tokens": 4, "temperature": 0})[:2]
                       for _ in range(2)]
        m = _scrape(url)
        ok = f'{{replica="{sibling}",outcome="ok"}}'
        moved = (_metric(m, "dllama_router_requests_total", ok)
                 - _metric(before, "dllama_router_requests_total", ok))
        assert moved == 2.0, side
        spills = (_metric(m, "dllama_router_spills_total", '{reason="draining"}')
                  - _metric(before, "dllama_router_spills_total", '{reason="draining"}'))
        out[side] = (hold, after_drain, victim, moved, spills,
                     {k: poll[k] for k in ("status", "in_flight", "drained")})
    assert out["port"] == out["jax"]
