"""The port's observability modules (dllama_tpu_torch/obs/) against their
JAX twins (dllama_tpu/obs/), on the CPU.

The copied modules run the same calls under the same fake clocks on both
packages and must give the same output: the Prometheus text (labels,
escaping, percentiles), the recorder's ring, overflow and postmortem (less
timestamps), Chrome traces and the per-request accounting, the SLO
windows, the series store and sampler, the default anomaly rules and the
watchdog's four stall rules (each firing and recovering on the same tick),
the dashboard's bytes and the knobs' environment fallbacks. No test
waits on real time. The rewritten modules (``cost``, ``device``) are held
to the port's own parameter tensors and to the JAX functions' None rules.
"""

import json
import logging
import os
import types

import numpy as np
import pytest
import torch

import dllama_tpu.obs as jobs
import dllama_tpu.obs.anomaly as j_anomaly
import dllama_tpu.obs.cost as j_cost
import dllama_tpu.obs.dashboard as j_dashboard
import dllama_tpu.obs.device as j_device
import dllama_tpu.obs.metrics as j_metrics
import dllama_tpu.obs.recorder as j_recorder
import dllama_tpu.obs.slo as j_slo
import dllama_tpu.obs.spans as j_spans
import dllama_tpu.obs.timeseries as j_timeseries
import dllama_tpu.obs.trace as j_trace
import dllama_tpu.obs.watchdog as j_watchdog
import dllama_tpu_torch.obs as pobs
import dllama_tpu_torch.obs.anomaly as p_anomaly
import dllama_tpu_torch.obs.cost as p_cost
import dllama_tpu_torch.obs.dashboard as p_dashboard
import dllama_tpu_torch.obs.device as p_device
import dllama_tpu_torch.obs.metrics as p_metrics
import dllama_tpu_torch.obs.recorder as p_recorder
import dllama_tpu_torch.obs.slo as p_slo
import dllama_tpu_torch.obs.spans as p_spans
import dllama_tpu_torch.obs.timeseries as p_timeseries
import dllama_tpu_torch.obs.trace as p_trace
import dllama_tpu_torch.obs.watchdog as p_watchdog
from dllama_tpu.formats import FloatType, LlmArch
from dllama_tpu_torch.formats.model_file import ModelReader
from dllama_tpu_torch.models.loader import load_params
from dllama_tpu_torch.ops.int8_matmul import pick_group, requantize_params

from helpers import TINY, TINY_MOE, make_tiny_model

JAX = types.SimpleNamespace(
    metrics=j_metrics, recorder=j_recorder, trace=j_trace, spans=j_spans, slo=j_slo,
    timeseries=j_timeseries, anomaly=j_anomaly, watchdog=j_watchdog, dashboard=j_dashboard)
PORT = types.SimpleNamespace(
    metrics=p_metrics, recorder=p_recorder, trace=p_trace, spans=p_spans, slo=p_slo,
    timeseries=p_timeseries, anomaly=p_anomaly, watchdog=p_watchdog, dashboard=p_dashboard)
TIMESTAMPS = ("t", "captured_unix", "captured_monotonic", "submitted_unix")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _strip(obj):
    """``obj`` without its wall and monotonic timestamps."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in TIMESTAMPS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# -- the copies against their twins -------------------------------------------


def _metrics(m, tmp):
    reg = m.metrics.MetricsRegistry()
    c = reg.counter("dllama_t_requests_total", 'help with \\ and "quotes"\nand a newline',
                    labelnames=("path",))
    c.labels(path='a"b\\c\nd').inc(2)
    c.labels(path="/v1/x").inc()
    g = reg.gauge("dllama_t_depth", "a gauge")
    g.set(2.5)
    g.inc()
    g.dec(0.25)
    h = reg.histogram("dllama_t_step_seconds", "a histogram", labelnames=("kind",))
    for v in (0.0005, 0.003, 0.2, 0.2, 7.0, 100.0):
        h.labels(kind="decode").observe(v)
    tok = reg.histogram("dllama_t_token_seconds", "tokens",
                        buckets=m.metrics.DEFAULT_TOKEN_BUCKETS_S)
    for v in np.linspace(0.0001, 0.3, 17):
        tok.observe(float(v))
    reg.disable()
    c.labels(path="/v1/x").inc(100)
    g.set(-1)
    h.labels(kind="decode").observe(1.0)
    reg.enable()
    with pytest.raises(ValueError):
        reg.gauge("dllama_t_requests_total")
    pct = [h.labels(kind="decode").percentile(q) for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)]
    pct += [tok.percentile(q) for q in (0.5, 0.99)]
    pct.append(reg.histogram("dllama_t_empty", "e").percentile(0.5))
    return reg.render(), pct, reg.flat_values(), m.metrics.DEFAULT_LATENCY_BUCKETS_S


def _recorder(m, tmp):
    d = os.path.join(tmp, "pm")
    rec = m.recorder.FlightRecorder(capacity=4, postmortem_dir=d)
    rec.add_context_provider("health", lambda: {"status": "ok"})
    rec.add_context_provider("broken", lambda: 1 / 0)
    for i in range(6):
        rec.record("step_dispatch" if i % 2 else "admit", i=i, lane=i % 3)
    path = rec.postmortem("engine-step", RuntimeError("boom"))
    with open(path) as f:
        pm = json.load(f)
    rec.disable()
    rec.record("ignored")
    rec.enable()
    return (_strip(rec.dump()), [e["i"] for e in rec.events("admit")], rec.total_recorded,
            _strip(pm), rec.postmortem_dir == d)


def _fake_time(clk):
    return types.SimpleNamespace(perf_counter=clk, time=lambda: 1000.0 + clk(),
                                 monotonic=clk)


def _trace(m, tmp, monkeypatch):
    clk = FakeClock(5.0)
    monkeypatch.setattr(m.trace, "time", _fake_time(clk))
    tracer = m.trace.Tracer(capacity=2, sink_path=os.path.join(tmp, "tr.jsonl"))
    out = []
    for i, rid in enumerate(("r1", "r2", "r3")):
        sp = tracer.span(request_id=rid, trace_id="t" if i == 1 else None)
        clk.t += 0.125
        out.append(sp.mark_admitted(lane=i, reused_prefix_tokens=16 * i))
        sp.set_prefill_seconds(0.5)
        clk.t += 0.25
        out.append(sp.mark_first_token())
        out.append(sp.mark_first_token())  # single-shot
        clk.t += 1.0
        out.append(sp.finish("stop" if i else "cancelled", n_prompt=10 + i, n_completion=5))
        out.append(sp.finish("length"))  # the first reason wins
        out.append((sp.ttft_ms, sp.queue_wait_ms))
    tracer.close()
    null = m.trace.NULL_SPAN
    out.append((null.mark_admitted(), null.mark_first_token(), null.finish("stop")))
    return out, tracer.records(), m.trace.read_jsonl(os.path.join(tmp, "tr.jsonl"))


def _spans(m, tmp):
    clk = FakeClock()
    rec = m.recorder.FlightRecorder(capacity=64)
    st = m.spans.SpanTracker(capacity=8, enabled=True, clock=clk, wall_clock=lambda: 1e9,
                             recorder=rec)

    def span(name, t0, t1, rid="r1", lane=None, component="scheduler", **attrs):
        clk.t = t0
        h = st.begin(name, component=component, request_id=rid, lane=lane, **attrs)
        clk.t = t1
        st.end(h, done=True)

    span("queue", 0.0, 1.0, n_prompt=7)
    span("decode", 1.0, 3.0, lane=2)
    span("decode_lanes", 1.5, 2.5, rid=None, component="engine")
    span("decode_lanes.device", 2.0, 2.5, rid=None, component="engine")
    span("sse_flush", 2.6, 2.7, component="http")
    span("other", 0.0, 9.0, rid="r2")
    span("a", 10.0, 11.0, rid="r3")
    span("b", 12.0, 13.0, rid="r3")
    with pytest.raises(RuntimeError):
        with st.span("chunk", request_id="r4"):
            clk.t = 14.5
            raise RuntimeError("engine died")
    path = os.path.join(tmp, "tl.json")
    n = st.export_file(path)
    with open(path) as f:
        exported = json.load(f)
    summaries = [st.request_summary(r) for r in ("r1", "r2", "r3", "missing")]
    traces = [st.chrome_trace(), st.chrome_trace(request_id="r1"),
              st.chrome_trace(pid_prefix="rep-", pid_base=10)]
    return (n, exported, summaries, traces, st.total_recorded, st.dropped,
            [_strip(e) for e in rec.events("obs_overflow")])


def _slo(m, tmp, monkeypatch):
    clk = FakeClock(1.0)
    reg = m.metrics.MetricsRegistry()
    slo = m.slo.SloTracker(ttft_target_ms=100.0, tpot_target_ms=20.0, registry=reg, clock=clk)
    met = []
    for i, (ttft, tpot) in enumerate([(0.05, 0.01), (0.2, 0.01), (0.05, 0.05), (None, 0.01),
                                      (0.09, None)]):
        clk.t = 1.0 + 7.0 * i
        met.append(slo.observe_request(ttft_s=ttft, tpot_s=tpot, queue_wait_s=0.01,
                                       n_tokens=10 + i, total_s=1.0,
                                       deadline_ms=500.0 if i == 4 else None))
        slo.note_tokens(3)
    monkeypatch.setattr(m.trace, "time", _fake_time(FakeClock(2.0)))
    span = m.trace.Tracer().span(request_id="s")
    span.mark_admitted()
    span.mark_first_token()
    span.finish("stop", n_prompt=3, n_completion=4)
    met.append(slo.observe_span(span))
    cancelled = m.trace.Tracer().span()
    cancelled.finish("cancelled")
    met.append(slo.observe_span(cancelled))
    snaps = []
    for t in (30.0, 65.0, 400.0):
        clk.t = t
        snaps.append(slo.snapshot())
    return met, snaps, reg.render()


def _series(m, tmp):
    reg = m.metrics.MetricsRegistry()
    rec = m.recorder.FlightRecorder()
    store = m.timeseries.SeriesStore(registry=reg, recorder=rec, interval_s=1.0,
                                     retention_s=120.0, max_series=6)
    clk = FakeClock(100.0)
    sampler = m.timeseries.MetricsSampler(store, registry=reg, clock=clk)
    c = reg.counter("dllama_t_c", "c")
    g = reg.gauge("dllama_t_g", "g", labelnames=("lane",))
    h = reg.histogram("dllama_t_h", "h")
    ticks = []
    sampler.on_sample.append(ticks.append)
    sampler.on_sample.append(lambda now: 1 / 0)  # contained
    reg.add_refresh_hook("live", lambda: g.labels(lane="0").set(clk.t))
    for i in range(40):
        clk.t = 100.0 + i
        c.inc(i % 3)
        h.observe(0.01 * (i % 7))
        if i == 20:
            for k in range(8):  # past max_series: new names drop, once
                reg.gauge(f"dllama_t_extra{k}", "x").set(k)
        sampler.sample_once()
    q = [store.query(n, w) for n in store.names() for w in (10.0, 300.0)]
    return (ticks, store.names(), q, store.latest("dllama_t_c"), store.latest("nope"),
            [_strip(e) for e in rec.events()], reg.render().count("\n"))


def _anomaly(m, tmp):
    reg = m.metrics.MetricsRegistry()
    store = m.timeseries.SeriesStore(registry=reg, recorder=m.recorder.FlightRecorder(),
                                     interval_s=1.0)
    rec = m.recorder.FlightRecorder()
    clk = FakeClock()
    mon = m.anomaly.AnomalyMonitor(m.anomaly.build_default_rules(store), registry=reg,
                                   recorder=rec, clock=clk)
    stall_sum = stall_n = ttft_sum = ttft_n = 0.0
    free = 10_000.0
    fired, statuses = [], []
    for i in range(90):
        t = float(i)
        clk.t = t
        spike = 40 <= i < 44  # decode stalls and TTFT spike, then recover
        drain = 60 <= i < 66  # the KV free list drains fast
        stall_sum += (2.0 if spike else 0.01 + 0.001 * (i % 5)) * 4
        stall_n += 4
        ttft_sum += 3.0 if spike else 0.1 + 0.01 * (i % 3)
        ttft_n += 1
        free -= 400.0 if drain else 1.0
        store.record(t, {
            "dllama_decode_stall_seconds_sum": ("counter", stall_sum),
            "dllama_decode_stall_seconds_count": ("counter", stall_n),
            "dllama_ttft_seconds_sum": ("counter", ttft_sum),
            "dllama_ttft_seconds_count": ("counter", ttft_n),
            "dllama_kv_pages_free": ("gauge", free),
        })
        fired.append(mon.evaluate(now=t + 0.5))
        statuses.append((mon.degraded, mon.active_signals()))
    return (fired, statuses, [_strip(e) for e in rec.events()], reg.render(),
            [r.signal for r in m.anomaly.build_default_rules(store)],
            m.anomaly.DEFAULT_SIGNAL_SERIES)


def _watchdog(m, tmp):
    out = []
    for rule in ("dispatch-hung", "scheduler-stalled", "decode-stalled", "admission-stalled"):
        clk = FakeClock()
        reg = m.metrics.MetricsRegistry()
        rec = m.recorder.FlightRecorder(postmortem_dir=os.path.join(tmp, rule))
        wd = m.watchdog.EngineWatchdog(dispatch_timeout_s=30.0, stall_factor=20.0,
                                       min_stall_s=5.0, block_p99=lambda: 0.5, clock=clk,
                                       registry=reg, recorder=rec)
        seq = []
        for t in range(0, 80, 3):
            clk.t = float(t)
            if rule == "dispatch-hung":
                if t == 0:
                    wd.beat(n_active=0)
                    wd.dispatch_begin("decode_lanes")
                if t == 45:
                    wd.dispatch_end()
                    wd.beat(n_active=0)
            elif rule == "scheduler-stalled":
                if t in (0, 48):
                    wd.beat(n_active=2)
                if t == 51:
                    wd.beat(n_active=0)
            elif rule == "decode-stalled":
                wd.beat(n_active=1)
                if t < 12 or t > 30:
                    wd.dispatch_begin("decode_lanes")
                    wd.dispatch_end()
            else:
                wd.beat(n_admitting=1 if t < 60 else 0)
                if t in (3, 45):
                    wd.dispatch_begin("prefill_lane_chunk")
                    wd.dispatch_end()
            seq.append((t, wd.check_once(), wd.degraded))
        out.append((seq, {k: v for k, v in wd.status().items() if k != "stalled_since_s"},
                     reg.render(), [_strip(e) for e in rec.events()],
                     len(os.listdir(os.path.join(tmp, rule)))))
    return out


def _knobs(m, tmp, monkeypatch):
    out = []
    for env in ({}, {"DLLAMA_SLO_TTFT_MS": "250", "DLLAMA_SLO_TPOT_MS": "40",
                     "DLLAMA_SERIES_RETENTION_S": "120", "DLLAMA_SERIES_INTERVAL_S": "0.5",
                     "DLLAMA_WATCHDOG_INTERVAL_S": "2", "DLLAMA_WATCHDOG_DISPATCH_TIMEOUT_S": "9",
                     "DLLAMA_WATCHDOG_STALL_FACTOR": "3", "DLLAMA_WATCHDOG_MIN_STALL_S": "1"}):
        for k in ("DLLAMA_SLO_TTFT_MS", "DLLAMA_SLO_TPOT_MS", "DLLAMA_SERIES_RETENTION_S",
                  "DLLAMA_SERIES_INTERVAL_S", "DLLAMA_WATCHDOG_INTERVAL_S",
                  "DLLAMA_WATCHDOG_DISPATCH_TIMEOUT_S", "DLLAMA_WATCHDOG_STALL_FACTOR",
                  "DLLAMA_WATCHDOG_MIN_STALL_S"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out.append((m.slo.resolve_slo_knobs(), m.slo.resolve_slo_knobs(50.0, None),
                    m.timeseries.resolve_series_knobs(),
                    m.timeseries.resolve_series_knobs(60.0),
                    m.watchdog.resolve_watchdog_knobs()))
    return out


def _dashboard(m, tmp):
    return m.dashboard.DASHBOARD_HTML, m.dashboard.render_dashboard(), \
        m.dashboard.DASHBOARD_CONTENT_TYPE


SCENARIOS = {
    "metrics": _metrics, "recorder": _recorder, "trace": _trace, "spans": _spans,
    "slo": _slo, "series": _series, "anomaly": _anomaly, "watchdog": _watchdog,
    "knobs": _knobs, "dashboard": _dashboard,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_copy_matches_jax_twin(name, tmp_path, monkeypatch):
    fn = SCENARIOS[name]
    outs = []
    for label, m in (("jax", JAX), ("port", PORT)):
        tmp = str(tmp_path / label)
        os.makedirs(tmp)
        args = (monkeypatch,) if "monkeypatch" in fn.__code__.co_varnames[:3] else ()
        outs.append(fn(m, tmp, *args))
    assert outs[0] == outs[1]


def test_anomaly_scenario_fires_and_recovers():
    """The scenario the twins are held to does exercise the rules: the
    stall and TTFT spike fire and recover, the drain fires kv_free_slope."""
    fired, statuses = _anomaly(PORT, None)[:2]
    flat = [s for tick in fired for s in tick]
    assert {"decode_stall", "ttft", "kv_free_slope"} <= set(flat)
    assert statuses[-1] == (False, [])


def test_watchdog_scenario_fires_each_rule():
    """Each of the four stall rules trips once in its schedule and clears."""
    for rule, (seq, *_rest, n_postmortems) in zip(
            ("dispatch-hung", "scheduler-stalled", "decode-stalled", "admission-stalled"),
            _watchdog(PORT, _tmpdir())):
        reasons = [r for _, r, _ in seq]
        assert rule in reasons, (rule, reasons)
        assert reasons[-1] is None and n_postmortems == 1


def _tmpdir():
    import tempfile

    return tempfile.mkdtemp(prefix="obs-wd-")


def test_package_exports_the_jax_all():
    assert pobs.__all__ == jobs.__all__
    for name in pobs.__all__:
        assert hasattr(pobs, name), name


def test_singletons_are_the_ports_own():
    assert p_metrics.get_registry() is not j_metrics.get_registry()
    assert p_recorder.get_recorder() is not j_recorder.get_recorder()
    assert p_spans.get_span_tracker() is not j_spans.get_span_tracker()
    assert isinstance(p_metrics.get_registry(), p_metrics.MetricsRegistry)


# -- cost --------------------------------------------------------------------

ROOF_CASES = [(8e9, 0.01, 3.35e12), (1.0, 1e-6, 2e12), (0.0, 1.0, 1e12), (5e9, 0.0, 1e12),
              (5e9, 1.0, None), (5e9, 1.0, 0.0), (-1.0, 1.0, 1e12)]


@pytest.mark.parametrize("args", ROOF_CASES)
def test_roofline_fraction_and_step_seconds_match_jax(args):
    assert p_cost.roofline_fraction(*args) == j_cost.roofline_fraction(*args)
    b, _, peak = args
    assert p_cost.analytic_step_seconds(b, peak) == j_cost.analytic_step_seconds(b, peak)
    assert p_cost.analytic_step_seconds(None, peak) == j_cost.analytic_step_seconds(None, peak)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_cost")
    out = {}
    # dims that a 64-group divides, so q40i8 has a group on both models
    dense = dict(TINY, dim=128, hidden_dim=256, n_heads=4, n_kv_heads=2, head_dim=32)
    moe = dict(TINY_MOE, dim=128, n_heads=4, n_kv_heads=2, head_dim=32, moe_hidden_dim=64)
    for name, arch, cfg in (("dense", LlmArch.LLAMA, dense), ("moe", LlmArch.QWEN3_MOE, moe)):
        out[name] = str(d / f"{name}.m")
        make_tiny_model(out[name], arch=arch, weight_type=FloatType.Q40, cfg=cfg)
    return out


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("fmt", ["q40", "q40i4", "q40i8", "dense"])
def test_weight_bytes_per_token_equals_param_tensors(tiny_files, model, fmt):
    reader = ModelReader(tiny_files[model])
    h = reader.header
    dtype = torch.bfloat16
    params = load_params(reader, dtype=dtype, device="cpu",
                         weight_format="q40" if fmt == "q40i8" else fmt)
    group = 512
    if fmt == "q40i8":
        group = pick_group(h)
        params = requantize_params(params, h, group)
    got = p_cost.weight_bytes_per_token(h, fmt, group, dtype_bytes=2)
    want = p_cost.weight_bytes_per_token(h, fmt, group, params=params)
    assert got == want
    # the tensors, summed by hand: non-expert matmuls, gates, the active
    # experts' share and the classifier
    nb = p_cost.nbytes
    total = nb(params["wcls"])
    for lp in params["layers"]:
        total += sum(nb(lp[k]) for k in ("wq", "wk", "wv", "wo"))
        ffn = sum(nb(lp[k]) for k in ("w1", "w2", "w3"))
        total += nb(lp["moe_gate"]) + ffn * h.n_active_experts // h.n_experts if h.is_moe else ffn
    assert want == total
    rep = p_cost.roofline_report(h, fmt, i8_group=group, params=params)
    assert rep["weight_bytes_per_token_per_chip"] == total
    assert rep["hbm_peak_bytes_per_s"] is None and rep["min_ms_per_token"] is None


def test_q40_is_not_the_jax_byte_count(tiny_files):
    """The port stores f16 Q40 scales (1.0625 B a weight), not JAX's f32
    ones (1.125 B): the counts differ by the scales' share."""
    h = ModelReader(tiny_files["dense"]).header
    port = p_cost.weight_bytes_per_token(h, "q40")
    jax_ = j_cost.weight_bytes_per_token(h, "q40")
    assert port == pytest.approx(jax_ * 1.0625 / 1.125, rel=1e-6)


@pytest.mark.parametrize("name, peaks", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 989e12, 1979e12)),
    ("NVIDIA H100 PCIe", (2.0e12, None, None)),
    ("NVIDIA H100 NVL", (3.9e12, None, None)),
    ("NVIDIA A100-SXM4-80GB", (None, None, None)),
])
def test_card_peaks_by_name(monkeypatch, name, peaks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    got = (p_cost.hbm_peak_bytes_per_s(), p_cost.bf16_peak_flops(0), p_cost.int8_peak_ops(0))
    assert got == peaks
    # a CPU device never reads the card
    assert p_cost.hbm_peak_bytes_per_s(torch.device("cpu")) is None


def test_roofline_report_and_print_on_cpu(tiny_files, capsys):
    h = ModelReader(tiny_files["dense"]).header
    rep = p_cost.print_roofline_report(h, "q40", spec_k=4, device="cpu")
    want = j_cost.roofline_report(h, "q40", spec_k=4)
    assert rep.keys() == want.keys()
    assert rep["spec_tokens_per_pass_ceiling"] == want["spec_tokens_per_pass_ceiling"] == 5.0
    out = capsys.readouterr().out
    assert "Roofline" in out and "no tok/s ceiling" in out and "Speculation" in out


def test_step_cost_model_counts_weights_and_kv(tiny_files):
    reader = ModelReader(tiny_files["dense"])
    h = reader.header
    params = load_params(reader, dtype=torch.float32, device="cpu", weight_format="q40")
    model = p_cost.StepCostModel(h, params, 4, False)
    w = p_cost.param_bytes(params, h)
    row = 2 * h.n_kv_heads * h.head_dim * 4
    assert p_cost.kv_row_bytes(h, 4, False) == row
    assert p_cost.kv_row_bytes(h, 1, True) == 2 * h.n_kv_heads * (h.head_dim + 4)
    # a lane prefill chunk reads no classifier; a decode block of 3 reads
    # the weights 3 times and the KV rows it attends
    flops, nb = model.forward(8, 0, 8, 8, 36)
    assert nb == w["layers"] + h.n_layers * row * 16
    flops3, nb3 = model.forward(3, 3, 6, 3, 6, n=3)
    assert nb3 == 3 * (w["layers"] + w["cls"]) + h.n_layers * row * 9
    assert flops3 > 0 and flops > 0


# -- device ------------------------------------------------------------------


def test_cpu_device_reports_unavailable():
    (s,) = p_device.device_memory_stats("cpu")
    assert s == {"device": "cpu", "platform": "cpu", "available": False}
    reg = p_metrics.MetricsRegistry()
    assert p_device.sample_device_memory(reg, "cpu") == [s]
    assert "dllama_device_bytes_in_use" in reg.render()
    assert "dllama_device_bytes_in_use{" not in reg.render()  # no sample set
    assert p_device.compare_with_analytic(123, [s]) == j_device.compare_with_analytic(123, [s])


@pytest.mark.parametrize("used", [1000, 1099, 1101, 850])
def test_compare_with_analytic_warns_past_ten_percent(caplog, used):
    stats = [{"device": "cuda:0", "platform": "cuda", "available": True, "bytes_in_use": used,
              "peak_bytes_in_use": used, "bytes_limit": 8000}]
    with caplog.at_level(logging.WARNING):
        got = p_device.compare_with_analytic(1000, stats)
    assert got == j_device.compare_with_analytic(1000, stats)
    warned = any("diverges from the analytic report" in r.getMessage() for r in caplog.records
                 if r.name == p_device.__name__)
    assert warned == (abs(used - 1000) > 100)
    assert p_device.DIVERGENCE_WARN_FRACTION == j_device.DIVERGENCE_WARN_FRACTION == 0.10
