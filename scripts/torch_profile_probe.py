#!/usr/bin/env python3
"""Where a ``torch.profiler`` stop and export spend their time, and how long
each holds the interpreter, under a graph-replaying thread.

    python3 scripts/torch_profile_probe.py      # on a machine with a CUDA card (CPU: host ops)

A "scheduler" thread replays a CUDA graph of ``N_K`` (env, default 2000)
small kernels and reads one value back, in a loop, as the lane server's
scheduler does with its decode blocks; a ticker thread sleeps 0.5 ms a
turn. Each trial starts the profiler (CPU and CUDA activity) on the
scheduler thread between two steps, profiles 1 s, stops it there, then on
the main thread exports the trace with ``export_chrome_trace``, takes the
profiler's events (``kineto_results.events()``) and writes them with the
lane server's `write_chrome_trace` (a Python loop over the events). One
JSON line a trial: the stop's seconds and the scheduler's longest step gap
during it, the same for the export, the ``events()`` call and the Python
writer (and the steps the scheduler took during the writer), the event
counts, the launch-to-kernel flows the writer linked, and the events by
host or device and name prefix, with a name of each.

Trials: the default config, ``profile_all_threads``,
``disable_external_correlation``, both; ``cuda_off_early`` (CUDA activity
toggled off on the scheduler thread a quarter into the window: fewer
device records for the stop to convert); ``metadata``
(``expose_kineto_event_metadata``: each kernel's launch metadata, one
sample printed); ``trace_only`` where this torch has it (no Python
events are built at the stop; only the exports work, so the Python writer
is skipped). Traces go to a temporary directory that is removed.

Every trial starts and stops on the replaying thread: a stop from another
thread while it replays has deadlocked inside CUDA (torch 2.11).
"""

import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from dllama_tpu_torch.runtime.api_server import write_chrome_trace  # noqa: E402

N_K = int(os.environ.get("N_K", "2000"))
DEV = "cuda" if torch.cuda.is_available() else "cpu"
XS = [torch.zeros(64, device=DEV) for _ in range(8)]


def body():
    for i in range(N_K):
        XS[i % 8].add_(1.0)


GRAPH = None


def step():
    with record_function("probe.sched_step"):
        if GRAPH is not None:
            GRAPH.replay()
        else:
            body()
        XS[0][0].item()


def _kinds(events) -> dict:
    """Events by host or device and a name's first six characters: a count
    and a name."""
    out: dict = collections.OrderedDict()
    for e in events:
        key = f"{'host' if e.device_type() == DeviceType.CPU else 'device'}:{e.name()[:6]}"
        if key not in out:
            out[key] = [0, e.name()[:60]]
        out[key][0] += 1
    return out


def trial(label: str, out_dir: str, cfg_kw: dict | None = None, window: float = 1.0,
          cuda_off_at: float | None = None) -> dict:
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEV == "cuda" else [])
    kw = {"experimental_config": _ExperimentalConfig(**cfg_kw)} if cfg_kw else {}
    prof = profile(activities=acts, **kw)
    ticks, req, gaps, quit_, stop_ev, marks = [], [], [], [False], threading.Event(), {}

    def ticker():
        while not stop_ev.is_set():
            ticks.append(time.perf_counter())
            time.sleep(0.0005)

    def sched():
        last = time.perf_counter()
        while True:
            while req:
                fn, ev = req.pop(0)
                fn()
                ev.set()
            if quit_[0]:
                break
            step()
            now = time.perf_counter()
            gaps.append((last, now))
            last = now

    def on_sched(fn):
        ev = threading.Event()
        req.append((fn, ev))
        ev.wait()

    def stop():
        t0 = time.perf_counter()
        prof.stop()
        marks["stop"] = (t0, time.perf_counter())

    sched_t = threading.Thread(target=sched, daemon=True, name="dllama-probe-sched")
    ticker_t = threading.Thread(target=ticker, daemon=True, name="dllama-probe-ticker")
    sched_t.start()
    ticker_t.start()
    time.sleep(0.3)
    on_sched(prof.start)
    if cuda_off_at is not None and DEV == "cuda":
        time.sleep(window * cuda_off_at)
        on_sched(lambda: prof.toggle_collection_dynamic(False, [ProfilerActivity.CUDA]))
        time.sleep(window * (1 - cuda_off_at))
    else:
        time.sleep(window)
    on_sched(stop)
    time.sleep(0.3)
    path = os.path.join(out_dir, f"{label}.json")
    e0 = time.perf_counter()
    prof.export_chrome_trace(path)
    e1 = time.perf_counter()
    with open(path) as f:
        text = f.read()
    time.sleep(0.3)
    res = dict(label=label)
    if not (cfg_kw or {}).get("trace_only"):
        v0 = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        v1 = time.perf_counter()
        time.sleep(0.3)
        q0 = time.perf_counter()
        written = write_chrome_trace(events, path + ".py")
        q1 = time.perf_counter()
        meta = next((e.metadata_json() for e in events if e.device_type() != DeviceType.CPU
                     and hasattr(e, "metadata_json") and e.metadata_json()), "")
        res.update(events_s=round(v1 - v0, 4), py_events=written["n_events"],
                   py_flows=written["n_flows"], kinds=_kinds(events),
                   metadata_sample=meta[:300])
        del events
    time.sleep(0.3)
    quit_[0] = True
    sched_t.join()
    stop_ev.set()
    ticker_t.join()
    s0, s1 = marks["stop"]

    def sched_gap(a, b):
        return max((y - x for x, y in gaps if y > a and x < b), default=0.0)

    res.update(stop_s=round(s1 - s0, 4), stop_sched_gap_s=round(sched_gap(s0, s1), 4),
               export_s=round(e1 - e0, 4), export_sched_gap_s=round(sched_gap(e0, e1), 4),
               steps=len(gaps), kernels=text.count('"cat": "kernel"'),
               cpu_ops=text.count('"cat": "cpu_op"'), flows=text.count('"ph": "f"'))
    if "events_s" in res:
        res.update(events_sched_gap_s=round(sched_gap(v0, v1), 4),
                   py_export_s=round(q1 - q0, 4), py_export_sched_gap_s=round(sched_gap(q0, q1), 4),
                   py_export_sched_steps=sum(1 for _, y in gaps if q0 < y < q1))
    return res


def main() -> None:
    global GRAPH
    smi = "cpu"
    if DEV == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        body()
        torch.cuda.synchronize()
        GRAPH = torch.cuda.CUDAGraph()
        with torch.cuda.graph(GRAPH):
            body()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {DEV} {smi}", flush=True)
    print("KinetoEvent:", [m for m in dir(torch._C._autograd._KinetoEvent)
                           if not m.startswith("_")], flush=True)
    # CUPTI's first initialization, outside any trial
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if DEV == "cuda" else [])):
        step()
    trials = [("default", None, None), ("all_threads", dict(profile_all_threads=True), None),
              ("no_ext_corr", dict(disable_external_correlation=True), None),
              ("all_threads_no_ext_corr", dict(profile_all_threads=True,
                                               disable_external_correlation=True), None),
              ("cuda_off_early", None, 0.25),
              ("metadata", dict(expose_kineto_event_metadata=True), None)]
    try:
        _ExperimentalConfig(trace_only=True)
        trials.append(("trace_only", dict(trace_only=True), None))
    except TypeError:
        print(json.dumps({"label": "trace_only", "skipped": "not in this torch"}), flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        for label, cfg, off_at in trials:
            print(json.dumps(trial(label, out_dir, cfg, cuda_off_at=off_at)), flush=True)


if __name__ == "__main__":
    main()
