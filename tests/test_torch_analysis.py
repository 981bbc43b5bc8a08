"""dlint of the port (dllama_tpu_torch/analysis/) against the JAX package's.

* Each rule the two packages share gives the JAX rule's findings (rule,
  line, message) on the same sources: the fixtures in tests/fixtures/dlint/
  (read, not edited) and port fixtures written to tmp_path; each fires on
  its bad fixture and stays quiet on its good one.
* capture-purity (the port's trace-purity) fires on a bad capture fixture
  and stays quiet on a good one, the kernel wrappers' launch counters
  included.
* The docs rules read README.md's lists of what the port leaves out.
* The CLI: suppressions, the baseline round trip, ``--prune``,
  ``--rules``, the exit codes, and the port lints clean with its own
  (empty) baseline.
* What the guarded-attrs findings in parallel/control.py asked: every send
  on the control group happens under the controller's lock.
"""

import json
import pathlib
import subprocess
import sys
import time
import types

import pytest

from dllama_tpu.analysis import rules_clock as j_clock
from dllama_tpu.analysis import rules_dashboard as j_dashboard
from dllama_tpu.analysis import rules_env as j_env
from dllama_tpu.analysis import rules_except as j_except
from dllama_tpu.analysis import rules_kv as j_kv
from dllama_tpu.analysis import rules_locks as j_locks
from dllama_tpu.analysis import rules_metrics as j_metrics
from dllama_tpu.analysis import rules_threads as j_threads
from dllama_tpu.analysis.core import collect_repo as j_collect
from dllama_tpu.analysis.core import run_rules as j_run
from dllama_tpu_torch.analysis import all_rules
from dllama_tpu_torch.analysis import rules_clock, rules_dashboard, rules_env, rules_except
from dllama_tpu_torch.analysis import rules_kv, rules_locks, rules_metrics, rules_threads
from dllama_tpu_torch.analysis.core import (
    BASELINE_NAME,
    Finding,
    apply_baseline,
    collect_repo,
    load_baseline,
    run_rules,
    write_baseline,
)
from dllama_tpu_torch.analysis.rules_capture import CapturePurityRule

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXDIR = "tests/fixtures/dlint"
CLI = [sys.executable, "-m", "dllama_tpu_torch.analysis"]

# (JAX rule, the port's) of every rule the packages share
SHARED = {
    "guarded-attrs": (j_locks.GuardedAttrsRule, rules_locks.GuardedAttrsRule),
    "retain-release": (j_kv.RetainReleaseRule, rules_kv.RetainReleaseRule),
    "direct-clock": (j_clock.DirectClockRule, rules_clock.DirectClockRule),
    "thread-hygiene": (j_threads.ThreadHygieneRule, rules_threads.ThreadHygieneRule),
    "silent-except": (j_except.SilentExceptRule, rules_except.SilentExceptRule),
    "dashboard-static": (j_dashboard.DashboardStaticRule, rules_dashboard.DashboardStaticRule),
    "metrics-docs": (j_metrics.MetricsDocsRule, rules_metrics.MetricsDocsRule),
    "env-knob-docs": (j_env.EnvKnobDocsRule, rules_env.EnvKnobDocsRule),
}
FIXTURE_STEMS = {"guarded-attrs": "guarded_attrs", "retain-release": "retain_release",
                 "direct-clock": "direct_clock", "thread-hygiene": "thread_hygiene"}


def _triples(findings) -> list:
    return sorted((f.rule, f.line, f.message) for f in findings)


def _both(root, jax_targets, port_targets, name):
    """(the JAX rule's findings, the port rule's) over the same sources."""
    j_rule, p_rule = SHARED[name]
    jf, _ = j_run(j_collect(root, jax_targets), [j_rule()])
    pf, _ = run_rules(collect_repo(root, port_targets), [p_rule()])
    return jf, pf


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("name", sorted(FIXTURE_STEMS))
def test_shared_rule_gives_the_jax_findings_on_the_fixtures(name, kind):
    target = [f"{FIXDIR}/{kind}_{FIXTURE_STEMS[name]}.py"]
    jf, pf = _both(REPO_ROOT, target, target, name)
    assert _triples(pf) == _triples(jf)
    if kind == "bad":
        assert pf and all(f.rule == name for f in pf)
    else:
        assert pf == []


SILENT = '''\
def work(x):
    try:
        return x()
    except Exception:
        return None


def recorded(x, recorder):
    try:
        return x()
    except BaseException as e:
        recorder.record("failed", error=str(e))


def narrow(x):
    try:
        return x()
    except ValueError:
        return None


def bare(x):
    try:
        return x()
    except:  # noqa: E722
        pass
'''


def test_silent_except_gives_the_jax_findings_in_its_scope(tmp_path):
    for pkg in ("dllama_tpu", "dllama_tpu_torch"):
        for sub in ("runtime", "ops"):
            d = tmp_path / pkg / sub
            d.mkdir(parents=True)
            (d / "m.py").write_text(SILENT)
    jf, pf = _both(tmp_path, ["dllama_tpu"], ["dllama_tpu_torch"], "silent-except")
    assert _triples(pf) == _triples(jf)
    # the unguarded and the bare handler, in runtime/ only (ops/ is out of scope)
    assert [f.line for f in pf] == [4, 25]
    assert all(f.path == "dllama_tpu_torch/runtime/m.py" for f in pf)


def test_dashboard_static_gives_the_jax_findings_on_the_port_dashboard(tmp_path):
    page = (REPO_ROOT / "dllama_tpu_torch/obs/dashboard.py").read_text()
    bad = page + '\nEXTRA = """<script src="https://cdn.example/x.js"></script>"""\n'
    for text, want in ((page, 0), (bad, 2)):
        for pkg in ("dllama_tpu", "dllama_tpu_torch"):
            d = tmp_path / pkg / "obs"
            d.mkdir(parents=True, exist_ok=True)
            (d / "dashboard.py").write_text(text)
        jf, pf = _both(tmp_path, ["dllama_tpu"], ["dllama_tpu_torch"], "dashboard-static")
        assert _triples(pf) == _triples(jf)
        assert len(pf) == want


def _docs_repo(root: pathlib.Path, readme: str = "") -> None:
    for pkg in ("dllama_tpu", "dllama_tpu_torch"):
        (root / pkg).mkdir(exist_ok=True)
        (root / pkg / "m.py").write_text(
            'c = counter("dllama_documented_total", "d")\n'
            'g = gauge("dllama_undocumented_thing", "d")\n'
            'a = os.environ.get("DLLAMA_DOCUMENTED_KNOB", "0")\n'
            'b = _env_int(\n    "DLLAMA_UNDOCUMENTED_KNOB", 4)\n'
            'c = os.getenv("DLLAMA_FAM_MEMBER")\n'
            '# a comment naming DLLAMA_ONLY_IN_COMMENT is not a read site\n'
            'os.environ.setdefault("DLLAMA_SETDEFAULT_ONLY", "1")\n'
        )
    (root / "docs").mkdir(exist_ok=True)
    (root / "docs" / "serving_metrics.md").write_text(
        "`dllama_documented_total` — fine\n"
        "`dllama_phantom_metric` — registered nowhere\n"
        "`dllama_left_out_total` — the JAX package's alone\n"
        "`dllama_no_reason_total` — listed below with no reason\n"
    )
    (root / "README.md").write_text(
        "Set `DLLAMA_DOCUMENTED_KNOB` to tune things.\n"
        "`DLLAMA_PHANTOM_KNOB` — documented, read nowhere.\n"
        "The `DLLAMA_FAM_*` family covers its members.\n"
        "The `DLLAMA_GHOSTFAM_*` family matches no read at all.\n" + readme
    )


@pytest.mark.parametrize("name", ["metrics-docs", "env-knob-docs"])
def test_docs_rules_give_the_jax_findings_both_directions(tmp_path, name):
    _docs_repo(tmp_path)
    jf, pf = _both(tmp_path, ["dllama_tpu"], ["dllama_tpu_torch"], name)
    assert [(r, m.replace("dllama_tpu_torch/", "dllama_tpu/")) for r, _, m in _triples(pf)] \
        == [(r, m) for r, _, m in _triples(jf)]
    assert [f.line for f in pf] == [f.line for f in sorted(
        jf, key=lambda f: (f.path, f.line, f.rule, f.message))]
    msgs = " ".join(f.message for f in pf)
    if name == "metrics-docs":
        assert "dllama_undocumented_thing" in msgs and "dllama_phantom_metric" in msgs
        assert "dllama_documented_total" not in msgs
    else:
        assert "DLLAMA_UNDOCUMENTED_KNOB is read here" in msgs
        assert "DLLAMA_PHANTOM_KNOB is documented but read nowhere" in msgs
        assert len(pf) == 3


LEFT_OUT = """
#### Metric families the port leaves out

- `dllama_phantom_metric`, `dllama_left_out_total`: the JAX package's alone.
- `dllama_documented_total`: a claim the port's registration contradicts.
- `dllama_never_named_total`: no doc names it.
- `dllama_no_reason_total`

#### Env knobs the port leaves out

- `DLLAMA_PHANTOM_KNOB`, `DLLAMA_GHOSTFAM_*`: read by the JAX package alone.
- `DLLAMA_DOCUMENTED_KNOB`: a claim the port's read contradicts.

## Next
- `dllama_after_the_list_total`: past the list's end, not on it.
"""


def test_docs_rules_read_the_readme_left_out_lists(tmp_path):
    _docs_repo(tmp_path, LEFT_OUT)
    repo = collect_repo(tmp_path, ["dllama_tpu_torch"])
    out = rules_metrics.left_out(repo, rules_metrics.LEFT_OUT_HEADING)
    assert set(out) == {"dllama_phantom_metric", "dllama_left_out_total",
                        "dllama_documented_total", "dllama_never_named_total",
                        "dllama_no_reason_total"}
    assert out["dllama_no_reason_total"][1] == ""
    mf, _ = run_rules(repo, [rules_metrics.MetricsDocsRule()])
    msgs = [f.message for f in mf]
    # the listed phantoms are no longer findings; the list's own faults are
    assert not any("dllama_phantom_metric is documented" in m for m in msgs)
    assert not any("dllama_left_out_total" in m for m in msgs)
    assert "metric dllama_documented_total is listed as left out but the port has it" in msgs
    assert ("metric dllama_never_named_total is listed as left out but "
            "docs/serving_metrics.md never names it") in msgs
    assert "metric dllama_no_reason_total is listed as left out with no reason" in msgs
    assert all(f.path == "README.md" for f in mf if "listed as left out" in f.message)
    ef, _ = run_rules(repo, [rules_env.EnvKnobDocsRule()])
    msgs = [f.message for f in ef]
    assert not any("DLLAMA_PHANTOM_KNOB is documented" in m for m in msgs)
    assert not any("DLLAMA_GHOSTFAM_" in m for m in msgs)
    assert "env knob DLLAMA_DOCUMENTED_KNOB is listed as left out but the port has it" in msgs
    assert any("DLLAMA_UNDOCUMENTED_KNOB is read here" in m for m in msgs)


BAD_CAPTURE = '''\
import time

import torch


class Engine:
    def _helper(self, x):
        return x.item()

    def decode(self, key, b):
        def block():
            t0 = time.monotonic()
            self.last = self._helper(b["x"])
            self.obs_steps.inc()
            print("captured")
            host = torch.tensor([1, 2, 3], device="cuda")
            self.stats.calls += 1
            b["out"].copy_(host)

        self.graphs.run(key, block)
        self.graphs.run(key, lambda: b["y"].cpu())

    def record(self, pool, step):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool):
            with self._lock:
                step()
            torch.cuda.synchronize()
'''

GOOD_CAPTURE = '''\
import time

import torch


def qmatmul(x, w):
    qmatmul.launches += 1  # the wrappers' counters: StepGraphs settles them
    return x @ w


qmatmul.launches = 0


class Engine:
    def _forward(self, x, w):
        return qmatmul(x, w)

    def decode(self, key, b, w):
        def block():
            b["out"].copy_(self._forward(b["x"], w))

        t0 = time.monotonic()  # outside the captured body
        self.graphs.run(key, block)
        self.graphs.run(key, lambda: self._forward(b["x"], w))
        subprocess_like = self.runner.run(key, print)  # not a graphs receiver
        return b["out"].tolist(), time.monotonic() - t0, subprocess_like
'''


def _capture_findings(tmp_path, text):
    (tmp_path / "m.py").write_text(text)
    findings, _ = run_rules(collect_repo(tmp_path, ["m.py"]), [CapturePurityRule()])
    return findings


def test_capture_purity_fires_on_host_side_effects_under_capture(tmp_path):
    findings = _capture_findings(tmp_path, BAD_CAPTURE)
    assert all(f.rule == "capture-purity" for f in findings)
    by_line = {f.line: f.message for f in findings}
    assert "time.monotonic() inside captured block()" in by_line[12]
    assert "self.last mutated inside captured block()" in by_line[13]
    assert "x.item() inside captured _helper()" in by_line[8]  # reached through self
    assert "self.obs_steps.inc()" in by_line[14]
    assert "print()" in by_line[15]
    assert "torch.tensor()" in by_line[16]
    assert "self.stats.calls updated" in by_line[17]
    assert "b['y'].cpu() inside captured the lambda that decode() captures" in by_line[21]
    assert "lock acquisition (self._lock) inside captured the torch.cuda.graph body " \
           "in record()" in by_line[26]
    assert "torch.cuda.synchronize()" in by_line[28]
    # messages carry no line numbers: fingerprints survive edits
    assert not any(str(f.line) in f.message for f in findings)


def test_capture_purity_quiet_on_pure_captures_and_the_launch_counters(tmp_path):
    assert _capture_findings(tmp_path, GOOD_CAPTURE) == []
    # the exemption is the counter's name alone: another counter fires
    bad = GOOD_CAPTURE.replace("qmatmul.launches += 1", "qmatmul.calls += 1")
    findings = _capture_findings(tmp_path, bad)
    assert [f.message.split(" inside")[0] for f in findings] == ["qmatmul.calls updated"]


def test_inline_suppression_counts_and_silences():
    repo = collect_repo(REPO_ROOT, [f"{FIXDIR}/good_guarded_attrs.py"])
    findings, n_suppressed = run_rules(repo, [rules_locks.GuardedAttrsRule()])
    assert findings == [] and n_suppressed == 1


def test_baseline_roundtrip_and_staleness(tmp_path):
    f1 = Finding(rule="r", path="a.py", line=3, message="m1")
    f2 = Finding(rule="r", path="a.py", line=9, message="m2")
    bp = tmp_path / "baseline.json"
    write_baseline(bp, [f1])
    new, old, stale = apply_baseline([f1, f2], load_baseline(bp) | {"r::gone.py::x"})
    assert [f.message for f in new] == ["m2"] and [f.message for f in old] == ["m1"]
    assert stale == {"r::gone.py::x"}
    assert Finding(rule="r", path="a.py", line=33, message="m1").fingerprint() == f1.fingerprint()
    assert "dllama_tpu_torch.analysis --update-baseline" in json.loads(bp.read_text())["comment"]


def test_default_targets_are_the_port():
    repo = collect_repo(REPO_ROOT)
    rels = {m.rel for m in repo.modules}
    assert "chip_smoke.py" in rels and "dllama_tpu_torch/runtime/engine.py" in rels
    assert any(r.startswith("scripts/torch_") for r in rels)
    assert not any(r.startswith(("dllama_tpu/", "tests/")) or r == "bench.py" for r in rels)
    assert not repo.parse_errors


def test_cli_baseline_prune_rules_and_exit_codes(tmp_path):
    bad = f"{FIXDIR}/bad_guarded_attrs.py"
    bp = tmp_path / "baseline.json"

    def cli(*args):
        return subprocess.run(CLI + list(args), cwd=REPO_ROOT, capture_output=True, text=True,
                              timeout=120)

    proc = cli("--update-baseline", "--baseline", str(bp), bad)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    real = json.loads(bp.read_text())["findings"]
    assert real
    # baselined: exit 0; a stale fingerprint is reported, then pruned away
    doc = json.loads(bp.read_text())
    doc["findings"] = sorted(real + ["ghost-rule::gone.py::never"])
    bp.write_text(json.dumps(doc))
    proc = cli("--baseline", str(bp), bad)
    assert proc.returncode == 0 and "1 stale baseline entry" in proc.stdout
    proc = cli("--prune", "--baseline", str(bp), bad)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(bp.read_text())["findings"] == sorted(real)
    # new findings: exit 1, and --rules narrows the run
    proc = cli("--no-baseline", "--rules", "guarded-attrs,direct-clock", bad)
    assert proc.returncode == 1 and "[guarded-attrs]" in proc.stdout
    assert "2 rules" in proc.stdout
    proc = cli("--rules", "nope")
    assert proc.returncode == 2 and "unknown rule(s): nope" in proc.stderr
    proc = cli("--list-rules")
    assert proc.returncode == 0
    assert [line.split()[0] for line in proc.stdout.splitlines()] == [r.name for r in all_rules()]


def test_port_lints_clean():
    """The acceptance gate: `python -m dllama_tpu_torch.analysis` exits 0 on
    the tree, with the port's own baseline empty."""
    assert json.loads((REPO_ROOT / BASELINE_NAME).read_text())["findings"] == []
    proc = subprocess.run(CLI + ["--no-baseline"], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s), 0 baselined" in proc.stdout


def test_controller_broadcasts_only_under_its_lock(monkeypatch):
    """The guarded-attrs findings in parallel/control.py: every send on the
    control group (a dispatch's command, its tape's first device work, a
    heartbeat, stop) happens while the controller's lock is held, so the
    heartbeat thread and a dispatch never broadcast on the group at once
    (`_send_pending_locked`)."""
    from dllama_tpu_torch.parallel import control

    owned: list = []
    sent: list = []

    def broadcast(objs, src, group):
        owned.append(ctl._lock._is_owned())
        sent.append(objs[0].name)

    monkeypatch.setattr(control, "control_group", lambda timeout_s: None)
    monkeypatch.setattr(control.dist, "broadcast_object_list", broadcast)

    class Engine:
        temperature, sampler, tape = 0.0, types.SimpleNamespace(topp=0.9), None

        def __getattr__(self, name):  # every leaf dispatch: device work, then a result
            if name not in control.DISPATCHES:
                raise AttributeError(name)

            def dispatch(*args, **kwargs):
                if self.tape is not None:
                    self.tape.launch()
                return None
            return dispatch

    engine = Engine()
    ctl = control.Controller(engine, types.SimpleNamespace(rank=0), timeout_s=0.4)
    engine.decode_block(1, 0, 8)  # sends at the tape's launch
    engine.set_seed(3)  # host state only: sent once it returned
    deadline = time.monotonic() + 5
    while "heartbeat" not in sent and time.monotonic() < deadline:
        time.sleep(0.02)
    summary = ctl.stop()
    assert sent[:2] == ["decode_block", "set_seed"] and "heartbeat" in sent
    assert sent[-1] == "stop" and summary["commands"] == 2
    assert owned and all(owned)
