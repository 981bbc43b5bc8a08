"""Import hygiene of the PyTorch port: dllama_tpu_torch and chip_smoke.py
import with jax (and dllama_tpu) blocked, and their sources import neither."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

from helpers import REPO_ROOT

PKG = os.path.join(REPO_ROOT, "dllama_tpu_torch")


def _port_files():
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    import dllama_tpu_torch

    return ["dllama_tpu_torch"] + sorted(
        m.name
        for m in pkgutil.walk_packages(dllama_tpu_torch.__path__, "dllama_tpu_torch.")
        if not m.name.endswith("__main__")
    )


def test_port_imports_with_jax_blocked():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dllama_tpu'] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dllama_tpu' or m.startswith('dllama_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "dllama_tpu"), f"{path}: imports {n}"


def test_serving_slice_modules_are_covered():
    """The serving slice's copies (kv/, tokenizer/chat.py, the lane server)
    and the paged-KV helpers are among the modules checked above."""
    mods = _port_modules()
    for m in ("kv.pool", "kv.radix", "kv.manager", "tokenizer.chat", "runtime.api_server",
              "ops.kv_cache"):
        assert f"dllama_tpu_torch.{m}" in mods


def test_speculation_slice_modules_are_covered():
    """The speculation slice's copies (runtime/spec.py and the lockwatch it
    takes its lock from) are among the modules and files checked above."""
    mods, files = _port_modules(), _port_files()
    for m in ("runtime.spec", "analysis.lockwatch"):
        assert f"dllama_tpu_torch.{m}" in mods
        assert os.path.join(PKG, *m.split(".")) + ".py" in files


def test_resilience_slice_module_is_covered():
    """The resilience slice's copy (runtime/faults.py, the chaos plane) is
    among the modules and files checked above."""
    mods, files = _port_modules(), _port_files()
    assert "dllama_tpu_torch.runtime.faults" in mods
    assert os.path.join(PKG, "runtime", "faults.py") in files


def test_observability_slice_modules_are_covered():
    """The observability slice's copies and rewrites (obs/) are among the
    modules and files checked above, and the package imports without a
    card (no triton, no nvcc, no CUDA call at import)."""
    mods = _port_modules()
    files = _port_files()
    for m in ("anomaly", "cost", "dashboard", "device", "metrics", "recorder", "slo", "spans",
              "timeseries", "trace", "watchdog"):
        assert f"dllama_tpu_torch.obs.{m}" in mods
        assert os.path.join(PKG, "obs", f"{m}.py") in files
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dllama_tpu'] = None\n"
        "sys.modules['triton'] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: (_ for _ in ()).throw(AssertionError('cuda'))\n"
        "import dllama_tpu_torch.obs as obs\n"
        "assert all(hasattr(obs, n) for n in obs.__all__)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_admission_slice_module_is_covered():
    """The admission slice's copy (runtime/admission.py, the load
    predictor) is among the modules and files checked above, and imports
    with jax, dllama_tpu and torch all blocked: it is stdlib only."""
    mods, files = _port_modules(), _port_files()
    assert "dllama_tpu_torch.runtime.admission" in mods
    path = os.path.join(PKG, "runtime", "admission.py")
    assert path in files
    code = (
        "import importlib.util, sys\n"
        "for name in ('jax', 'dllama_tpu', 'torch', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"spec = importlib.util.spec_from_file_location('admission', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert mod.LoadPredictor and mod.effective_deadline_ms\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_slab_and_serialized_slice_modules_are_covered():
    """The modules the slab-lane and serialized-server slice touched (the
    manager's slab mode, the slab copies in ops/kv_cache.py, the engine, the
    model, the server with its NaiveCache, the CLI) are among the modules
    and files checked above, and the server's batch-1 and slab pieces import
    with jax, dllama_tpu and triton blocked and no card asked for."""
    mods, files = _port_modules(), _port_files()
    for m in ("kv.manager", "ops.kv_cache", "runtime.engine", "models.transformer",
              "runtime.api_server", "cli"):
        assert f"dllama_tpu_torch.{m}" in mods
        assert os.path.join(PKG, *m.split(".")) + ".py" in files
    code = (
        "import sys\n"
        "for name in ('jax', 'dllama_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: (_ for _ in ()).throw(AssertionError('cuda'))\n"
        "from dllama_tpu_torch.runtime.api_server import NaiveCache, resolve_kv_knobs\n"
        "from dllama_tpu_torch.ops.kv_cache import pages_to_rows, rows_to_pages, kv_lane\n"
        "assert NaiveCache().probe([]) == 0 and resolve_kv_knobs(8, 0, False)[0] == 8\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


FLEET_MODULES = ("affinity", "replicas", "obs", "router", "launch")


def test_fleet_slice_modules_are_covered():
    """The fleet slice's six files (fleet/__init__.py and its five modules)
    are among the modules and files checked above; the package, its router
    and its launcher import with jax, dllama_tpu and triton blocked and no
    card asked for; and the affinity module is stdlib only (it imports with
    torch blocked as well)."""
    mods, files = _port_modules(), _port_files()
    assert "dllama_tpu_torch.fleet" in mods
    assert os.path.join(PKG, "fleet", "__init__.py") in files
    for m in FLEET_MODULES:
        assert f"dllama_tpu_torch.fleet.{m}" in mods
        assert os.path.join(PKG, "fleet", m + ".py") in files
    code = (
        "import sys\n"
        "for name in ('jax', 'dllama_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: (_ for _ in ()).throw(AssertionError('cuda'))\n"
        "import dllama_tpu_torch.fleet as fleet\n"
        "from dllama_tpu_torch.fleet.launch import launch_inprocess_fleet, main\n"
        "from dllama_tpu_torch.fleet.router import serve_router, main as router_main\n"
        "assert fleet.HashRing and fleet.ReplicaRegistry and fleet.RouterState\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    path = os.path.join(PKG, "fleet", "affinity.py")
    code = (
        "import importlib.util, sys\n"
        "for name in ('jax', 'dllama_tpu', 'torch', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"spec = importlib.util.spec_from_file_location('affinity', {path!r})\n"
        "mod = sys.modules['affinity'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert mod.HashRing(['r0']).order(mod.prefix_affinity_key([1, 2])) == ['r0']\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


PARALLEL_MODULES = ("mesh", "collectives", "sharding", "ring_attention", "launch")


def test_parallel_slice_modules_are_covered():
    """The parallel slice's files (parallel/__init__.py, its five modules and
    utils/telemetry.py) are among the modules and files checked above; the
    package, the launcher and the telemetry import with jax, dllama_tpu and
    triton blocked and no card asked for."""
    mods, files = _port_modules(), _port_files()
    assert "dllama_tpu_torch.parallel" in mods and "dllama_tpu_torch.utils.telemetry" in mods
    assert os.path.join(PKG, "parallel", "__init__.py") in files
    assert os.path.join(PKG, "utils", "telemetry.py") in files
    for m in PARALLEL_MODULES:
        assert f"dllama_tpu_torch.parallel.{m}" in mods
        assert os.path.join(PKG, "parallel", m + ".py") in files
    code = (
        "import sys\n"
        "for name in ('jax', 'dllama_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: (_ for _ in ()).throw(AssertionError('cuda'))\n"
        "import dllama_tpu_torch.parallel as par\n"
        "from dllama_tpu_torch.parallel.launch import spawn, jobs_target, cli_target\n"
        "from dllama_tpu_torch.parallel.collectives import all_reduce, quantize_q80_blocks\n"
        "from dllama_tpu_torch.utils.telemetry import ici_traffic_per_token, memory_report\n"
        "assert par.make_mesh(1, 1, 'cpu').world == 1 and par.Mesh and par.shard_params\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_parallel_serving_slice_module_is_covered():
    """The parallel serving slice's control plane (parallel/control.py) is
    among the modules and files checked above, and a follower's side of it
    (the engine, the launcher's follower target, `follow`) imports with jax,
    dllama_tpu and triton blocked and no card asked for: a follower rank
    imports torch and the port only."""
    mods, files = _port_modules(), _port_files()
    assert "dllama_tpu_torch.parallel.control" in mods
    assert os.path.join(PKG, "parallel", "control.py") in files
    code = (
        "import sys\n"
        "for name in ('jax', 'dllama_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: (_ for _ in ()).throw(AssertionError('cuda'))\n"
        "from dllama_tpu_torch.parallel.control import DISPATCHES, Controller, follow\n"
        "from dllama_tpu_torch.parallel.launch import follower_target, lead, serve_target\n"
        "from dllama_tpu_torch.runtime.engine import InferenceEngine\n"
        "assert all(callable(getattr(InferenceEngine, n)) for n in DISPATCHES)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_pipeline_slice_module_is_covered():
    """The pipeline slice's module (parallel/pipeline.py) is among the
    modules and files checked above, and a stage's side of it (forward_pp,
    the stage ranges, the stage collectives) imports with jax, dllama_tpu
    and triton blocked and no card asked for."""
    mods, files = _port_modules(), _port_files()
    assert "dllama_tpu_torch.parallel.pipeline" in mods
    assert os.path.join(PKG, "parallel", "pipeline.py") in files
    code = (
        "import sys\n"
        "for name in ('jax', 'dllama_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: (_ for _ in ()).throw(AssertionError('cuda'))\n"
        "from dllama_tpu_torch.parallel.pipeline import forward_pp, stage_range, validate_pp\n"
        "from dllama_tpu_torch.parallel.collectives import broadcast, stage_recv, stage_send\n"
        "from dllama_tpu_torch.parallel.mesh import make_mesh\n"
        "m = make_mesh(1, 1, 'cpu', pp=1, dp=1)\n"
        "assert (m.pp.size, m.dp.size, m.world) == (1, 1, 1)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
