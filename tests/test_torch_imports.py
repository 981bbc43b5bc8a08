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
