"""capture-purity: no host side effects inside a CUDA graph capture.

The port's counterpart of dllama_tpu/analysis/rules_trace.py (trace-purity).
A body run under CUDA graph capture runs ONCE, at capture: a replay
launches the kernels it enqueued and nothing else. A ``time.monotonic()``
read, a metrics ``.inc()``, a lock, a ``print`` or a ``self.X = ...``
inside it fires at capture and never again, and a host sync (``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``) or a
tensor made from host data (``torch.tensor``, ``torch.as_tensor``,
``torch.from_numpy``) either fails the capture or bakes the capture's
host value into every replay — the hazard of a JAX trace.

Captured functions are found two ways, then closed transitively over
same-module calls (by bare name, as the JAX rule does, and through
``self.<method>(...)`` to a function of that name in the module):

* the callable passed to ``<...>graphs.run(key, fn)`` (the engine's
  `StepGraphs` sites): a name of a function or closure in the module, or
  a ``lambda`` whose body is scanned in place;
* the body of ``with torch.cuda.graph(...)``.

Flagged inside a captured body: the JAX list (``time.*`` clock calls,
metric/recorder side effects ``.inc``/``.observe``/``.labels``/
``.record``, ``get_registry``/``get_recorder``/``get_span_tracker``, lock
acquisition and ``threading.*``, ``print``, ``logging``/``logger`` calls,
``os.environ`` reads, ``self.X = ...``), augmented assignment to any
attribute, and the host syncs and host-data tensors above.

One host-state write is exempt on purpose: the kernel wrappers' launch
counters (``qmatmul.launches += 1``, listed in ``ops.KERNELS``). A capture
moves them for kernels that never ran and a replay does not move them, so
`StepGraphs` (runtime/graphs.py, its docstring and ``_capture``) takes
what a capture added back off and keeps it as the graph's tally, which
each replay adds. An augmented assignment to an attribute named
``launches`` is therefore not a finding.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, Rule, SourceModule, dotted

METRIC_METHODS = {"inc", "observe", "labels", "record"}
OBS_GETTERS = {"get_registry", "get_recorder", "get_span_tracker"}
SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
HOST_TENSOR_CALLS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.asarray"}
# the launch counters StepGraphs settles itself (module docstring)
EXEMPT_COUNTERS = {"launches"}


def _is_graphs_run(call: ast.Call) -> bool:
    fn = call.func
    return (
        isinstance(fn, ast.Attribute)
        and fn.attr == "run"
        and dotted(fn.value).split(".")[-1].endswith("graphs")
        and len(call.args) >= 2
    )


def _is_graph_capture(item: ast.withitem) -> bool:
    ce = item.context_expr
    return isinstance(ce, ast.Call) and dotted(ce.func) in (
        "torch.cuda.graph", "cuda.graph",
    )


class CapturePurityRule(Rule):
    name = "capture-purity"
    description = (
        "functions run under CUDA graph capture (StepGraphs.run, "
        "torch.cuda.graph) must not touch locks, metrics, time.*, host "
        "syncs or host-side state"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        index: dict[str, list] = {}
        for n in ast.walk(mod.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index.setdefault(n.name, []).append(n)

        captured: dict[int, tuple[ast.AST, str]] = {}

        def mark(node, label):
            captured.setdefault(id(node), (node, label))

        # innermost function first, so a site is labelled by the function
        # that holds it (labels carry no line numbers: fingerprints)
        owners = sorted(
            (d for ds in index.values() for d in ds),
            key=lambda d: -d.lineno,
        )
        for owner in owners:
            for n in ast.walk(owner):
                if isinstance(n, ast.Call) and _is_graphs_run(n):
                    fn = n.args[1]
                    if isinstance(fn, ast.Lambda):
                        mark(fn, f"the lambda that {owner.name}() captures")
                    elif isinstance(fn, ast.Name):
                        for d in index.get(fn.id, ()):
                            mark(d, f"{d.name}()")
                elif isinstance(n, (ast.With, ast.AsyncWith)) and any(
                    _is_graph_capture(i) for i in n.items
                ):
                    mark(n, f"the torch.cuda.graph body in {owner.name}()")

        # transitive: captured code calling a same-module function by name
        # or a method of the module through self
        work = [node for node, _ in captured.values()]
        while work:
            fn = work.pop()
            for n in ast.walk(fn):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                name = None
                if isinstance(f, ast.Name):
                    name = f.id
                elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                        and f.value.id == "self":
                    name = f.attr
                for callee in index.get(name, ()):
                    if id(callee) not in captured:
                        captured[id(callee)] = (callee, f"{callee.name}()")
                        work.append(callee)

        seen: set[tuple[int, str]] = set()
        for node, label in captured.values():
            for f in self._check_captured(mod, node, label):
                if (f.line, f.message) not in seen:
                    seen.add((f.line, f.message))
                    yield f

    # -- impurity scan ------------------------------------------------------

    def _check_captured(
        self, mod: SourceModule, fn: ast.AST, label: str
    ) -> Iterable[Finding]:
        where = f"captured {label}"
        body = fn.body if isinstance(fn, (ast.With, ast.AsyncWith, ast.Lambda)) else fn
        nodes = (
            [n for s in body for n in ast.walk(s)] if isinstance(body, list)
            else list(ast.walk(body))
        )
        for n in nodes:
            if isinstance(n, ast.Call):
                name = dotted(n.func)
                parts = name.split(".")
                if parts[0] == "time" and len(parts) == 2:
                    yield mod.finding(
                        self.name, n,
                        f"{name}() inside {where}: the clock is read once "
                        f"at capture, not per replay",
                    )
                elif parts[-1] in METRIC_METHODS and parts[0] in (
                    "self", "obs",
                ) or name.startswith(("logger.", "logging.")):
                    yield mod.finding(
                        self.name, n,
                        f"{name}() inside {where}: host side effect fires "
                        f"at capture, not per replay",
                    )
                elif parts[-1] in OBS_GETTERS:
                    yield mod.finding(
                        self.name, n,
                        f"{name}() inside {where}: observability handles "
                        f"must stay outside captured code",
                    )
                elif name == "print":
                    yield mod.finding(
                        self.name, n,
                        f"print() inside {where}: prints once at capture",
                    )
                elif parts[0] in ("threading", "_threading"):
                    yield mod.finding(
                        self.name, n,
                        f"{name}() inside {where}: threading primitives "
                        f"must not be created or used under capture",
                    )
                elif name in ("torch.cuda.synchronize", "cuda.synchronize") or (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in SYNC_METHODS
                    and not n.args
                ):
                    yield mod.finding(
                        self.name, n,
                        f"{name}() inside {where}: a host sync fails the "
                        f"capture or reads the capture's value once",
                    )
                elif name in HOST_TENSOR_CALLS:
                    yield mod.finding(
                        self.name, n,
                        f"{name}() inside {where}: a tensor made from host "
                        f"data bakes the capture's values into every replay",
                    )
            elif isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    ce_name = dotted(item.context_expr)
                    if "lock" in ce_name.lower():
                        yield mod.finding(
                            self.name, item.context_expr,
                            f"lock acquisition ({ce_name}) inside {where}: "
                            f"acquired once at capture, never on replay",
                        )
            elif isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Attribute):
                if n.target.attr in EXEMPT_COUNTERS or dotted(n.target.value) == "self":
                    continue  # StepGraphs settles the launch counters; self.X below
                yield mod.finding(
                    self.name, n,
                    f"{dotted(n.target)} updated inside {where}: host-side "
                    f"state moves at capture, not per replay",
                )
            elif isinstance(n, ast.Attribute):
                if (
                    isinstance(n.ctx, (ast.Store, ast.Del))
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                ):
                    yield mod.finding(
                        self.name, n,
                        f"self.{n.attr} mutated inside {where}: host-side "
                        f"state written at capture, not per replay",
                    )
                elif (
                    n.attr == "environ"
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "os"
                ):
                    yield mod.finding(
                        self.name, n,
                        f"os.environ read inside {where}: the environment "
                        f"is read once at capture",
                    )
