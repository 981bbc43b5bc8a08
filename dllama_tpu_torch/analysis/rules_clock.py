"""direct-clock: clock-injectable modules must use the injected clock.

The port's copy of dllama_tpu/analysis/rules_clock.py.

obs/watchdog.py, obs/slo.py and obs/spans.py accept a ``clock=``
parameter precisely so fake-clock tests can drive their stall rules and
sliding windows deterministically. A direct ``time.time()`` /
``time.monotonic()`` / ``time.perf_counter()`` call in such a module is
a hole in that determinism: the code path silently reads the real clock
and the fake-clock test can never cover it.

The rule fires in any module where some function signature has a
``clock`` or ``wall_clock`` parameter, on every *call* of a ``time``
module clock. A bare reference (``clock=time.monotonic`` as a default —
the injection point itself) is not a call and never fires.

Wall-clock timestamps for human-facing output are still legitimate —
inject them too (``wall_clock=time.time``) or suppress with
``# dlint: disable=direct-clock — why``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, Rule, SourceModule

CLOCK_PARAMS = {"clock", "wall_clock"}
CLOCK_CALLS = {"time", "monotonic", "perf_counter", "monotonic_ns",
               "perf_counter_ns", "time_ns"}


class DirectClockRule(Rule):
    name = "direct-clock"
    description = (
        "modules with an injectable clock= parameter must not call "
        "time.time()/time.monotonic()/time.perf_counter() directly"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        if not self._is_clock_injectable(mod.tree):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in CLOCK_CALLS
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "time"
            ):
                yield mod.finding(
                    self.name,
                    node,
                    f"direct time.{fn.attr}() call in a clock-injectable "
                    f"module; route it through the injected clock so "
                    f"fake-clock tests cover this path",
                )

    def _is_clock_injectable(self, tree: ast.AST) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                names = [
                    a.arg
                    for a in (
                        args.posonlyargs + args.args + args.kwonlyargs
                    )
                ]
                if CLOCK_PARAMS & set(names):
                    return True
        return False
