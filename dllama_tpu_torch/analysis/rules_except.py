"""silent-except: broad exception handlers must leave evidence.

The port's copy of dllama_tpu/analysis/rules_except.py, scoped to the
port's runtime/, kv/ and fleet/.

The serving path deliberately survives engine failures — the scheduler
loop, the KV manager and the chunked-admission machinery all contain
``except Exception`` blocks that degrade instead of crashing. That
policy is only safe while every such block EMITS something an operator
can find later: a flight-recorder event, a metric increment, or a
re-raise that hands the failure to a layer that does. A broad handler
that swallows the exception with none of those is how a chaos run "goes
green" while silently corrupting streams.

The rule walks ``except`` handlers in ``dllama_tpu_torch/runtime/``,
``dllama_tpu_torch/kv/`` and ``dllama_tpu_torch/fleet/`` whose caught
type is ``Exception`` / ``BaseException`` / bare (or a tuple
containing one of those) and flags any whose body neither raises nor
calls an evidence sink — ``.record(...)`` / ``.postmortem(...)`` (the
recorder), ``.inc(...)`` / ``.observe(...)`` /
``.labels(...)`` (metric handles). Plain logging does NOT count: log
lines are not scrapeable and the repo's failure-path tests assert on
recorder events and metrics, not grep.

Narrow handlers (``except ValueError``) stay exempt — catching a
specific type is itself a statement of intent. Suppress a deliberate
silent site with ``# dlint: disable=silent-except — why``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, Rule, SourceModule

SCOPED_PREFIXES = (
    "dllama_tpu_torch/runtime/",
    "dllama_tpu_torch/kv/",
    # the fleet front door's error paths (failover, spill, drain
    # forwarding) must leave evidence from day one — a router that
    # swallows a replica death silently defeats its own purpose
    "dllama_tpu_torch/fleet/",
)
BROAD_TYPES = {"Exception", "BaseException"}
EVIDENCE_CALLS = {"record", "postmortem", "inc", "observe", "labels"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        if isinstance(node, ast.Name) and node.id in BROAD_TYPES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in BROAD_TYPES:
            return True
    return False


def _leaves_evidence(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in EVIDENCE_CALLS
        ):
            return True
    return False


class SilentExceptRule(Rule):
    name = "silent-except"
    description = (
        "broad except blocks in runtime/, kv/ and fleet/ must re-raise or emit "
        "a recorder event / metric"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        if not mod.rel.startswith(SCOPED_PREFIXES):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _leaves_evidence(node):
                continue
            caught = (
                "bare except"
                if node.type is None
                else f"except {ast.unparse(node.type)}"
            )
            yield mod.finding(
                self.name,
                node,
                f"{caught} swallows the failure with no recorder event, "
                f"metric, or re-raise — the degraded-not-dead policy "
                f"requires evidence; record it or suppress with a reason",
            )
