"""dashboard-static: the live dashboard must stay self-contained.

The port's copy of dllama_tpu/analysis/rules_dashboard.py, scoped to the
port's obs/dashboard.py.

``GET /dashboard`` (obs/dashboard.py) promises a single-file page —
inline CSS, inline JS, canvas rendering — that works from
``curl -o dash.html`` on an air-gapped host and never phones home. One
``<script src=...cdn...>`` quietly added in review would break both
properties, so the contract is enforced here: any external reference
inside the module's string literals (the HTML template) is a finding.

Flagged inside string constants of ``obs/dashboard.py``:

* absolute URLs (``http://`` / ``https://``);
* scheme-relative references (``src="//..."`` / ``href="//..."``);
* ``<script src=...>`` and ``<link ... href=...>`` tags (inline-only);
* CSS ``@import``.

The scan walks AST string constants — not raw source lines — so code
comments may *mention* the forbidden patterns when documenting the rule.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .core import Finding, Rule, SourceModule

DASHBOARD_MODULES = ("dllama_tpu_torch/obs/dashboard.py",)

_PATTERNS: tuple[tuple[re.Pattern, str], ...] = (
    (
        re.compile(r"https?://", re.I),
        "absolute URL in the dashboard template (must be self-contained)",
    ),
    (
        re.compile(r"""(?:src|href)\s*=\s*["']//""", re.I),
        "scheme-relative external reference in the dashboard template",
    ),
    (
        re.compile(r"<script\s[^>]*src", re.I),
        "<script src=...> in the dashboard template (scripts must be inline)",
    ),
    (
        re.compile(r"<link\s[^>]*href", re.I),
        "<link href=...> in the dashboard template (styles must be inline)",
    ),
    (
        re.compile(r"@import", re.I),
        "CSS @import in the dashboard template (styles must be inline)",
    ),
)


class DashboardStaticRule(Rule):
    name = "dashboard-static"
    description = (
        "the /dashboard page must be self-contained: no external URLs, "
        "script/style includes, or CSS imports in obs/dashboard.py"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        if mod.rel not in DASHBOARD_MODULES:
            return
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
            ):
                continue
            for pattern, why in _PATTERNS:
                for m in pattern.finditer(node.value):
                    # anchor the finding to the line inside the (multi-
                    # line) template literal where the match sits
                    line = node.lineno + node.value[: m.start()].count("\n")
                    yield mod.finding(
                        self.name, line, f"{why}: {m.group(0)!r}"
                    )
