"""metrics-docs: registered ``dllama_*`` metrics and the operator doc
must agree in both directions.

The port's copy of dllama_tpu/analysis/rules_metrics.py, scoped to the
port: the source side scans the port's registrations, the doc side the
operator docs that document the JAX package's families (read, never
edited here), and what the port claims in between is the README's list
of the families it leaves out.

* source side — static scan of ``counter("dllama_...")`` /
  ``gauge(`` / ``histogram(`` registration calls across
  ``dllama_tpu_torch/`` and ``chip_smoke.py`` (registrations span lines,
  so the regex runs over whole file contents). Dynamically named metrics
  have no literal name at the registration site and stay out of scope;
* doc side — every backticked ``dllama_*`` identifier in
  ``docs/serving_metrics.md``. The ``<name>`` placeholder in the template
  breaks the identifier pattern, so it never counts;
* left out — the bullets under README.md's ``#### Metric families the
  port leaves out`` heading, each ``- `dllama_a`, `dllama_b`: reason``.
  A documented family on that list is no phantom; a listed family the
  port registers, one the doc does not name, and a bullet with no reason
  are findings, so the list cannot go stale or grow silently.

A metric registered but undocumented is silent telemetry nobody can
discover; documented but unregistered is a dashboard querying a phantom.
"""

from __future__ import annotations

import re
from typing import Iterable

from .core import Finding, Repo, Rule

DOC_REL = "docs/serving_metrics.md"
README_REL = "README.md"
LEFT_OUT_HEADING = "#### Metric families the port leaves out"
SOURCE_PREFIXES = ("dllama_tpu_torch/",)
SOURCE_FILES = ("chip_smoke.py",)

_REGISTRATION = re.compile(
    r"\b(?:counter|gauge|histogram)\(\s*[\"'](dllama_[a-z0-9_]+)[\"']"
)
_DOC_NAME = re.compile(r"`(dllama_[a-z0-9_]+)`")
_BULLET = re.compile(r"^- ((?:`[^`]+`(?:, )?)+)\s*:?\s*(.*)$")


def in_port(rel: str) -> bool:
    return rel.startswith(SOURCE_PREFIXES) or rel in SOURCE_FILES


def registered_names(repo: Repo) -> dict[str, tuple[str, int]]:
    """metric name -> (path, line) of its first registration site."""
    names: dict[str, tuple[str, int]] = {}
    for mod in repo.modules:
        if not in_port(mod.rel):
            continue
        for m in _REGISTRATION.finditer(mod.text):
            line = mod.text.count("\n", 0, m.start()) + 1
            names.setdefault(m.group(1), (mod.rel, line))
    return names


def documented_names(repo: Repo) -> dict[str, int]:
    doc = repo.root / DOC_REL
    if not doc.exists():
        return {}
    text = doc.read_text()
    names: dict[str, int] = {}
    for m in _DOC_NAME.finditer(text):
        names.setdefault(m.group(1), text.count("\n", 0, m.start()) + 1)
    return names


def left_out(repo: Repo, heading: str) -> dict[str, tuple[int, str]]:
    """name -> (README line, reason) of every name on the bullets under
    ``heading`` in README.md, up to the next heading. A bullet with no
    reason maps its names to an empty reason."""
    readme = repo.root / README_REL
    if not readme.exists():
        return {}
    out: dict[str, tuple[int, str]] = {}
    inside = False
    for i, line in enumerate(readme.read_text().splitlines(), start=1):
        if line.strip() == heading:
            inside = True
            continue
        if not inside:
            continue
        if line.startswith("#"):
            break
        m = _BULLET.match(line)
        if m:
            for name in re.findall(r"`([^`]+)`", m.group(1)):
                out.setdefault(name, (i, m.group(2).strip()))
    return out


class MetricsDocsRule(Rule):
    name = "metrics-docs"
    description = (
        "every dllama_* metric the port registers is documented in "
        "docs/serving_metrics.md, and every documented one is registered "
        "or on README.md's list of families the port leaves out"
    )

    def check_repo(self, repo: Repo) -> Iterable[Finding]:
        code = registered_names(repo)
        doc = documented_names(repo)
        out = left_out(repo, LEFT_OUT_HEADING)
        for name in sorted(set(code) - set(doc)):
            path, line = code[name]
            yield Finding(
                rule=self.name, path=path, line=line,
                message=(
                    f"metric {name} is registered here but missing from "
                    f"{DOC_REL}"
                ),
            )
        for name in sorted(set(doc) - set(code) - set(out)):
            yield Finding(
                rule=self.name, path=DOC_REL, line=doc[name],
                message=(
                    f"metric {name} is documented but registered nowhere "
                    f"(dashboards would query a phantom)"
                ),
            )
        yield from left_out_findings(
            self.name, out, "metric", set(code), set(doc), DOC_REL
        )


def left_out_findings(
    rule: str,
    out: dict[str, tuple[int, str]],
    what: str,
    in_code: set,
    in_docs: set,
    docs: str,
) -> Iterable[Finding]:
    """The left-out list's own findings: a name the port has after all, a
    name the docs never mention, a bullet with no reason."""
    for name in sorted(out):
        line, reason = out[name]
        if name in in_code:
            msg = f"{what} {name} is listed as left out but the port has it"
        elif name not in in_docs:
            msg = f"{what} {name} is listed as left out but {docs} never names it"
        elif not reason:
            msg = f"{what} {name} is listed as left out with no reason"
        else:
            continue
        yield Finding(rule=rule, path=README_REL, line=line, message=msg)
