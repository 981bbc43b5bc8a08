"""dlint core: findings, rule base class, suppressions, baseline, runner.

The port's copy of dllama_tpu/analysis/core.py (stdlib only), with the
port's own baseline file and default targets.

A rule sees the repo through two hooks:

* ``check_module(mod)`` — once per parsed source file (most rules);
* ``check_repo(repo)``  — once per run, for cross-file contracts (the
  metrics↔docs rule).

Suppression model (two layers, both visible in review):

* **inline** — ``# dlint: disable=rule-a,rule-b — why this is fine`` on
  the finding's line silences those rules for that line only. The
  justification text is free-form but the convention (enforced by
  review, not the tool) is one line of WHY.
* **baseline** — ``dlint-torch-baseline.json`` at the repo root lists finding
  fingerprints that predate the rule and are allowed to persist.
  Fingerprints deliberately exclude line numbers so unrelated edits
  don't churn the file; ``--update-baseline`` rewrites it.

Exit codes: 0 clean (or fully baselined/suppressed), 1 findings, 2
usage/internal error.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator

BASELINE_NAME = "dlint-torch-baseline.json"

# ``# dlint: disable=rule-a,rule-b`` optionally followed by free text
_SUPPRESS = re.compile(r"#\s*dlint:\s*disable=([a-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int  # 1-indexed
    message: str

    def fingerprint(self) -> str:
        # no line number: survives unrelated edits above the finding
        return f"{self.rule}::{self.path}::{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Rule:
    """Base class; subclasses set ``name``/``description`` and override
    one or both check hooks."""

    name = ""
    description = ""

    def check_module(self, mod: "SourceModule") -> Iterable[Finding]:
        return ()

    def check_repo(self, repo: "Repo") -> Iterable[Finding]:
        return ()


class SourceModule:
    """One parsed source file plus its per-line suppression table."""

    def __init__(self, root: pathlib.Path, path: pathlib.Path) -> None:
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        # line -> set of suppressed rule names
        self.suppressions: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppressions.setdefault(i, set()).update(rules)

    def suppressed(self, finding: Finding) -> bool:
        return finding.rule in self.suppressions.get(finding.line, ())

    def finding(self, rule: str, node: ast.AST | int, message: str) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.rel, line=line, message=message)


@dataclass
class Repo:
    root: pathlib.Path
    modules: list[SourceModule] = field(default_factory=list)
    # files that exist but failed to parse: reported, never silently skipped
    parse_errors: list[tuple[str, str]] = field(default_factory=list)

    def module(self, rel: str) -> SourceModule | None:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None


# the port, its chip smoke and its scripts (``scripts/torch_*.py``); a
# target with a ``*`` is a glob under the root
DEFAULT_TARGETS = ("dllama_tpu_torch", "chip_smoke.py", "scripts/torch_*.py")
_SKIP_DIRS = {"__pycache__", ".git", "node_modules"}


def collect_repo(
    root: pathlib.Path, targets: Iterable[str] | None = None
) -> Repo:
    repo = Repo(root=root)
    paths: list[pathlib.Path] = []
    for t in targets or DEFAULT_TARGETS:
        if "*" in t:
            paths.extend(q for q in sorted(root.glob(t)) if q.is_file())
            continue
        p = root / t
        if p.is_dir():
            paths.extend(
                q
                for q in sorted(p.rglob("*.py"))
                if not (_SKIP_DIRS & set(q.parts))
            )
        elif p.is_file():
            paths.append(p)
    for p in paths:
        try:
            repo.modules.append(SourceModule(root, p))
        except SyntaxError as e:
            repo.parse_errors.append((p.relative_to(root).as_posix(), str(e)))
    return repo


def run_rules(
    repo: Repo, rules: Iterable[Rule]
) -> tuple[list[Finding], int]:
    """All unsuppressed findings plus the count of inline-suppressed
    ones (surfaced in the summary so suppressions stay visible)."""
    findings: list[Finding] = []
    n_suppressed = 0
    by_rel = {m.rel: m for m in repo.modules}
    for rule in rules:
        for mod in repo.modules:
            for f in rule.check_module(mod):
                if mod.suppressed(f):
                    n_suppressed += 1
                else:
                    findings.append(f)
        for f in rule.check_repo(repo):
            mod = by_rel.get(f.path)
            if mod is not None and mod.suppressed(f):
                n_suppressed += 1
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, n_suppressed


# -- baseline ---------------------------------------------------------------

def load_baseline(path: pathlib.Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("findings", []))


def write_baseline(path: pathlib.Path, findings: Iterable[Finding]) -> None:
    data = {
        "comment": (
            "dlint baseline: fingerprints of pre-existing findings allowed "
            "to persist. Regenerate with "
            "`python -m dllama_tpu_torch.analysis --update-baseline`; shrink it "
            "whenever you fix one."
        ),
        "findings": sorted({f.fingerprint() for f in findings}),
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def apply_baseline(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding], set[str]]:
    """Split into (new, baselined) and report stale baseline entries."""
    new: list[Finding] = []
    old: list[Finding] = []
    seen: set[str] = set()
    for f in findings:
        fp = f.fingerprint()
        if fp in baseline:
            old.append(f)
            seen.add(fp)
        else:
            new.append(f)
    stale = baseline - seen
    return new, old, stale


# -- shared AST helpers (used by several rules) -----------------------------

def is_self_attr(node: ast.AST, name: str | None = None) -> bool:
    """``self.X`` (optionally a specific X)."""
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and (name is None or node.attr == name)
    )


def dotted(node: ast.AST) -> str:
    """Best-effort dotted-name rendering of an expression (for keys and
    messages); falls back to ast.unparse for anything unusual."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{dotted(node.value)}.{node.attr}"
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse handles all exprs today
        return "<expr>"


def iter_methods(cls: ast.ClassDef) -> Iterator[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
