"""env-knob-docs: every ``DLLAMA_*`` environment knob the code reads
must be documented somewhere an operator will find it.

The port's copy of dllama_tpu/analysis/rules_env.py. The doc side is the
whole repo's (README.md and docs/*.md, which also document the JAX
package's knobs); a documented knob the port reads nowhere is a finding
unless README.md lists it under ``#### Env knobs the port leaves out``,
each bullet with its reason (``- `DLLAMA_A`, `DLLAMA_B_*`: reason``). A
listed knob the port reads, one no doc names, and a bullet with no
reason are findings too (:func:`.rules_metrics.left_out_findings`).

Same two-sided sync contract as the metrics rule
(:mod:`.rules_metrics`), applied to configuration instead of
telemetry: a knob read in code but absent from README.md and docs/ is
behavior nobody can discover; a knob documented but read nowhere is an
operator setting a dead variable.

Read sites recognized (regex over whole file text, since helper calls
wrap across lines): ``os.environ.get/os.getenv/os.environ[...]`` and
the project's ``_env_int/_env_float/_env_str/_env_bool`` helpers, each
with a literal ``"DLLAMA_..."`` name. ``environ.setdefault`` is a
write, not a read, and names in docstrings/comments have no read site
— neither counts. Doc side: any ``DLLAMA_*`` token in README.md or any
``docs/*.md``; a trailing-star family mention (``DLLAMA_WATCHDOG_*``)
documents every knob sharing the prefix.
"""

from __future__ import annotations

import re
from typing import Iterable

from .core import Finding, Repo, Rule
from .rules_metrics import left_out, left_out_findings

LEFT_OUT_HEADING = "#### Env knobs the port leaves out"

_READ_SITE = re.compile(
    r"(?:environ\.get|\bgetenv|environ\[|_env_int|_env_float|_env_str"
    r"|_env_bool)\s*\(?\s*[\"'](DLLAMA_[A-Z0-9_]+)[\"']"
)
_DOC_NAME = re.compile(r"\b(DLLAMA_[A-Z0-9_]+)(\*)?")


def read_knobs(repo: Repo) -> dict[str, tuple[str, int]]:
    """knob name -> (path, line) of its first read site."""
    knobs: dict[str, tuple[str, int]] = {}
    for mod in repo.modules:
        for m in _READ_SITE.finditer(mod.text):
            line = mod.text.count("\n", 0, m.start()) + 1
            knobs.setdefault(m.group(1), (mod.rel, line))
    return knobs


def documented_knobs(
    repo: Repo,
) -> tuple[dict[str, tuple[str, int]], dict[str, tuple[str, int]]]:
    """(exact knob mentions, family-prefix mentions) across README.md
    and docs/*.md, each name -> (doc path, line) of its first mention.
    A ``DLLAMA_FOO_*`` token lands in the prefix dict as ``DLLAMA_FOO_``."""
    exact: dict[str, tuple[str, int]] = {}
    prefixes: dict[str, tuple[str, int]] = {}
    docs = [repo.root / "README.md"]
    docs_dir = repo.root / "docs"
    if docs_dir.is_dir():
        docs.extend(sorted(docs_dir.glob("*.md")))
    for doc in docs:
        if not doc.exists():
            continue
        text = doc.read_text()
        rel = doc.relative_to(repo.root).as_posix()
        for m in _DOC_NAME.finditer(text):
            loc = (rel, text.count("\n", 0, m.start()) + 1)
            if m.group(2):
                prefixes.setdefault(m.group(1), loc)
            else:
                exact.setdefault(m.group(1), loc)
    return exact, prefixes


class EnvKnobDocsRule(Rule):
    name = "env-knob-docs"
    description = (
        "every DLLAMA_* env knob read in code is documented in README.md "
        "or docs/, and every documented one is read or listed as left out"
    )

    def check_repo(self, repo: Repo) -> Iterable[Finding]:
        code = read_knobs(repo)
        exact, prefixes = documented_knobs(repo)
        out = left_out(repo, LEFT_OUT_HEADING)
        out_exact = {n for n in out if not n.endswith("*")}
        out_prefixes = {n[:-1] for n in out if n.endswith("*")}

        def covered(name: str) -> bool:
            return name in exact or any(
                name.startswith(p) for p in prefixes
            )

        for name in sorted(n for n in code if not covered(n)):
            path, line = code[name]
            yield Finding(
                rule=self.name, path=path, line=line,
                message=(
                    f"env knob {name} is read here but documented in "
                    f"neither README.md nor docs/"
                ),
            )
        for name in sorted(set(exact) - set(code) - out_exact):
            if any(name.startswith(p) for p in out_prefixes):
                continue
            path, line = exact[name]
            yield Finding(
                rule=self.name, path=path, line=line,
                message=(
                    f"env knob {name} is documented but read nowhere "
                    f"(operators would set a dead variable)"
                ),
            )
        for pref in sorted(
            p for p in prefixes
            if not any(n.startswith(p) for n in code)
            and p not in out_prefixes
        ):
            path, line = prefixes[pref]
            yield Finding(
                rule=self.name, path=path, line=line,
                message=(
                    f"env knob family {pref}* is documented but no knob "
                    f"with that prefix is read anywhere"
                ),
            )
        listed = set(out_exact) | {p + "*" for p in out_prefixes}
        read = set(code) | {
            p + "*" for p in out_prefixes if any(n.startswith(p) for n in code)
        }
        docs = set(exact) | {p + "*" for p in prefixes}
        yield from left_out_findings(
            self.name, {n: out[n] for n in listed}, "env knob", read, docs,
            "README.md or docs/",
        )
