"""``python -m dllama_tpu_torch.analysis`` — run every dlint rule on the port.

The port's copy of dllama_tpu/analysis/__main__.py, with the same flags
and exit codes. ``--hlo`` switches from source lint to captured-graph
lint (:mod:`.graphlint`): it builds a tiny engine on the card, captures
the admission graph set (`rehearse_admission`) and checks every graph's
node list against the host/donation/collective/dtype/launch-budget
policies, gated by ``xlalint-torch-baseline.json``; on a host without
CUDA it exits 2 (there is no graph to read on the CPU). ``--prune`` (in
either mode) rewrites the baseline minus entries that no longer match
any finding, so dead suppressions can't accumulate.

Exit 0 when every finding is fixed, inline-suppressed, or baselined;
exit 1 on any new finding (what CI's fast lane gates on); exit 2 on
usage errors or unparseable sources.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from . import all_rules
from .core import (
    BASELINE_NAME,
    apply_baseline,
    collect_repo,
    load_baseline,
    run_rules,
    write_baseline,
)
from .graphlint import XLALINT_BASELINE_NAME


def repo_root() -> pathlib.Path:
    # analysis/ -> dllama_tpu_torch/ -> repo root
    return pathlib.Path(__file__).resolve().parent.parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dllama_tpu_torch.analysis",
        description="project-native static analysis (dlint)",
    )
    ap.add_argument(
        "targets", nargs="*",
        help="files/directories/globs to lint (default: dllama_tpu_torch/, "
             "chip_smoke.py, scripts/torch_*.py)",
    )
    ap.add_argument(
        "--rules", default="",
        help="comma-separated rule names to run (default: all)",
    )
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument(
        "--baseline", default=None,
        help=f"baseline file (default: <repo>/{BASELINE_NAME})",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings and exit 0",
    )
    ap.add_argument(
        "--prune", action="store_true",
        help="rewrite the baseline minus stale entries (ones matching no "
             "current finding) and exit 0",
    )
    ap.add_argument(
        "--hlo", action="store_true",
        help="lint CAPTURED CUDA graphs: build a tiny engine on the card, "
             "capture the admission graph set, check the graph policies "
             f"against <repo>/{XLALINT_BASELINE_NAME} (needs CUDA)",
    )
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.hlo:
        if args.list_rules:
            from .graphlint import all_hlo_rules

            for hr in all_hlo_rules():
                print(f"{hr.name:24s} {hr.description}")
            return 0
        from .graphlint import run_hlo_cli

        return run_hlo_cli(args)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.name:16s} {r.description}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.name for r in rules}
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]

    root = repo_root()
    repo = collect_repo(root, args.targets or None)
    if repo.parse_errors:
        for rel, err in repo.parse_errors:
            print(f"{rel}: PARSE ERROR: {err}", file=sys.stderr)
        return 2

    findings, n_suppressed = run_rules(repo, rules)

    baseline_path = (
        pathlib.Path(args.baseline) if args.baseline
        else root / BASELINE_NAME
    )
    if args.update_baseline:
        write_baseline(baseline_path, findings)
        print(
            f"baseline written: {len(findings)} finding(s) -> "
            f"{baseline_path}"
        )
        return 0

    baseline = set() if args.no_baseline else load_baseline(baseline_path)
    new, baselined, stale = apply_baseline(findings, baseline)

    if args.prune:
        # keep exactly the entries that still match a finding: stale
        # fingerprints (rule/file fixed or renamed) drop out, new
        # findings are NOT added — pruning never widens the baseline
        write_baseline(baseline_path, baselined)
        print(
            f"baseline pruned: {len(stale)} stale entr"
            f"{'y' if len(stale) == 1 else 'ies'} removed, "
            f"{len(baselined)} kept -> {baseline_path}"
        )
        return 0

    for f in new:
        print(f.render())
    if not args.quiet:
        if stale:
            print(
                f"note: {len(stale)} stale baseline entr"
                f"{'y' if len(stale) == 1 else 'ies'} no longer match any "
                f"finding — prune with --prune"
            )
        print(
            f"dlint: {len(repo.modules)} files, {len(rules)} rules, "
            f"{len(new)} new finding(s), {len(baselined)} baselined, "
            f"{n_suppressed} suppressed inline"
        )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
