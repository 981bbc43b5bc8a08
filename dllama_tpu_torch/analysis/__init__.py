"""dlint for the port: project-native static analysis of dllama_tpu_torch.

The port's copy of dllama_tpu/analysis/ (stdlib only; it imports nothing
of the JAX package). An AST lint framework with rules written against
this codebase's conventions (``self._lock`` guarding, the
``PagePool.retain``/``release`` ownership protocol, injectable clocks,
CUDA graph capture purity, thread hygiene, the metrics↔docs and
knobs↔docs contracts), and a lint of the CUDA graphs the engine captures
(:mod:`.graphlint`, the counterpart of the JAX package's xlalint).

One entrypoint runs everything::

    python -m dllama_tpu_torch.analysis            # lint the port, exit 0/1
    python -m dllama_tpu_torch.analysis --list-rules
    python -m dllama_tpu_torch.analysis --update-baseline
    python -m dllama_tpu_torch.analysis --prune    # drop stale baseline entries
    python -m dllama_tpu_torch.analysis --hlo      # lint CAPTURED graphs (a card)

Per-line suppressions use ``# dlint: disable=<rule>[,<rule>] — reason``
on the offending line; pre-existing findings can instead live in the
port's checked-in baseline (``dlint-torch-baseline.json``), which lists
the only findings allowed to exist.

The runtime half — a test-mode lock wrapper that records the cross-thread
lock acquisition-order graph and fails on cycles, plus a deterministic
seeded interleaving harness — lives in :mod:`.lockwatch`.
"""

from __future__ import annotations

from .core import (  # noqa: F401
    Finding,
    Repo,
    Rule,
    SourceModule,
    load_baseline,
    run_rules,
    write_baseline,
)


def all_rules() -> list:
    """Every registered rule, instantiated (import-cycle-free accessor:
    rule modules import core, never the other way around)."""
    from .rules_capture import CapturePurityRule
    from .rules_clock import DirectClockRule
    from .rules_dashboard import DashboardStaticRule
    from .rules_env import EnvKnobDocsRule
    from .rules_except import SilentExceptRule
    from .rules_kv import RetainReleaseRule
    from .rules_locks import GuardedAttrsRule
    from .rules_metrics import MetricsDocsRule
    from .rules_threads import ThreadHygieneRule

    return [
        GuardedAttrsRule(),
        RetainReleaseRule(),
        DirectClockRule(),
        CapturePurityRule(),
        ThreadHygieneRule(),
        MetricsDocsRule(),
        DashboardStaticRule(),
        EnvKnobDocsRule(),
        SilentExceptRule(),
    ]
