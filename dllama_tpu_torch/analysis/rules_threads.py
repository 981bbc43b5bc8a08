"""thread-hygiene: every thread is named, daemonized, and stoppable.

The port's copy of dllama_tpu/analysis/rules_threads.py.

An anonymous thread is invisible in ``py-spy``/``faulthandler`` dumps
(the first tool reached for when the engine wedges — see the watchdog's
postmortems); a non-daemon thread turns Ctrl-C into a hang; a thread
with no join/stop path leaks across engine restarts in tests and keeps
mutating shared state after its owner is gone.

For every ``threading.Thread(...)`` construction:

* ``name=`` must be passed (convention: ``dllama-<role>``);
* ``daemon=True`` must be passed at construction (not assigned later —
  the window between ``start()`` and the assignment is exactly when an
  exception would leave it non-daemon);
* there must be a join/stop path: either the thread object lands in an
  attribute/variable that is ``.join()``-ed somewhere in the same
  class/function, or the owning class defines a ``stop``/``close``/
  ``shutdown``/``join`` method (the project's stop-event pattern —
  watchdog/scheduler loops exit when their stop flag is set). Bare
  ``threading.Thread(...).start()`` fire-and-forget constructions are
  flagged; where the lifetime is genuinely bounded and observed through
  another mechanism, say so in an inline
  ``# dlint: disable=thread-hygiene — why``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, Rule, SourceModule, is_self_attr

STOP_METHODS = {"stop", "close", "shutdown", "join", "__exit__"}


def _is_thread_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        return True
    return isinstance(fn, ast.Name) and fn.id == "Thread"


def _class_has_stop_path(cls: ast.ClassDef, attr: str | None) -> bool:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in STOP_METHODS:
                return True
    if attr is not None:
        for node in ast.walk(cls):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and is_self_attr(node.func.value, attr)
            ):
                return True
    return False


def _joins_name(node: ast.AST, var: str) -> bool:
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == var
        ):
            return True
    return False


def _function_joins(
    fn: ast.FunctionDef | ast.AsyncFunctionDef, var: str
) -> bool:
    if _joins_name(fn, var):
        return True
    # the list idiom: threads = [Thread(...) for ...]; later
    # ``for t in threads: t.join()`` (possibly ``threads + [other]``)
    for node in ast.walk(fn):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        iter_names = {
            n.id for n in ast.walk(node.iter) if isinstance(n, ast.Name)
        }
        if var not in iter_names:
            continue
        if isinstance(node.target, ast.Name) and _joins_name(
            node, node.target.id
        ):
            return True
    return False


class ThreadHygieneRule(Rule):
    name = "thread-hygiene"
    description = (
        "threading.Thread must be named, daemonized at construction, "
        "and have a join/stop path"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        findings: list[Finding] = []
        self._walk(mod, mod.tree.body, cls=None, fn=None, out=findings)
        return findings

    def _walk(
        self,
        mod: SourceModule,
        stmts: list,
        cls: ast.ClassDef | None,
        fn: ast.FunctionDef | ast.AsyncFunctionDef | None,
        out: list,
    ) -> None:
        for s in stmts:
            if isinstance(s, ast.ClassDef):
                self._walk(mod, s.body, cls=s, fn=fn, out=out)
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(mod, s.body, cls=cls, fn=s, out=out)
            elif isinstance(s, (ast.If, ast.For, ast.AsyncFor, ast.While)):
                self._walk(mod, s.body, cls, fn, out)
                self._walk(mod, s.orelse, cls, fn, out)
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                self._walk(mod, s.body, cls, fn, out)
            elif isinstance(s, ast.Try):
                self._walk(mod, s.body, cls, fn, out)
                for h in s.handlers:
                    self._walk(mod, h.body, cls, fn, out)
                self._walk(mod, s.orelse, cls, fn, out)
                self._walk(mod, s.finalbody, cls, fn, out)
            else:
                for n in ast.walk(s):
                    if _is_thread_ctor(n):
                        self._check_ctor(mod, s, n, cls, fn, out)

    def _check_ctor(
        self,
        mod: SourceModule,
        stmt: ast.stmt,
        ctor: ast.Call,
        cls: ast.ClassDef | None,
        fn: ast.FunctionDef | ast.AsyncFunctionDef | None,
        out: list,
    ) -> None:
        kw = {k.arg: k.value for k in ctor.keywords}
        if "name" not in kw:
            out.append(mod.finding(
                self.name, ctor,
                "thread constructed without name=: invisible in stack "
                "dumps — name it dllama-<role>",
            ))
        daemon = kw.get("daemon")
        if not (isinstance(daemon, ast.Constant) and daemon.value is True):
            out.append(mod.finding(
                self.name, ctor,
                "thread constructed without daemon=True: a leaked "
                "non-daemon thread turns interpreter shutdown into a hang",
            ))
        self._check_join_path(mod, stmt, ctor, cls, fn, out)

    def _check_join_path(
        self,
        mod: SourceModule,
        stmt: ast.stmt,
        ctor: ast.Call,
        cls: ast.ClassDef | None,
        fn: ast.FunctionDef | ast.AsyncFunctionDef | None,
        out: list,
    ) -> None:
        # binding: self.X = Thread(...) | x = Thread(...) — including the
        # list idiom x = [Thread(...) for ...] | Thread(...).start()
        if isinstance(stmt, ast.Assign) and any(
            n is ctor for n in ast.walk(stmt.value)
        ):
            target = stmt.targets[0]
            if is_self_attr(target) and cls is not None:
                if not _class_has_stop_path(cls, target.attr):
                    out.append(mod.finding(
                        self.name, ctor,
                        f"thread stored in self.{target.attr} but class "
                        f"{cls.name} has no stop/close/shutdown/join path",
                    ))
                return
            if isinstance(target, ast.Name) and fn is not None:
                if not _function_joins(fn, target.id):
                    out.append(mod.finding(
                        self.name, ctor,
                        f"thread bound to {target.id!r} is never joined in "
                        f"{fn.name}()",
                    ))
                return
        out.append(mod.finding(
            self.name, ctor,
            "fire-and-forget thread: no handle survives to join or stop "
            "it",
        ))
