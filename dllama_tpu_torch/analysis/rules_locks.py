"""guarded-attrs: lock discipline on shared attributes.

The port's copy of dllama_tpu/analysis/rules_locks.py.

The project convention (kv/manager.py, obs/*, the engine compile cache):
a class that creates a ``threading.Lock``/``RLock``/``Condition`` in an
attribute guards some of its state with it. This rule infers the guarded
set — any attribute *written* while holding one of the class's locks in
a non-``__init__`` method — and then flags every read or write of a
guarded attribute performed without holding a class lock.

What counts as a write (all of these mutate shared state):

* plain / augmented / annotated assignment to ``self.X``;
* subscript stores and deletes (``self.X[k] = v``, ``del self.X[k]``);
* calls to container mutators (``self.X.append(...)``, ``.pop``,
  ``.clear``, ``.update`` …).

Exemptions, matching how the code is actually safe:

* ``__init__`` — construction happens-before publication to any other
  thread, so unlocked writes there are fine (and do not mark an
  attribute as guarded by themselves);
* methods named ``*_locked`` — the project suffix for "caller holds the
  lock" helpers;
* bodies of functions nested inside a method are analyzed as holding NO
  lock even when defined inside a ``with`` block: closures outlive the
  block (thread targets, callbacks), so assuming the lock there would
  hide exactly the bug this rule exists for.

Intentional unlocked accesses (racy-but-benign monitoring reads, double-
checked locking fast paths) take an inline
``# dlint: disable=guarded-attrs — why`` with the why spelled out.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from .core import Finding, Rule, SourceModule, is_self_attr, iter_methods

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
# lockwatch.make_lock()/make_condition() return drop-in locks
LOCK_FACTORY_FUNCS = {"make_lock", "make_condition"}

MUTATORS = {
    "append", "appendleft", "pop", "popleft", "popitem", "clear", "extend",
    "extendleft", "insert", "remove", "update", "add", "discard",
    "setdefault", "sort", "reverse",
}


def _is_lock_factory(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in LOCK_FACTORIES | LOCK_FACTORY_FUNCS
    if isinstance(fn, ast.Name):
        return fn.id in LOCK_FACTORIES | LOCK_FACTORY_FUNCS
    return False


class _Access:
    __slots__ = ("attr", "method", "line", "locks", "is_write")

    def __init__(self, attr, method, line, locks, is_write):
        self.attr = attr
        self.method = method
        self.line = line
        self.locks = locks
        self.is_write = is_write


class GuardedAttrsRule(Rule):
    name = "guarded-attrs"
    description = (
        "attributes written under a class lock must not be read or "
        "written elsewhere without it"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(mod, node)

    # -- per-class analysis -------------------------------------------------

    def _check_class(
        self, mod: SourceModule, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return
        accesses: list[_Access] = []
        for meth in iter_methods(cls):
            self._visit_stmts(
                meth.body, frozenset(), meth.name, lock_attrs, accesses
            )
        # guarded = written under a lock outside __init__
        guarded: dict[str, tuple[str, str]] = {}
        for a in sorted(accesses, key=lambda a: (a.attr, a.method, a.line)):
            if a.is_write and a.locks and a.method != "__init__":
                guarded.setdefault(a.attr, (sorted(a.locks)[0], a.method))
        for a in accesses:
            if a.attr not in guarded:
                continue
            if a.locks or a.method == "__init__":
                continue
            if a.method.endswith("_locked"):
                continue  # project convention: caller holds the lock
            lock, writer = guarded[a.attr]
            kind = "written" if a.is_write else "read"
            yield mod.finding(
                self.name,
                a.line,
                f"{cls.name}.{a.attr} is guarded by self.{lock} "
                f"(written under it in {writer}()) but {kind} without a "
                f"lock in {a.method}()",
            )

    def _lock_attrs(self, cls: ast.ClassDef) -> set[str]:
        found: set[str] = set()
        for meth in iter_methods(cls):
            for node in ast.walk(meth):
                if isinstance(node, ast.Assign) and _is_lock_factory(
                    node.value
                ):
                    for t in node.targets:
                        if is_self_attr(t):
                            found.add(t.attr)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    if _is_lock_factory(node.value) and is_self_attr(
                        node.target
                    ):
                        found.add(node.target.attr)
        return found

    # -- traversal with a held-locks context --------------------------------

    def _visit_stmts(
        self,
        stmts: list,
        held: frozenset,
        method: ast.FunctionDef | ast.AsyncFunctionDef,
        lock_attrs: set,
        out: list,
    ) -> None:
        for s in stmts:
            if isinstance(s, (ast.With, ast.AsyncWith)):
                newly = set()
                for item in s.items:
                    ce = item.context_expr
                    self._scan(ce, held, method, lock_attrs, out)
                    if is_self_attr(ce) and ce.attr in lock_attrs:
                        newly.add(ce.attr)
                    # `with self._lock` spelled as acquire-style contexts
                    # (e.g. `with self._lock.locked_scope()`) is out of
                    # convention; only the bare attribute form is a guard.
                self._visit_stmts(
                    s.body, held | frozenset(newly), method, lock_attrs, out
                )
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure may run after the with-block exits: no lock
                for d in s.decorator_list:
                    self._scan(d, held, method, lock_attrs, out)
                self._visit_stmts(
                    s.body, frozenset(), method, lock_attrs, out
                )
            elif isinstance(s, ast.ClassDef):
                continue  # nested classes analyzed independently
            elif isinstance(s, ast.If):
                self._scan(s.test, held, method, lock_attrs, out)
                self._visit_stmts(s.body, held, method, lock_attrs, out)
                self._visit_stmts(s.orelse, held, method, lock_attrs, out)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                self._scan(s.target, held, method, lock_attrs, out)
                self._scan(s.iter, held, method, lock_attrs, out)
                self._visit_stmts(s.body, held, method, lock_attrs, out)
                self._visit_stmts(s.orelse, held, method, lock_attrs, out)
            elif isinstance(s, ast.While):
                self._scan(s.test, held, method, lock_attrs, out)
                self._visit_stmts(s.body, held, method, lock_attrs, out)
                self._visit_stmts(s.orelse, held, method, lock_attrs, out)
            elif isinstance(s, ast.Try):
                self._visit_stmts(s.body, held, method, lock_attrs, out)
                for h in s.handlers:
                    self._visit_stmts(h.body, held, method, lock_attrs, out)
                self._visit_stmts(s.orelse, held, method, lock_attrs, out)
                self._visit_stmts(s.finalbody, held, method, lock_attrs, out)
            else:
                self._scan(s, held, method, lock_attrs, out)

    def _scan(
        self,
        node: ast.AST,
        held: frozenset,
        method: ast.FunctionDef | ast.AsyncFunctionDef,
        lock_attrs: set,
        out: list,
    ) -> None:
        """Record self-attribute reads/writes in an expression (or simple
        statement) subtree."""
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and is_self_attr(n):
                if n.attr in lock_attrs:
                    continue
                if isinstance(n.ctx, (ast.Store, ast.Del)):
                    out.append(_Access(n.attr, method, n.lineno, held, True))
                else:
                    out.append(_Access(n.attr, method, n.lineno, held, False))
            elif isinstance(n, ast.Subscript) and isinstance(
                n.ctx, (ast.Store, ast.Del)
            ):
                if is_self_attr(n.value) and n.value.attr not in lock_attrs:
                    out.append(
                        _Access(n.value.attr, method, n.lineno, held, True)
                    )
            elif isinstance(n, ast.Call) and isinstance(
                n.func, ast.Attribute
            ):
                tgt = n.func.value
                if (
                    n.func.attr in MUTATORS
                    and is_self_attr(tgt)
                    and tgt.attr not in lock_attrs
                ):
                    out.append(
                        _Access(tgt.attr, method, n.lineno, held, True)
                    )
