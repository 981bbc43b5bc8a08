"""retain-release: PagePool ownership must balance on every exit path.

The port's copy of dllama_tpu/analysis/rules_kv.py.

Two cross-request KV races this rule guards against were refcount-pairing
holes: a ``match`` without ``retain`` across a tick gap, and a publish path whose matched
pages could be evicted mid-flow. This rule walks every function that
touches a page pool (``*.retain(...)``, ``*.alloc(...)``,
``*.fork(...)`` on a receiver whose name ends in ``pool``) with a small
path-sensitive interpreter and checks the ownership protocol:

* a ``retain(E)`` / ``alloc()``->var / ``fork()``->var opens a token;
* ``release(E)``, storing into a ``*_lane_pages``-style map
  (subscript-store mentioning the token), ``tree.insert(... token ...)``
  and ``reset(...)`` close it (transfer of ownership IS balance —
  the new owner's release path takes over);
* returning the token hands ownership to the caller (closed here);
* every ``return`` / ``break`` / ``continue`` / fall-off-the-end must
  see zero open tokens (``finally`` closers count on return paths);
* while a token is open and not protected by a ``finally``/``except``
  that closes it, no *risky* call may run — a risky call is anything
  that can raise out of the accounting's control (``self.engine.*``,
  free functions, other objects); pool/tree/recorder/metric calls and
  builtins are safe. This is exactly the shape of those races: device
  work dispatched while holding unprotected page refs.

Path handling is approximate by design: ``if``/``try`` branch states
are tracked as sets (capped), loop bodies are evaluated once, and the
handler entry state over-approximates to "everything the body may have
opened". False positives get an inline
``# dlint: disable=retain-release — why`` at the opening site.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from .core import Finding, Rule, SourceModule, dotted

MAX_STATES = 128

_SAFE_BUILTINS = {
    "len", "list", "min", "max", "sorted", "range", "int", "str", "float",
    "tuple", "set", "dict", "isinstance", "round", "sum", "zip", "enumerate",
    "abs", "repr", "print",
}
_SAFE_RECEIVER_PARTS = ("pool", "tree", "recorder", "logger", "logging")


class _Token:
    __slots__ = ("kind", "key", "line")

    def __init__(self, kind: str, key: str, line: int) -> None:
        self.kind = kind  # "retain" | "pages"
        self.key = key    # dotted expr ("mr.pages") or var name ("pages")
        self.line = line

    def __hash__(self):
        return hash((self.kind, self.key, self.line))

    def __eq__(self, other):
        return (self.kind, self.key, self.line) == (
            other.kind, other.key, other.line
        )

    def describe(self) -> str:
        verb = "retained" if self.kind == "retain" else "allocated"
        return f"pool pages {verb} at line {self.line} ({self.key!r})"


def _is_pool_call(node: ast.Call, names: tuple[str, ...]) -> bool:
    fn = node.func
    return (
        isinstance(fn, ast.Attribute)
        and fn.attr in names
        and dotted(fn.value).split(".")[-1].endswith("pool")
    )


def _names_in(node: ast.AST) -> set[str]:
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, (ast.Name, ast.Attribute)):
            out.add(dotted(n))
    return out


def _call_is_risky(call: ast.Call) -> str | None:
    """Dotted callee name if the call can raise outside the accounting's
    control, else None."""
    fn = call.func
    name = dotted(fn)
    if isinstance(fn, ast.Name):
        return None if fn.id in _SAFE_BUILTINS else name
    if isinstance(fn, ast.Attribute):
        parts = name.split(".")
        if parts[0] == "self":
            if len(parts) >= 3 and parts[1] == "engine":
                return name  # device dispatch: the canonical risky call
            if any(p.endswith(_SAFE_RECEIVER_PARTS) for p in parts[:-1]):
                return None
            return None  # other self.* helpers: accounting-local
        if any(p.endswith(_SAFE_RECEIVER_PARTS) for p in parts[:-1]):
            return None
        return name
    return name


class _Ctx:
    def __init__(self) -> None:
        self.finally_closers: set[str] = set()   # token keys
        self.raise_protected: set[str] = set()   # token keys
        self.loop_entry: frozenset | None = None
        self.findings: list[tuple[int, str]] = []
        self.risk_reported: set[_Token] = set()

    def copy(self) -> "_Ctx":
        c = _Ctx.__new__(_Ctx)
        c.finally_closers = set(self.finally_closers)
        c.raise_protected = set(self.raise_protected)
        c.loop_entry = self.loop_entry
        c.findings = self.findings          # shared accumulator
        c.risk_reported = self.risk_reported
        return c


class RetainReleaseRule(Rule):
    name = "retain-release"
    description = (
        "PagePool retain/alloc/fork must be released or ownership-"
        "transferred on every exit path, and protected across calls "
        "that may raise"
    )

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._touches_pool(node):
                    yield from self._check_function(mod, node)

    def _touches_pool(
        self, fn: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> bool:
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and _is_pool_call(
                n, ("retain", "alloc", "fork")
            ):
                return True
        return False

    # -- interpreter --------------------------------------------------------

    def _check_function(
        self, mod: SourceModule, fn: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> Iterator[Finding]:
        ctx = _Ctx()
        states = {frozenset()}
        states = self._eval(fn.body, states, ctx)
        end_line = getattr(fn, "end_lineno", fn.lineno)
        for st in states:
            for tok in st:
                ctx.findings.append((
                    end_line,
                    f"{tok.describe()} is neither released nor ownership-"
                    f"transferred on some path through {fn.name}()",
                ))
        seen: set[tuple[int, str]] = set()
        for line, msg in ctx.findings:
            if (line, msg) in seen:
                continue
            seen.add((line, msg))
            yield mod.finding(self.name, line, msg)

    def _eval(
        self, stmts: list, states: set, ctx: "_Ctx"
    ) -> set:
        for s in stmts:
            if len(states) > MAX_STATES:
                states = {frozenset().union(*states)}
            if isinstance(s, ast.If):
                a = self._eval(s.body, set(states), ctx.copy())
                b = self._eval(s.orelse, set(states), ctx.copy())
                states = a | b
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                states = self._eval(s.body, states, ctx)
            elif isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                inner = ctx.copy()
                inner.loop_entry = frozenset().union(*states) if states \
                    else frozenset()
                body_states = self._eval(s.body, set(states), inner)
                states = states | body_states
                states = self._eval(s.orelse, states, ctx)
            elif isinstance(s, ast.Try):
                states = self._eval_try(s, states, ctx)
            elif isinstance(s, ast.Return):
                self._exit_check(s, states, ctx, "return")
                return set()  # path ends
            elif isinstance(s, (ast.Break, ast.Continue)):
                self._loop_exit_check(s, states, ctx)
                return set()
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                continue  # nested defs analyzed on their own
            elif isinstance(s, ast.Raise):
                # an explicit raise with open unprotected tokens leaks
                self._exit_check(s, states, ctx, "raise", protected_ok=True)
                return set()
            else:
                states = {self._apply(s, st, ctx) for st in states}
        return states

    def _eval_try(
        self, s: ast.Try, states: set, ctx: "_Ctx"
    ) -> set:
        fin_closers = self._closers(s.finalbody)
        exc_closers = set()
        for h in s.handlers:
            exc_closers |= self._closers(h.body)
        body_ctx = ctx.copy()
        body_ctx.finally_closers |= fin_closers
        body_ctx.raise_protected |= fin_closers | exc_closers
        entry = set(states)
        after_body = self._eval(s.body, set(states), body_ctx)
        after_body = self._eval(s.orelse, after_body, body_ctx)
        # handlers start from "anything the body may have opened"
        handler_entry = entry | after_body
        out = set(after_body)
        for h in s.handlers:
            out |= self._eval(h.body, set(handler_entry), ctx.copy())
        out = self._eval(s.finalbody, out, ctx)
        return out

    # -- transfer / open / close extraction ---------------------------------

    def _closers(self, stmts: list) -> set[str]:
        """Token KEYS closed anywhere in a statement list (used to mark
        finally/except protection)."""
        keys: set[str] = set()
        for s in stmts:
            for n in ast.walk(s):
                if isinstance(n, ast.Call):
                    fn = n.func
                    if _is_pool_call(n, ("release",)) and n.args:
                        keys.add(dotted(n.args[0]))
                    elif isinstance(fn, ast.Attribute) and fn.attr in (
                        "reset", "clear",
                    ):
                        keys.add("*")
                    elif isinstance(fn, ast.Attribute) and fn.attr == \
                            "insert":
                        for a in n.args:
                            keys |= _names_in(a)
        return keys

    def _apply(
        self, stmt: ast.stmt, state: frozenset, ctx: "_Ctx"
    ) -> frozenset:
        opened: list[_Token] = []
        closed_keys: set[str] = set()
        close_all = False

        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            if _is_pool_call(n, ("retain",)) and n.args:
                opened.append(
                    _Token("retain", dotted(n.args[0]), n.lineno)
                )
            elif _is_pool_call(n, ("release",)) and n.args:
                closed_keys.add(dotted(n.args[0]))
            elif isinstance(fn, ast.Attribute) and fn.attr == "reset":
                close_all = True
            elif isinstance(fn, ast.Attribute) and fn.attr == "insert":
                # tree.insert(tokens, pages, ...) — ownership transfer
                for a in list(n.args) + [k.value for k in n.keywords]:
                    closed_keys |= _names_in(a)

        # alloc/fork results bound to a name open a "pages" token
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            has_alloc = value is not None and any(
                isinstance(n, ast.Call)
                and _is_pool_call(n, ("alloc", "fork"))
                for n in ast.walk(value)
            )
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign)
                else [stmt.target]
            )
            if has_alloc and not isinstance(stmt, ast.AugAssign):
                for t in targets:
                    if isinstance(t, (ast.Name, ast.Attribute)):
                        opened.append(
                            _Token("pages", dotted(t), stmt.lineno)
                        )
            # subscript-store transfer: self._lane_pages[lane] = pages
            for t in targets:
                if isinstance(t, ast.Subscript) and value is not None:
                    closed_keys |= _names_in(value)

        # risky-call audit BEFORE applying closers: the call runs while
        # the tokens opened earlier are still live (tokens opened in THIS
        # statement are its own result and cannot leak through it)
        risky = None
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                risky = _call_is_risky(n)
                if risky:
                    break
        if risky:
            for tok in state:
                if tok.key in ctx.raise_protected or \
                        "*" in ctx.raise_protected:
                    continue
                if tok in ctx.risk_reported:
                    continue
                ctx.risk_reported.add(tok)
                ctx.findings.append((
                    stmt.lineno,
                    f"{tok.describe()} may leak if {risky}() raises here "
                    f"(no enclosing finally/except releases it)",
                ))

        new = set(state)
        if close_all:
            new.clear()
        else:
            new = {
                t for t in new
                if t.key not in closed_keys
            }
        new.update(opened)
        # token self-close within the same statement
        # (e.g. release(alloc(...)) — degenerate but keeps things sane)
        if closed_keys:
            new = {t for t in new if t.key not in closed_keys}
        return frozenset(new)

    # -- exit checks --------------------------------------------------------

    def _exit_check(self, stmt, states, ctx, how, protected_ok=False):
        returned = (
            _names_in(stmt.value)
            if isinstance(stmt, ast.Return) and stmt.value is not None
            else set()
        )
        for st in states:
            for tok in st:
                if tok.key in ctx.finally_closers or \
                        "*" in ctx.finally_closers:
                    continue  # finally releases it on the way out
                if tok.key in returned:
                    continue  # ownership handed to the caller
                if protected_ok and (
                    tok.key in ctx.raise_protected
                    or "*" in ctx.raise_protected
                ):
                    continue
                ctx.findings.append((
                    stmt.lineno,
                    f"{tok.describe()} is not released before the {how} "
                    f"at line {stmt.lineno}",
                ))

    def _loop_exit_check(self, stmt, states, ctx):
        entry = ctx.loop_entry or frozenset()
        kw = "break" if isinstance(stmt, ast.Break) else "continue"
        for st in states:
            for tok in st:
                if tok in entry:
                    continue
                if tok.key in ctx.finally_closers or \
                        "*" in ctx.finally_closers:
                    continue
                ctx.findings.append((
                    stmt.lineno,
                    f"{tok.describe()} is not released before the {kw} "
                    f"at line {stmt.lineno}",
                ))
