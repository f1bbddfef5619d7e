"""donation-lifetime: a buffer donated to the device is dead to the
host.

The reference's rule: ``jax.jit(..., donate_argnums=(k,))`` transfers
ownership of argument k to the runtime at call time — XLA may alias the
output onto it, and a later host read of the same variable observes
whatever the kernel scribbled.  The pass tracks donating callables —
defs decorated with a ``donate_argnums`` jit, names bound to
``jax.jit(..., donate_argnums=...)``, and calls through factories
invoked with ``donate=True`` — and flags any read of a donated variable
that is sequentially after the donating call in the same function scope
(same-branch, not re-bound in between).  Those forms still trip here.

The port donates by handing a recycled device buffer to a kernel as
its output: ``LaunchAggregator._dispatch(g, data, donate)`` (the engine
in ``ops/offload_runtime.py`` and its services in
``codec/matrix_codec.py``, ``ops/checksum_offload.py`` and
``compressor/device.py``) donates its third argument, and
``encode_array`` / ``decode_array(..., out=buf)`` donate ``buf``.  After
the call the buffer holds the launch's output, which the call returns;
a host read of the donated name, in the same scope and not rebound,
reads a buffer the kernel owns (and may still be writing, or that the
donation pool hands to the next launch).  ``donate = _dispatch(g, data,
donate)`` rebinds it and is fine.
"""

from __future__ import annotations

import ast

from .. import Finding, SourceTree


def _callable_name(fn: ast.AST) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _donated_positions(call: ast.Call) -> tuple[int, ...] | None:
    """The donate_argnums tuple of a jax.jit(...) call, if present."""
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Tuple):
                out = []
                for e in v.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, int):
                        out.append(e.value)
                return tuple(out)
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
            return ()  # present but unresolvable: treat arg 0 as donated
    return None


def _jit_donations(call: ast.Call) -> tuple[int, ...] | None:
    """donate positions when `call` is jax.jit(...)/partial(jax.jit,...)
    with donate_argnums; None otherwise."""
    name = _callable_name(call.func)
    if name == "jit":
        return _donated_positions(call)
    if name == "partial" and call.args and \
            _callable_name(call.args[0]) == "jit":
        return _donated_positions(call)
    return None


def _collect_donating_callables(sf) -> dict[str, tuple[int, ...]]:
    """name -> donated positions, for decorated defs and jit-bound
    names in this module."""
    out: dict[str, tuple[int, ...]] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call):
                    pos = _jit_donations(dec)
                    if pos is not None:
                        out[node.name] = pos or (0,)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            pos = _jit_donations(node.value)
            if pos is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = pos or (0,)
    return out


def _stmt_index_path(sf, node: ast.AST) -> list[tuple[ast.AST, str, int]]:
    """Path of (parent, field, index) statement coordinates from the
    module down to `node` — the basis for branch-aware ordering."""
    chain = sf.ancestors(node) + [node]
    path = []
    for parent, child in zip(chain, chain[1:]):
        for field, value in ast.iter_fields(parent):
            if isinstance(value, list) and child in value:
                path.append((parent, field, value.index(child)))
                break
    return path


def _sequentially_after(sf, first: ast.AST, later: ast.AST) -> bool:
    """True when `later` executes after `first` in straight-line order:
    they share a statement list downstream of their common ancestor (or
    body→finalbody/orelse of a Try or loop), and `later`'s position is
    greater.  Sibling branches (if/else arms, except handlers) are NOT
    sequential."""
    pa = _stmt_index_path(sf, first)
    pb = _stmt_index_path(sf, later)
    for (na, fa, xa), (nb, fb, xb) in zip(pa, pb):
        if na is not nb:
            return False  # diverged without a shared statement list
        if fa == fb:
            if xa == xb:
                continue  # same statement: descend further
            return xb > xa
        # different fields of the same parent node
        if isinstance(na, ast.Try):
            # try-body -> finally always runs after; try-body -> else
            # runs after normal completion.  body -> handler is NOT
            # sequential (the donation may not have happened).
            return (fa, fb) in (("body", "finalbody"), ("body", "orelse"),
                                ("handlers", "finalbody"),
                                ("orelse", "finalbody"))
        if isinstance(na, (ast.For, ast.AsyncFor, ast.While)):
            return (fa, fb) == ("body", "orelse")
        return False  # if/else arms and everything else: parallel
    return False


def _rebound_between(func: ast.AST, name: str, sf,
                     call: ast.Call, read: ast.Name) -> bool:
    """Was `name` re-assigned sequentially between the call and the
    read?  A rebind kills the donated binding — the read is fresh."""
    for node in ast.walk(func):
        if isinstance(node, ast.Name) and node.id == name and \
                isinstance(node.ctx, ast.Store):
            if node is read:
                continue
            if _sequentially_after(sf, call, node) and \
                    _sequentially_after(sf, node, read):
                return True
    return False


class DonationLifetimePass:
    PASS_ID = "donation-lifetime"
    DESCRIBE = (
        "host reads of a buffer after it was passed in a donate_argnums/"
        "donate=True position, as _dispatch's donate or encode_array/"
        "decode_array's out= (use-after-donation)"
    )

    def __call__(self, tree: SourceTree) -> list[Finding]:
        # donating callables are collected package-wide (a decorated def
        # in ops/ is called from codec/), keyed by bare name
        donating: dict[str, tuple[int, ...]] = {}
        for sf in tree.files:
            donating.update(_collect_donating_callables(sf))
        findings: list[Finding] = []
        for sf in tree.files:
            for func in ast.walk(sf.tree):
                if not isinstance(func, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                # local bindings shadow the package-wide map
                local = dict(donating)
                if not isinstance(func, ast.Lambda):
                    local.update(_collect_donating_callables_scope(func))
                for call in ast.walk(func):
                    if not isinstance(call, ast.Call):
                        continue
                    donated_args = self._donated_args(call, local)
                    for arg in donated_args:
                        if not isinstance(arg, ast.Name):
                            continue
                        findings.extend(self._reads_after(
                            sf, func, call, arg.id
                        ))
        return findings

    @staticmethod
    def _enclosing_stmt(sf, node: ast.AST) -> ast.stmt | None:
        cur = node
        while cur in sf.parents:
            if isinstance(cur, ast.stmt):
                return cur
            cur = sf.parents[cur]
        return None

    @staticmethod
    def _donated_args(call: ast.Call, donating) -> list[ast.AST]:
        """Argument expressions donated by this call."""
        name = _callable_name(call.func)
        if name in donating:
            pos = donating[name]
            return [call.args[i] for i in pos if i < len(call.args)]
        # the port's: _dispatch(g, data, donate) and
        # encode_array/decode_array(..., out=buf)
        if name == "_dispatch" and len(call.args) >= 3:
            return [call.args[2]]
        if name in ("encode_array", "decode_array"):
            return [kw.value for kw in call.keywords if kw.arg == "out"]
        # factory(..., donate=True)(buf): the outer call's args are all
        # donated — the factory built a donating executable
        if isinstance(call.func, ast.Call):
            for kw in call.func.keywords:
                if kw.arg == "donate" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return list(call.args)
        return []

    def _reads_after(self, sf, func, call: ast.Call,
                     varname: str) -> list[Finding]:
        # `x, p = donating(x, p)` immediately rebinds the donated name to
        # the call's RESULT — the canonical safe donation idiom; later
        # reads see the fresh buffer, not the dead one
        stmt = self._enclosing_stmt(sf, call)
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name) and sub.id == varname \
                            and isinstance(sub.ctx, ast.Store):
                        return []
        out = []
        for node in ast.walk(func):
            if not (isinstance(node, ast.Name) and node.id == varname
                    and isinstance(node.ctx, ast.Load)):
                continue
            # the donating call's own argument reads don't count
            if node.lineno == call.lineno and any(
                    node is a or node in ast.walk(a)
                    for a in call.args + [kw.value for kw in call.keywords]):
                continue
            if not _sequentially_after(sf, call, node):
                continue
            if _rebound_between(func, varname, sf, call, node):
                continue
            out.append(Finding(
                pass_id=self.PASS_ID,
                file=sf.rel,
                line=node.lineno,
                key=f"{sf.rel}::{sf.scope_of(node)}::{varname}",
                message=(
                    f"`{varname}` read after being donated to the device "
                    f"at line {call.lineno} — the buffer may alias the "
                    "kernel's output or already be deleted "
                    "(use-after-donation)"
                ),
            ))
        return out


def _collect_donating_callables_scope(func) -> dict[str, tuple[int, ...]]:
    """Scope-local `f = jax.jit(..., donate_argnums=...)` bindings."""
    out: dict[str, tuple[int, ...]] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            pos = _jit_donations(node.value)
            if pos is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = pos or (0,)
    return out
