"""ledger-discipline: device-buffer residency outside the HBM mempool
ledger is invisible residency.

``common/mempool.py`` exists so every byte resident on the device is
attributable to a named pool.  That property only holds if new code
keeps the discipline.  Two forms are checked in the data-path packages
(``ops/``, ``codec/``, ``parallel/``, ``compressor/``):

- the reference's: every ``jax.device_put`` call, as there (its fixtures
  still trip);
- the port's: a host-to-device placement whose result outlives the
  call — assigned to an attribute (``self.masks = ...``), a subscript
  (``_TABLES[key] = ...``, a module-level cache) or a name at module
  level, directly or through one local name that a later statement of
  the function keeps that way or hands to a container's storing method
  (``setdefault``, ``append``, ``put``, ``_lru_put``, ...) — such as a
  plan's operand or a program table.  A placement is
  a ``.cuda(...)``, a ``.to(...)`` that names a device (a string
  starting ``cuda``, a ``device=`` keyword, a name containing ``dev``,
  or ``torch.device(...)``; ``torch.from_numpy(a).to(dev)`` is one), a
  ``torch.as_tensor`` / ``torch.tensor`` with a ``device=`` keyword,
  and a ``.copy_(...)`` whose result is kept.

Either is fine when it is threaded through a mempool-tracked helper —
``track_buffer(...)`` or ``track_placement(...)`` (the port's: it
charges only a buffer off the host) wrapping the call, or an explicit
``ledger().alloc(...)`` handle in the same function.  Transient scratch
inside one call (a placement bound to a local name, passed to a kernel
and dropped) does not count: it is charged nowhere and lives no longer
than the launch.  Intentional untracked sites get an allowlist entry
with a reason (``analysis/allowlists/ledger-discipline.allow``), like
every other pass.
"""

from __future__ import annotations

import ast

from .. import Finding, SourceTree

# packages whose device_put calls must be ledger-tracked: the EC data
# path's HBM holders, plus the compressor package now that the device
# plugin places block batches through the offload runtime.
# Matched as path components so the fixture trees in tests
# (pkg/ops/x.py) scope the same way the live tree does.
_SCOPED_DIRS = {"ops", "codec", "parallel", "compressor"}

_TRACKED_WRAPPERS = {"track_buffer", "track_placement", "tracked_device_put", "_hbm_track"}

# names a ledger factory goes by at call sites: `<factory>().alloc(...)`
# is the explicit-handle spelling the pass accepts.  A bare `.alloc` on
# an arbitrary receiver (slots.alloc(), arena.alloc(n)) must NOT count
# — it would silence the only gate enforcing the ledger invariant.
_LEDGER_FACTORIES = {"ledger", "_hbm_ledger", "hbm_ledger", "_hbm"}


def _callable_name(fn: ast.AST) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _in_scope(rel: str) -> bool:
    parts = rel.split("/")
    return any(p in _SCOPED_DIRS for p in parts[:-1])


def _names_device(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.startswith("cuda")
    if isinstance(expr, ast.Name):
        return "dev" in expr.id.lower()
    if isinstance(expr, ast.Attribute):
        return "dev" in expr.attr.lower()
    if isinstance(expr, ast.Call):
        return _callable_name(expr.func) == "device"
    return False


def _placement(node: ast.Call) -> str | None:
    """The placement's name when `node` puts host bytes on the device
    (see the module docstring), else None."""
    name = _callable_name(node.func)
    if not isinstance(node.func, ast.Attribute):
        return None
    if name in ("cuda", "copy_"):
        return name
    if name == "to":
        if any(kw.arg == "device" for kw in node.keywords):
            return name
        if any(_names_device(a) for a in node.args):
            return name
        return None
    if name in ("as_tensor", "tensor") and \
            isinstance(node.func.value, ast.Name) and \
            node.func.value.id == "torch":
        if any(kw.arg == "device" for kw in node.keywords):
            return name
    return None


def _kept_targets(sf, stmt: ast.AST) -> bool:
    """Whether an assignment keeps its value beyond the call: a target
    that is an attribute, a subscript, or a name at module level (or
    declared global in its function)."""
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    else:
        return False
    func = sf.enclosing_function(stmt)
    globals_ = set()
    if func is not None:
        for node in ast.walk(func):
            if isinstance(node, ast.Global):
                globals_.update(node.names)
    for tgt in targets:
        for sub in ast.walk(tgt):
            if isinstance(sub, (ast.Attribute, ast.Subscript)) and \
                    isinstance(sub.ctx, ast.Store):
                return True
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store) \
                    and (func is None or sub.id in globals_):
                return True
    return False


# container methods that keep what they are handed
_STORE_METHODS = {"setdefault", "append", "extend", "insert", "add", "put",
                  "_lru_put", "update"}


def _loads(expr: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _kept_names(sf, func: ast.AST) -> set[str]:
    """Local names of `func` that a statement keeps: read in the value of
    a kept assignment, or handed to a container's storing method."""
    out: set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None and _kept_targets(sf, node):
            out |= _loads(node.value)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _STORE_METHODS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                out |= _loads(arg)
    return out


class LedgerDisciplinePass:
    PASS_ID = "ledger-discipline"
    DESCRIBE = (
        "jax.device_put, or a torch placement kept beyond its call, in "
        "ops//codec//parallel//compressor/ outside a mempool-tracked "
        "helper (track_buffer or an explicit ledger alloc handle)"
    )

    def __call__(self, tree: SourceTree) -> list[Finding]:
        findings: list[Finding] = []
        for sf in tree.files:
            if not _in_scope(sf.rel):
                continue
            wrapped = self._wrapped_calls(sf)
            findings.extend(self._kept_placements(sf, wrapped))
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                if _callable_name(node.func) != "device_put":
                    continue
                if id(node) in wrapped:
                    continue
                if self._function_allocs(sf, node):
                    continue
                findings.append(Finding(
                    pass_id=self.PASS_ID,
                    file=sf.rel,
                    line=node.lineno,
                    key=f"{sf.rel}::{sf.scope_of(node)}::device_put",
                    message=(
                        "device_put commits bytes to HBM outside the "
                        "mempool ledger — wrap it in track_buffer(...) "
                        "or account it with ledger().alloc(...) so "
                        "dump_mempools and the pressure layer see the "
                        "residency"
                    ),
                ))
        return findings

    def _kept_placements(self, sf, wrapped: set[int]) -> list[Finding]:
        out = []
        kept_locals: dict[int, set[str]] = {}
        for stmt in ast.walk(sf.tree):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            if stmt.value is None:
                continue
            if not _kept_targets(sf, stmt):
                # a local binding: kept when the function keeps the name
                func = sf.enclosing_function(stmt)
                if func is None:
                    continue
                if id(func) not in kept_locals:
                    kept_locals[id(func)] = _kept_names(sf, func)
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                names = {n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)}
                if not names & kept_locals[id(func)]:
                    continue
            for node in ast.walk(stmt.value):
                if not isinstance(node, ast.Call):
                    continue
                kind = _placement(node)
                if kind is None or id(node) in wrapped:
                    continue
                if self._function_allocs(sf, node):
                    continue
                out.append(Finding(
                    pass_id=self.PASS_ID,
                    file=sf.rel,
                    line=node.lineno,
                    key=f"{sf.rel}::{sf.scope_of(node)}::place.{kind}",
                    message=(
                        f"`.{kind}(...)` keeps a device placement beyond "
                        "the call outside the mempool ledger — wrap it in "
                        "track_buffer(...) or account it with "
                        "ledger().alloc(...) so dump_mempools and the "
                        "pressure layer see the residency"
                    ),
                ))
                break  # one finding a statement: the outermost placement
        return out

    @staticmethod
    def _wrapped_calls(sf) -> set[int]:
        """ids of device_put (and placement) Call nodes that appear
        inside an argument of a track_buffer/tracked_device_put call."""
        out: set[int] = set()
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callable_name(node.func) not in _TRACKED_WRAPPERS:
                continue
            # positional AND keyword arguments: track_buffer(buf=...)
            # is tracked too
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Call) and (
                            _callable_name(sub.func) == "device_put"
                            or _placement(sub) is not None):
                        out.add(id(sub))
        return out

    @staticmethod
    def _function_allocs(sf, call: ast.Call) -> bool:
        """True when the enclosing (non-lambda) function also takes an
        explicit LEDGER handle — an ``.alloc(...)`` whose receiver is a
        ledger factory call (``ledger().alloc(...)`` /
        ``_hbm_ledger().alloc(...)``, the device_cache.put shape: the
        device_put result is accounted a few lines later under the
        cache lock).  An ``.alloc`` on any other receiver
        (slots.alloc(), arena.alloc(n)) does NOT count, and a
        track_buffer call elsewhere in the function does NOT excuse a
        bare device_put next to it — per-call wrapping is checked by
        _wrapped_calls, so counting it here would let one tracked
        placement silence every untracked sibling."""
        func = sf.enclosing_function(call)
        if func is None:
            return False
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "alloc":
                    recv = node.func.value
                    if isinstance(recv, ast.Call) and \
                            _callable_name(recv.func) in _LEDGER_FACTORIES:
                        return True
        return False
