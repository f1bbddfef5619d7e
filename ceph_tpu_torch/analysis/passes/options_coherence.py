"""config-option coherence: the option table, the code, and the docs
agree.

Four checks over ``common/options.py``'s table — the port's own
(``ceph_tpu_torch/common/options.py``), read in place:

- ``unread``: an option no code ever reads is dead weight — or worse,
  an operator knob that silently does nothing.
- ``unwired-runtime``: an option declared ``runtime=True`` must either
  be re-read per use (a read inside a non-``__init__`` function) or
  have a config observer (``add_observer``) — an init-time-only read
  means a runtime ``config set`` silently changes nothing.
- ``undocumented``: every option name appears in ``docs/``
  (docs/OPTIONS.md is the index this pass enforces) or, for an option
  only the port has, in the port's own index
  ``ceph_tpu_torch/OPTIONS.md``.
- ``unregistered-read``: ``conf.get("name")`` with a literal not in the
  table — a typo'd knob that can only fail at runtime, if ever.

Option-name "reads" are any string literal equal to the name anywhere
outside ``options.py`` — plus f-string literal PREFIXES ending in ``_``
(``f"ec_tpu_sched_{lane}_{knob}"`` wires the whole family), matching
how the observer registrations are actually written.
"""

from __future__ import annotations

import ast

from .. import Finding, SourceTree

OPTIONS_FILE = "common/options.py"


def _load_real_options():
    from ...common.options import OPTIONS

    return {
        name: {"runtime": opt.runtime} for name, opt in OPTIONS.items()
    }


class _Read:
    __slots__ = ("file", "line", "scope", "in_observer")

    def __init__(self, file, line, scope, in_observer):
        self.file, self.line = file, line
        self.scope, self.in_observer = scope, in_observer


class OptionsCoherencePass:
    PASS_ID = "config-coherence"
    DESCRIBE = (
        "every option read somewhere, observer-wired or re-read per use "
        "if runtime-mutable, documented in docs/, and no unregistered "
        "name read"
    )

    def __init__(self, options: dict | None = None):
        # injectable for fixture tests; None = the live table
        self._options = options

    def __call__(self, tree: SourceTree) -> list[Finding]:
        options = self._options
        if options is None:
            options = _load_real_options()
        reads: dict[str, list[_Read]] = {name: [] for name in options}
        prefix_reads: list[tuple[str, _Read]] = []
        conf_get_literals: list[tuple[str, object, object]] = []
        opt_line: dict[str, int] = {}

        for sf in tree.files:
            is_options_file = sf.rel.endswith(OPTIONS_FILE)
            observer_spans = _observer_string_nodes(sf)
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    s = node.value
                    if is_options_file:
                        if s in options:
                            opt_line.setdefault(s, node.lineno)
                        continue
                    rd = _Read(sf.rel, node.lineno,
                               _live_scope(sf, node),
                               id(node) in observer_spans)
                    if s in options:
                        reads[s].append(rd)
                    # f-string literal prefix: covers name families
                    if id(node) in _joined_fragments(sf) and \
                            s.endswith("_"):
                        prefix_reads.append((s, rd))
                if isinstance(node, ast.Call) and not is_options_file:
                    lit = _conf_get_literal(node)
                    if lit is not None:
                        conf_get_literals.append((lit, sf, node))

        findings: list[Finding] = []
        for name, meta in sorted(options.items()):
            live_prefix = [
                rd for frag, rd in prefix_reads if name.startswith(frag)
            ]
            all_reads = reads[name] + live_prefix
            line = opt_line.get(name, 1)
            if not all_reads:
                findings.append(Finding(
                    pass_id=self.PASS_ID,
                    file=OPTIONS_FILE, line=line,
                    key=f"unread::{name}",
                    message=(
                        f"option `{name}` is never read anywhere in the "
                        "package — dead knob (wire it or remove it)"
                    ),
                ))
                continue
            if meta["runtime"]:
                wired = any(rd.in_observer for rd in all_reads) or any(
                    rd.scope != "<module>"
                    and not rd.scope.split(".")[-1] == "__init__"
                    for rd in all_reads
                )
                if not wired:
                    findings.append(Finding(
                        pass_id=self.PASS_ID,
                        file=OPTIONS_FILE, line=line,
                        key=f"unwired-runtime::{name}",
                        message=(
                            f"runtime-mutable option `{name}` is only read "
                            "at init time and has no config observer — a "
                            "runtime `config set` silently changes nothing"
                        ),
                    ))
        docs = tree.docs_text()
        for name in sorted(options):
            if name not in docs:
                findings.append(Finding(
                    pass_id=self.PASS_ID,
                    file=OPTIONS_FILE, line=opt_line.get(name, 1),
                    key=f"undocumented::{name}",
                    message=(
                        f"option `{name}` is not documented anywhere under "
                        "docs/ (docs/OPTIONS.md is the index) nor in the "
                        "package's OPTIONS.md"
                    ),
                ))
        for lit, sf, node in conf_get_literals:
            if lit not in options:
                findings.append(Finding(
                    pass_id=self.PASS_ID,
                    file=sf.rel, line=node.lineno,
                    key=f"unregistered-read::{lit}",
                    message=(
                        f"conf.get({lit!r}) reads a name that is not in "
                        "the option table — typo'd knob"
                    ),
                ))
        return findings


def _live_scope(sf, node) -> str:
    """Scope qualname, with reads inside a Lambda counted as their own
    (deferred) scope — `Reserver(lambda: conf.get("osd_max_backfills"))`
    re-reads at every call, which is runtime-mutable-safe."""
    import ast as _ast

    cur = node
    while cur in sf.parents:
        cur = sf.parents[cur]
        if isinstance(cur, _ast.Lambda):
            return "<lambda>"
    return sf.scope_of(node)


def _conf_get_literal(node: ast.Call) -> str | None:
    """`<...>conf.get("lit")` / `conf["lit"]`-style reads (the receiver
    must be named conf/config so plain dict .get()s don't false-trip)."""
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "get"):
        return None
    recv = fn.value
    recv_name = recv.attr if isinstance(recv, ast.Attribute) else (
        recv.id if isinstance(recv, ast.Name) else "")
    if recv_name not in ("conf", "config", "_conf"):
        return None
    if node.args and isinstance(node.args[0], ast.Constant) and \
            isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _observer_string_nodes(sf) -> set[int]:
    """ids of string-constant nodes that appear inside an
    add_observer(...) call's arguments."""
    out: set[int] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            attr = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if attr != "add_observer":
                continue
            for arg in node.args:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Constant) and \
                            isinstance(sub.value, str):
                        out.add(id(sub))
    return out


def _joined_fragments(sf) -> set[int]:
    """ids of string constants that are literal fragments of f-strings
    (JoinedStr) — the prefix-wiring spelling."""
    cache = getattr(sf, "_joined_cache", None)
    if cache is None:
        cache = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.JoinedStr):
                for v in node.values:
                    if isinstance(v, ast.Constant):
                        cache.add(id(v))
        sf._joined_cache = cache
    return cache
