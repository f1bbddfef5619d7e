"""exception-swallowing: an ``except Exception:`` handler that leaves no
trace is an invisible failure, and one that swallows a device error
hides a dead card.

The reference's rule, kept as it is: a broad handler is fine when it
re-raises, references the caught exception (reply/store/format — the
failure reaches someone), calls a reporting function (``dout``/``clog``/
logger methods/``mark_degraded``), bumps a counter (``.inc(...)`` or an
augmented assignment), or is itself inside a loud context.  Anything
else swallows the failure byte-for-byte.  Key: ``<file>::<scope>``.

The port's device rule: a broad handler that can catch a device error
(``ops.guard.is_device_error``: a kernel that does not build or launch,
a lost card, a guarded call's timeout or refusal) must let it through in
one of three ways, as ROADMAP C26, C29 and C31 did by hand:

- re-raise it (a ``raise`` anywhere in the handler);
- hand it to its owner's device-fails hook: the handler names
  ``is_device_error``, ``DeviceError`` or one of its kinds
  (``DeviceTimeout``, ``DeviceDegraded``), ``_device_fails`` (the
  monitor's wrapper; the MDS, the mgr, rbd-mirror, RGW's front end and
  ``tools/guarded.py`` test ``is_device_error`` and stop or exit),
  ``_device_failed`` (the offload aggregators') or ``mark_degraded``
  (the device guard's: every launch after it is refused with
  ``DeviceDegraded`` until a probe heals);
- turn it into an EIO that reaches the caller: the handler names
  ``EIO`` (``errno.EIO``, ``-EIO``, ``EcError(EIO)``).

Logging or counting a device error is not letting it through.  A
handler that does none of these gets a finding keyed
``<file>::<scope>::device``, so an allowlist entry written for the
plain rule (``<file>::<scope>``) cannot cover it.

"Can catch a device error" is read from imports: a handler is held to
the device rule when its module can reach the device, that is, imports
``torch`` or imports (anywhere in its text, at any depth) a module of
the tree that can.  A module that reaches neither, such as a fixture
with no imports, cannot raise one.
"""

from __future__ import annotations

import ast

from .. import Finding, SourceTree

# call names/attrs that count as "the failure left a trace"
REPORT_CALLS = {
    "dout", "_dout", "log", "clog", "clog_error", "log_error",
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "mark_degraded", "record_error", "print", "fail",
}

# names that let a device error through (see the module docstring)
DEVICE_HOOKS = {
    "is_device_error", "DeviceError", "DeviceTimeout", "DeviceDegraded",
    "_device_fails", "_device_failed", "mark_degraded", "EIO",
}

DEVICE_ROOTS = {"torch"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    """except Exception / except BaseException / bare except — including
    tuple forms containing one of them."""
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_nodes(handler: ast.ExceptHandler):
    return ast.walk(ast.Module(body=handler.body, type_ignores=[]))


def _leaves_trace(handler: ast.ExceptHandler) -> bool:
    alias = handler.name
    for node in _handler_nodes(handler):
        if isinstance(node, ast.Raise):
            return True
        if alias and isinstance(node, ast.Name) and node.id == alias \
                and isinstance(node.ctx, ast.Load):
            return True  # the exception reaches a reply/store/format
        if isinstance(node, ast.AugAssign):
            return True  # counter bump
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in REPORT_CALLS or name == "inc":
                return True
    return False


def _lets_device_error_through(handler: ast.ExceptHandler) -> bool:
    for node in _handler_nodes(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Name) and node.id in DEVICE_HOOKS:
            return True
        if isinstance(node, ast.Attribute) and node.attr in DEVICE_HOOKS:
            return True
    return False


def _module_name(sf, tree: SourceTree) -> tuple[str, bool]:
    """Dotted module path under the tree's root, and whether it is a
    package (`__init__.py`)."""
    rel = sf.path.relative_to(tree.root).with_suffix("")
    parts = list(rel.parts)
    is_pkg = parts[-1] == "__init__"
    if is_pkg:
        parts = parts[:-1]
    return ".".join(parts), is_pkg


def _imports(sf, mod: str, is_pkg: bool) -> set[str]:
    """Every module `sf` imports, anywhere in its text: absolute names as
    written, relative ones resolved against `mod` (both `pkg.name` and
    `pkg`, since `from . import name` may name a module or an object)."""
    out: set[str] = set()
    here = mod.split(".") if mod else []
    base_pkg = here if is_pkg else here[:-1]
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                if node.module:
                    out.add(node.module)
                    out.update(f"{node.module}.{a.name}" for a in node.names)
                continue
            up = node.level - 1
            if up > len(base_pkg):
                continue
            pkg = base_pkg[: len(base_pkg) - up]
            target = pkg + (node.module.split(".") if node.module else [])
            out.add("@" + ".".join(target))
            out.update("@" + ".".join(target + [a.name]) for a in node.names)
    return out


def device_reaching_modules(tree: SourceTree) -> set[str]:
    """rel paths of the tree's modules that can reach the device: import
    `torch`, or import a module of the tree that can (a fixpoint over the
    tree's import graph)."""
    names = {}
    for sf in tree.files:
        names[sf.rel] = _module_name(sf, tree)
    by_mod = {mod: rel for rel, (mod, _pkg) in names.items()}
    root_name = tree.root.name
    edges: dict[str, set[str]] = {}
    reach: set[str] = set()
    for sf in tree.files:
        mod, is_pkg = names[sf.rel]
        deps: set[str] = set()
        for imp in _imports(sf, mod, is_pkg):
            if imp.startswith("@"):
                target = imp[1:]
            else:
                if imp.split(".")[0] in DEVICE_ROOTS:
                    reach.add(sf.rel)
                # an absolute import of the tree's own package
                if imp.split(".")[0] != root_name:
                    continue
                target = imp[len(root_name) + 1:]
            if target in by_mod:
                deps.add(by_mod[target])
        edges[sf.rel] = deps
    changed = True
    while changed:
        changed = False
        for rel, deps in edges.items():
            if rel not in reach and deps & reach:
                reach.add(rel)
                changed = True
    return reach


class ExceptionSwallowPass:
    PASS_ID = "exception-swallowing"
    DESCRIBE = (
        "except Exception: handlers that neither re-raise, log, count, "
        "reference the exception, nor mark DEGRADED; and, where the "
        "module can reach the device, handlers that swallow a device "
        "error (neither re-raise, name is_device_error/DeviceError/"
        "_device_fails, nor answer EIO)"
    )

    def __call__(self, tree: SourceTree) -> list[Finding]:
        findings: list[Finding] = []
        device = device_reaching_modules(tree)
        for sf in tree.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if not _is_broad(node):
                    continue
                scope = sf.scope_of(node)
                if not _leaves_trace(node):
                    findings.append(Finding(
                        pass_id=self.PASS_ID,
                        file=sf.rel,
                        line=node.lineno,
                        key=f"{sf.rel}::{scope}",
                        message=(
                            "broad except handler swallows the failure "
                            "invisibly — re-raise, log (dout/clog), count a "
                            "perf counter, or allowlist with the reason the "
                            "silence is safe"
                        ),
                    ))
                if sf.rel in device and not _lets_device_error_through(node):
                    findings.append(Finding(
                        pass_id=self.PASS_ID,
                        file=sf.rel,
                        line=node.lineno,
                        key=f"{sf.rel}::{scope}::device",
                        message=(
                            "broad except handler can swallow a device "
                            "error — re-raise it, hand it to the owner's "
                            "device-fails hook (is_device_error), answer "
                            "EIO to the caller, or allowlist with the reason "
                            "no device error reaches it"
                        ),
                    ))
        return findings
