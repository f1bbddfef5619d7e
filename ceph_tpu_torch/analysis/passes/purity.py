"""jit-purity: host side effects inside traced closures bake in one
value forever.

A ``time.time()``, ``np.random`` draw, lock acquisition, ``faultpoint``
check, perf-counter ``.inc`` or global mutation inside a function that
is traced or captured runs ONCE — at trace or capture time — and its
value is burned into the compiled program or the recorded graph.  The
fault never fires again, the timestamp never advances, the counter
counts compiles instead of launches.  Scope: the kernel dirs (``ops/``,
``codec/``, ``parallel/``), where every traced function must be pure
tensor math.

What is traced: the reference's forms (``@jax.jit``, ``jax.jit(f)``,
``shard_map`` and ``pmap`` bodies, so its fixtures still trip), and the
port's: ``@torch.compile`` / ``torch.compile(f)``, ``@torch.jit.script``
/ ``torch.jit.script(f)`` / ``torch.jit.trace(f, ...)``, and the body of
a CUDA-graph capture, ``with torch.cuda.graph(g):``.  The port has none
of these today: its kernels are hand-written CUDA launched from plain
Python, so the live tree gives no finding, and the pass is there for the
first one that comes.
"""

from __future__ import annotations

import ast

from .. import Finding, SourceTree

SCOPE_DIRS = ("ops/", "codec/", "parallel/")

_TIME_FNS = {"time", "monotonic", "perf_counter", "perf_counter_ns",
             "time_ns", "process_time"}
_JIT_WRAPPERS = {"jit", "shard_map", "_shard_map", "pmap"}


def _in_scope(rel: str) -> bool:
    return any(f"/{d}" in rel or rel.startswith(d) for d in SCOPE_DIRS)


def _callable_name(fn: ast.AST) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_torch_tracer(fn: ast.AST) -> bool:
    """torch.compile, torch.jit.script, torch.jit.trace (qualified, so
    the builtin `compile` and `re.compile` do not count)."""
    if not isinstance(fn, ast.Attribute):
        return False
    base = fn.value
    if fn.attr == "compile":
        return isinstance(base, ast.Name) and base.id == "torch"
    if fn.attr in ("script", "trace"):
        return isinstance(base, ast.Attribute) and base.attr == "jit"
    return False


def _is_jit_call(node: ast.Call) -> bool:
    """jax.jit(...), functools.partial(jax.jit, ...), shard_map(...),
    torch.compile(...), torch.jit.script(...)."""
    name = _callable_name(node.func)
    if name in _JIT_WRAPPERS or _is_torch_tracer(node.func):
        return True
    if name == "partial" and node.args:
        return _callable_name(node.args[0]) in _JIT_WRAPPERS or \
            _is_torch_tracer(node.args[0])
    return False


def _is_graph_capture(node: ast.AST) -> bool:
    """`with torch.cuda.graph(g):` (any receiver's `.graph(...)` under
    `cuda`)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr == "graph" and \
                isinstance(expr.func.value, ast.Attribute) and \
                expr.func.value.attr == "cuda":
            return True
    return False


def _jitted_functions(sf) -> list[tuple[ast.AST, str]]:
    """(function node, how) for every lexically-traced function body:
    decorated defs, `jax.jit(f)` / `shard_map(f, ...)` over a local def
    or lambda."""
    out = []
    local_defs: dict[str, ast.AST] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local_defs.setdefault(node.name, node)
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and _is_jit_call(dec):
                    out.append((node, "decorator"))
                elif _callable_name(dec) in _JIT_WRAPPERS or \
                        _is_torch_tracer(dec):
                    out.append((node, "decorator"))
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and _is_jit_call(node):
            for arg in node.args:
                if isinstance(arg, ast.Lambda):
                    out.append((arg, "wrapped"))
                elif isinstance(arg, ast.Name) and arg.id in local_defs:
                    out.append((local_defs[arg.id], "wrapped"))
        elif _is_graph_capture(node):
            out.append((node, "captured"))
    return out


def _impurities(func: ast.AST) -> list[tuple[ast.AST, str]]:
    found = []
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                base = fn.value
                if isinstance(base, ast.Name) and base.id == "time" \
                        and fn.attr in _TIME_FNS:
                    found.append((node, f"host clock time.{fn.attr}()"))
                elif isinstance(base, ast.Attribute) and \
                        base.attr == "random" and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id in ("np", "numpy"):
                    found.append((node, f"np.random.{fn.attr}() host RNG"))
                elif isinstance(base, ast.Name) and base.id == "random":
                    found.append((node, f"random.{fn.attr}() host RNG"))
                elif fn.attr == "acquire":
                    found.append((node, "lock acquisition"))
                elif fn.attr == "inc":
                    found.append((node, "perf-counter .inc() mutation"))
            elif isinstance(fn, ast.Name):
                if fn.id in ("faultpoint", "_faultpoint"):
                    found.append((node, "faultpoint() check"))
                elif fn.id == "print":
                    found.append((node, "print() host I/O"))
        elif isinstance(node, ast.Global):
            found.append((node, "global-variable mutation"))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                attr = expr.attr if isinstance(expr, ast.Attribute) else (
                    expr.id if isinstance(expr, ast.Name) else "")
                if "lock" in attr.lower():
                    found.append((node, "lock held inside the trace"))
    return found


class JitPurityPass:
    PASS_ID = "jit-purity"
    DESCRIBE = (
        "host side effects (clocks, RNG, locks, faultpoints, counters) "
        "reachable inside jax.jit/shard_map/torch.compile/torch.jit "
        "closures and CUDA-graph capture bodies in ops/, codec/, parallel/"
    )

    def __call__(self, tree: SourceTree) -> list[Finding]:
        findings: list[Finding] = []
        for sf in tree.files:
            if not _in_scope(sf.rel):
                continue
            seen: set[int] = set()
            for func, how in _jitted_functions(sf):
                if id(func) in seen:
                    continue
                seen.add(id(func))
                fname = getattr(func, "name", None) or (
                    sf.scope_of(func) if how == "captured" else "<lambda>")
                for node, what in _impurities(func):
                    findings.append(Finding(
                        pass_id=self.PASS_ID,
                        file=sf.rel,
                        line=node.lineno,
                        key=f"{sf.rel}::{fname}::{what.split('(')[0].strip()}",
                        message=(
                            f"{what} inside traced function `{fname}` — "
                            "runs once at trace time and bakes its value "
                            "into the executable"
                        ),
                    ))
        return findings
