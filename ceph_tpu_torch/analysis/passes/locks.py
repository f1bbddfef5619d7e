"""lock-discipline: every lock routes through the lockdep factory, and
no blocking device wait runs under a held lock.

A bare ``threading.Lock()`` / ``threading.RLock()`` / ``asyncio.Lock()``
(or a zero-arg ``threading.Condition()``, which embeds one) constructed
anywhere but ``common/lockdep.py`` bypasses lock-order validation — the
dynamic lockdep tier (CEPH_TPU_LOCKDEP=1) can only see locks created by
``make_lock`` / ``make_rlock`` / ``make_async_lock``.  Separately, a
blocking device wait inside a ``with <lock>:`` body serializes every
sibling of that lock behind the device — the priority-inversion shape
the launch scheduler exists to prevent.

The device waits, by the called attribute's name (the receiver cannot
be typed statically, so a CPU tensor's ``.cpu()`` counts as well):

- the reference's: ``block_until_ready``, ``device_put``, ``.result()``
  (kept, so the reference's fixtures still trip);
- torch's: ``synchronize`` (``torch.cuda.synchronize()``,
  ``Event.synchronize()``, ``Stream.synchronize()``), and a tensor's
  ``.cpu()``, ``.item()`` and ``.tolist()``, each of which waits for
  the stream that writes the tensor before it copies to the host.

``Event.query()`` does not count: it returns at once whether or not
the device has finished, so no sibling waits on the device behind it.
``.numpy()`` does not count either: on a CUDA tensor it raises, and the
copy that waits is the ``.cpu()`` before it.
"""

from __future__ import annotations

import ast

from .. import Finding, SourceTree

FACTORY_FILE = "common/lockdep.py"  # the one legitimate constructor site

_BARE = {
    ("threading", "Lock"),
    ("threading", "RLock"),
    ("asyncio", "Lock"),
    ("threading", "Condition"),
    ("asyncio", "Condition"),
}
_DEVICE_WAITS = {
    "block_until_ready", "device_put", "result",
    "synchronize", "cpu", "item", "tolist",
}


def _bare_lock_call(node: ast.Call) -> str | None:
    """`threading.Lock()` etc -> "threading.Lock", else None."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        pair = (fn.value.id, fn.attr)
        if pair in _BARE:
            # Condition(lock) wrapping an instrumented lock is fine —
            # only the zero-arg form fabricates its own hidden RLock
            if fn.attr == "Condition" and (node.args or node.keywords):
                return None
            return ".".join(pair)
    return None


def _looks_like_lock(expr: ast.AST) -> bool:
    """Heuristic for `with <expr>:` guarding a critical section."""
    if isinstance(expr, ast.Name):
        return "lock" in expr.id.lower()
    if isinstance(expr, ast.Attribute):
        return "lock" in expr.attr.lower()
    return False


class LockDisciplinePass:
    PASS_ID = "lock-discipline"
    DESCRIBE = (
        "bare Lock()/RLock()/asyncio.Lock() outside the lockdep factory; "
        "blocking device waits while holding a lock"
    )

    def __call__(self, tree: SourceTree) -> list[Finding]:
        findings: list[Finding] = []
        for sf in tree.files:
            if sf.rel.endswith(FACTORY_FILE):
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    kind = _bare_lock_call(node)
                    if kind is not None:
                        scope = sf.scope_of(node)
                        findings.append(Finding(
                            pass_id=self.PASS_ID,
                            file=sf.rel,
                            line=node.lineno,
                            key=f"{sf.rel}::{scope}::{kind}",
                            message=(
                                f"bare {kind}() constructed outside "
                                "common/lockdep.py — use make_lock/"
                                "make_rlock/make_async_lock so lock-order "
                                "validation sees it"
                            ),
                        ))
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    if not any(
                        _looks_like_lock(item.context_expr)
                        for item in node.items
                    ):
                        continue
                    for sub in ast.walk(node):
                        if not isinstance(sub, ast.Call):
                            continue
                        fn = sub.func
                        attr = fn.attr if isinstance(fn, ast.Attribute) \
                            else (fn.id if isinstance(fn, ast.Name) else "")
                        if attr in _DEVICE_WAITS:
                            scope = sf.scope_of(sub)
                            findings.append(Finding(
                                pass_id=self.PASS_ID,
                                file=sf.rel,
                                line=sub.lineno,
                                key=f"{sf.rel}::{scope}::wait.{attr}",
                                message=(
                                    f"blocking device wait `{attr}` while "
                                    "holding a lock — every sibling of the "
                                    "lock serializes behind the device"
                                ),
                            ))
        return findings
