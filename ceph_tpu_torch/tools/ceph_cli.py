"""ceph CLI — mirror of src/ceph.in (the admin command shell).

Sends JSON commands to the monitors exactly as the reference CLI builds
cmdmaps, printing the reply:

    python -m ceph_tpu_torch.tools.ceph_cli status
    python -m ceph_tpu_torch.tools.ceph_cli osd dump
    python -m ceph_tpu_torch.tools.ceph_cli osd pool create mypool replicated
    python -m ceph_tpu_torch.tools.ceph_cli osd erasure-code-profile set p1 k=4 m=2

The port's copy of `ceph_tpu/tools/ceph_cli.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..mon.client import MonClient
from .vstart import CLUSTER_FILE, load_monmap

# prefix word-counts the mon understands, longest match first
_PREFIXES = [
    "osd erasure-code-profile set",
    "osd erasure-code-profile get",
    "osd erasure-code-profile ls",
    "osd erasure-code-profile rm",
    "osd pool create",
    "osd pool set-quota",
    "osd pool set",
    "osd pool ls",
    "osd pool get",
    "osd pool application enable",
    "osd pool application get",
    "osd df",
    "log last",
    "health history",
    "health mute",
    "health unmute",
    "health",
    "osd pool rm",
    "osd tier add",
    "osd tier remove-overlay",
    "osd tier remove",
    "osd tier cache-mode",
    "osd tier set-overlay",
    "osd blocklist add",
    "osd blocklist rm",
    "osd blocklist ls",
    "osd reweight",
    "osd dump",
    "osd out",
    "osd in",
    "fs new",
    "fs rm",
    "fs status",
    "quorum_status",
    "status",
    "df",
]


def build_cmd(words: list[str]) -> dict:
    """Tokens → cmdmap (ceph.in's json_command translation)."""
    joined = " ".join(words)
    for prefix in _PREFIXES:
        if joined == prefix or joined.startswith(prefix + " "):
            rest = words[len(prefix.split()):]
            cmd: dict = {"prefix": prefix}
            if prefix == "osd pool create":
                for i, k in enumerate(["pool", "pool_type", "erasure_code_profile"]):
                    if i < len(rest):
                        cmd[k] = rest[i]
            elif prefix == "osd pool set":
                for i, k in enumerate(["pool", "var", "val"]):
                    if i < len(rest):
                        cmd[k] = rest[i]
            elif prefix == "osd pool set-quota":
                for i, k in enumerate(["pool", "field", "val"]):
                    if i < len(rest):
                        cmd[k] = rest[i]
                if "yes_i_really_mean_it" in rest:
                    cmd["yes_i_really_mean_it"] = True
            elif prefix in ("osd pool rm",):
                if rest:
                    cmd["pool"] = rest[0]
            elif prefix == "osd pool get":
                for i, k in enumerate(["pool", "var"]):
                    if i < len(rest):
                        cmd[k] = rest[i]
            elif prefix.startswith("osd pool application"):
                for i, k in enumerate(["pool", "app"]):
                    if i < len(rest):
                        cmd[k] = rest[i]
            elif prefix in ("osd tier add", "osd tier remove"):
                cmd["pool"], cmd["tierpool"] = rest[0], rest[1]
            elif prefix == "osd tier cache-mode":
                cmd["pool"], cmd["mode"] = rest[0], rest[1]
            elif prefix == "osd tier set-overlay":
                cmd["pool"], cmd["overlaypool"] = rest[0], rest[1]
            elif prefix == "osd tier remove-overlay":
                cmd["pool"] = rest[0]
            elif prefix in ("osd blocklist add", "osd blocklist rm"):
                if rest:
                    cmd["entity"] = rest[0]
            elif prefix == "osd reweight":
                cmd["id"], cmd["weight"] = rest[0], rest[1]
            elif prefix in ("osd out", "osd in"):
                cmd["id"] = rest[0]
            elif prefix == "fs new":
                for i, k in enumerate(["fs_name", "metadata", "data"]):
                    if i < len(rest):
                        cmd[k] = rest[i]
            elif prefix == "fs rm":
                if rest:
                    cmd["fs_name"] = rest[0]
            elif prefix == "health":
                # `ceph health detail`: per-daemon breakdown of each check
                if rest and rest[0] == "detail":
                    cmd["detail"] = True
            elif prefix == "log last":
                # `ceph log last [n] [channel] [severity]` — positional n
                # first, then channel/severity keywords in either order
                for r in rest:
                    if r.isdigit():
                        cmd["num"] = int(r)
                    elif r in ("cluster", "audit"):
                        cmd["channel"] = r
                    elif r in ("debug", "info", "warn", "error"):
                        cmd["level"] = r
            elif prefix == "health mute":
                # `ceph health mute <CODE> [<ttl>] [--sticky]`
                for r in rest:
                    if r == "--sticky":
                        cmd["sticky"] = True
                    elif "code" not in cmd:
                        cmd["code"] = r
                    else:
                        cmd["ttl"] = r
            elif prefix == "health unmute":
                if rest:
                    cmd["code"] = rest[0]
            elif prefix == "health history":
                if rest and rest[0].isdigit():
                    cmd["num"] = int(rest[0])
            elif prefix.startswith("osd erasure-code-profile"):
                if rest:
                    cmd["name"] = rest[0]
                    kvs = [r for r in rest[1:] if "=" in r]
                    if kvs:
                        cmd["profile"] = kvs
            return cmd
    return {"prefix": joined}


def _run_tell(args) -> int:
    """`ceph tell <daemon> <cmd> [k=v ...]` — route a command straight to
    a daemon's admin socket (ceph.in's tell path; the daemon must have
    been started with admin sockets, e.g. vstart --asok-dir)."""
    from ..common.admin_socket import admin_command

    daemon, words = args.words[1], args.words[2:]
    with open(args.cluster_file) as f:
        info = json.load(f)
    socks = info.get("admin_sockets", {})
    path = socks.get(daemon)
    if path is None:
        print(
            f"no admin socket for {daemon!r} (have: {sorted(socks)})",
            file=sys.stderr,
        )
        return 1
    prefix_words = [w for w in words if "=" not in w]
    kwargs = dict(w.split("=", 1) for w in words if "=" in w)
    kwargs.pop("timeout", None)  # reserved: the CLI's --timeout flag wins
    try:
        result = admin_command(
            path, " ".join(prefix_words), timeout=args.timeout, **kwargs
        )
    except Exception as e:
        # daemon down, stale socket, unknown command, hook error — all
        # surface as one clean line, not a traceback
        print(f"tell {daemon} failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


async def _run(args) -> int:
    monmap = load_monmap(args.cluster_file)
    client = MonClient("client.ceph-cli", monmap)
    try:
        cmd = build_cmd(args.words)
        rv, rs, out = await client.command(cmd, timeout=args.timeout)
        if out:
            try:
                print(json.dumps(json.loads(out.decode()), indent=2))
            except (json.JSONDecodeError, UnicodeDecodeError):
                sys.stdout.buffer.write(out)
        if rs:
            print(rs, file=sys.stderr)
        return 0 if rv == 0 else 1
    finally:
        await client.msgr.shutdown()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cluster-file", default=CLUSTER_FILE)
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("words", nargs="+")
    args = p.parse_args()
    if args.words[0] == "tell":
        if len(args.words) < 3:
            print("usage: ceph tell <daemon> <command> [k=v ...]",
                  file=sys.stderr)
            sys.exit(1)
        sys.exit(_run_tell(args))
    sys.exit(asyncio.run(_run(args)))


if __name__ == "__main__":
    main()
