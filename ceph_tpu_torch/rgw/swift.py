"""Swift-compatible API front end — mirror of src/rgw/rgw_swift_auth.cc +
the RGWHandler_REST_*_SWIFT family.

The reference's radosgw speaks both S3 and Swift over the same RGWRados
core; this module is the Swift personality over the same ObjectGateway
the S3 server uses (buckets ARE containers — rgw's own model):

- **TempAuth** (`rgw_swift_auth.cc` swift auth v1): `GET /auth/v1.0` with
  `X-Auth-User: <uid>:swift` + `X-Auth-Key: <secret>` returns an
  `X-Auth-Token` and the account's `X-Storage-Url`; requests present the
  token.  Tokens are HMAC-signed, expiring blobs (not a server-side
  session table), like rgw's swift token encoding.
- **Account**: `GET /v1/AUTH_<acct>` lists containers (plain or
  `?format=json`).
- **Container**: PUT creates, DELETE removes (409 when non-empty), GET
  lists objects with `prefix`/`marker`/`limit`, plain or JSON.
- **Object**: PUT stores (`X-Object-Meta-*` headers persist as user
  metadata), GET returns bytes + ETag + meta, HEAD the same without the
  body, DELETE removes.  ETags are MD5 hex like Swift's.

The port's copy of `ceph_tpu/rgw/swift.py`.  Where it differs (ROADMAP
C26): a request that meets a `RadosError` the gateway does not handle
(any but a missing object, since C26) is answered `500 Internal Server
Error`; the reference's handler lets the error out and closes the
connection with no answer.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import time
from urllib.parse import parse_qs, unquote, urlparse

from ..client.rados import RadosError
from .rgw import ObjectGateway, RgwError

TOKEN_TTL = 3600.0


class SwiftServer:
    def __init__(self, gateway: ObjectGateway, require_auth: bool = True):
        self.gw = gateway
        self.require_auth = require_auth
        self._server: asyncio.AbstractServer | None = None
        self.addr = ""
        import secrets

        self._token_secret = secrets.token_bytes(16)

    async def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(self._handle, host, port)
        sock = self._server.sockets[0].getsockname()
        self.addr = f"{sock[0]}:{sock[1]}"
        return self.addr

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- tokens (TempAuth) -----------------------------------------------------

    def _mint_token(self, uid: str) -> str:
        expires = time.time() + TOKEN_TTL
        body = f"{uid}:{expires}"
        sig = hmac.new(
            self._token_secret, body.encode(), hashlib.sha256
        ).hexdigest()
        return f"AUTH_tk_{body}:{sig}"

    def _verify_token(self, token: str) -> str | None:
        if not token.startswith("AUTH_tk_"):
            return None
        try:
            uid, expires, sig = token[len("AUTH_tk_"):].rsplit(":", 2)
            body = f"{uid}:{expires}"
            expect = hmac.new(
                self._token_secret, body.encode(), hashlib.sha256
            ).hexdigest()
            if not hmac.compare_digest(sig, expect):
                return None
            if float(expires) < time.time():
                return None
            return uid
        except ValueError:
            return None

    # -- http plumbing (shares the S3 server's minimal HTTP shape) -------------

    async def _handle(self, reader, writer) -> None:
        try:
            request = await reader.readline()
            if not request:
                return
            method, target, _version = request.decode().split(" ", 2)
            headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode().partition(":")
                headers[name.strip().lower()] = value.strip()
            body = b""
            if "content-length" in headers:
                body = await reader.readexactly(int(headers["content-length"]))
            status, resp_headers, resp_body = await self._route(
                method, target, headers, body
            )
            writer.write(f"HTTP/1.1 {status}\r\n".encode())
            resp_headers.setdefault("Content-Length", str(len(resp_body)))
            resp_headers.setdefault("Connection", "close")
            for k, v in resp_headers.items():
                writer.write(f"{k}: {v}\r\n".encode())
            writer.write(b"\r\n")
            writer.write(resp_body)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            writer.close()

    # -- routing ---------------------------------------------------------------

    async def _route(self, method: str, target: str, headers: dict, body: bytes):
        url = urlparse(target)
        path = unquote(url.path)
        query = parse_qs(url.query, keep_blank_values=True)

        if path == "/auth/v1.0":
            return await self._auth(method, headers)

        if not path.startswith("/v1/AUTH_"):
            return "404 Not Found", {}, b"not a swift path"
        account_path = path[len("/v1/AUTH_"):]
        parts = account_path.split("/", 2)
        account = parts[0]
        container = parts[1] if len(parts) > 1 else ""
        obj = parts[2] if len(parts) > 2 else ""

        uid = None
        if self.require_auth:
            uid = self._verify_token(headers.get("x-auth-token", ""))
            anonymous_read = (
                uid is None and container and method in ("GET", "HEAD")
            )
            if uid is None and not anonymous_read:
                # anonymous traffic may only attempt reads — which a
                # container's .r:* (AllUsers) READ grant can then allow;
                # everything else needs a token (rgw_swift anon handling)
                return "401 Unauthorized", {}, b""
            # account-level ops and container CREATION belong to the
            # account's owner; other container/object access across
            # accounts is decided by container ACLs (rgw_swift's
            # read/write ACL model)
            if not container and uid != account:
                return "403 Forbidden", {}, b""
            if container and not obj and method == "PUT" and uid != account:
                return "403 Forbidden", {}, b""

        try:
            if not container:
                return await self._account_op(method, account, query, uid)
            if not obj:
                return await self._container_op(method, container, query,
                                                headers, uid)
            return await self._object_op(
                method, container, obj, headers, body, uid
            )
        except RgwError as e:
            status = {
                "NoSuchBucket": "404 Not Found",
                "NoSuchKey": "404 Not Found",
                "AccessDenied": "403 Forbidden",
                "BucketNotEmpty": "409 Conflict",
            }.get(e.code, "400 Bad Request")
            return status, {}, b""
        except RadosError:
            return "500 Internal Server Error", {}, b""

    @staticmethod
    def _acl_grantees(value: str, perm: str) -> list[str]:
        """X-Container-Read/Write -> grantee list: ".r:*" is world READ,
        otherwise a comma list of account uids (rgw_swift ACL parsing).
        Referrer tokens are READ-only — the reference rejects them in
        write ACLs, where a world-WRITE would be catastrophic."""
        out = []
        for tok in (t.strip() for t in value.split(",")):
            if not tok:
                continue
            if tok in (".r:*", ".referrer:*"):
                if perm != "READ":
                    from ..common.errs import EINVAL

                    raise RgwError(
                        EINVAL, "InvalidArgument",
                        "referrer tokens are read-only",
                    )
                out.append("*")
            else:
                out.append(tok)
        return out

    def _merge_acl_headers(self, grants: dict, headers: dict) -> dict:
        """Apply X-Container-Read/Write headers onto a grant map keeping
        READ and WRITE lists INDEPENDENT per grantee (swift's two ACL
        lists): setting one list never disturbs the other."""
        merged: dict[str, set] = {
            g: set(p if isinstance(p, (list, set)) else [p])
            for g, p in grants.items()
        }
        for hdr, perm in (
            ("x-container-read", "READ"), ("x-container-write", "WRITE")
        ):
            if hdr not in headers:
                continue
            for perms in merged.values():
                perms.discard(perm)
            for grantee in self._acl_grantees(headers[hdr], perm):
                merged.setdefault(grantee, set()).add(perm)
        return {g: sorted(p) for g, p in merged.items() if p}

    async def _auth(self, method: str, headers: dict):
        if method != "GET":
            return "405 Method Not Allowed", {}, b""
        user_hdr = headers.get("x-auth-user", "")
        key = headers.get("x-auth-key", "")
        uid = user_hdr.split(":", 1)[0]
        try:
            user = await self.gw.get_user(uid)
        except RgwError:
            return "401 Unauthorized", {}, b""
        # TempAuth checks the swift key; the gateway's secret_key plays it
        if not hmac.compare_digest(key, user["secret_key"]):
            return "401 Unauthorized", {}, b""
        token = self._mint_token(uid)
        return (
            "200 OK",
            {
                "X-Auth-Token": token,
                "X-Storage-Token": token,
                "X-Storage-Url": f"http://{self.addr}/v1/AUTH_{uid}",
            },
            b"",
        )

    async def _account_op(self, method: str, account: str, query: dict, uid):
        if method not in ("GET", "HEAD"):
            return "405 Method Not Allowed", {}, b""
        names = await self.gw.list_buckets(owner=uid if uid else None)
        if method == "HEAD":
            return "204 No Content", {"X-Account-Container-Count": str(len(names))}, b""
        if query.get("format", [""])[0] == "json":
            return (
                "200 OK",
                {"Content-Type": "application/json"},
                json.dumps([{"name": n} for n in names]).encode(),
            )
        return (
            "200 OK",
            {"Content-Type": "text/plain"},
            ("\n".join(names) + "\n" if names else "").encode(),
        )

    async def _container_op(
        self, method: str, container: str, query: dict, headers: dict, uid
    ):
        if method == "PUT":
            try:
                await self.gw.create_bucket(
                    container, owner=uid or "",
                    grants=self._merge_acl_headers({}, headers),
                )
                return "201 Created", {}, b""
            except RgwError as e:
                if e.code != "BucketAlreadyExists":
                    raise
            # existing container: swift's PUT is a metadata update — ACL
            # headers apply, gated on FULL_CONTROL like any ACL change
            # (a non-owner gets 403, not a silent 202)
            acl = await self.gw.get_bucket_acl(container, actor=uid)
            await self.gw.set_bucket_acl(
                container, self._merge_acl_headers(acl["grants"], headers),
                actor=uid,
            )
            return "202 Accepted", {}, b""
        if method == "POST":
            # update container ACLs (swift POST metadata semantics)
            acl = await self.gw.get_bucket_acl(container, actor=uid)
            await self.gw.set_bucket_acl(
                container, self._merge_acl_headers(acl["grants"], headers),
                actor=uid,
            )
            return "204 No Content", {}, b""
        if method == "DELETE":
            await self.gw._require_access(container, uid, "FULL_CONTROL")
            await self.gw.delete_bucket(container)
            return "204 No Content", {}, b""
        if method in ("GET", "HEAD"):
            listing = await self.gw.list_objects(
                container,
                prefix=query.get("prefix", [""])[0],
                marker=query.get("marker", [""])[0],
                max_keys=int(query.get("limit", ["10000"])[0]),
                actor=uid,
            )
            if method == "HEAD":
                return (
                    "204 No Content",
                    {"X-Container-Object-Count": str(len(listing["contents"]))},
                    b"",
                )
            if query.get("format", [""])[0] == "json":
                return (
                    "200 OK",
                    {"Content-Type": "application/json"},
                    json.dumps(
                        [
                            {
                                "name": c["key"],
                                "bytes": c["size"],
                                "hash": c["etag"],
                            }
                            for c in listing["contents"]
                        ]
                    ).encode(),
                )
            names = [c["key"] for c in listing["contents"]]
            return (
                "200 OK",
                {"Content-Type": "text/plain"},
                ("\n".join(names) + "\n" if names else "").encode(),
            )
        return "405 Method Not Allowed", {}, b""

    async def _object_op(
        self, method: str, container: str, obj: str, headers: dict,
        body: bytes, uid,
    ):
        if method == "PUT":
            meta = {
                name[len("x-object-meta-"):]: value
                for name, value in headers.items()
                if name.startswith("x-object-meta-")
            }
            etag, _vid = await self.gw.put_object(
                container, obj, body, meta=meta, actor=uid
            )
            return "201 Created", {"ETag": etag}, b""
        if method in ("GET", "HEAD"):
            info = await self.gw.head_object(container, obj, actor=uid)
            resp_headers = {
                "ETag": info["etag"],
                "Content-Type": "application/octet-stream",
                "X-Timestamp": str(info.get("mtime", 0)),
            }
            for mk, mv in info.get("meta", {}).items():
                resp_headers[f"X-Object-Meta-{mk}"] = mv
            if method == "HEAD":
                resp_headers["Content-Length"] = str(info["size"])
                return "200 OK", resp_headers, b""
            data = await self.gw.get_object(container, obj, actor=uid)
            return "200 OK", resp_headers, data
        if method == "DELETE":
            await self.gw.head_object(container, obj, actor=uid)  # 404 if absent
            await self.gw.delete_object(container, obj, actor=uid)
            return "204 No Content", {}, b""
        return "405 Method Not Allowed", {}, b""
