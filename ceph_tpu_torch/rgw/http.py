"""S3 REST front end — mirror of src/rgw's REST layer (rgw_rest_s3).

A minimal HTTP/1.1 responder exposing the S3 surface the gateway core
implements: bucket create/delete/list, object PUT/GET/HEAD/DELETE, and
bucket listing with prefix/delimiter.  Requests authenticate with the
AWS v2-style header `Authorization: AWS <access_key>:<signature>`, the
signature being HMAC-SHA1 over the canonical string — the same scheme
rgw_auth_s3.cc verifies (v4 is out of scope).

Path-style addressing only: /<bucket>/<key>.

The port's copy of `ceph_tpu/rgw/http.py`.  Where it differs:

- ROADMAP C26: a request that meets a `RadosError` the gateway does not
  handle (any but a missing object, since C26) is answered `500
  Internal Server Error` with the S3 code `InternalError`; the
  reference's handler lets the error out and closes the connection with
  no answer.
- The lifecycle loop (`_lc_loop`) sleeps `lc_interval` between passes
  and retries a failed pass; it judges no peer, so the rule for the
  daemons' periodic judges (a late tick judges no one) does not apply to
  it.  Expiry is measured on the wall clock by design, as in the
  reference.  A device error (`ops.guard.is_device_error`) is not
  retried: it ends the loop, and `shutdown()` raises it.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
from urllib.parse import parse_qs, unquote, urlparse
from xml.sax.saxutils import escape as _x

from ..client.rados import RadosError
from ..common.log import dout
from ..ops.guard import is_device_error
from .rgw import ObjectGateway, RgwError


def sign_v2(
    secret_key: str,
    method: str,
    path: str,
    date: str,
    content_md5: str = "",
    content_type: str = "",
    amz_date: str = "",
) -> str:
    """AWS signature v2 string-to-sign, as rgw_auth_s3 canonicalizes it:
    Method, Content-MD5, Content-Type, Date, CanonicalizedAmzHeaders,
    CanonicalizedResource.  Covering Content-MD5 binds the signature to
    the request body.  When the client authenticates with x-amz-date
    instead of Date, v2 uses an empty Date line and the x-amz-date value
    rides in the canonicalized amz headers — so the freshness timestamp
    is still signature-covered either way."""
    amz = f"x-amz-date:{amz_date}\n" if amz_date else ""
    string_to_sign = f"{method}\n{content_md5}\n{content_type}\n{date}\n{amz}{path}"
    mac = hmac.new(secret_key.encode(), string_to_sign.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


# AWS rejects requests whose Date is more than 15 minutes off the server
# clock (rgw's RGW_AUTH_GRACE); limits replay of a captured signature.
DATE_SKEW_S = 15 * 60


class S3Server:
    def __init__(
        self, gateway: ObjectGateway, require_auth: bool = False,
        lc_interval: float = 0.0,
    ):
        self.gw = gateway
        self.require_auth = require_auth
        self.lc_interval = lc_interval  # seconds; 0 disables the LC worker
        self._server: asyncio.AbstractServer | None = None
        self._lc_task: asyncio.Task | None = None
        self.addr = ""
        self.lc_errors = 0  # failed lifecycle passes (visible, not silent)

    async def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(self._handle, host, port)
        sock = self._server.sockets[0].getsockname()
        self.addr = f"{sock[0]}:{sock[1]}"
        if self.lc_interval > 0:
            self._lc_task = asyncio.create_task(self._lc_loop())
        return self.addr

    async def _lc_loop(self) -> None:
        """Background lifecycle worker (the RGWLC thread; interval is
        rgw_lc_debug_interval's role in the reference's QA runs)."""
        while True:
            await asyncio.sleep(self.lc_interval)
            try:
                await self.gw.process_lifecycle()
            except Exception as e:
                if is_device_error(e):
                    raise
                # a pool hiccup must not kill the worker — but a
                # lifecycle pass that silently fails every tick would
                # never expire anything and never say so
                self.lc_errors += 1
                dout("rgw", 1, f"lifecycle pass failed: {e!r}")

    async def shutdown(self) -> None:
        failed = None
        if self._lc_task is not None:
            task, self._lc_task = self._lc_task, None
            if task.done() and not task.cancelled():
                failed = task.exception()  # a device error ended the loop
            task.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if failed is not None:
            raise failed

    # -- request handling ------------------------------------------------------

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

    # sentinel: request carried bad credentials (vs None = anonymous)
    _BAD_AUTH = object()

    async def _authenticate(
        self, method: str, path: str, headers: dict, body: bytes
    ):
        """Returns the authenticated uid, None for anonymous, or
        _BAD_AUTH when credentials were presented and failed
        (rgw_auth_s3.cc authorize; SignatureDoesNotMatch)."""
        auth = headers.get("authorization", "")
        if not auth:
            return self._BAD_AUTH if self.require_auth else None
        if not auth.startswith("AWS "):
            return self._BAD_AUTH
        try:
            access_key, signature = auth[4:].split(":", 1)
        except ValueError:
            return self._BAD_AUTH
        date = headers.get("date", "")
        amz_date = headers.get("x-amz-date", "")
        if amz_date:
            # v2: x-amz-date overrides Date; the Date line in the
            # string-to-sign becomes empty and freshness is checked on
            # the amz header instead (rgw accepts either).
            date = ""
            if not self._date_fresh(amz_date):
                return self._BAD_AUTH
        elif not self._date_fresh(date):
            return self._BAD_AUTH
        # The signature covers Content-MD5; when the client sends it, the
        # body must actually hash to it, or an attacker could replay a
        # captured signature with a different body attached.  (v2 treats
        # Content-MD5 as optional — stock clients omit it on PUT — so a
        # body without the header is accepted, as rgw/AWS do; transport
        # security covers that gap.)
        content_md5 = headers.get("content-md5", "")
        if content_md5:
            actual = base64.b64encode(hashlib.md5(body).digest()).decode()
            if not hmac.compare_digest(content_md5, actual):
                return self._BAD_AUTH
        user = await self.gw.user_by_access_key(access_key)
        if user is None:
            return self._BAD_AUTH
        expect = sign_v2(
            user["secret_key"],
            method,
            path,
            date,
            content_md5=content_md5,
            content_type=headers.get("content-type", ""),
            amz_date=amz_date,
        )
        if not hmac.compare_digest(signature, expect):
            return self._BAD_AUTH
        return user["uid"]

    @staticmethod
    def _date_fresh(date: str) -> bool:
        from email.utils import parsedate_to_datetime

        try:
            sent = parsedate_to_datetime(date)
        except (TypeError, ValueError):
            return False
        import datetime

        if sent.tzinfo is None:
            sent = sent.replace(tzinfo=datetime.timezone.utc)
        now = datetime.datetime.now(datetime.timezone.utc)
        return abs((now - sent).total_seconds()) <= DATE_SKEW_S

    async def _route(self, method: str, target: str, headers: dict, body: bytes):
        url = urlparse(target)
        path = unquote(url.path)
        query = parse_qs(url.query, keep_blank_values=True)
        actor = await self._authenticate(method, path, headers, body)
        if actor is self._BAD_AUTH:
            return "403 Forbidden", {}, _error_xml("AccessDenied")
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        try:
            if not bucket:  # service level: list the caller's buckets
                if method == "GET":
                    names = await self.gw.list_buckets(
                        owner=actor if actor else None
                    )
                    xml = "".join(f"<Bucket><Name>{_x(n)}</Name></Bucket>" for n in names)
                    return (
                        "200 OK",
                        {"Content-Type": "application/xml"},
                        f"<ListAllMyBucketsResult><Buckets>{xml}</Buckets>"
                        f"</ListAllMyBucketsResult>".encode(),
                    )
                return "405 Method Not Allowed", {}, b""
            if not key:
                return await self._bucket_op(method, bucket, query, headers, body, actor)
            return await self._object_op(method, bucket, key, body, query, headers, actor)
        except RgwError as e:
            status = {
                "NoSuchBucket": "404 Not Found",
                "NoSuchKey": "404 Not Found",
                "NoSuchVersion": "404 Not Found",
                "NoSuchUpload": "404 Not Found",
                "NoSuchUser": "404 Not Found",
                "NoSuchLifecycleConfiguration": "404 Not Found",
                "AccessDenied": "403 Forbidden",
                "MethodNotAllowed": "405 Method Not Allowed",
                "BucketAlreadyExists": "409 Conflict",
                "BucketNotEmpty": "409 Conflict",
                "UserAlreadyExists": "409 Conflict",
            }.get(e.code, "400 Bad Request")
            return status, {"Content-Type": "application/xml"}, _error_xml(e.code)
        except RadosError:
            return ("500 Internal Server Error", {"Content-Type": "application/xml"},
                    _error_xml("InternalError"))

    @staticmethod
    def _canned_grants(headers: dict) -> dict:
        """x-amz-acl canned ACL -> grant map (rgw_acl_s3.cc canned
        policies; private is the empty grant set — owner only).  READ and
        WRITE are independent permissions, so public-read-write grants
        both explicitly."""
        canned = headers.get("x-amz-acl", "private")
        if canned == "public-read":
            return {"*": "READ"}
        if canned == "public-read-write":
            return {"*": ["READ", "WRITE"]}
        return {}

    async def _bucket_op(
        self, method: str, bucket: str, query: dict, headers: dict,
        body: bytes, actor,
    ):
        if "acl" in query:
            return await self._acl_op(method, bucket, headers, actor)
        if "versioning" in query:
            return await self._versioning_op(method, bucket, body, actor)
        if "lifecycle" in query:
            return await self._lifecycle_op(method, bucket, body, actor)
        if "uploads" in query and method == "GET":
            ups = await self.gw.list_multipart_uploads(bucket, actor=actor)
            rows = "".join(
                f"<Upload><Key>{_x(u['key'])}</Key>"
                f"<UploadId>{_x(u['upload_id'])}</UploadId></Upload>"
                for u in ups
            )
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<ListMultipartUploadsResult>{rows}"
                f"</ListMultipartUploadsResult>".encode(),
            )
        if "versions" in query and method == "GET":
            versions = await self.gw.list_object_versions(
                bucket, prefix=query.get("prefix", [""])[0], actor=actor
            )
            rows = "".join(
                (
                    f"<DeleteMarker><Key>{_x(v['key'])}</Key>"
                    f"<VersionId>{_x(v.get('version_id', 'null'))}</VersionId>"
                    f"<IsLatest>{str(v['is_latest']).lower()}</IsLatest>"
                    f"</DeleteMarker>"
                    if v.get("delete_marker")
                    else f"<Version><Key>{_x(v['key'])}</Key>"
                    f"<VersionId>{_x(v.get('version_id', 'null'))}</VersionId>"
                    f"<IsLatest>{str(v['is_latest']).lower()}</IsLatest>"
                    f"<Size>{v.get('size', 0)}</Size>"
                    f"<ETag>&quot;{v.get('etag', '')}&quot;</ETag></Version>"
                )
                for v in versions
            )
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<ListVersionsResult><Name>{_x(bucket)}</Name>{rows}"
                f"</ListVersionsResult>".encode(),
            )
        if method == "PUT":
            await self.gw.create_bucket(
                bucket, owner=actor or "", grants=self._canned_grants(headers)
            )
            return "200 OK", {}, b""
        if method == "DELETE":
            await self.gw._require_access(bucket, actor, "FULL_CONTROL")
            await self.gw.delete_bucket(bucket)
            return "204 No Content", {}, b""
        if method == "GET":
            listing = await self.gw.list_objects(
                bucket,
                prefix=query.get("prefix", [""])[0],
                delimiter=query.get("delimiter", [""])[0],
                marker=query.get("marker", [""])[0],
                max_keys=_int_arg(query.get("max-keys", ["1000"])[0]),
                actor=actor,
            )
            contents = "".join(
                f"<Contents><Key>{_x(c['key'])}</Key><Size>{c['size']}</Size>"
                f"<ETag>&quot;{c['etag']}&quot;</ETag></Contents>"
                for c in listing["contents"]
            )
            prefixes = "".join(
                f"<CommonPrefixes><Prefix>{_x(p)}</Prefix></CommonPrefixes>"
                for p in listing["common_prefixes"]
            )
            trunc = "true" if listing["is_truncated"] else "false"
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<ListBucketResult><Name>{_x(bucket)}</Name>"
                f"<IsTruncated>{trunc}</IsTruncated>"
                f"{contents}{prefixes}</ListBucketResult>".encode(),
            )
        return "405 Method Not Allowed", {}, b""

    async def _acl_op(self, method: str, bucket: str, headers: dict, actor):
        """?acl subresource: GET dumps the policy, PUT applies a canned
        ACL (x-amz-acl), both owner-gated (RGWGetACLs / RGWPutACLs)."""
        if method == "GET":
            acl = await self.gw.get_bucket_acl(bucket, actor=actor)
            grants = "".join(
                f"<Grant><Grantee>{_x(g)}</Grantee>"
                f"<Permission>{_x(p if isinstance(p, str) else '+'.join(sorted(p)))}"
                f"</Permission></Grant>"
                for g, p in sorted(acl["grants"].items())
            )
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<AccessControlPolicy><Owner><ID>{_x(acl['owner'])}</ID>"
                f"</Owner><AccessControlList>{grants}</AccessControlList>"
                f"</AccessControlPolicy>".encode(),
            )
        if method == "PUT":
            await self.gw.set_bucket_acl(
                bucket, self._canned_grants(headers), actor=actor
            )
            return "200 OK", {}, b""
        return "405 Method Not Allowed", {}, b""

    async def _lifecycle_op(self, method: str, bucket: str, body: bytes, actor):
        """?lifecycle subresource (RGWPutLC/RGWGetLC): expiration rules
        as <Rule><ID/><Prefix/><Expiration><Days/></Expiration></Rule>."""
        import re

        if method == "GET":
            rules = await self.gw.get_lifecycle(bucket, actor=actor)
            xml = "".join(
                f"<Rule><ID>{_x(r['id'])}</ID><Prefix>{_x(r['prefix'])}</Prefix>"
                f"<Status>Enabled</Status><Expiration><Days>{r['days']}</Days>"
                f"</Expiration></Rule>"
                for r in rules
            )
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<LifecycleConfiguration>{xml}</LifecycleConfiguration>".encode(),
            )
        if method == "PUT":
            rules = []
            for rule in re.findall(rb"<Rule>(.*?)</Rule>", body, re.S):
                def field(tag, blob=rule):
                    m = re.search(
                        rb"<" + tag + rb">\s*(.*?)\s*</" + tag + rb">", blob, re.S
                    )
                    return m.group(1).decode() if m else ""

                days = field(rb"Days")
                if not days:
                    continue
                rules.append(
                    {"id": field(rb"ID"), "prefix": field(rb"Prefix"),
                     "days": days}
                )
            await self.gw.set_lifecycle(bucket, rules, actor=actor)
            return "200 OK", {}, b""
        if method == "DELETE":
            await self.gw.set_lifecycle(bucket, [], actor=actor)
            return "204 No Content", {}, b""
        return "405 Method Not Allowed", {}, b""

    async def _versioning_op(self, method: str, bucket: str, body: bytes, actor):
        if method == "GET":
            status = await self.gw.get_versioning(bucket, actor=actor)
            inner = f"<Status>{_x(status)}</Status>" if status else ""
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<VersioningConfiguration>{inner}"
                f"</VersioningConfiguration>".encode(),
            )
        if method == "PUT":
            import re

            m = re.search(rb"<Status>\s*(\w+)\s*</Status>", body)
            status = m.group(1).decode() if m else ""
            await self.gw.set_versioning(bucket, status, actor=actor)
            return "200 OK", {}, b""
        return "405 Method Not Allowed", {}, b""

    async def _object_op(
        self, method: str, bucket: str, key: str, body: bytes, query: dict,
        headers: dict, actor,
    ):
        if "acl" in query:
            # object ?acl subresource (RGWGetACLs/RGWPutACLs on objects)
            if method == "GET":
                acl = await self.gw.get_object_acl(bucket, key, actor=actor)
                grants = "".join(
                    f"<Grant><Grantee>{_x(g)}</Grantee>"
                    f"<Permission>"
                    f"{_x(p if isinstance(p, str) else '+'.join(sorted(p)))}"
                    f"</Permission></Grant>"
                    for g, p in sorted(acl["grants"].items())
                )
                return (
                    "200 OK",
                    {"Content-Type": "application/xml"},
                    f"<AccessControlPolicy><Owner><ID>{_x(acl['owner'])}</ID>"
                    f"</Owner><AccessControlList>{grants}</AccessControlList>"
                    f"</AccessControlPolicy>".encode(),
                )
            if method == "PUT":
                await self.gw.set_object_acl(
                    bucket, key, self._canned_grants(headers), actor=actor
                )
                return "200 OK", {}, b""
            return "405 Method Not Allowed", {}, b""
        version_id = query.get("versionId", [""])[0]
        upload_id = query.get("uploadId", [""])[0]
        if "uploads" in query and method == "POST":
            # InitiateMultipartUpload (RGWInitMultipart)
            uid = await self.gw.initiate_multipart(bucket, key, actor=actor)
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<InitiateMultipartUploadResult><Bucket>{_x(bucket)}</Bucket>"
                f"<Key>{_x(key)}</Key><UploadId>{_x(uid)}</UploadId>"
                f"</InitiateMultipartUploadResult>".encode(),
            )
        if upload_id and method == "PUT":
            # UploadPart
            pn = _int_arg(query.get("partNumber", ["0"])[0])
            etag = await self.gw.upload_part(upload_id, pn, body)
            return "200 OK", {"ETag": f'"{etag}"'}, b""
        if upload_id and method == "GET":
            parts = await self.gw.list_parts(upload_id)
            rows = "".join(
                f"<Part><PartNumber>{p['part_number']}</PartNumber>"
                f"<Size>{p['size']}</Size>"
                f"<ETag>&quot;{p['etag']}&quot;</ETag></Part>"
                for p in parts
            )
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<ListPartsResult>{rows}</ListPartsResult>".encode(),
            )
        if upload_id and method == "POST":
            # CompleteMultipartUpload
            etag = await self.gw.complete_multipart(upload_id, actor=actor)
            return (
                "200 OK",
                {"Content-Type": "application/xml"},
                f"<CompleteMultipartUploadResult><ETag>&quot;{etag}&quot;"
                f"</ETag></CompleteMultipartUploadResult>".encode(),
            )
        if upload_id and method == "DELETE":
            await self.gw.abort_multipart(upload_id)
            return "204 No Content", {}, b""
        if method == "PUT":
            meta = {
                name[len("x-amz-meta-"):]: value
                for name, value in headers.items()
                if name.startswith("x-amz-meta-")
            }
            ct = headers.get("content-type", "")
            if ct:
                meta["content-type"] = ct
            etag, vid = await self.gw.put_object(
                bucket, key, body, meta=meta or None, actor=actor
            )
            hdrs = {"ETag": f'"{etag}"'}
            if vid:
                hdrs["x-amz-version-id"] = vid
            return "200 OK", hdrs, b""
        if method == "GET":
            data = await self.gw.get_object(
                bucket, key, actor=actor, version_id=version_id
            )
            meta = await self.gw.head_object(
                bucket, key, actor=actor, version_id=version_id
            )
            user_meta = meta.get("meta", {})
            hdrs = {
                "ETag": f'"{meta["etag"]}"',
                "Content-Type": user_meta.get(
                    "content-type", "application/octet-stream"
                ),
            }
            for mk, mv in user_meta.items():
                if mk != "content-type":
                    hdrs[f"x-amz-meta-{mk}"] = mv
            if meta.get("version_id"):
                hdrs["x-amz-version-id"] = meta["version_id"]
            return "200 OK", hdrs, data
        if method == "HEAD":
            meta = await self.gw.head_object(
                bucket, key, actor=actor, version_id=version_id
            )
            return (
                "200 OK",
                {"ETag": f'"{meta["etag"]}"', "Content-Length": str(meta["size"])},
                b"",
            )
        if method == "DELETE":
            vid = await self.gw.delete_object(
                bucket, key, actor=actor, version_id=version_id
            )
            hdrs = {}
            if vid:
                hdrs["x-amz-version-id"] = vid
                if not version_id:
                    hdrs["x-amz-delete-marker"] = "true"
            return "204 No Content", hdrs, b""
        return "405 Method Not Allowed", {}, b""


def _error_xml(code: str) -> bytes:
    return f"<Error><Code>{_x(code)}</Code></Error>".encode()


def _int_arg(value: str) -> int:
    """Query-string int with S3's InvalidArgument error (not a dropped
    connection) on junk."""
    try:
        return int(value)
    except ValueError:
        from ..common.errs import EINVAL

        raise RgwError(EINVAL, "InvalidArgument", f"bad integer {value!r}")
