"""Object gateway core — mirror of src/rgw's storage layer (rgw_rados /
the SAL RadosStore).

The reference (236k LoC; SURVEY.md §2.7) layers S3/Swift semantics over
RADOS: buckets with an index, objects whose head holds metadata and
whose data stripes over tail objects, multipart uploads assembled from
parts, users with access keys.  The same shapes here:

- **Users** live in a registry object (`user.<id>` in the reference's
  user pool; one JSON registry object here) carrying access/secret keys
  (RGWUserInfo).
- **Buckets**: a bucket record plus a **bucket index** object listing
  keys → {size, etag, mtime} (the reference's bucket index omap,
  cls_rgw); listing with prefix/marker/delimiter walks it exactly like
  RGWRados::Bucket::List with CommonPrefixes.
- **Objects**: data stripes over RADOS via the striper (the reference's
  head+tail manifest, rgw_obj_manifest); etag = md5 of the body as S3
  requires (RGWPutObj_ObjProcessor).
- **Multipart**: parts upload as their own striped objects; complete
  concatenates them into the final object and drops the parts
  (RGWCompleteMultipart).

The port's copy of `ceph_tpu/rgw/rgw.py`.  Where it differs (ROADMAP
C26): a registry, a bucket index or an upload record reads as empty only
when its object does not exist or holds no JSON, and the index's and the
upload record's removes pass over only a missing object
(`client/absent.py`).  The reference catches every exception around
those reads, so an EIO from a degraded read made the next `put_object`
store an index holding only its own key.  Every other error reaches the
caller as `RadosError`, which the S3 and Swift front ends answer with
500.  Nothing here touches the device: the kernels run in the OSDs.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import time

from ..client.absent import parse_json, unless_absent
from ..common.errs import EEXIST, EINVAL, ENOENT, EPERM
from ..striper import StripedObject, StripePolicy

USERS_OID = "rgw.users"
BUCKETS_OID = "rgw.buckets"

# ACL permissions (rgw_acl.h RGW_PERM_*): READ and WRITE are INDEPENDENT
# bits, as in the reference — a write-only grant must not disclose object
# bytes (the Swift drop-box pattern) and a read grant must not allow
# writes.  FULL_CONTROL implies both plus ACL administration.  A grant
# value is one permission or a list of them.
ALL_USERS = "*"  # the AllUsers group grantee (anonymous included)


def _perm_set(value) -> set[str]:
    perms = {value} if isinstance(value, str) else set(value)
    if "FULL_CONTROL" in perms:
        perms |= {"READ", "WRITE"}
    return perms


class RgwError(Exception):
    def __init__(self, err: int, code: str, msg: str = ""):
        self.errno = -abs(err)
        self.code = code  # S3 error code (NoSuchBucket, ...)
        super().__init__(f"{code}: {msg}")


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class ObjectGateway:
    """The gateway's storage operations (rgw::sal::RadosStore analog);
    one instance per pool-backed zone."""

    def __init__(self, ioctx, policy: StripePolicy | None = None):
        self.ioctx = ioctx
        self.policy = policy or StripePolicy(
            stripe_unit=512 * 1024, stripe_count=1, object_size=4 * 1024 * 1024
        )

    # -- registries ------------------------------------------------------------

    async def _load(self, oid: str) -> dict:
        return parse_json(await unless_absent(self.ioctx.read(oid)), {})

    async def _store(self, oid: str, data: dict) -> None:
        await self.ioctx.write_full(oid, json.dumps(data).encode())

    # -- users (RGWUserInfo) ---------------------------------------------------

    async def create_user(self, uid: str, display_name: str = "") -> dict:
        users = await self._load(USERS_OID)
        if uid in users:
            raise RgwError(EEXIST, "UserAlreadyExists", uid)
        user = {
            "uid": uid,
            "display_name": display_name or uid,
            "access_key": secrets.token_hex(10).upper(),
            "secret_key": secrets.token_hex(20),
        }
        users[uid] = user
        await self._store(USERS_OID, users)
        return user

    async def get_user(self, uid: str) -> dict:
        users = await self._load(USERS_OID)
        if uid not in users:
            raise RgwError(ENOENT, "NoSuchUser", uid)
        return users[uid]

    async def user_by_access_key(self, access_key: str) -> dict | None:
        users = await self._load(USERS_OID)
        for user in users.values():
            if user["access_key"] == access_key:
                return user
        return None

    # -- buckets ---------------------------------------------------------------

    def _index_oid(self, bucket: str) -> str:
        return f"rgw.bucket.index.{bucket}"

    async def create_bucket(
        self, bucket: str, owner: str = "", grants: dict | None = None
    ) -> None:
        """`grants` maps grantee (uid or "*" AllUsers) -> permission —
        the RGWAccessControlPolicy essence (rgw_acl.cc); canned-ACL
        translation lives in the REST layer."""
        buckets = await self._load(BUCKETS_OID)
        if bucket in buckets:
            raise RgwError(EEXIST, "BucketAlreadyExists", bucket)
        buckets[bucket] = {
            "owner": owner,
            "created": time.time(),
            "grants": dict(grants or {}),
            "versioning": "",
        }
        await self._store(BUCKETS_OID, buckets)
        await self._store(self._index_oid(bucket), {})

    # -- ACLs (RGWAccessControlPolicy; verify_bucket_permission) ---------------

    @staticmethod
    def _allowed(info: dict, actor: str | None, need: str) -> bool:
        owner = info.get("owner", "")
        if not owner:
            return True  # legacy/open bucket (no owner recorded)
        if actor == owner:
            return True  # owner always has FULL_CONTROL
        grants = info.get("grants", {})
        for grantee, perm in grants.items():
            if grantee == ALL_USERS or grantee == actor:
                if need in _perm_set(perm):
                    return True
        return False

    async def _require_access(
        self, bucket: str, actor: str | None, need: str
    ) -> dict:
        """Bucket record if `actor` holds `need`, else AccessDenied
        (rgw_op.cc verify_bucket_permission → -EACCES)."""
        buckets = await self._load(BUCKETS_OID)
        if bucket not in buckets:
            raise RgwError(ENOENT, "NoSuchBucket", bucket)
        info = buckets[bucket]
        if not self._allowed(info, actor, need):
            raise RgwError(EPERM, "AccessDenied", f"{actor} lacks {need} on {bucket}")
        return info

    async def get_bucket_acl(self, bucket: str, actor: str | None = None) -> dict:
        info = await self._require_access(bucket, actor, "FULL_CONTROL")
        return {"owner": info.get("owner", ""), "grants": info.get("grants", {})}

    async def set_bucket_acl(
        self, bucket: str, grants: dict, actor: str | None = None
    ) -> None:
        await self._require_access(bucket, actor, "FULL_CONTROL")
        buckets = await self._load(BUCKETS_OID)
        buckets[bucket]["grants"] = dict(grants)
        await self._store(BUCKETS_OID, buckets)

    # -- lifecycle (RGWLC / RGWPutLC; cls_lc essence) --------------------------

    async def set_lifecycle(
        self, bucket: str, rules: list[dict], actor: str | None = None
    ) -> None:
        """rules: [{"id", "prefix", "days"}] — expiration-only scope (the
        reference's transition rules need storage classes, out of scope)."""
        await self._require_access(bucket, actor, "FULL_CONTROL")
        for r in rules:
            if int(r.get("days", -1)) < 0:
                raise RgwError(EINVAL, "InvalidArgument", "Days must be >= 0")
        buckets = await self._load(BUCKETS_OID)
        buckets[bucket]["lifecycle"] = [
            {"id": r.get("id", ""), "prefix": r.get("prefix", ""),
             "days": int(r["days"])}
            for r in rules
        ]
        await self._store(BUCKETS_OID, buckets)

    async def get_lifecycle(
        self, bucket: str, actor: str | None = None
    ) -> list[dict]:
        info = await self._require_access(bucket, actor, "READ")
        rules = info.get("lifecycle", [])
        if not rules:
            raise RgwError(ENOENT, "NoSuchLifecycleConfiguration", bucket)
        return rules

    async def process_lifecycle(self, now: float | None = None) -> int:
        """One LC pass over every bucket (RGWLC::process): expire objects
        whose latest mtime is older than a matching rule's Days.  On a
        versioning-enabled bucket expiration lays a delete marker, as S3
        does.  Returns the number of keys expired."""
        now = time.time() if now is None else now
        buckets = await self._load(BUCKETS_OID)
        expired = 0
        for bucket, info in buckets.items():
            rules = info.get("lifecycle")
            if not rules:
                continue
            owner = info.get("owner", "") or None
            index = await self._load(self._index_oid(bucket))
            for key in sorted(index):
                live = self._live(index[key])
                if live is None:
                    continue
                for rule in rules:
                    if not key.startswith(rule["prefix"]):
                        continue
                    if now - live.get("mtime", now) >= rule["days"] * 86400:
                        await self.delete_object(bucket, key, actor=owner)
                        expired += 1
                        break
        return expired

    # -- versioning (RGWBucketVersioning; rgw_op RGWSetBucketVersioning) -------

    async def set_versioning(
        self, bucket: str, status: str, actor: str | None = None
    ) -> None:
        if status not in ("Enabled", "Suspended"):
            raise RgwError(EINVAL, "IllegalVersioningConfigurationException", status)
        # S3 PutBucketVersioning is a bucket-configuration change: owner /
        # FULL_CONTROL only, like set_lifecycle — a WRITE (object upload)
        # grant must not be able to flip versioning off
        await self._require_access(bucket, actor, "FULL_CONTROL")
        buckets = await self._load(BUCKETS_OID)
        buckets[bucket]["versioning"] = status
        await self._store(BUCKETS_OID, buckets)

    async def get_versioning(self, bucket: str, actor: str | None = None) -> str:
        info = await self._require_access(bucket, actor, "READ")
        return info.get("versioning", "")

    async def list_buckets(self, owner: str | None = None) -> list[str]:
        buckets = await self._load(BUCKETS_OID)
        return sorted(
            b for b, info in buckets.items()
            if owner is None or info["owner"] == owner
        )

    async def delete_bucket(self, bucket: str) -> None:
        buckets = await self._load(BUCKETS_OID)
        if bucket not in buckets:
            raise RgwError(ENOENT, "NoSuchBucket", bucket)
        index = await self._load(self._index_oid(bucket))
        if index:
            raise RgwError(EINVAL, "BucketNotEmpty", bucket)
        del buckets[bucket]
        await self._store(BUCKETS_OID, buckets)
        await unless_absent(self.ioctx.remove(self._index_oid(bucket)))

    async def _require_bucket(self, bucket: str) -> None:
        buckets = await self._load(BUCKETS_OID)
        if bucket not in buckets:
            raise RgwError(ENOENT, "NoSuchBucket", bucket)

    # -- objects ---------------------------------------------------------------

    def _data(self, bucket: str, key: str, vid: str = "") -> StripedObject:
        # versioned data lives under its own prefix keyed by version id
        # ("@" is reserved for snap clones in the RADOS flat namespace)
        oid = (
            f"rgw.ver.{vid}.{bucket}/{key}" if vid else f"rgw.obj.{bucket}/{key}"
        )
        return StripedObject(self.ioctx, oid, policy=self.policy)

    @staticmethod
    def _latest(entry: dict) -> dict | None:
        """Latest version record of a versioned entry (None = plain)."""
        versions = entry.get("versions")
        return versions[-1] if versions else None

    @staticmethod
    def _live(entry: dict) -> dict | None:
        """The record a plain GET serves: the entry itself (plain), or
        the latest version when it is not a delete marker."""
        if "versions" not in entry:
            return entry
        latest = entry["versions"][-1]
        return None if latest.get("delete_marker") else latest

    async def put_object(
        self,
        bucket: str,
        key: str,
        data: bytes,
        meta: dict | None = None,
        actor: str | None = None,
    ) -> tuple[str, str]:
        """PutObject; returns (etag, version_id) — version_id "" on an
        unversioned bucket (RGWPutObj).  `meta` carries user metadata
        (x-amz-meta-* / X-Object-Meta-*, RGWObjManifest attrs)."""
        info = await self._require_access(bucket, actor, "WRITE")
        versioning = info.get("versioning", "")
        etag = _etag(data)
        index = await self._load(self._index_oid(bucket))
        entry = index.get(key, {})
        record = {"size": len(data), "etag": etag, "mtime": time.time()}
        if actor:
            record["owner"] = actor  # the uploader (object owner in S3)
        if meta:
            record["meta"] = dict(meta)
        if versioning == "Enabled":
            vid = secrets.token_hex(8)
        elif versioning == "Suspended" or "versions" in entry:
            # suspended (or formerly-versioned): writes land on the
            # "null" version, replacing any previous null (S3 semantics)
            vid = "null"
        else:
            vid = ""
        if vid:
            record["version_id"] = vid
            versions = [
                v for v in entry.get("versions", []) if v.get("version_id") != vid
            ]
            versions.append(record)
            index[key] = {"versions": versions}
            obj = self._data(bucket, key, vid)
        else:
            index[key] = record
            obj = self._data(bucket, key)
        await obj.remove()  # overwrite semantics
        await obj.write(data)
        await self._store(self._index_oid(bucket), index)
        return etag, vid

    @staticmethod
    def _object_allowed(
        record: dict, bucket_info: dict, actor: str | None, need: str
    ) -> bool:
        """Object-level ACL check (rgw_op verify_object_permission): the
        object's own policy decides when present; otherwise the bucket's
        policy governs.  The object owner (its uploader) always has
        FULL_CONTROL, like the reference's object owner semantics."""
        acl = record.get("acl")
        if acl is None:
            return ObjectGateway._allowed(bucket_info, actor, need)
        if actor and actor == acl.get("owner"):
            return True
        if ObjectGateway._allowed(
            {"owner": acl.get("owner", ""), "grants": acl.get("grants", {})},
            actor,
            need,
        ):
            return True
        # bucket owner retains control over contained objects
        return bool(bucket_info.get("owner")) and actor == bucket_info["owner"]

    def _resolve(
        self, entry: dict, key: str, version_id: str
    ) -> dict:
        """Pick the version record a read addresses, with S3's errors:
        latest-is-marker -> NoSuchKey; explicit missing vid -> NoSuchVersion."""
        if version_id:
            for v in entry.get("versions", []):
                if v.get("version_id") == version_id:
                    if v.get("delete_marker"):
                        raise RgwError(ENOENT, "MethodNotAllowed", "delete marker")
                    return v
            raise RgwError(ENOENT, "NoSuchVersion", version_id)
        live = self._live(entry)
        if live is None:
            raise RgwError(ENOENT, "NoSuchKey", key)
        return live

    async def get_object(
        self,
        bucket: str,
        key: str,
        actor: str | None = None,
        version_id: str = "",
    ) -> bytes:
        info = await self._object_access(bucket, key, actor, "READ")
        index = await self._load(self._index_oid(bucket))
        if key not in index:
            raise RgwError(ENOENT, "NoSuchKey", key)
        record = self._resolve(index[key], key, version_id)
        return await self._data(
            bucket, key, record.get("version_id", "")
        ).read()

    async def _object_access(
        self, bucket: str, key: str, actor: str | None, need: str
    ) -> dict:
        """Bucket info after the object-level check: an object ACL (when
        set) overrides the bucket policy for this object."""
        buckets = await self._load(BUCKETS_OID)
        if bucket not in buckets:
            raise RgwError(ENOENT, "NoSuchBucket", bucket)
        info = buckets[bucket]
        index = await self._load(self._index_oid(bucket))
        entry = index.get(key)
        live = self._live(entry) if entry else None
        record = live if live is not None else {}
        if not self._object_allowed(record, info, actor, need):
            raise RgwError(
                EPERM, "AccessDenied", f"{actor} lacks {need} on {bucket}/{key}"
            )
        return info

    async def head_object(
        self,
        bucket: str,
        key: str,
        actor: str | None = None,
        version_id: str = "",
    ) -> dict:
        await self._object_access(bucket, key, actor, "READ")
        index = await self._load(self._index_oid(bucket))
        if key not in index:
            raise RgwError(ENOENT, "NoSuchKey", key)
        return self._resolve(index[key], key, version_id)

    async def delete_object(
        self,
        bucket: str,
        key: str,
        actor: str | None = None,
        version_id: str = "",
    ) -> str:
        """DeleteObject.  On a versioning-enabled bucket a plain delete
        lays down a DELETE MARKER (returns its version id); deleting a
        specific version removes that version's bytes (RGWDeleteObj)."""
        info = await self._require_access(bucket, actor, "WRITE")
        versioning = info.get("versioning", "")
        index = await self._load(self._index_oid(bucket))
        entry = index.get(key)
        if entry is None:
            # deleting a missing key succeeds (S3), marker only if enabled
            if versioning != "Enabled":
                await self._data(bucket, key).remove()
                return ""
            entry = {"versions": []}
        if version_id:
            versions = entry.get("versions", [])
            keep = [v for v in versions if v.get("version_id") != version_id]
            if len(keep) == len(versions):
                raise RgwError(ENOENT, "NoSuchVersion", version_id)
            await self._data(bucket, key, version_id).remove()
            if keep:
                index[key] = {"versions": keep}
            else:
                del index[key]
            await self._store(self._index_oid(bucket), index)
            return version_id
        if versioning == "Enabled":
            vid = secrets.token_hex(8)
            versions = entry.get("versions", [])
            versions.append(
                {"version_id": vid, "delete_marker": True, "mtime": time.time()}
            )
            index[key] = {"versions": versions}
            await self._store(self._index_oid(bucket), index)
            return vid
        if "versions" in entry:
            # suspended: plain delete replaces the null version with a
            # null delete marker
            versions = [
                v for v in entry["versions"] if v.get("version_id") != "null"
            ]
            await self._data(bucket, key, "null").remove()
            versions.append(
                {"version_id": "null", "delete_marker": True, "mtime": time.time()}
            )
            index[key] = {"versions": versions}
            await self._store(self._index_oid(bucket), index)
            return "null"
        del index[key]
        await self._store(self._index_oid(bucket), index)
        await self._data(bucket, key).remove()
        return ""

    async def set_object_acl(
        self, bucket: str, key: str, grants: dict, actor: str | None = None
    ) -> None:
        """PutObjectAcl: per-object grants, owner-gated (the object's
        uploader or the bucket owner)."""
        info = await self._require_access(bucket, actor, "READ")
        index = await self._load(self._index_oid(bucket))
        entry = index.get(key)
        live = self._live(entry) if entry else None
        if live is None:
            raise RgwError(ENOENT, "NoSuchKey", key)
        current = live.get("acl") or {"owner": live.get("owner", ""), "grants": {}}
        admin = (
            actor
            and (
                actor == current.get("owner")
                or actor == info.get("owner")
                or not info.get("owner")
            )
        )
        if not admin:
            raise RgwError(EPERM, "AccessDenied", f"{actor} cannot set acl")
        live["acl"] = {"owner": current.get("owner") or (actor or ""), "grants": dict(grants)}
        await self._store(self._index_oid(bucket), index)

    async def get_object_acl(
        self, bucket: str, key: str, actor: str | None = None
    ) -> dict:
        await self._object_access(bucket, key, actor, "READ")
        index = await self._load(self._index_oid(bucket))
        live = self._live(index.get(key, {}))
        if live is None:
            raise RgwError(ENOENT, "NoSuchKey", key)
        return live.get("acl") or {"owner": "", "grants": {}}

    async def list_object_versions(
        self, bucket: str, prefix: str = "", actor: str | None = None
    ) -> list[dict]:
        """ListObjectVersions: every version + delete marker, newest
        first per key (RGWListBucketVersions)."""
        await self._require_access(bucket, actor, "READ")
        index = await self._load(self._index_oid(bucket))
        out: list[dict] = []
        for key in sorted(k for k in index if k.startswith(prefix)):
            entry = index[key]
            versions = entry.get("versions")
            if versions is None:
                out.append({"key": key, "version_id": "null", "is_latest": True, **entry})
                continue
            for i, v in enumerate(reversed(versions)):
                out.append({"key": key, "is_latest": i == 0, **v})
        return out

    async def list_objects(
        self,
        bucket: str,
        prefix: str = "",
        delimiter: str = "",
        marker: str = "",
        max_keys: int = 1000,
        actor: str | None = None,
    ) -> dict:
        """ListObjects with CommonPrefixes rollup
        (RGWRados::Bucket::List::list_objects).  Versioned entries show
        their latest LIVE version; keys whose latest is a delete marker
        are hidden (as S3 lists them)."""
        await self._require_access(bucket, actor, "READ")
        index = await self._load(self._index_oid(bucket))
        keys = sorted(k for k in index if k.startswith(prefix) and k > marker)
        contents: list[dict] = []
        common: list[str] = []
        truncated = False
        for key in keys:
            live = self._live(index[key])
            if live is None:
                continue  # latest is a delete marker
            if len(contents) + len(common) >= max_keys:
                truncated = True
                break
            if delimiter:
                rest = key[len(prefix):]
                idx = rest.find(delimiter)
                if idx >= 0:
                    cp = prefix + rest[: idx + len(delimiter)]
                    if cp not in common:
                        common.append(cp)
                    continue
            contents.append({"key": key, **live})
        return {
            "contents": contents,
            "common_prefixes": common,
            "is_truncated": truncated,
        }

    # -- multipart (RGWCompleteMultipart) --------------------------------------

    async def initiate_multipart(
        self, bucket: str, key: str, actor: str | None = None
    ) -> str:
        await self._require_access(bucket, actor, "WRITE")
        upload_id = secrets.token_hex(8)
        await self._store(
            f"rgw.multipart.{upload_id}",
            {"bucket": bucket, "key": key, "parts": {}},
        )
        return upload_id

    async def upload_part(
        self, upload_id: str, part_number: int, data: bytes
    ) -> str:
        meta = await self._load(f"rgw.multipart.{upload_id}")
        if not meta:
            raise RgwError(ENOENT, "NoSuchUpload", upload_id)
        part_obj = StripedObject(
            self.ioctx, f"rgw.part.{upload_id}.{part_number}", policy=self.policy
        )
        await part_obj.remove()
        await part_obj.write(data)
        etag = _etag(data)
        meta["parts"][str(part_number)] = {"size": len(data), "etag": etag}
        await self._store(f"rgw.multipart.{upload_id}", meta)
        return etag

    async def complete_multipart(
        self, upload_id: str, actor: str | None = None
    ) -> str:
        meta = await self._load(f"rgw.multipart.{upload_id}")
        if not meta:
            raise RgwError(ENOENT, "NoSuchUpload", upload_id)
        bucket, key = meta["bucket"], meta["key"]
        info = await self._require_access(bucket, actor, "WRITE")
        versioning = info.get("versioning", "")
        index = await self._load(self._index_oid(bucket))
        if versioning == "Enabled":
            vid = secrets.token_hex(8)
        elif versioning == "Suspended" or "versions" in index.get(key, {}):
            vid = "null"
        else:
            vid = ""
        obj = self._data(bucket, key, vid)
        await obj.remove()
        off = 0
        md5s = []
        for pn in sorted(meta["parts"], key=int):
            part_obj = StripedObject(
                self.ioctx, f"rgw.part.{upload_id}.{pn}", policy=self.policy
            )
            data = await part_obj.read()
            await obj.write(data, off)
            off += len(data)
            md5s.append(bytes.fromhex(meta["parts"][pn]["etag"]))
            await part_obj.remove()
        # S3 multipart etag convention: md5-of-md5s + "-<nparts>"
        etag = f"{hashlib.md5(b''.join(md5s)).hexdigest()}-{len(md5s)}"
        record = {"size": off, "etag": etag, "mtime": time.time()}
        if vid:
            record["version_id"] = vid
            entry = index.get(key, {})
            versions = [
                v for v in entry.get("versions", []) if v.get("version_id") != vid
            ]
            versions.append(record)
            index[key] = {"versions": versions}
        else:
            index[key] = record
        await self._store(self._index_oid(bucket), index)
        await self.ioctx.remove(f"rgw.multipart.{upload_id}")
        return etag

    async def list_multipart_uploads(
        self, bucket: str, actor: str | None = None
    ) -> list[dict]:
        """ListMultipartUploads (RGWListBucketMultiparts)."""
        await self._require_access(bucket, actor, "READ")
        out = []
        for oid in await self.ioctx.list_objects():
            if not oid.startswith("rgw.multipart."):
                continue
            meta = await self._load(oid)
            if meta.get("bucket") == bucket:
                out.append(
                    {"upload_id": oid[len("rgw.multipart."):],
                     "key": meta.get("key", "")}
                )
        return sorted(out, key=lambda u: (u["key"], u["upload_id"]))

    async def list_parts(self, upload_id: str) -> list[dict]:
        """ListParts (RGWListMultipart)."""
        meta = await self._load(f"rgw.multipart.{upload_id}")
        if not meta:
            raise RgwError(ENOENT, "NoSuchUpload", upload_id)
        return [
            {"part_number": int(pn), **info}
            for pn, info in sorted(meta["parts"].items(), key=lambda kv: int(kv[0]))
        ]

    async def abort_multipart(self, upload_id: str) -> None:
        meta = await self._load(f"rgw.multipart.{upload_id}")
        for pn in meta.get("parts", {}):
            await StripedObject(
                self.ioctx, f"rgw.part.{upload_id}.{pn}", policy=self.policy
            ).remove()
        await unless_absent(self.ioctx.remove(f"rgw.multipart.{upload_id}"))
