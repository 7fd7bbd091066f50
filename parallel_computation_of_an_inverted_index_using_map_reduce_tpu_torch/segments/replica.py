"""Segment shipping + primary-election leases for live index dirs.

A replica never re-indexes: it catches up by asking the primary's
daemon for a manifest ``snapshot``, fetching exactly the segment
artifacts and tombstone bitmaps it is missing (content-addressed by the
manifest's per-file adler32, verified on arrival, staged under
``segments/.fetch_*`` and published by the same atomic manifest swap
every mutation uses), then adopting the primary's WAL tail — the
acked-but-unpublished suffix — so an acknowledged mutation survives
even a primary that never gets to publish it.  :func:`replicate` is
one catch-up round; the daemon's ``--replica-of`` poll loop and the
``replicate`` CLI both call it.

Primary election is a TTL'd lease stored INSIDE ``segments.lock`` (the
flock target every mutator already serializes on; :func:`~.manifest.
mutation_lock` opens it without truncation precisely so the lease JSON
survives).  With ``MRI_SEGMENT_LEASE_TTL_S`` > 0 every mutation first
:func:`renew_lease`; a live foreign owner raises :class:`LeaseError`
("lease_lost") and the mutation is rejected while reads keep serving
the old generation.  TTL 0 (the default) disables leasing for
single-writer deployments.

Failure shapes proven by the fault kinds: ``fetch-partial`` truncates
one shipped payload (the per-file verification must reject + retry,
never swap a torn segment in) and ``lease-steal`` rewrites the lease
to a foreign owner mid-run (the next renew must reject).
"""

from __future__ import annotations

import base64
import contextlib
import json
import logging
import os
import re
import shutil
import socket
import time
from pathlib import Path

from . import wal as wal_mod
from .manifest import (LOCK_NAME, SegmentEntry, SegmentError,
                       SegmentManifest, load_manifest, mutation_lock,
                       save_manifest, segment_dir, segments_root)
from .. import faults
from ..serve import artifact as artifact_mod
from ..utils import envknobs
from ..utils.checksum import adler32_hex

log = logging.getLogger("mri_torch.segments")

LEASE_TTL_ENV = "MRI_SEGMENT_LEASE_TTL_S"
POLL_ENV = "MRI_REPLICA_POLL_MS"

#: Owner name the ``lease-steal`` fault writes — a value no real
#: daemon ever uses, so trial logs attribute the rejection correctly.
THIEF_OWNER = "lease-thief"

_SEGMENT_NAME = re.compile(r"^seg_\d+_\d+$")
_TOMB_NAME = re.compile(r"^tombstones_\d+\.bin$")


class ReplicaError(SegmentError):
    """A catch-up round failed (unreachable primary, refused op, or a
    shipped file that failed verification twice)."""


class LeaseError(SegmentError):
    """The mutation lease is held by a live foreign owner.  The
    message starts with ``lease_lost`` — the wire detail clients key
    rejection handling on."""


def parse_addr(target: str) -> tuple[str, int]:
    host, _, port_s = str(target).rpartition(":")
    try:
        port = int(port_s)
        if not host or not (0 < port <= 65535):
            raise ValueError
    except ValueError:
        raise ReplicaError(
            f"replica source must be HOST:PORT, got {target!r}") from None
    return host, port


# -- lease (TTL'd primary election inside segments.lock) ---------------

def lease_ttl() -> float:
    return float(envknobs.get(LEASE_TTL_ENV))


@contextlib.contextmanager
def _locked_lease_fd(root):
    """flock'd fd over ``segments.lock`` — the SAME lock every mutator
    takes, so a lease decision can never interleave with a mutation.
    Never call while already holding :func:`~.manifest.mutation_lock`:
    flock on a second fd in the same process self-deadlocks."""
    import fcntl
    Path(root).mkdir(parents=True, exist_ok=True)
    path = Path(root) / LOCK_NAME
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield fd
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _read_lease_fd(fd) -> dict | None:
    data = os.pread(fd, 4096, 0)
    if not data.strip():
        return None
    try:
        lease = json.loads(data)
        return {"owner": str(lease["owner"]),
                "expires": float(lease["expires"])}
    except (ValueError, KeyError, TypeError):
        return None  # pre-lease lock file content: no holder


def _write_lease_fd(fd, lease: dict | None) -> None:
    os.ftruncate(fd, 0)
    if lease is not None:
        os.pwrite(fd, json.dumps(lease, sort_keys=True).encode("utf-8"), 0)


def read_lease(root) -> dict | None:
    """The current lease (diagnostics; no freshness judgement)."""
    with _locked_lease_fd(root) as fd:
        return _read_lease_fd(fd)


def renew_lease(root, owner: str, *, ttl: float | None = None) -> dict | None:
    """Validate-and-renew the mutation lease for ``owner``; None when
    leasing is disabled (TTL 0).  A live foreign holder raises
    :class:`LeaseError`; an expired or absent lease is taken over.
    Callers run this BEFORE taking the mutation lock (same flock)."""
    ttl = lease_ttl() if ttl is None else float(ttl)
    if ttl <= 0:
        return None
    with _locked_lease_fd(root) as fd:
        inj = faults.active()
        if inj is not None and inj.on_lease_check():
            # the injected steal: a foreign owner grabbed a live lease
            # between our mutations — written here so the normal check
            # below is the thing that rejects it
            _write_lease_fd(fd, {"owner": THIEF_OWNER,
                                 "expires": time.time() + ttl})
        lease = _read_lease_fd(fd)
        now = time.time()
        if lease is not None and lease["owner"] != owner \
                and lease["expires"] > now:
            raise LeaseError(
                f"lease_lost: held by {lease['owner']!r} for another "
                f"{lease['expires'] - now:.1f}s")
        fresh = {"owner": owner, "expires": now + ttl}
        _write_lease_fd(fd, fresh)
        return fresh


def release_lease(root, owner: str) -> bool:
    """Drop the lease iff ``owner`` still holds it (clean shutdown —
    the successor takes over without waiting out the TTL)."""
    if lease_ttl() <= 0:
        return False
    with _locked_lease_fd(root) as fd:
        lease = _read_lease_fd(fd)
        if lease is None or lease["owner"] != owner:
            return False
        _write_lease_fd(fd, None)
        return True


# -- primary-side payloads (daemon admin ops) --------------------------

def snapshot_payload(root) -> dict:
    """The ``snapshot`` admin-op body: the manifest a replica diffs
    against (generation, wal_seq, entries with their checksums)."""
    man = load_manifest(root)
    if man is None:
        raise ReplicaError(
            f"{root}: not segment-managed (nothing to replicate)")
    return man.to_json()


def segment_file_payload(root, segment: str, file: str) -> dict:
    """The ``fetch_segment`` admin-op body: one segment file, base64'd,
    with the adler32 + size of the TRUE content (computed before the
    ``fetch-partial`` fault may truncate the shipped copy, so a torn
    ship is detectable by the replica)."""
    if not _SEGMENT_NAME.match(segment or ""):
        raise ReplicaError(f"bad segment name {segment!r}")
    if file != artifact_mod.ARTIFACT_NAME and not _TOMB_NAME.match(file or ""):
        raise ReplicaError(f"bad segment file name {file!r}")
    path = segment_dir(root, segment) / file
    try:
        raw = path.read_bytes()
    except OSError as e:
        raise ReplicaError(f"{path}: cannot ship segment file ({e})") \
            from e
    crc, size = adler32_hex(raw), len(raw)
    inj = faults.active()
    if inj is not None:
        raw = inj.on_fetch_payload(f"{segment}/{file}", raw)
    return {"segment": segment, "file": file, "adler32": crc,
            "bytes": size,
            "data": base64.b64encode(raw).decode("ascii")}


def wal_tail_payload(root, after_seq: int) -> list[dict]:
    """The ``wal_tail`` admin-op body: records above ``after_seq``.
    Takes the mutation lock — the tail read repairs damage in place and
    must never interleave with a writer's append."""
    with mutation_lock(root):
        return wal_mod.tail(root, int(after_seq))


# -- replica-side catch-up ---------------------------------------------

class _Client:
    """Minimal JSON-lines RPC client over the daemon protocol."""

    def __init__(self, addr: tuple[str, int], timeout: float = 30.0):
        try:
            self._sock = socket.create_connection(addr, timeout=timeout)
            self._f = self._sock.makefile("rb")
        except OSError as e:
            raise ReplicaError(
                f"cannot reach primary at {addr[0]}:{addr[1]}: {e}") \
                from e
        self._id = 0

    def rpc(self, op: str, **fields) -> dict:
        self._id += 1
        req = {"id": self._id, "op": op, **fields}
        try:
            self._sock.sendall(
                (json.dumps(req, separators=(",", ":")) + "\n").encode())
            line = self._f.readline()
        except OSError as e:
            raise ReplicaError(f"primary connection lost: {e}") from e
        if not line:
            raise ReplicaError("primary closed the connection")
        try:
            resp = json.loads(line)
        except ValueError as e:
            raise ReplicaError(f"primary sent a torn response: {e}") \
                from e
        if not resp.get("ok"):
            raise ReplicaError(
                f"primary refused {op}: {resp.get('error')} "
                f"({resp.get('detail', '')})")
        return resp

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._f.close()
        with contextlib.suppress(OSError):
            self._sock.close()


def _manifest_from_snapshot(doc: dict) -> SegmentManifest:
    try:
        return SegmentManifest(
            generation=int(doc["generation"]),
            next_seg=int(doc["next_seg"]),
            entries=tuple(SegmentEntry.from_json(e)
                          for e in doc["entries"]),
            wal_seq=int(doc.get("wal_seq", 0)))
    except (KeyError, TypeError, ValueError) as e:
        raise ReplicaError(f"malformed snapshot: {e}") from e


def _missing_files(local: SegmentManifest | None,
                   remote: SegmentManifest) -> list[tuple[str, str, str, int]]:
    """``(segment, file, adler32, bytes)`` for every remote file the
    local set lacks or holds under a different checksum."""
    have = {} if local is None else {e.name: e for e in local.entries}
    out: list[tuple[str, str, str, int]] = []
    for e in remote.entries:
        mine = have.get(e.name)
        if mine is None or mine.adler32 != e.adler32:
            out.append((e.name, artifact_mod.ARTIFACT_NAME,
                        e.adler32, e.bytes))
        if e.tombstones is not None and (
                mine is None or mine.tombstones != e.tombstones
                or mine.tomb_adler32 != e.tomb_adler32):
            out.append((e.name, e.tombstones,
                        e.tomb_adler32 or "", e.tomb_bytes or 0))
    return out


def _fetch_one(client: _Client, stage: Path, segment: str, file: str,
               want_crc: str, want_bytes: int) -> None:
    """Fetch one file into the staging dir, verifying the manifest's
    checksum; one retry on a short/torn ship (the ``fetch-partial``
    proof), then :class:`ReplicaError`."""
    last = ""
    for attempt in (1, 2):
        resp = client.rpc("fetch_segment", segment=segment, file=file)
        try:
            data = base64.b64decode(resp.get("data", ""), validate=True)
        except (ValueError, TypeError):
            data = b""
        if len(data) == want_bytes and adler32_hex(data) == want_crc:
            tmp = stage / f"{file}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, stage / file)
            return
        last = (f"{segment}/{file}: shipped {len(data)} byte(s) "
                f"(adler32 {adler32_hex(data)}), manifest promises "
                f"{want_bytes} ({want_crc}) — attempt {attempt}")
        log.warning("replicate: %s", last)
    raise ReplicaError(f"segment ship failed verification twice: {last}")


def replicate(root, addr: tuple[str, int], *, registry=None,
              timeout: float = 30.0) -> dict:
    """One catch-up round against a primary daemon at ``addr``.

    Snapshot → diff by (name, adler32) → fetch missing files into
    ``segments/.fetch_<name>`` staging (verified per file) → move into
    the live segment dirs → atomically adopt the primary's manifest →
    adopt its WAL tail → drop published records.  Idempotent: a replica
    already at the primary's generation fetches nothing.  Never
    re-indexes and never touches files the old generation still serves.
    """
    t0 = time.perf_counter()
    client = _Client(addr, timeout=timeout)
    try:
        remote = _manifest_from_snapshot(client.rpc("snapshot")["snapshot"])
        local = load_manifest(root)
        behind = remote.generation - (0 if local is None
                                      else local.generation)
        if behind < 0:
            # refuse BEFORE any fetch: a same-named segment with a
            # different checksum would otherwise overwrite newer local
            # bytes on its way to the (doomed) manifest adoption
            raise ReplicaError(
                f"local generation {local.generation} is ahead of the "
                f"primary's {remote.generation} — refusing to roll "
                "back (two primaries?)")
        missing = _missing_files(local, remote)
        fetched: list[str] = []
        bytes_fetched = 0
        for segment, file, crc, size in missing:
            stage = segments_root(root) / f".fetch_{segment}"
            stage.mkdir(parents=True, exist_ok=True)
            _fetch_one(client, stage, segment, file, crc, size)
            seg = segment_dir(root, segment)
            seg.mkdir(parents=True, exist_ok=True)
            os.replace(stage / file, seg / file)
            shutil.rmtree(stage, ignore_errors=True)
            fetched.append(f"{segment}/{file}")
            bytes_fetched += size
        changed = local is None or remote.generation != local.generation \
            or remote.wal_seq != local.wal_seq
        if changed:
            with mutation_lock(root):
                # re-check under the lock: a local mutator advancing the
                # directory past the snapshot must not be rolled back
                current = load_manifest(root)
                if current is not None \
                        and current.generation > remote.generation:
                    raise ReplicaError(
                        f"local generation {current.generation} is ahead "
                        f"of the primary's {remote.generation} — refusing "
                        "to roll back (two primaries?)")
                save_manifest(root, remote, op="replicate")
        tail = client.rpc("wal_tail",
                          after_seq=remote.wal_seq).get("records", [])
        adopted = wal_mod.append_tail(root, tail)
        wal_mod.truncate_published(root)
    finally:
        client.close()
    dt = time.perf_counter() - t0
    if fetched or adopted:
        log.info("replicate: generation %d (%d behind), %d file(s) / "
                 "%d byte(s) shipped, %d wal record(s) adopted "
                 "(%.1f ms)", remote.generation, behind, len(fetched),
                 bytes_fetched, adopted, dt * 1e3)
    return {"generation": remote.generation, "wal_seq": remote.wal_seq,
            "behind": behind, "changed": changed, "fetched": fetched,
            "bytes_fetched": bytes_fetched, "adopted_records": adopted,
            "seconds": round(dt, 6)}
