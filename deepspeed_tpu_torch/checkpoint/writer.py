"""Atomic on-disk commit protocol + integrity verification (port of
``deepspeed_tpu/checkpoint/writer.py``, which imports no jax: the same
protocol and the same files, on the port's logger).

Commit order for one checkpoint:

1. payload files are written into ``<tag>.tmp/`` and fsynced one by one;
2. ``manifest.json`` (per-file byte sizes + checksums) is written LAST and
   fsynced — a tmp dir without a readable manifest is by definition torn;
3. ``os.replace(<tag>.tmp, <tag>)`` publishes the directory atomically;
4. the ``latest`` pointer is swapped through its own tmp + ``os.replace``.

A crash at any point leaves either the previous committed checkpoint (plus
a stale ``*.tmp`` dir that :func:`verify_checkpoint` rejects and retention
sweeps) or the new one — never a loadable half-write.

Checksums prefer hardware crc32c when the optional ``crc32c`` package is
present and fall back to zlib's crc32; the manifest records which
algorithm produced its values and verification always recomputes with
that algorithm (degrading to sizes-only when it isn't available locally).
"""

import json
import logging
import os
import shutil
import zlib

from .constants import (LATEST_FILE, MANIFEST_FORMAT_VERSION, MANIFEST_JSON,
                        META_JSON, OLD_SUFFIX, TMP_SUFFIX)

logger = logging.getLogger(__name__)

# checksum updaters by manifest name; zlib crc32 is always available,
# hardware crc32c only when the optional wheel exists.  Writers use the
# best local algorithm; verifiers MUST use the manifest's algorithm (a
# crc32 manifest checked with crc32c would flag every intact file)
_CRC_UPDATERS = {"crc32": zlib.crc32}
try:  # gated optional dep
    import crc32c as _crc32c_mod

    _CRC_UPDATERS["crc32c"] = _crc32c_mod.crc32c
    _CRC_ALGORITHM = "crc32c"
except ImportError:
    _CRC_ALGORITHM = "crc32"


class CheckpointError(RuntimeError):
    """Base error for checkpoint save/load failures."""


class CheckpointCorruptionError(CheckpointError):
    """A checkpoint directory failed manifest/integrity verification."""


# Test seam: called as hook(tmp_dir, filename) after each payload file is
# durably written.  Crash-mid-save tests raise from it; async-overlap
# tests block on an event in it.  Never set in production.
_file_written_hook = None


def file_checksum(path, chunk_bytes=4 * 1024 * 1024, algorithm=None):
    update = _CRC_UPDATERS[algorithm or _CRC_ALGORITHM]
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            crc = update(chunk, crc)
    return crc & 0xFFFFFFFF


def _checksum_fn(name):
    if name not in _CRC_UPDATERS:
        return None  # manifest written with an algorithm we don't have
    return lambda path: file_checksum(path, algorithm=name)


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; replace still lands
    finally:
        os.close(fd)


def write_file(path, writer_fn):
    """Write one payload file durably: ``writer_fn(file_object)`` then
    flush + fsync before close."""
    with open(path, "wb") as f:
        writer_fn(f)
        f.flush()
        os.fsync(f.fileno())


def write_checkpoint(save_dir, tag, file_writers, extra_manifest=None):
    """Write + atomically commit one checkpoint; returns the final dir.

    ``file_writers`` maps filename -> ``fn(file_object)``; files are
    written in mapping order.  Raises on any I/O failure — the caller
    (manager) owns retry policy.  An existing ``<tag>/`` is replaced only
    at the final ``os.replace``, so a failed re-save never clobbers it.
    """
    save_dir = str(save_dir)
    final_dir = os.path.join(save_dir, str(tag))
    tmp_dir = final_dir + TMP_SUFFIX
    if os.path.isdir(tmp_dir):  # stale leftovers from a crashed attempt
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)

    entries = {}
    for name, writer_fn in file_writers.items():
        path = os.path.join(tmp_dir, name)
        write_file(path, writer_fn)
        entries[name] = {"bytes": os.path.getsize(path),
                         "checksum": file_checksum(path)}
        if _file_written_hook is not None:
            _file_written_hook(tmp_dir, name)

    manifest = {"format_version": MANIFEST_FORMAT_VERSION,
                "tag": str(tag),
                "checksum_algorithm": _CRC_ALGORITHM,
                "files": entries}
    if extra_manifest:
        manifest.update(extra_manifest)
    write_file(os.path.join(tmp_dir, MANIFEST_JSON),
               lambda f: f.write(json.dumps(manifest, indent=2).encode()))
    _fsync_path(tmp_dir)

    if os.path.isdir(final_dir):
        # re-saving an existing tag: move the old dir aside first so the
        # window without a committed <tag>/ is one rename, not a full
        # rewrite (os.replace cannot overwrite a non-empty dir).  A crash
        # inside that window is healed by recover_tag on the next load.
        doomed = final_dir + OLD_SUFFIX
        if os.path.isdir(doomed):
            shutil.rmtree(doomed)
        os.replace(final_dir, doomed)
        os.replace(tmp_dir, final_dir)
        shutil.rmtree(doomed, ignore_errors=True)
    else:
        os.replace(tmp_dir, final_dir)
    _fsync_path(save_dir)
    return final_dir


def recover_tag(save_dir, tag):
    """Heal a crash that hit a same-tag re-save between its two renames:
    if ``<tag>/`` is missing but a manifest-complete ``<tag>.old/``
    survives, rename it back.  Returns True if a recovery happened."""
    final_dir = os.path.join(str(save_dir), str(tag))
    old_dir = final_dir + OLD_SUFFIX
    if os.path.isdir(final_dir) or not os.path.isdir(old_dir):
        return False
    status, _ = verify_checkpoint(old_dir)
    if status not in ("ok", "legacy"):  # legacy: manifest-less but intact
        return False
    os.replace(old_dir, final_dir)
    _fsync_path(str(save_dir))
    logger.warning(f"recovered checkpoint {final_dir} from interrupted "
                   f"re-save ({OLD_SUFFIX} fallback)")
    return True


def write_latest(save_dir, tag):
    """Atomically point ``latest`` at ``tag`` (tmp + ``os.replace``)."""
    latest = os.path.join(str(save_dir), LATEST_FILE)
    tmp = latest + TMP_SUFFIX
    write_file(tmp, lambda f: f.write(str(tag).encode()))
    os.replace(tmp, latest)
    _fsync_path(str(save_dir))


def read_latest(save_dir):
    """Tag named by the ``latest`` pointer, or None."""
    latest = os.path.join(str(save_dir), LATEST_FILE)
    if not os.path.isfile(latest):
        return None
    with open(latest) as f:
        return f.read().strip() or None


def read_manifest(ckpt_dir):
    path = os.path.join(str(ckpt_dir), MANIFEST_JSON)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def verify_checkpoint(ckpt_dir, check_checksums=True):
    """Integrity-check one checkpoint directory.

    Returns ``(status, problems)`` where status is:

    - ``"ok"``      manifest present, every file matches size (+checksum);
    - ``"legacy"``  pre-manifest layout (``meta.json`` but no manifest) —
      loadable for back-compat, nothing to verify against;
    - ``"bad"``     torn/corrupt: missing dir, a ``*.tmp`` dir, unreadable
      manifest, or any file missing / size or checksum mismatch.
    """
    ckpt_dir = str(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return "bad", [f"{ckpt_dir} is not a directory"]
    if ckpt_dir.rstrip(os.sep).endswith(TMP_SUFFIX):
        return "bad", [f"{ckpt_dir} is an uncommitted {TMP_SUFFIX} dir"]
    try:
        manifest = read_manifest(ckpt_dir)
    except (json.JSONDecodeError, OSError) as e:
        return "bad", [f"unreadable {MANIFEST_JSON}: {e}"]
    if manifest is None:
        if os.path.isfile(os.path.join(ckpt_dir, META_JSON)):
            return "legacy", []
        return "bad", [f"no {MANIFEST_JSON} and no {META_JSON}"]

    problems = []
    checksum_fn = _checksum_fn(manifest.get("checksum_algorithm", ""))
    for name, entry in manifest.get("files", {}).items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.isfile(path):
            problems.append(f"missing file {name}")
            continue
        size = os.path.getsize(path)
        if size != entry.get("bytes"):
            problems.append(
                f"{name}: size {size} != manifest {entry.get('bytes')}")
            continue
        if check_checksums:
            if checksum_fn is None:
                logger.warning(
                    f"checkpoint {ckpt_dir}: manifest checksums use "
                    f"{manifest.get('checksum_algorithm')!r} which is not "
                    f"available here; verifying sizes only")
                checksum_fn = False
            if checksum_fn:
                crc = checksum_fn(path)
                if crc != entry.get("checksum"):
                    problems.append(
                        f"{name}: checksum {crc:#010x} != manifest "
                        f"{entry.get('checksum', 0):#010x}")
    return ("ok" if not problems else "bad"), problems
