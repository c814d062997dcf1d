"""Checkpoints on disk (port of ``tfidf_tpu/checkpoint.py``): the
streaming engine's state (:func:`save_state` / :func:`restore_state` /
:func:`exists`) and index snapshots (:func:`save_index` /
:func:`restore_index`, :class:`SnapshotMismatch`). numpy only.

One crash-safe protocol serves both, the JAX package's, unchanged: each
save writes a fresh payload directory ``ckpt-<seq>/`` under the
checkpoint root, then atomically repoints the ``LATEST`` file at it,
then deletes superseded payloads. A crash at any instant leaves the old
committed checkpoint or the new one, never neither. Saves are
single-writer per root (an advisory flock).

State payloads are a plain ``state.npz``, which the JAX package's
``restore_state`` reads first. The JAX package writes its state with
Orbax when Orbax is installed; :func:`restore_state` reads such a
payload through ``tensorstore`` (the array store under Orbax, no JAX
inside) when that is installed. Index payloads are ``index.npz`` +
``meta.json`` with a sha256 per array. So each package restores the
other's checkpoints.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, Iterator, Tuple

import numpy as np


class SnapshotMismatch(ValueError):
    """A committed snapshot cannot serve this process: a checksum
    failed (corruption) or the config fingerprint differs from the
    running config (restoring it would silently serve wrong results).
    Callers fall back to a rebuild."""

_LATEST = "LATEST"
_LOCK = "LOCK"


@contextlib.contextmanager
def _writer_lock(path: str) -> Iterator[None]:
    """Advisory single-writer lock on the checkpoint root.

    A save assumes one writer per root: its debris sweep deletes every
    uncommitted ``ckpt-*`` entry, so a second concurrent saver's
    in-flight payload would be destroyed mid-write. The flock makes that
    contract enforced — a concurrent save raises instead of corrupting —
    and cannot go stale (the kernel drops flocks when the holder dies).
    """
    fd = os.open(os.path.join(path, _LOCK), os.O_CREAT | os.O_RDWR, 0o644)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            raise RuntimeError(
                f"another process is saving a checkpoint under {path}; "
                "saves are single-writer per checkpoint root")
        yield
    finally:
        os.close(fd)  # releases the flock


def _fsync_dir(path: str) -> None:
    """Make directory-entry changes (create/rename/unlink) durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover — e.g. platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _reclaim_debris(path: str, keep: str | None) -> None:
    """Remove every payload/tmp entry except ``keep`` (the committed one).

    Covers uncommitted ``ckpt-<n>`` dirs from a save that crashed before
    the LATEST repoint, orphaned superseded payloads from a crash
    *after* the repoint but before their rmtree, and stale
    ``*.latest.tmp`` pointer files.
    """
    for entry in os.listdir(path):
        if entry == _LATEST or entry == keep:
            continue
        if entry.startswith("ckpt-") or entry.endswith(".latest.tmp"):
            full = os.path.join(path, entry)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                try:
                    os.unlink(full)
                except OSError:  # pragma: no cover
                    pass


def _committed_payload(path: str):
    """(payload_dir, seq) of the committed checkpoint, or (None, -1)."""
    latest = os.path.join(path, _LATEST)
    try:
        with open(latest, "r") as f:
            name = f.read().strip()
    except OSError:
        return None, -1
    payload = os.path.join(path, name)
    if not os.path.isdir(payload):
        return None, -1  # pointer ahead of a crashed/garbage-collected dir
    try:
        seq = int(name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        seq = 0
    return payload, seq


def _commit_payload(path: str, write_payload: Callable[[str], None]
                    ) -> None:
    """The shared crash-safety protocol: write a fresh ``ckpt-<seq>``
    payload via ``write_payload(payload_dir)``, then atomically
    repoint ``LATEST``, then drop the superseded payload. A crash at
    any instant leaves the old committed checkpoint or the new one —
    never neither. Single-writer per root (flock-enforced)."""
    os.makedirs(path, exist_ok=True)
    with _writer_lock(path):
        old_payload, seq = _committed_payload(path)
        _reclaim_debris(path,
                        os.path.basename(old_payload) if old_payload else None)
        name = f"ckpt-{seq + 1}"
        payload = os.path.join(path, name)
        write_payload(payload)
        _fsync_dir(path)  # make the new payload's dirent durable pre-commit

        # Commit: atomically repoint LATEST, then drop superseded payload.
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".latest.tmp")
        with os.fdopen(fd, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, _LATEST))
        _fsync_dir(path)  # rename must hit disk before old payload goes
        if old_payload and os.path.isdir(old_payload):
            shutil.rmtree(old_payload, ignore_errors=True)


# --- streaming state ---------------------------------------------------

_NPZ_NAME = "state.npz"
_ORBAX_META = "_METADATA"


def save_state(path: str, state: Dict[str, np.ndarray]) -> str:
    """Persist a streaming state dict under the checkpoint root ``path``.

    The payload is a plain ``state.npz``; returns ``"npz"``. The
    previous checkpoint stays restorable until the new one is committed.
    Single-writer per root: a concurrent save on the same ``path``
    raises ``RuntimeError``; readers only follow the committed pointer.
    """
    state = {k: np.asarray(v) for k, v in state.items()}

    def write_payload(payload: str) -> None:
        os.makedirs(payload)
        with open(os.path.join(payload, _NPZ_NAME), "wb") as f:
            np.savez(f, **state)
            f.flush()
            os.fsync(f.fileno())

    _commit_payload(path, write_payload)
    return "npz"


def _restore_orbax(payload: str) -> Dict[str, np.ndarray]:
    """The arrays of a flat Orbax PyTree payload (the JAX package's
    state checkpoint when Orbax is installed), read with tensorstore."""
    try:
        import tensorstore as ts
    except ImportError:
        raise FileNotFoundError(
            f"checkpoint payload {payload} was written by Orbax; reading "
            f"it needs the tensorstore package") from None
    with open(os.path.join(payload, _ORBAX_META)) as f:
        doc = json.load(f)
    base = os.path.abspath(payload)
    out = {}
    for entry in doc["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if len(keys) != 1:
            raise ValueError(f"checkpoint payload {payload}: nested key "
                             f"{keys} in a flat state dict")
        kv = ({"driver": "ocdbt", "base": f"file://{base}"}
              if doc.get("use_ocdbt", True) else
              {"driver": "file", "path": os.path.join(base, keys[0])})
        spec = {"driver": "zarr3" if doc.get("use_zarr3") else "zarr",
                "kvstore": kv}
        if doc.get("use_ocdbt", True):
            spec["path"] = keys[0]
        out[keys[0]] = np.asarray(ts.open(spec, open=True).result()
                                  .read().result())
    return out


def restore_state(path: str) -> Dict[str, np.ndarray]:
    """Load the committed state dict written by :func:`save_state` (or by
    the JAX package's, npz or Orbax)."""
    payload, _ = _committed_payload(path)
    if payload is None:
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    npz_path = os.path.join(payload, _NPZ_NAME)
    if os.path.exists(npz_path):
        with np.load(npz_path) as data:
            return {k: data[k] for k in data.files}
    if os.path.exists(os.path.join(payload, _ORBAX_META)):
        return _restore_orbax(payload)
    raise FileNotFoundError(
        f"committed payload {payload} holds no state checkpoint")


def exists(path: str) -> bool:
    """True when ``path`` holds a committed, restorable checkpoint."""
    return _committed_payload(path)[0] is not None


# --- index snapshots (round 13) --------------------------------------

_INDEX_NPZ = "index.npz"
_INDEX_META = "meta.json"
INDEX_SCHEMA = "tfidf-index/1"


def _array_sha(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def save_index(path: str, arrays: Dict[str, np.ndarray],
               meta: Dict) -> str:
    """Persist a built retriever index under the checkpoint root
    ``path`` with the seq+LATEST commit protocol.

    The payload is one plain ``index.npz`` (portable — restoring
    needs numpy only) plus ``meta.json`` carrying the caller's
    metadata (epoch, config fingerprint, doc count) and a sha256
    checksum per array; :func:`restore_index` re-verifies them, so a
    torn or bit-rotted snapshot raises :class:`SnapshotMismatch`
    instead of silently serving wrong results. Returns ``path``."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    doc = {
        "schema": INDEX_SCHEMA,
        "meta": dict(meta),
        "checksums": {k: _array_sha(v) for k, v in arrays.items()},
        "arrays": {k: {"dtype": str(v.dtype), "shape": list(v.shape)}
                   for k, v in arrays.items()},
    }

    def write_payload(payload: str) -> None:
        os.makedirs(payload)
        with open(os.path.join(payload, _INDEX_NPZ), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(payload, _INDEX_META), "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())

    _commit_payload(path, write_payload)
    return path


def restore_index(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load the committed index snapshot: ``(arrays, meta)``.

    Raises ``FileNotFoundError`` when no committed snapshot exists and
    :class:`SnapshotMismatch` when the payload fails its schema or
    checksum validation (the caller falls back to a rebuild)."""
    payload, _ = _committed_payload(path)
    if payload is None:
        raise FileNotFoundError(f"no committed index snapshot at {path}")
    meta_path = os.path.join(payload, _INDEX_META)
    npz_path = os.path.join(payload, _INDEX_NPZ)
    if not os.path.exists(meta_path) or not os.path.exists(npz_path):
        raise SnapshotMismatch(
            f"committed payload {payload} is not an index snapshot "
            f"(state checkpoint? missing meta/npz)")
    with open(meta_path) as f:
        doc = json.load(f)
    if doc.get("schema") != INDEX_SCHEMA:
        raise SnapshotMismatch(
            f"index snapshot schema {doc.get('schema')!r} != "
            f"{INDEX_SCHEMA!r}")
    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}
    checksums = doc.get("checksums", {})
    if set(checksums) != set(arrays):
        raise SnapshotMismatch(
            f"index snapshot arrays {sorted(arrays)} != checksummed "
            f"set {sorted(checksums)}")
    for name, arr in arrays.items():
        got = _array_sha(arr)
        if got != checksums[name]:
            raise SnapshotMismatch(
                f"index snapshot array {name!r} fails its checksum "
                f"({got[:12]}... != {checksums[name][:12]}...) — "
                f"corrupt payload")
    return arrays, dict(doc.get("meta", {}))
