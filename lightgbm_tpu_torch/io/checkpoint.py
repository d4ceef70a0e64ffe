"""Atomic training checkpoints: write-temp-fsync-rename, a checksum
header, keep-last-k rotation.

Counterpart of ``lightgbm_tpu/io/checkpoint.py``. A model-text snapshot
(``snapshot_freq``) cannot resume a run bit for bit: it loses the cached
scores, the random streams, the bagging state and the early-stopping
bests. A snapshot here is the complete training state
(``boosting/gbdt.py`` ``capture_training_state``), so ``train`` with
``tpu_checkpoint_dir`` resumes a killed run to the model an uninterrupted
run would have grown.

The durability contract is the JAX package's:

* **atomic**: the payload goes to a temporary file in the same directory,
  is fsync-ed, then ``os.replace``-d into place and the directory entry
  fsync-ed, so a crash mid-write never leaves a half-written file under a
  snapshot's name (the reader ignores the temporary names);
* **self-validating**: a magic, the payload's length and its SHA-256 lead
  the file; a torn, truncated or bit-flipped file raises
  :class:`SnapshotCorrupt`, and :func:`load_latest` falls back to the
  previous valid snapshot;
* **bounded**: keep-last-``keep`` rotation deletes older snapshots only
  after the new one is durably in place.

The format differs from the JAX package's, which pickles: the payload is
an ``.npz`` archive (numpy arrays, read with ``allow_pickle=False``) whose
``__state__`` member is the state's JSON, in which each array stands as
``{"__nd__": name}`` and each tuple as ``{"__tuple__": [...]}``. Loading
a snapshot runs no code from it, as the port's ``load_binary`` refuses
pickles. The port has its own magic: a JAX-package snapshot is
``SnapshotCorrupt`` ("not a port snapshot"), never unpickled.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import log

MAGIC = b"LGBTTORCHCK1"
# the JAX package's magic (lightgbm_tpu/io/checkpoint.py): a pickle
_JAX_MAGIC = b"LGBMTPUCKPT1"
_HEADER_LEN = len(MAGIC) + 8 + 32
_NAME_RE = re.compile(r"^snapshot_iter_(\d+)\.ckpt$")
_STATE = "__state__"


class SnapshotCorrupt(ValueError):
    """A snapshot file failed its magic, length, checksum or decoding."""


def snapshot_path(directory: str, iteration: int) -> str:
    return os.path.join(directory, f"snapshot_iter_{iteration:09d}.ckpt")


def list_snapshots(directory: str) -> List[Tuple[int, str]]:
    """The ``(iteration, path)`` pairs in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def _encode(obj: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """``obj`` as JSON, its numpy arrays moved into ``arrays``."""
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise TypeError("a snapshot holds no object arrays")
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"__nd__": key}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str) or k in ("__nd__", "__tuple__"):
                raise TypeError(f"snapshot dict keys are plain strings, "
                                f"got {k!r}")
            out[k] = _encode(v, arrays)
        return out
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v, arrays) for v in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"a snapshot cannot hold {type(obj).__name__}")


def _decode(obj: Any, arrays) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return arrays[obj["__nd__"]]
        if "__tuple__" in obj:
            return tuple(_decode(v, arrays) for v in obj["__tuple__"])
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


def encode_state(state: Dict[str, Any]) -> bytes:
    """The payload of ``state``: an ``.npz`` archive of its arrays and its
    JSON."""
    arrays: Dict[str, np.ndarray] = {}
    doc = json.dumps(_encode(state, arrays)).encode()
    arrays[_STATE] = np.frombuffer(doc, np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_state(payload: bytes) -> Dict[str, Any]:
    """``encode_state``'s inverse; reads no pickle."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
        arrays = {k: npz[k] for k in npz.files}
    doc = arrays.pop(_STATE)
    return _decode(json.loads(doc.tobytes().decode()), arrays)


def _fsync_dir(directory: str) -> None:
    """Make the rename durable in the directory entry (POSIX: a rename is
    atomic, but durable only once the directory syncs)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - a directory that cannot open
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def write_snapshot(directory: str, iteration: int, state: Dict[str, Any],
                   keep: int = 3) -> str:
    """Persist ``state`` atomically as the snapshot of ``iteration``;
    returns its path. Rotation (keep the last ``keep``; ``keep <= 0``
    keeps all) runs only after the new snapshot is durably in place."""
    os.makedirs(directory, exist_ok=True)
    payload = encode_state(state)
    digest = hashlib.sha256(payload).digest()
    final = snapshot_path(directory, iteration)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".snapshot_tmp_")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(MAGIC)
            fh.write(len(payload).to_bytes(8, "big"))
            fh.write(digest)
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)
    if keep > 0:
        for _, old in list_snapshots(directory)[:-keep]:
            try:
                os.unlink(old)
            except OSError:  # pragma: no cover - already gone
                pass
    # chaos hook: corrupt@snapshot=N damages the file that just landed
    from ..analysis.faultinject import active_plan
    active_plan().fire("snapshot", path=final)
    return final


def read_snapshot(path: str) -> Dict[str, Any]:
    """Load and check one snapshot; raises :class:`SnapshotCorrupt`."""
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as err:
        raise SnapshotCorrupt(f"{path}: unreadable ({err})")
    if blob.startswith(_JAX_MAGIC):
        raise SnapshotCorrupt(f"{path}: not a port snapshot (the JAX "
                              "package's pickled format is never loaded)")
    if len(blob) < _HEADER_LEN or not blob.startswith(MAGIC):
        raise SnapshotCorrupt(f"{path}: bad magic / truncated header")
    n = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 8], "big")
    digest = blob[len(MAGIC) + 8:_HEADER_LEN]
    payload = blob[_HEADER_LEN:]
    if len(payload) != n:
        raise SnapshotCorrupt(
            f"{path}: payload length {len(payload)} != recorded {n} "
            "(torn write)")
    if hashlib.sha256(payload).digest() != digest:
        raise SnapshotCorrupt(f"{path}: checksum mismatch")
    try:
        return decode_state(payload)
    except Exception as err:
        raise SnapshotCorrupt(f"{path}: undecodable payload ({err})")


def load_latest(directory: str) -> Optional[Dict[str, Any]]:
    """The newest valid snapshot's state, or None: damaged snapshots are
    warned about and skipped back to the previous valid one."""
    for iteration, path in reversed(list_snapshots(directory)):
        try:
            state = read_snapshot(path)
        except SnapshotCorrupt as err:
            log.warning(f"skipping corrupted snapshot: {err}")
            continue
        state.setdefault("iteration", iteration)
        return state
    return None
