"""Candidate publishing: the trainer end of the promotion conveyor (port of
``distegnn_tpu/promote/publish.py``).

After each checkpoint rotation the trainer calls
:meth:`CandidatePublisher.publish` with the freshly written ``step_<n>.ckpt``.
The publisher copies it into the watched conveyor directory and then writes a
JSON *candidate manifest* next to it — both tmp + fsync + rename, manifest
strictly LAST — so the promoter's watcher has one invariant to trust: **a
manifest implies a complete, checksummed checkpoint**. A trainer killed
mid-publish leaves at worst a stale ``.tmp.*`` file that the next publish
sweeps up; it never leaves a half-candidate that a promoter would canary.

Manifest fields (``step_<n>.json``), the JAX package's byte for byte (but
``time``), so a conveyor directory written by either package is read by the
other::

    {"step": n, "ckpt": "step_<n>.ckpt", "crc32": ..., "size": ...,
     "val_loss": ... | null, "config_hash": "..." | null, "time": ...}

``crc32``/``size`` cover the published checkpoint bytes; the promoter
re-verifies them before restoring (torn copies and bit-rot are rejected at
the conveyor, not at swap time). The checkpoint itself is the trainer's
(``train/checkpoint.py``) or a JAX one; ``load_params`` tells them apart.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from distegnn_tpu_torch import obs

_CAND_RE = re.compile(r"^step_(\d+)\.json$")


def candidate_manifest_name(step: int) -> str:
    return f"step_{int(step):010d}.json"


def config_hash(config: Optional[dict]) -> Optional[str]:
    """Stable short hash of a config mapping (sorted-key JSON, sha256/12):
    the promoter surfaces it so a fleet running candidate N is attributable
    to the exact training config that produced it."""
    if config is None:
        return None
    try:
        blob = json.dumps(config, sort_keys=True, default=repr)
    except (TypeError, ValueError):
        blob = repr(sorted(config.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _write_atomic(path: str, blob: bytes) -> None:
    """tmp + fsync + rename in the target directory: readers never observe
    a partial file, and a crash leaves only a ``.tmp.*`` orphan."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CandidatePublisher:
    """Atomically publish rotated checkpoints into the conveyor directory.

    Args:
      watch_dir: the conveyor directory the promoter polls. Created on
        first publish.
      history: candidates retained; older (step, ckpt, manifest) pairs are
        pruned after each publish — manifest FIRST, so a candidate is
        withdrawn before its bytes disappear.
    """

    def __init__(self, watch_dir: str, history: int = 4):
        self.watch_dir = str(watch_dir)
        self.history = max(int(history), 1)
        self.published = 0

    def publish(self, ckpt_path: str, step: int,
                val_loss: Optional[float] = None,
                config: Optional[dict] = None) -> str:
        """Copy ``ckpt_path`` into the conveyor and manifest it. Returns the
        manifest path. Raises on I/O failure — the trainer treats a failed
        publish as non-fatal: training never stops for the conveyor."""
        t0 = time.perf_counter()
        os.makedirs(self.watch_dir, exist_ok=True)
        self._sweep_tmp()
        with open(ckpt_path, "rb") as f:
            blob = f.read()
        step = int(step)
        name = f"step_{step:010d}.ckpt"
        dst = os.path.join(self.watch_dir, name)
        _write_atomic(dst, blob)
        manifest = {
            "step": step,
            "ckpt": name,
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "size": len(blob),
            "val_loss": None if val_loss is None else float(val_loss),
            "config_hash": config_hash(config),
            "time": time.time(),
        }
        mpath = os.path.join(self.watch_dir, candidate_manifest_name(step))
        _write_atomic(mpath, json.dumps(manifest, indent=2).encode())
        self.published += 1
        obs.event("promote/publish", step=step, bytes=len(blob),
                  val_loss=manifest["val_loss"],
                  config_hash=manifest["config_hash"],
                  dur_s=round(time.perf_counter() - t0, 6))
        self._prune()
        return mpath

    def _sweep_tmp(self) -> None:
        """Remove orphaned ``.tmp.*`` files of a publisher that died
        mid-write."""
        try:
            names = os.listdir(self.watch_dir)
        except OSError:
            return
        for n in names:
            if ".tmp." in n:
                try:
                    os.unlink(os.path.join(self.watch_dir, n))
                except OSError:
                    pass

    def _prune(self) -> None:
        steps = sorted(s for s, _ in _scan(self.watch_dir))
        for s in steps[:-self.history]:
            m = os.path.join(self.watch_dir, candidate_manifest_name(s))
            c = os.path.join(self.watch_dir, f"step_{s:010d}.ckpt")
            for path in (m, c):  # manifest first: withdraw, then delete
                try:
                    os.unlink(path)
                except OSError:
                    pass


def _scan(watch_dir: str) -> List[Tuple[int, str]]:
    try:
        names = os.listdir(watch_dir)
    except OSError:
        return []
    out = []
    for n in names:
        m = _CAND_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(watch_dir, n)))
    return out


def list_candidates(watch_dir: str) -> List[int]:
    """Steps with a manifest present, ascending. Presence of the manifest is
    the publication event; the checkpoint itself is verified by
    :func:`read_candidate`."""
    return sorted(s for s, _ in _scan(watch_dir))


def read_candidate(watch_dir: str, step: int) -> Dict[str, Any]:
    """Load + verify one candidate: manifest parses, checkpoint exists, and
    its bytes match the manifest's crc32/size. Returns the manifest dict
    with an absolute ``ckpt_path`` added. Raises ValueError on any mismatch
    (the promoter rejects, it never canaries a torn candidate)."""
    mpath = os.path.join(watch_dir, candidate_manifest_name(step))
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise ValueError(f"candidate step {step}: unreadable manifest "
                         f"{mpath}: {exc}") from None
    ckpt = os.path.join(watch_dir, str(manifest.get("ckpt", "")))
    try:
        with open(ckpt, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise ValueError(f"candidate step {step}: missing checkpoint "
                         f"{ckpt}: {exc}") from None
    if len(blob) != int(manifest.get("size", -1)):
        raise ValueError(f"candidate step {step}: size mismatch "
                         f"({len(blob)} != {manifest.get('size')})")
    if (zlib.crc32(blob) & 0xFFFFFFFF) != int(manifest.get("crc32", -1)):
        raise ValueError(f"candidate step {step}: crc32 mismatch")
    manifest["ckpt_path"] = ckpt
    return manifest


__all__ = ["CandidatePublisher", "candidate_manifest_name", "config_hash",
           "list_candidates", "read_candidate"]
