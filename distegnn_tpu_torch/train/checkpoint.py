"""Durable checkpoints (port of ``distegnn_tpu/train/checkpoint.py``):
:func:`restore_for_resume` resumes a run (model, optimizer and the resume
coordinates), :func:`restore_params` loads only the model's parameters for
evaluation and serving.

A checkpoint holds {epoch, model state_dict, optimizer state (Adam's, the
micro-step count, the update count and the summed micro-gradients), step,
step_in_epoch, seed, losses, config, mesh}, serialised with ``torch.save``
(plain containers and tensors only, so it loads with ``weights_only=True``).
The parameters are full on every rank, so a checkpoint written under one
world size restores under another (:func:`check_mesh_restore_compat`).
Only rank 0 writes files.

The durability layer, as in JAX:
  - every save is tmp-write + fsync + atomic rename and records a CRC32 +
    size entry in the directory's ``manifest.json`` (itself written
    atomically), so a restore proves a file intact before it deserialises
    it; a torn or garbled file raises :class:`CheckpointCorruptError`;
  - ``save_checkpoint`` sweeps ``*.tmp`` leftovers of a killed write;
  - step checkpoints (``step_<n>.ckpt``) rotate, keeping the newest K
    beside ``best_model`` / ``last_model`` / ``preempt_model``, which never
    rotate;
  - ``train.resume: auto`` (:func:`resolve_resume`) scans a log dir,
    verifies checksums and falls back past corrupt or incompatible files
    to the newest valid state; the seed is adopted from it before anything
    derives from the seed (:func:`adopt_resume_seed`);
  - a preempted run leaves a ``PREEMPTED`` marker naming its checkpoint;
  - under a graph axis every rank resolves its own candidate and
    :func:`verify_resume_consensus` fails before the first step unless
    they all adopted the same coordinates.

Events: ``ckpt/save``, ``ckpt/rotate``, ``ckpt/restore``, ``ckpt/corrupt``,
``ckpt/reshard``, ``resume/consensus`` (obs/trace.py).
"""

from __future__ import annotations

import glob
import io
import json
import os
import pickle
import re
import time
import zipfile
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from distegnn_tpu_torch import obs

MANIFEST_NAME = "manifest.json"
PREEMPT_MARKER = "PREEMPTED"
_REQUIRED_KEYS = ("epoch", "model", "optimizer", "step")
# what a torn or garbled payload raises while it is read back
_LOAD_ERRORS = (EOFError, pickle.UnpicklingError, RuntimeError, ValueError,
                zipfile.BadZipFile, KeyError, AttributeError, TypeError)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification (CRC/size mismatch against its
    manifest entry, an unreadable payload, or missing payload keys)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason
        # every corruption found lands on the event stream's fault timeline
        obs.event("ckpt/corrupt", path=os.path.basename(path), reason=reason)


def _is_main() -> bool:
    """Rank 0 of an initialised process group, or a single process: the
    one writer of checkpoint files."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


@dataclass
class RestoredRun:
    """What a resumed run needs to replay the schedule exactly: the state,
    the completed epochs, the steps of the next epoch already applied
    (mid-epoch cadence or preemption saves), the seed the run started with
    (the loader order and the step generators derive from (seed, epoch,
    step)) and the file. The divergence rollback's learning-rate scale is
    not part of a checkpoint, as in JAX: a resumed run starts at
    ``lr_scale`` 1."""

    state: Any
    epoch: int
    step_in_epoch: int = 0
    losses: dict = field(default_factory=dict)
    seed: Optional[int] = None
    path: Optional[str] = None


def _mesh_of(config) -> Optional[dict]:
    """The (data, graph, tensor) shape recorded in a config, as ints (the
    graph degree: ``parallel.mesh.graph``, else ``data.world_size``), or
    None when the config carries none."""
    if not isinstance(config, dict):
        return None
    mesh = (config.get("parallel") or {}).get("mesh")
    if not isinstance(mesh, dict):
        return None
    data = config.get("data") if isinstance(config.get("data"), dict) else {}
    try:
        out = {k: int(mesh.get(k) or 1) for k in ("data", "graph", "tensor")}
        if mesh.get("graph") is None and data.get("world_size"):
            out["graph"] = int(data["world_size"])
        return out
    except (TypeError, ValueError):
        return None


def check_mesh_restore_compat(payload: dict, config=None) -> None:
    """A checkpoint written under one mesh restores under another: the
    parameters are saved full on every rank, so a change of world size is
    a plain load, recorded as a ``ckpt/reshard`` event. (The tensor axis,
    whose degree must divide the hidden width in JAX, is not ported.)"""
    saved_mesh = payload.get("mesh") or _mesh_of(payload.get("config"))
    target_mesh = _mesh_of(config.to_dict() if hasattr(config, "to_dict")
                           else config)
    if target_mesh is None or saved_mesh is None:
        return
    if saved_mesh != target_mesh:
        obs.event("ckpt/reshard", saved=saved_mesh, target=target_mesh)
        obs.log(f"restore: checkpoint saved under mesh {saved_mesh} onto "
                f"mesh {target_mesh} (the parameters are full on every "
                "rank: a plain load)")


class ResumeConsensusError(RuntimeError):
    """The ranks of a distributed resume adopted different (epoch,
    step_in_epoch) coordinates from their views of the checkpoint
    directory. ``coords`` holds each rank's, ``lagging`` the ranks behind
    the newest view, ``local_path`` the checkpoint this rank resolved."""

    def __init__(self, coords, lagging, local_path=None):
        self.coords = [tuple(int(v) for v in row) for row in coords]
        self.lagging = sorted(int(i) for i in lagging)
        self.local_path = local_path
        latest = max(self.coords)
        views = ", ".join(f"rank {i}: epoch={e} step_in_epoch={s}"
                          for i, (e, s) in enumerate(self.coords))
        behind = ", ".join(f"rank {i}" for i in self.lagging)
        where = (f" (this rank resolved {local_path!r})"
                 if local_path else "")
        super().__init__(
            f"resume consensus failure: {behind} lag(s) behind the newest "
            f"view epoch={latest[0]} step_in_epoch={latest[1]}; a "
            f"half-propagated checkpoint directory on the lagging rank(s) is "
            f"the usual cause. Views: {views}{where}. Give every rank the "
            "same state_dict/ contents, then relaunch.")


def _all_gather_coords(local: np.ndarray, axis_name: str) -> np.ndarray:
    import torch.distributed as dist

    from distegnn_tpu_torch.parallel.mesh import axis_group

    group = axis_group(axis_name)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(local, dtype=torch.int64, device=dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).cpu().numpy()


def verify_resume_consensus(epoch: int, step_in_epoch: int,
                            axis_name: Optional[str] = None,
                            path: Optional[str] = None,
                            allgather: Optional[Callable] = None) -> None:
    """Every rank publishes the (epoch, step_in_epoch) it resumed at, over
    a ``torch.distributed`` all-gather on the group of ``axis_name``; any
    disagreement raises :class:`ResumeConsensusError` on every rank before
    a step runs. A no-op without an axis (one device). ``allgather`` (the
    local [2] array -> the [ranks, 2] stack) replaces the collective in
    single-process tests; ``path`` rides the error."""
    if allgather is None:
        if axis_name is None:
            return
        allgather = lambda x: _all_gather_coords(x, axis_name)  # noqa: E731
    local = np.asarray([int(epoch), int(step_in_epoch)], dtype=np.int64)
    coords = np.asarray(allgather(local)).reshape(-1, 2)
    uniq = {tuple(int(v) for v in row) for row in coords}
    obs.event("resume/consensus", epoch=int(epoch),
              step_in_epoch=int(step_in_epoch), n_views=len(uniq))
    if len(uniq) > 1:
        latest = max(uniq)
        lagging = [i for i, row in enumerate(coords)
                   if (int(row[0]), int(row[1])) < latest]
        obs.event("resume/consensus_failure", lagging=lagging,
                  latest=list(latest),
                  views=[[int(v) for v in row] for row in coords])
        raise ResumeConsensusError(coords, lagging, local_path=path)


def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, MANIFEST_NAME)


def read_manifest(ckpt_dir: str) -> dict:
    """{basename: {crc32, size, epoch, step, step_in_epoch, time}}; empty on
    a missing or unparseable manifest (restore then works without it)."""
    try:
        with open(_manifest_path(ckpt_dir)) as f:
            m = json.load(f)
        return m if isinstance(m, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)   # a crash never leaves a torn file under path


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state, epoch: int,
                    losses: Optional[dict] = None,
                    config: Optional[dict] = None, seed: Optional[int] = None,
                    step_in_epoch: int = 0) -> None:
    """Atomically write one checkpoint of a ``TrainState`` and its manifest
    entry (rank 0 only; a no-op on the others). ``epoch`` counts completed
    epochs; ``step_in_epoch`` the steps of epoch ``epoch + 1`` already
    applied (0 = an epoch boundary)."""
    if not _is_main():
        return
    t0 = time.perf_counter()
    payload = {
        "epoch": int(epoch),
        "model": _cpu(state.model.state_dict()),
        "optimizer": _cpu(state.optimizer.state_dict()),
        "step": int(state.step),
        "step_in_epoch": int(step_in_epoch),
        "seed": None if seed is None else int(seed),
        "losses": dict(losses or {}),
        "config": config,
        # the mesh this run trained under: any other restores (the
        # parameters are full); check_mesh_restore_compat reads it
        "mesh": _mesh_of(config),
    }
    ckpt_dir = os.path.dirname(path) or "."
    os.makedirs(ckpt_dir, exist_ok=True)
    for stale in glob.glob(os.path.join(ckpt_dir, "*.tmp")):
        os.remove(stale)    # leftovers of a killed write
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    _write_atomic(path, blob)
    manifest = read_manifest(ckpt_dir)
    manifest[os.path.basename(path)] = {
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF, "size": len(blob),
        "epoch": int(epoch), "step": int(state.step),
        "step_in_epoch": int(step_in_epoch), "time": time.time()}
    manifest = {k: v for k, v in manifest.items()
                if os.path.exists(os.path.join(ckpt_dir, k))}
    _write_atomic(_manifest_path(ckpt_dir),
                  json.dumps(manifest, indent=2, sort_keys=True).encode())
    obs.event("ckpt/save", path=os.path.basename(path), epoch=int(epoch),
              bytes=len(blob), dur_s=round(time.perf_counter() - t0, 6))


_STEP_RE = re.compile(r"^step_(\d+)\.ckpt$")


def step_checkpoint_name(step: int) -> str:
    return f"step_{int(step):010d}.ckpt"


def rotate_checkpoints(ckpt_dir: str, keep: int) -> List[str]:
    """Keep the newest ``keep`` step checkpoints (by step number);
    ``best_model`` / ``last_model`` / ``preempt_model`` never rotate.
    Returns the removed paths (rank 0; [] on the others)."""
    if not _is_main():
        return []
    steps = []
    for p in glob.glob(os.path.join(ckpt_dir, "step_*.ckpt")):
        m = _STEP_RE.match(os.path.basename(p))
        if m:
            steps.append((int(m.group(1)), p))
    steps.sort()
    keep = max(int(keep), 1)
    removed = []
    for _, p in steps[:max(0, len(steps) - keep)]:
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    if steps:
        newest_step, newest_path = steps[-1]
        try:
            newest_bytes = os.path.getsize(newest_path)
        except OSError:
            newest_bytes = -1
        obs.event("ckpt/rotate", step=newest_step, bytes=newest_bytes,
                  kept=min(len(steps) - len(removed), keep),
                  removed=len(removed))
    return removed


def verified_blob(path: str) -> bytes:
    """A checkpoint file's bytes, checked against the size and CRC32 of its
    directory's manifest entry where there is one."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        raise CheckpointCorruptError(path, "file missing") from None
    entry = read_manifest(os.path.dirname(path) or ".").get(
        os.path.basename(path))
    if entry is not None:
        if len(blob) != int(entry.get("size", -1)):
            raise CheckpointCorruptError(
                path, f"size {len(blob)} != manifest {entry.get('size')} "
                      "(truncated or partially written file)")
        if (zlib.crc32(blob) & 0xFFFFFFFF) != int(entry.get("crc32", -1)):
            raise CheckpointCorruptError(
                path, "CRC32 mismatch against the manifest")
    return blob


def verify_checkpoint(path: str) -> dict:
    """Read and integrity-check one checkpoint; returns the payload."""
    blob = verified_blob(path)
    try:
        payload = torch.load(io.BytesIO(blob), map_location="cpu",
                             weights_only=True)
    except _LOAD_ERRORS as e:
        raise CheckpointCorruptError(path, f"load failed: {e!r}") from None
    if not isinstance(payload, dict) or any(k not in payload
                                            for k in _REQUIRED_KEYS):
        raise CheckpointCorruptError(path, "payload missing required keys")
    return payload


def restore_for_resume(path: str, state, config=None) -> RestoredRun:
    """Verified restore into ``state`` (its model and optimizer, in place,
    the accumulated gradient included), with the resume coordinates
    (epoch, step_in_epoch, seed). A checkpoint of another architecture
    raises ValueError; with ``config`` the saved mesh is checked against
    the restoring one (:func:`check_mesh_restore_compat`)."""
    t0 = time.perf_counter()
    payload = verify_checkpoint(path)
    if config is not None:
        check_mesh_restore_compat(payload, config)
    try:
        _check_fits(state.model, payload["model"])
    except ValueError as e:
        raise _with_config_hint(payload, e) from None
    # both checks before anything loads: a refused file leaves the state
    # as it was (the resume scan then tries the next one)
    state.optimizer.check_state_dict(payload["optimizer"])
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    obs.event("ckpt/restore", path=os.path.basename(path),
              epoch=int(payload["epoch"]),
              bytes=int(os.path.getsize(path)),
              dur_s=round(time.perf_counter() - t0, 6))
    return RestoredRun(state=state, epoch=int(payload["epoch"]),
                       step_in_epoch=int(payload.get("step_in_epoch") or 0),
                       losses=payload.get("losses") or {},
                       seed=payload.get("seed"), path=path)


def restore_checkpoint(path: str, state, config=None
                       ) -> Tuple[object, int, dict]:
    """:func:`restore_for_resume` returning (state, completed epoch,
    losses)."""
    r = restore_for_resume(path, state, config=config)
    return r.state, r.epoch, r.losses


def _with_config_hint(payload: dict, e: Exception) -> ValueError:
    saved_cfg = payload.get("config") or {}
    model_cfg = saved_cfg.get("model") if isinstance(saved_cfg, dict) else None
    hint = (f"; the checkpoint was written with model config {model_cfg}"
            if model_cfg else "")
    return ValueError(f"{e}{hint}")


def _check_fits(model: torch.nn.Module, sd: dict) -> None:
    """Raise ValueError, before any parameter is touched, unless ``sd`` has
    exactly the model's keys and shapes."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = sorted(k for k in set(own) & set(sd)
                    if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(
            f"the checkpoint's parameters do not fit the model: missing "
            f"{missing}, unexpected {unexpected}, other shapes {shapes}")


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Params-only restore for evaluation and serving (the JAX package's
    ``restore_params``): verify the file, then load its ``model`` state
    into ``model``, ignoring the saved optimizer state. A corrupted file
    raises :class:`CheckpointCorruptError`; a checkpoint of another
    architecture raises ValueError naming the model config it was written
    with. Either way ``model`` is left as it was. Returns ``model``."""
    payload = verify_checkpoint(path)
    try:
        _check_fits(model, payload["model"])
    except ValueError as e:
        raise _with_config_hint(payload, e) from None
    model.load_state_dict(payload["model"])
    return model


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint's parameters into ``model`` for serving, told
    apart by the file's content: a trainer checkpoint (the payload of
    :func:`save_checkpoint`) through :func:`restore_params`, which verifies
    it first; a bare ``state_dict`` (e.g. of ``convert.params_from_jax``,
    written with ``torch.save``) as it is. A file that does not load at all
    is read as a damaged trainer checkpoint: :class:`CheckpointCorruptError`.
    Returns ``model``."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except _LOAD_ERRORS:
        obj = None
    if obj is None or (isinstance(obj, dict)
                       and all(k in obj for k in _REQUIRED_KEYS)):
        return restore_params(path, model)
    model.load_state_dict(obj)
    return model


# ---- the resume scan ---------------------------------------------------------

def scan_resume_candidates(log_dir: str) -> List[str]:
    """Every checkpoint under ``<log_dir>/<exp>/state_dict/`` (and a bare
    ``<log_dir>/state_dict/``), newest first by mtime: a preemption's
    ``preempt_model.ckpt``, written last, sorts first."""
    pats = [os.path.join(log_dir, "*", "state_dict", "*.ckpt"),
            os.path.join(log_dir, "state_dict", "*.ckpt")]
    hits = [p for pat in pats for p in glob.glob(pat)]
    return sorted(hits, key=lambda p: os.path.getmtime(p), reverse=True)


def peek_resume_seed(log_dir: str):
    """(seed, path) of the newest checksum-valid checkpoint under
    ``log_dir``, or (None, None): read before the model and the loaders
    exist."""
    for path in scan_resume_candidates(log_dir):
        try:
            payload = verify_checkpoint(path)
        except CheckpointCorruptError:
            continue
        return payload.get("seed"), path
    return None, None


def find_resume_checkpoint(log_dir: str, state,
                           config=None) -> Optional[RestoredRun]:
    """``train.resume: auto``: restore the newest valid checkpoint under
    ``log_dir``, falling back past corrupt, truncated or incompatible files
    with a printed reason. None when nothing restores (a fresh start)."""
    for path in scan_resume_candidates(log_dir):
        try:
            return restore_for_resume(path, state, config=config)
        except CheckpointCorruptError as e:
            obs.log(f"resume: skipping {path} ({e.reason})")
        except ValueError as e:
            obs.log(f"resume: skipping incompatible {path} ({e})")
    return None


def adopt_resume_seed(config) -> None:
    """With ``train.resume`` set, take the seed of the checkpoint about to
    be resumed before anything derives from ``config.seed`` (the loader
    order and the step generators fold (seed, epoch, step))."""
    resume = config.train.get("resume")
    if not resume:
        return
    if resume == "auto":
        seed, path = peek_resume_seed(config.log.log_dir)
    else:
        try:
            seed, path = verify_checkpoint(resume).get("seed"), resume
        except CheckpointCorruptError:
            return  # resolve_resume raises the typed error
    if seed is not None and int(seed) != int(config.seed):
        obs.log(f"resume: adopting seed {seed} from {path} (config had "
                f"{config.seed}) so the resumed run replays the schedule")
        config.seed = int(seed)


def resolve_resume(config, state) -> Optional[RestoredRun]:
    """``train.resume``: 'auto' scans ``log.log_dir`` and falls back past
    corrupt files; a path restores that file or raises. Returns a
    RestoredRun, or None (a fresh start)."""
    resume = config.train.get("resume")
    if not resume:
        return None
    if resume == "auto":
        rr = find_resume_checkpoint(config.log.log_dir, state, config=config)
        if rr is None:
            obs.log("resume: auto found no valid checkpoint under "
                    f"{config.log.log_dir}; starting fresh")
        return rr
    return restore_for_resume(resume, state, config=config)


def write_preempt_marker(ckpt_dir: str, ckpt_name: str, epoch: int,
                         step_in_epoch: int) -> None:
    """The marker of a run that exited on purpose mid-training: the named
    checkpoint continues it (rank 0 writes it)."""
    if not _is_main():
        return
    tmp = os.path.join(ckpt_dir, PREEMPT_MARKER + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"checkpoint": ckpt_name, "epoch": int(epoch),
                   "step_in_epoch": int(step_in_epoch),
                   "time": time.time()}, f)
    os.replace(tmp, os.path.join(ckpt_dir, PREEMPT_MARKER))


def clear_preempt_marker(ckpt_dir: str) -> None:
    try:
        os.remove(os.path.join(ckpt_dir, PREEMPT_MARKER))
    except OSError:
        pass
