"""Durable checkpoint save/restore (port of the save/restore contract of
``distegnn_tpu/train/checkpoint.py``): :func:`restore_checkpoint` resumes a
run (model and optimizer), :func:`restore_params` loads only the model's
parameters for evaluation and serving.

A checkpoint holds {epoch, model state_dict, optimizer state, step,
step_in_epoch, seed, losses, config}, serialised with ``torch.save`` (plain
containers and tensors only, so it loads with ``weights_only=True``). Every
save is tmp-write + fsync + atomic rename, and records a CRC32 + size entry
in the directory's ``manifest.json`` (itself written atomically), so restore
can prove a file intact before it deserialises it; a torn or garbled file
raises :class:`CheckpointCorruptError` naming the path.
"""

from __future__ import annotations

import glob
import io
import json
import os
import pickle
import time
import zipfile
import zlib
from typing import Optional, Tuple

import torch

MANIFEST_NAME = "manifest.json"
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
    entry. ``epoch`` counts completed epochs; ``step_in_epoch`` the steps of
    epoch ``epoch + 1`` already applied (0 = an epoch boundary)."""
    payload = {
        "epoch": int(epoch),
        "model": _cpu(state.model.state_dict()),
        "optimizer": _cpu(state.optimizer.state_dict()),
        "step": int(state.step),
        "step_in_epoch": int(step_in_epoch),
        "seed": None if seed is None else int(seed),
        "losses": dict(losses or {}),
        "config": config,
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


def verify_checkpoint(path: str) -> dict:
    """Read and integrity-check one checkpoint; returns the payload."""
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
    try:
        payload = torch.load(io.BytesIO(blob), map_location="cpu",
                             weights_only=True)
    except _LOAD_ERRORS as e:
        raise CheckpointCorruptError(path, f"load failed: {e!r}") from None
    if not isinstance(payload, dict) or any(k not in payload
                                            for k in _REQUIRED_KEYS):
        raise CheckpointCorruptError(path, "payload missing required keys")
    return payload


def restore_checkpoint(path: str, state) -> Tuple[object, int, dict]:
    """Verified restore into ``state`` (its model and optimizer, in place);
    returns (state, completed epoch, losses). A checkpoint of another
    architecture raises ValueError."""
    payload = verify_checkpoint(path)
    try:
        state.model.load_state_dict(payload["model"])
    except RuntimeError as e:
        raise ValueError(f"checkpoint {path} does not fit the model: "
                         f"{e}") from None
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), payload.get("losses") or {}


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
