"""Deterministic fault injectors of the training runtime (port of
``distegnn_tpu/testing/faults.py``; docs/ROBUSTNESS.md, the fault-injection
cookbook).

Each injector reproduces ONE real failure mode at an exact, controllable
point, so the tests and ``testing/tiny_run.py`` can prove the recovery path
instead of hoping for it:

  - :func:`corrupt_checkpoint` — torn write / bit-rot on a checkpoint file
    (restore must skip past it to the previous valid state);
  - :func:`simulate_killed_save` — a save killed between tmp-write and rename
    (the ``*.tmp`` leftover must be swept, the real file stays valid);
  - :func:`poison_nan_batches` — one NaN batch at step N (divergence recovery
    must roll back and retry, not kill the run);
  - :func:`flaky_open` / :func:`truncated_read` — a transient ``OSError``
    or a torn payload from the dataset reads (the bounded-backoff retry of
    ``data/loader.py`` must absorb it);
  - :func:`inject_at_call` — run an arbitrary action (SIGKILL/SIGTERM to
    self) after exactly N train-step calls.

The checkpoint injectors write the JAX package's bytes; the loader
injectors patch the port's open hook ``data/loader.py`` ``_file_open``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch


# ---- checkpoint faults -----------------------------------------------------

def corrupt_checkpoint(path: str, mode: str = "truncate") -> None:
    """Damage an existing checkpoint file in place.

    ``truncate``: cut the file to half its size (a torn write — the manifest
    size check catches it). ``garbage``: flip bytes in the middle keeping the
    size (bit-rot — the CRC32 check catches it). ``headerless``: replace the
    whole file with non-pickle bytes (no manifest entry needed to detect)."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "rb+") as f:
            f.truncate(max(1, size // 2))
    elif mode == "garbage":
        with open(path, "rb+") as f:
            f.seek(size // 2)
            chunk = f.read(64)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
    elif mode == "headerless":
        with open(path, "wb") as f:
            f.write(b"not a pickle at all")
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


def simulate_killed_save(ckpt_dir: str, name: str = "victim.ckpt") -> str:
    """Leave the debris of a save killed MID-WRITE: a partial ``<name>.tmp``
    that never reached its atomic rename. Returns the tmp path. The next
    save_checkpoint into the directory must sweep it; restore must never
    consider it (only ``*.ckpt`` files are scanned)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = pickle.dumps({"epoch": 0, "params_leaves": [np.zeros(3)]})
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob[: len(blob) // 2])  # killed before the write finished
    return tmp


# ---- data faults -----------------------------------------------------------

def _nanify(x):
    """``x`` with every floating array replaced by NaN, where it sits (a
    tensor keeps its device); a GraphBatch or a graph dict field by field;
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan")) if x.is_floating_point() \
            else x
    if isinstance(x, np.ndarray):
        return np.full_like(x, np.nan) if np.issubdtype(
            x.dtype, np.floating) else x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _nanify(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _nanify(v) for k, v in x.items()}
    return x


class poison_nan_batches:
    """Loader wrapper yielding batch ``at_step`` (0-based, counted across
    epochs) with every floating field replaced by NaN — the classic corrupted
    shard / overflowed preprocessing record. Fires ``times`` times total, so
    a rolled-back retry of the same epoch sees the CLEAN batch and recovery
    can be proven deterministic."""

    def __init__(self, loader, at_step: int, times: int = 1):
        self.loader = loader
        self.at_step = int(at_step)
        self.times = int(times)
        self._count = 0
        self.fired = 0

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            if self._count == self.at_step and self.fired < self.times:
                self.fired += 1
                batch = _nanify(batch)
            self._count += 1
            yield batch


@contextlib.contextmanager
def _patched_open(hook_factory):
    """Install ``hook_factory(real_open, calls)`` as the loader's open hook
    for the context; yields the call counter and restores the hook."""
    from distegnn_tpu_torch.data import loader as loader_mod

    calls = {"n": 0}
    real = loader_mod._file_open
    loader_mod._file_open = hook_factory(real, calls)
    try:
        yield calls
    finally:
        loader_mod._file_open = real


def flaky_open(fail_times: int, exc: Optional[OSError] = None):
    """Patch the data loader's open hook so the first ``fail_times`` opens
    raise a transient ``OSError`` (default: errno 5, the NFS/GCS hiccup
    shape), then defer to the real ``open``. Context manager; restores the
    hook on exit. Yields a dict with the observed call count."""
    err = exc if exc is not None else OSError(5, "injected transient I/O error")

    def factory(real, calls):
        def _open(path, mode="rb"):
            calls["n"] += 1
            if calls["n"] <= fail_times:
                raise type(err)(*err.args)
            return real(path, mode)
        return _open

    return _patched_open(factory)


def truncated_read(fail_times: int, fraction: float = 0.5):
    """Patch the loader's open hook so the first ``fail_times`` opened files
    hand back only the leading ``fraction`` of their bytes — the torn-NFS
    shape where ``open()`` SUCCEEDS and the failure only surfaces inside the
    payload read (``pickle.load`` EOFError, npz BadZipFile, shard CRC
    mismatch). Exercises the full-read retry (``loader._read_with_retry``)
    that a plain open-retry cannot cover. Yields the observed call count."""
    def factory(real, calls):
        def _open(path, mode="rb"):
            calls["n"] += 1
            if calls["n"] <= fail_times:
                with real(path, "rb") as f:
                    data = f.read()
                return io.BytesIO(data[:int(len(data) * fraction)])
            return real(path, mode)
        return _open

    return _patched_open(factory)


# ---- process faults --------------------------------------------------------

def inject_at_call(step: Callable, n: int, action: Callable[[], None]) -> Callable:
    """Wrap a train step so ``action()`` runs immediately AFTER the ``n``-th
    call (1-based) returns — e.g. ``lambda: os.kill(os.getpid(),
    signal.SIGKILL)`` for an abrupt preemption, or ``signal.raise_signal``
    for a graceful one. The wrapped step is otherwise transparent, whatever
    its arguments (the port's ``(state, batch, generator)``)."""
    count = {"i": 0}

    def wrapped(*args, **kwargs):
        out = step(*args, **kwargs)
        count["i"] += 1
        if count["i"] == n:
            action()
        return out

    return wrapped
