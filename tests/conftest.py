"""Test harness: force an 8-virtual-device CPU platform so multi-chip sharding
is exercised without a pod (SURVEY.md §4: simulate the 8-way partition on CPU).

Note: a pytest plugin imports jax before this conftest runs, so env vars are
too late — use jax.config.update instead (valid until a backend initializes).
float32 matmuls run at 'highest' precision so equivariance tolerances (1e-4,
parity with reference equivariant_test.py:62) hold on any backend.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    # jax < 0.5: the option doesn't exist; the XLA flag is read when the CPU
    # backend initializes (first device use), which hasn't happened yet even
    # though jax is imported — so the env route still works here.
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test (multi-process spawns)")
    # serve tests are tier-1 (NOT slow): CPU-only via JAX_PLATFORMS=cpu, the
    # queue/batcher exercised fully in-process — no network sockets
    config.addinivalue_line("markers", "serve: serving-stack tests (distegnn_tpu/serve)")
    # process-backed serving worker tests: each spawns at least one real
    # child interpreter (slow jax import). One smoke test stays tier-1; the
    # full matrix (chaos drill, swap-under-workers) is additionally `slow`.
    config.addinivalue_line(
        "markers", "process: spawns serving worker child processes")
    # io tests exercise the out-of-core streamed pipeline (data/stream.py);
    # the full-epoch blocked-layout parity sweep is additionally `slow`
    config.addinivalue_line(
        "markers", "io: input-pipeline tests (sharded datasets, prefetch)")
    # the PyTorch port's CUDA kernels have no CPU mode: these tests skip,
    # with a reason, where torch.cuda.is_available() is false
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (distegnn_tpu_torch kernels)")


@pytest.fixture(autouse=True)
def _reap_worker_children():
    """Serving worker children must never outlive their test. The parent-side
    bookkeeping (worker._LIVE + atexit) covers interpreter exit; this covers
    the inter-test gap — a FAILED process-marked test can bail between spawn
    and terminate, and the next test must not inherit its children. Bounded:
    reap_live_workers escalates SIGTERM → SIGKILL and joins each child."""
    yield
    import sys

    wmod = sys.modules.get("distegnn_tpu.serve.worker")
    if wmod is not None:
        wmod.reap_live_workers(join_timeout_s=10.0)


@pytest.fixture
def rng():
    return np.random.default_rng(43)


def make_water3d_h5(base_dir, n_part, t_frames, step_scale, seed):
    """Synthetic Water-3D raw h5 (the reference's converted DeepMind layout:
    traj_<k>/position [T,N,3] + particle_type [N]) for train/valid/test —
    shared by the pipeline and e2e tests. (test_rollout.py keeps its own
    constant-velocity variant: rollout checks need a different trajectory
    model.) Returns the data_dir to pass to the processors."""
    import h5py

    rng = np.random.default_rng(seed)
    base = os.path.join(str(base_dir), "Water-3D")
    os.makedirs(base, exist_ok=True)
    for split in ("train", "valid", "test"):
        with h5py.File(os.path.join(base, f"{split}.h5"), "w") as f:
            for k in range(2):
                g = f.create_group(f"traj_{k}")
                g["particle_type"] = np.full((n_part,), 5.0)
                pos = rng.uniform(0, 0.5, size=(1, n_part, 3)).astype(np.float32)
                steps = rng.normal(
                    size=(t_frames - 1, n_part, 3)).astype(np.float32) * step_scale
                g["position"] = np.concatenate(
                    [pos, pos + np.cumsum(steps, axis=0)], axis=0)
    return str(base_dir)


def assert_run_artifacts(log_dir):
    """The shared trainer's on-disk contract: some run dir under log_dir has
    log/log.json (trainer.py log_dir layout)."""
    runs = os.listdir(str(log_dir))
    assert any(os.path.exists(os.path.join(str(log_dir), r, "log", "log.json"))
               for r in runs)
