"""The port's protein (AdK) pipeline against the JAX package's on the CPU.

The synthetic AdK-shaped npz of ``tests/test_pipelines.py`` (T=4180 frames,
N=30 atoms, a Gaussian random walk) goes through both packages'
``process_protein_cutoff``: the plain split, the ``test_rot`` and the
``test_trans`` test splits (translation scaled by the coordinate span, and
by the npz's box ``dimensions`` where it has them) give the same file names
and every field of every graph equal. Without MDAnalysis the extract stage
raises ``NotImplementedError`` naming the npz to place. Then the whole
slice: the first batch of the processed test split through both eval steps
in f32 within 1e-6 of scale, and a protein_cpu_slice-shaped run of the
port's ``main`` on the CPU.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest
import yaml

from distegnn_tpu.data import protein as jprot
from distegnn_tpu.utils import rotate as jrot
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.data import protein as pprot
from distegnn_tpu_torch.utils import rotate as prot_rot
from test_torch_water3d import TOL_FWD, assert_graphs_equal, load, \
    slice_eval_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTA_T, SEED = 5, 3


def write_npz(root, dimensions=False):
    """The fixture of tests/test_pipelines.py; returns the data_dir."""
    rng = np.random.default_rng(2)
    base = os.path.join(str(root), "protein")
    os.makedirs(base, exist_ok=True)
    T, N = 4180, 30
    start = rng.uniform(0, 20, size=(1, N, 3)).astype(np.float32)
    steps = rng.normal(size=(T - 1, N, 3)).astype(np.float32) * 0.05
    positions = np.concatenate([start, start + np.cumsum(steps, axis=0)],
                               axis=0)
    charges = rng.uniform(0.1, 1.0, size=(N,)).astype(np.float32)
    extra = ({"dimensions": np.array([70.0, 60.0, 50.0], np.float32)}
             if dimensions else {})
    np.savez_compressed(os.path.join(base, "adk_backbone.npz"),
                        positions=positions, charges=charges, **extra)
    return str(root)


def test_rotations_match_jax():
    for f in ("rotx", "roty", "rotz"):
        assert np.array_equal(getattr(prot_rot, f)(0.7),
                              getattr(jrot, f)(0.7)), f
    for f in ("random_rotate", "random_rotate_y"):
        a = getattr(prot_rot, f)(np.random.default_rng(5))
        b = getattr(jrot, f)(np.random.default_rng(5))
        assert np.array_equal(a, b), f
    R = prot_rot.random_rotate(np.random.default_rng(1))
    np.testing.assert_allclose(R @ R.T, np.eye(3), rtol=0, atol=1e-12)


@pytest.mark.parametrize("rot, trans, dims, max_samples", [
    (False, False, False, 200),
    (True, False, False, 60),
    (False, True, False, 60),
    (True, True, True, 60)],
    ids=["plain", "test_rot", "test_trans", "rot_trans_dimensions"])
def test_splits_equal_the_jax_splits(tmp_path, rot, trans, dims,
                                     max_samples):
    jdir = write_npz(tmp_path / "jax", dims)
    pdir = write_npz(tmp_path / "port", dims)
    args = ("protein", max_samples, 10.0, DELTA_T, 0.0)
    kw = dict(test_rot=rot, test_trans=trans, seed=SEED)
    jpaths = jprot.process_protein_cutoff(jdir, *args, **kw)
    ppaths = pprot.process_protein_cutoff(pdir, *args, **kw)
    assert [os.path.basename(p) for p in jpaths] == \
        [os.path.basename(p) for p in ppaths]
    splits = [load(p) for p in ppaths]
    for jp, got in zip(jpaths, splits):
        assert_graphs_equal(load(jp), got)
    # the fixed split's first max_samples frames of each
    assert [len(s) for s in splits] == [max_samples] * 3
    with np.load(os.path.join(pdir, "protein", "adk_backbone.npz")) as z:
        first_valid = z["positions"][pprot.TRAIN_VALID_TEST["valid"][0]]
    assert np.array_equal(splits[1][0]["loc"], first_valid)
    if rot or trans:
        # only the test split moves: train and valid are the plain ones
        plain = pprot.process_protein_cutoff(
            str(tmp_path / "port"), *args, seed=SEED)
        assert_graphs_equal(load(plain[0]), splits[0])
        moved = load(plain[2])[0]["loc"], splits[2][0]["loc"]
        assert not np.allclose(*moved, atol=1e-3)


def test_extract_raises_without_mdanalysis_in_both(tmp_path):
    for mod in (jprot, pprot):
        with pytest.raises(NotImplementedError, match="adk_backbone.npz"):
            mod.extract_adk_npz(str(tmp_path))
    with pytest.raises(NotImplementedError, match="adk_all.npz"):
        pprot.process_protein_cutoff(str(tmp_path), "protein", 10, 10.0,
                                     DELTA_T, 0.0, backbone=False)


def test_the_slice_eval_step_matches_jax_on_the_test_split(tmp_path):
    data = write_npz(tmp_path)
    paths = pprot.process_protein_cutoff(data, "protein", 20, 10.0, DELTA_T,
                                         0.0, test_rot=True, seed=SEED)
    over = {"model.hidden_nf": 16, "model.n_layers": 2}
    rel, fwd = slice_eval_parity(
        os.path.join(REPO, "configs", "protein_fastegnn.yaml"), over,
        paths[2], batch_size=5)
    assert rel <= TOL_FWD, rel
    assert fwd <= TOL_FWD, fwd


def test_main_trains_a_protein_cpu_slice_shaped_config(tmp_path):
    """configs/protein_cpu_slice.yaml at narrow widths, 1 epoch, on the
    synthetic npz, through the port's command line."""
    with open(os.path.join(REPO, "configs", "protein_cpu_slice.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["data"].update(data_dir=write_npz(tmp_path / "data"), max_samples=10,
                       test_rot=True)
    raw["model"].update(hidden_nf=16, n_layers=2)
    raw["train"].update(epochs=1)
    raw["log"].update(log_dir=str(tmp_path / "logs"), test_interval=1)
    path = tmp_path / "protein.yaml"
    path.write_text(yaml.safe_dump(raw))
    best = pmain.main(["--config_path", str(path), "--device", "cpu"])
    assert np.isfinite(best["loss_valid"]) and np.isfinite(best["loss_test"])
    names = os.listdir(tmp_path / "data" / "protein" / "processed")
    assert any("_rot1_trans0_s43" in n for n in names), names
