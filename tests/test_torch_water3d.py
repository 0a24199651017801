"""The port's Water-3D pipeline against the JAX package's on the CPU.

The same raw h5 files (``tests/conftest.py`` ``make_water3d_h5``: 40
particles, 40 frames, 2 trajectories a split) go through both packages'
processors: cutoff mode writes the same file names and every field of every
graph is equal (``np.array_equal``); distribute mode at world 4 under
``kmeans`` and ``metis`` gives equal shards rank by rank; the port reads a
cache the JAX package wrote. The port reads the h5 files with its own
numpy reader (``data/hdf5.py``), held here against ``h5py`` on the layouts
the HDF5 library writes (contiguous, gzip and shuffle chunks, compact, a
multi-level group B-tree, big-endian and integer types); its writer's files
read back equal through ``h5py`` and through the JAX processor. Then the
whole slice: the first batch of the processed test split through the JAX
eval step and the port's, with the weights carried across by
``convert.params_from_jax``, in f32 within 1e-6 of scale.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import pickle

import h5py
import jax
import numpy as np
import pytest
import torch

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu.data import water3d as jw
from distegnn_tpu.data.loader import GraphDataset as JaxGraphDataset
from distegnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from distegnn_tpu.models.registry import get_model as jax_get_model
from distegnn_tpu.train import step as jstep
from distegnn_tpu_torch.config import load_config
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data import hdf5
from distegnn_tpu_torch.data import water3d as pw
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.train.step import make_eval_step
from test_torch_fast_egnn import numpy_params
from tests.conftest import make_water3d_h5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PART, T_FRAMES = 40, 40
RADIUS, DELTA_T, MAX_SAMPLES, SEED = 0.15, 5, 20, 3
# the forward tolerance of the port's f32 parity tests, of max |target|
TOL_FWD = 1e-6


def raw_dir(root):
    return make_water3d_h5(root, N_PART, T_FRAMES, step_scale=0.003, seed=11)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_graphs_equal(a, b):
    assert len(a) == len(b) > 0
    for ga, gb in zip(a, b):
        assert ga.keys() == gb.keys()
        for k in ga:
            if ga[k] is None:
                assert gb[k] is None, k
                continue
            assert ga[k].dtype == gb[k].dtype, k
            assert np.array_equal(ga[k], gb[k]), k


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The same raw files processed in cutoff mode by each package, in a
    directory of its own: (jax paths, port paths)."""
    jdir = raw_dir(tmp_path_factory.mktemp("w3d_jax"))
    pdir = raw_dir(tmp_path_factory.mktemp("w3d_port"))
    args = ("Water-3D", MAX_SAMPLES, RADIUS, DELTA_T, 0.0)
    return (jw.process_water3d_cutoff(jdir, *args, seed=SEED),
            pw.process_water3d_cutoff(pdir, *args, seed=SEED))


def test_cutoff_mode_writes_the_jax_graphs_under_the_jax_names(both):
    jpaths, ppaths = both
    assert [os.path.basename(p) for p in jpaths] == \
        [os.path.basename(p) for p in ppaths]
    for jp, pp in zip(jpaths, ppaths):
        assert_graphs_equal(load(jp), load(pp))
    g = load(ppaths[0])[0]
    assert g["edge_index"].shape[1] > 0 and g["node_feat"].shape == (N_PART, 2)
    # 15 frames of the first trajectory, 5 of the second
    assert len(load(ppaths[0])) == MAX_SAMPLES


def test_port_reads_a_cache_the_jax_package_wrote(tmp_path):
    data = raw_dir(tmp_path)
    args = ("Water-3D", MAX_SAMPLES, RADIUS, DELTA_T, 0.0)
    jpaths = jw.process_water3d_cutoff(data, *args, seed=SEED)
    stamps = [os.stat(p).st_mtime_ns for p in jpaths]
    # the raw files go: a processor that did not find the cache would fail
    for split in ("train", "valid", "test"):
        os.remove(os.path.join(data, "Water-3D", f"{split}.h5"))
    ppaths = pw.process_water3d_cutoff(data, *args, seed=SEED)
    assert ppaths == jpaths
    assert [os.stat(p).st_mtime_ns for p in ppaths] == stamps
    assert_graphs_equal(JaxGraphDataset(jpaths[2]).graphs,
                        GraphDataset(ppaths[2]).graphs)


@pytest.mark.parametrize("split_mode", ["kmeans", "metis"])
def test_distribute_mode_shards_equal_the_jax_shards(tmp_path, split_mode):
    jdir, pdir = raw_dir(tmp_path / "jax"), raw_dir(tmp_path / "port")
    args = ("Water-3D", 4, 6, RADIUS, RADIUS + 0.03, split_mode, DELTA_T)
    jsplits = jw.process_water3d_distribute(jdir, *args, seed=SEED)
    psplits = pw.process_water3d_distribute(pdir, *args, seed=SEED)
    for js, ps in zip(jsplits, psplits):
        assert [os.path.basename(p) for p in js] == \
            [os.path.basename(p) for p in ps]
        assert len(ps) == 4
        for jp, pp in zip(js, ps):
            assert_graphs_equal(load(jp), load(pp))
    # the parts of a frame partition its particles
    shards = [load(p) for p in psplits[0]]
    for parts in zip(*shards):
        assert sum(g["loc"].shape[0] for g in parts) == N_PART


def slice_eval_parity(config_path, over, test_pkl, batch_size):
    """The first batch of ``test_pkl`` through the JAX package's eval step
    and the port's, with numpy-drawn weights converted by
    ``params_from_jax``: returns (relative MSE error, forward error over
    max |target|)."""
    jcfg = jax_load_config(config_path)
    for k, v in over.items():
        section, name = k.split(".")
        jcfg[section][name] = v
    cfg = load_config(config_path, over)
    jb = next(iter(JaxGraphLoader(JaxGraphDataset(test_pkl), batch_size)))
    pb = next(iter(GraphLoader(GraphDataset(test_pkl), batch_size)))
    jm = jax_get_model(jcfg.model, dataset_name=jcfg.data.dataset_name)
    params = numpy_params(jm, jb, seed=7)
    want = float(jax.jit(jstep.make_eval_step(jm))(params, jb))
    jpred, _ = jax.jit(jm.apply)(params, jb)
    pm = get_model(cfg.model, dataset_name=cfg.data.dataset_name)
    pm.load_state_dict(params_from_jax(params))
    got = float(make_eval_step(pm)(pb))
    with torch.no_grad():
        ppred, _ = pm(pb)
    mask = np.asarray(jb.node_mask, bool)
    jpred = np.asarray(jpred)[mask]
    scale = float(np.abs(np.asarray(jb.target)[mask]).max())
    fwd = float(np.abs(ppred.numpy()[mask] - jpred).max()) / scale
    return abs(got - want) / abs(want), fwd


def test_the_slice_eval_step_matches_jax_on_the_test_split(both):
    _, ppaths = both
    over = {"model.hidden_nf": 16, "model.n_layers": 2}
    rel, fwd = slice_eval_parity(
        os.path.join(REPO, "configs", "water3d_fastegnn.yaml"), over,
        ppaths[2], batch_size=4)
    assert rel <= TOL_FWD, rel
    assert fwd <= TOL_FWD, fwd


def h5_cases():
    rng = np.random.default_rng(0)

    def trajs(n, T, N, pt, pos):
        return {f"traj_{k}": {
            "particle_type": np.arange(N).astype(pt),
            "position": rng.normal(size=(T, N, 3)).astype(pos)}
            for k in range(n)}

    return {
        "contiguous": (trajs(2, 10, 40, np.float64, np.float32), {}),
        "gzip": (trajs(3, 17, 33, np.int64, np.float32),
                 dict(compression="gzip")),
        "shuffle_chunks": (trajs(2, 17, 33, np.int32, np.float64),
                           dict(compression="gzip", shuffle=True,
                                chunks=(5, 10, 3))),
        "300_groups_big_endian": (trajs(300, 2, 4, ">i8", ">f4"), {}),
    }


@pytest.mark.parametrize("case", sorted(h5_cases()))
def test_hdf5_reader_and_writer_agree_with_h5py(tmp_path, case):
    groups, kw = h5_cases()[case]
    path = str(tmp_path / "lib.h5")
    with h5py.File(path, "w") as f:
        for g, arrays in groups.items():
            for name, a in arrays.items():
                f.create_dataset(f"{g}/{name}", data=a,
                                 **(kw if name == "position" else {}))
    written = str(tmp_path / "port.h5")
    if len(groups) <= 256:
        hdf5.write_groups(written, groups)
    for p in (path, written) if len(groups) <= 256 else (path,):
        got = hdf5.read_groups(p)
        with h5py.File(p, "r") as f:
            assert sorted(f.keys()) == sorted(got) == sorted(groups)
            for g, arrays in groups.items():
                for name, a in arrays.items():
                    want = f[g][name][()]
                    assert np.array_equal(want, a)
                    assert got[g][name].dtype == want.dtype.newbyteorder("=")
                    assert np.array_equal(got[g][name], want), (p, g, name)


def test_hdf5_reader_takes_a_compact_dataset_and_refuses_the_rest(tmp_path):
    path = str(tmp_path / "compact.h5")
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        g = f.create_group("traj_0")
        ds = h5py.h5d.create(g.id, b"particle_type", h5py.h5t.NATIVE_DOUBLE,
                             h5py.h5s.create_simple((6,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6.0))
    assert np.array_equal(hdf5.read_groups(path)["traj_0"]["particle_type"],
                          np.arange(6.0))
    latest = str(tmp_path / "latest.h5")
    with h5py.File(latest, "w", libver="latest") as f:
        f["traj_0/position"] = np.zeros((2, 3, 3), np.float32)
    with pytest.raises(NotImplementedError, match="superblock version"):
        hdf5.read_groups(latest)
    with pytest.raises(NotImplementedError, match="filter"):
        with h5py.File(path, "w") as f:
            f.create_dataset("traj_0/position", data=np.zeros((4, 3)),
                             chunks=(2, 3), fletcher32=True)
        hdf5.read_groups(path)


def test_jax_reads_the_files_the_port_writes(tmp_path):
    """Raw files written by data/hdf5.py: the JAX processor (h5py) and the
    port's give equal graphs."""
    rng = np.random.default_rng(4)
    raw = {split: {"traj_0": {
        "particle_type": np.full((40,), 5.0),
        "position": (0.2 + np.cumsum(rng.normal(size=(30, 40, 3)) * 0.003,
                                     axis=0)).astype(np.float32)}}
        for split in ("train", "valid", "test")}
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d / "Water-3D")
        for split, groups in raw.items():
            hdf5.write_groups(str(tmp_path / d / "Water-3D" / f"{split}.h5"),
                              groups)
    args = ("Water-3D", 6, RADIUS, DELTA_T, 0.0)
    jpaths = jw.process_water3d_cutoff(str(tmp_path / "jax"), *args)
    ppaths = pw.process_water3d_cutoff(str(tmp_path / "port"), *args)
    for jp, pp in zip(jpaths, ppaths):
        assert_graphs_equal(load(jp), load(pp))
