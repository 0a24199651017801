"""The port's Fluid113K scene synthesis (``data/bgeo.py``,
``data/fluid_scenes.py``) against the JAX package's on the CPU.

Each case of ``tests/test_fluid_scenes.py`` runs on the same seeded inputs
through both packages, at the same coarse particle radius: the BGEO files
the port writes are JAX's byte for byte and each package reads the other's
(gzipped ones too); the meshes, the volume and surface samples, the
rotations, the rasters and the FFT placement are bitwise equal and raise the
same errors; a synthesized scene directory (``scene.json``, the ``.bgeo``
files, ``box.obj``) is JAX's byte for byte, budgets and their errors
included; the shards packed from the same partio exports are JAX's byte for
byte and the port's ``read_sim`` equals JAX's on them. The external
simulator is a stand-in executable (written here): ``run_simulator`` hands
it the argv JAX's hands it, and the ``generate`` / ``pack`` command line
writes the files that ``scripts/generate_fluid_scenes.py`` and
``scripts/pack_fluid_records.py`` write. Tolerance: 0 everywhere (the same
numpy code on the same inputs).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import filecmp
import gzip
import importlib.util
import json
import os
import stat
import sys
from unittest import mock

import numpy as np
import pytest

from distegnn_tpu.data import bgeo as jb
from distegnn_tpu.data import fluid_scenes as jf
from distegnn_tpu.data.fluid113k import read_sim as jax_read_sim
from distegnn_tpu_torch.data import bgeo as pb
from distegnn_tpu_torch.data import fluid_scenes as pf
from distegnn_tpu_torch.data.fluid113k import read_sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_TEST = 0.1  # coarse particle radius so tests run in milliseconds
T_FRAMES = 20

# A stand-in for SPlisHSPlasH's DynamicBoundarySimulator: it logs its argv
# to $STANDIN_ARGV_LOG (when set) and exports T_FRAMES partio frames per
# fluid, the particles moved along their start velocities, shuffled and
# carrying ids, the way the simulator's exports arrive.
STANDIN = """#!{python}
import importlib.util, json, os, sys
import numpy as np
# the codec alone, by its path: an external program imports no torch
spec = importlib.util.spec_from_file_location(
    "bgeo", os.path.join({repo!r}, "distegnn_tpu_torch", "data", "bgeo.py"))
bgeo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bgeo)
numpy_from_bgeo, write_bgeo = bgeo.numpy_from_bgeo, bgeo.write_bgeo
log = os.environ.get("STANDIN_ARGV_LOG")
if log:
    with open(log, "a") as f:
        f.write(json.dumps(sys.argv[1:]) + "\\n")
out = sys.argv[sys.argv.index("--output-dir") + 1]
with open(sys.argv[-1]) as f:
    scene = json.load(f)
partio = os.path.join(out, "partio")
os.makedirs(partio, exist_ok=True)
for k, fm in enumerate(scene["FluidModels"]):
    pos0, vel0 = numpy_from_bgeo(os.path.join(out, fm["particleFile"]))
    for t in range({frames}):
        perm = np.random.default_rng([k, t]).permutation(pos0.shape[0])
        write_bgeo(os.path.join(partio, f"ParticleData_{{fm['id']}}_{{t}}.bgeo"),
                   (pos0 + 0.01 * t * vel0)[perm],
                   {{"velocity": vel0[perm], "id": perm.astype(np.int64)}})
"""


def _standin(path):
    with open(path, "w") as f:
        f.write(STANDIN.format(python=sys.executable, repo=REPO,
                               frames=T_FRAMES))
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return str(path)


def _same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names, byte for byte."""
    names = []
    for root, _, files in os.walk(a):
        names += [os.path.relpath(os.path.join(root, f), a) for f in files]
    other = []
    for root, _, files in os.walk(b):
        other += [os.path.relpath(os.path.join(root, f), b) for f in files]
    assert sorted(names) == sorted(other)
    assert names
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return sorted(names)


def _equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype, k


# ------------------------------------------------------------------- bgeo ---

def test_bgeo_roundtrip(tmp_path, rng):
    pos = rng.standard_normal((37, 3)).astype(np.float32)
    vel = rng.standard_normal((37, 3)).astype(np.float32)
    dens = rng.random(37).astype(np.float32)
    ids = rng.permutation(37).astype(np.int64)
    attrs = {"velocity": vel, "density": dens, "id": ids}
    pp, jp = str(tmp_path / "p.bgeo"), str(tmp_path / "j.bgeo")
    pb.write_bgeo(pp, pos, attrs)
    jb.write_bgeo(jp, pos, attrs)
    assert filecmp.cmp(pp, jp, shallow=False)
    # each package reads the other's file
    _equal_dicts(pb.read_bgeo(jp), jb.read_bgeo(pp))
    out = pb.read_bgeo(jp)
    np.testing.assert_array_equal(out["position"], pos)
    np.testing.assert_array_equal(out["velocity"], vel)
    np.testing.assert_array_equal(out["density"], dens)
    np.testing.assert_array_equal(out["id"], ids)


def test_bgeo_gzip_and_id_sort(tmp_path, rng):
    """numpy_from_bgeo restores id order on plain and gzipped files of
    either writer (gzip sniffed by magic, also under a .bgeo name); a
    ``.gz`` path is gzipped on write, its payload JAX's."""
    n = 20
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    perm = rng.permutation(n)
    attrs = {"velocity": vel[perm], "id": perm.astype(np.int64)}
    paths = []
    for tag, mod in (("p", pb), ("j", jb)):
        path = str(tmp_path / f"{tag}.bgeo")
        mod.write_bgeo(path, pos[perm], attrs)
        with open(path, "rb") as f:
            payload = f.read()
        gz_path = str(tmp_path / f"{tag}g.bgeo")
        with open(gz_path, "wb") as f:
            f.write(gzip.compress(payload))
        gz_name = str(tmp_path / f"{tag}.bgeo.gz")
        mod.write_bgeo(gz_name, pos[perm], attrs)
        with gzip.open(gz_name, "rb") as f:
            assert f.read() == payload
        paths += [path, gz_path, gz_name]
    for p in paths:
        for mod in (pb, jb):
            out_pos, out_vel = mod.numpy_from_bgeo(p)
            np.testing.assert_array_equal(out_pos, pos)
            np.testing.assert_array_equal(out_vel, vel)


def test_bgeo_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.bgeo")
    with open(path, "wb") as f:
        f.write(b"not a bgeo file at all")
    msgs = []
    for mod in (pb, jb):
        with pytest.raises(ValueError, match="magic") as e:
            mod.read_bgeo(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_list_partio_frames_ordering(tmp_path):
    d = str(tmp_path)
    for t in (10, 2, 0):  # out-of-order creation; numeric (not lexical) sort
        pb.write_bgeo(os.path.join(d, f"ParticleData_fluid0_{t}.bgeo"),
                      np.zeros((1, 3), np.float32))
    pb.write_bgeo(os.path.join(d, "ParticleData_fluid1_1.bgeo.gz"),
                  np.zeros((1, 3), np.float32))
    frames = pb.list_partio_frames(d)
    assert frames == jb.list_partio_frames(d)
    assert list(frames) == ["fluid0", "fluid1"]
    assert [os.path.basename(p) for p in frames["fluid0"]] == [
        "ParticleData_fluid0_0.bgeo", "ParticleData_fluid0_2.bgeo",
        "ParticleData_fluid0_10.bgeo"]


# ------------------------------------------------ meshes, samples, rasters ---

def test_obj_roundtrip(tmp_path):
    verts, tris = pf.box_mesh((2.0, 3.0, 4.0))
    jv, jt = jf.box_mesh((2.0, 3.0, 4.0))
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(tris, jt)
    fv, ft = pf.fluid_mesh()
    np.testing.assert_array_equal(fv, jf.fluid_mesh()[0])
    np.testing.assert_array_equal(ft, jf.fluid_mesh()[1])
    pp, jp = str(tmp_path / "p.obj"), str(tmp_path / "j.obj")
    pf.write_obj(pp, verts, tris)
    jf.write_obj(jp, verts, tris)
    assert filecmp.cmp(pp, jp, shallow=False)
    v2, t2 = pf.load_obj(jp)
    np.testing.assert_array_equal(v2, jf.load_obj(pp)[0])
    np.testing.assert_array_equal(t2, jf.load_obj(pp)[1])
    np.testing.assert_allclose(v2, verts, atol=1e-6)
    np.testing.assert_array_equal(t2, tris)


def test_points_inside_mesh(rng):
    verts, tris = pf.box_mesh((2.0, 2.0, 2.0))  # x,z in [-1,1], y in [0,2]
    pts = np.array([[0, 1, 0], [0.9, 0.1, -0.9], [1.5, 1, 0], [0, 2.5, 0],
                    [0, -0.1, 0]], np.float64)
    np.testing.assert_array_equal(pf.points_inside_mesh(pts, verts, tris),
                                  [True, True, False, False, False])
    cloud = rng.uniform(-1.5, 2.5, (2000, 3))
    np.testing.assert_array_equal(pf.points_inside_mesh(cloud, verts, tris),
                                  jf.points_inside_mesh(cloud, verts, tris))


def test_sample_volume_grid_density():
    verts, tris = pf.box_mesh((2.0, 2.0, 2.0))
    pts = pf.sample_volume(verts, tris, radius=R_TEST)
    # 2r grid inset by r: floor((2 - 2r) / 2r) + 1 = 10 per axis
    assert pts.shape == (1000, 3)
    np.testing.assert_array_equal(pts, jf.sample_volume(verts, tris,
                                                        radius=R_TEST))
    half = pf.sample_volume(verts, tris, scale=0.5, radius=R_TEST)
    assert half.shape[0] < 300
    np.testing.assert_array_equal(
        half, jf.sample_volume(verts, tris, scale=0.5, radius=R_TEST))


def test_sample_surface_on_surface_inward_normals():
    verts, tris = pf.box_mesh((2.0, 2.0, 2.0))
    pts, nrm = pf.sample_surface(verts, tris, radius=R_TEST)
    jpts, jnrm = jf.sample_surface(verts, tris, radius=R_TEST)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(nrm, jnrm)
    area = 6 * 2.0 * 2.0
    target = int(1.9 * area / (np.pi * R_TEST**2))
    assert pts.shape[0] > 0.5 * target
    inside = pf.points_inside_mesh((pts + 0.05 * nrm).astype(np.float64),
                                   verts, tris)
    assert inside.mean() > 0.99


def test_random_rotation_is_rotation():
    prng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for strength in (1.0, 1.0, 0.5, 0.25, 1.0):
        R = pf.random_rotation_matrix(prng, strength)
        np.testing.assert_array_equal(
            R, jf.random_rotation_matrix(jrng, strength))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-5)
    # the two generators consumed the same draws
    assert prng.random() == jrng.random()


def test_rasterize_points_marks_extent(rng):
    pts = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    arr_min, voxel, occ = pf.rasterize_points(pts, 2.01 * R_TEST, R_TEST)
    jmin, jvox, jocc = jf.rasterize_points(pts, 2.01 * R_TEST, R_TEST)
    np.testing.assert_array_equal(arr_min, jmin)
    assert voxel == jvox
    np.testing.assert_array_equal(occ, jocc)
    idx = np.floor_divide(pts, voxel).astype(np.int32) - arr_min
    assert occ[idx[:, 0], idx[:, 1], idx[:, 2]].all()
    msgs = []
    for mod in (pf, jf):
        with pytest.raises(ValueError) as e:
            mod.rasterize_points(pts, R_TEST, R_TEST)  # voxel too small
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_find_valid_positions_lowest_and_carve():
    """The same placements from the same generator, and the same carved
    free space after each (the raster is mutated in place)."""
    def rasters():
        return ((np.zeros(3, np.int32), 0.5, np.ones((10, 10, 10), bool)),
                (np.zeros(3, np.int32), 0.5, np.ones((3, 3, 3), bool)))

    (pbox, pfl), (jbox, jfl) = rasters(), rasters()
    prng, jrng = np.random.default_rng(43), np.random.default_rng(43)
    sels = []
    for _ in range(2):
        sel = pf.find_valid_fluid_start_positions(pbox, pfl, prng)
        np.testing.assert_array_equal(
            sel, jf.find_valid_fluid_start_positions(jbox, jfl, jrng))
        np.testing.assert_array_equal(pbox[2], jbox[2])
        sels.append(sel)
    assert sels[0][1] == 0.0  # the floor of an empty box
    assert (~pbox[2]).sum() == 54
    assert not np.allclose(sels[0], sels[1])


def test_find_valid_positions_too_large(rng):
    box = (np.zeros(3, np.int32), 0.5, np.ones((4, 4, 4), dtype=bool))
    fluid = (np.zeros(3, np.int32), 0.5, np.ones((6, 6, 6), dtype=bool))
    msgs = []
    for mod in (pf, jf):
        with pytest.raises(ValueError) as e:
            mod.find_valid_fluid_start_positions(box, fluid, rng)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------- scene synthesis ---

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Seed 7 (2 objects, min 500 particles), seed 11 (the 900-particle
    budget) and seed 3 (a 2.5 x 5 x 2.5 box of 1.25^3 fluids: the shards'
    zstd level 22 costs ~0.2 s a shard for the 5 x 10 x 5 box's surface),
    synthesized by each package into its own directory."""
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for tag, mod in (("port", pf), ("jax", jf)):
        d = str(root / tag)
        out[tag] = {
            7: mod.synthesize_scene(d, seed=7, radius=R_TEST, num_objects=2,
                                    min_fluid_particles=500),
            11: mod.synthesize_scene(d, seed=11, radius=R_TEST,
                                     num_objects=2,
                                     const_fluid_particles=900,
                                     min_fluid_particles=100),
            3: mod.synthesize_scene(d, seed=3, radius=R_TEST, num_objects=2,
                                    min_fluid_particles=100,
                                    box_size=(2.5, 5.0, 2.5),
                                    fluid_size=(1.25, 1.25, 1.25))}
    return out


@pytest.mark.parametrize("seed", [7, 11, 3])
def test_synthesize_scene_writes_jaxs_files(scenes, seed):
    names = _same_tree(scenes["port"][seed], scenes["jax"][seed])
    assert {"scene.json", "box.bgeo", "box.obj", "fluid0.bgeo"} <= set(names)
    sim = scenes["port"][seed]
    with open(os.path.join(sim, "scene.json")) as f:
        scene = json.load(f)
    assert scene["Configuration"]["particleRadius"] == R_TEST
    verts, tris = pf.box_mesh((2.5, 5.0, 2.5) if seed == 3 else
                              (5.0, 10.0, 5.0))
    for fm in scene["FluidModels"]:
        fid = fm["id"]
        assert 0.01 <= scene[fid]["viscosity"]
        assert 500 <= scene[fid]["density0"] <= 2000
        pos, vel = pb.numpy_from_bgeo(os.path.join(sim, fm["particleFile"]))
        assert pf.points_inside_mesh(pos.astype(np.float64), verts,
                                     tris).mean() > 0.95
        assert np.ptp(vel, axis=0).max() < 1e-6


def test_synthesize_scene_particle_budgets(tmp_path, scenes):
    sim = scenes["port"][11]
    with open(os.path.join(sim, "scene.json")) as f:
        scene = json.load(f)
    total = sum(pb.numpy_from_bgeo(os.path.join(sim, fm["particleFile"]))[0]
                .shape[0] for fm in scene["FluidModels"])
    assert total == 900
    msgs = []
    for tag, mod in (("p", pf), ("j", jf)):
        with pytest.raises(RuntimeError, match="particles") as e:
            mod.synthesize_scene(str(tmp_path / tag), seed=12, radius=R_TEST,
                                 min_fluid_particles=10**9)
        msgs.append(str(e.value))
        with pytest.raises(RuntimeError, match="particles") as e:
            mod.synthesize_scene(str(tmp_path / tag), seed=12, radius=R_TEST,
                                 max_fluid_particles=10, min_fluid_particles=1)
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]
    assert not os.path.exists(tmp_path / "p" / "sim_0012")


# ------------------------------------------------------ simulator, packing ---

def test_run_simulator_hands_the_standin_jaxs_argv(tmp_path, scenes,
                                                   monkeypatch):
    log = tmp_path / "argv.jsonl"
    monkeypatch.setenv("STANDIN_ARGV_LOG", str(log))
    bin_ = _standin(tmp_path / "standin")
    argv = []
    for mod, tag in ((pf, "port"), (jf, "jax")):
        assert mod.run_simulator(bin_, scenes[tag][7]) == 0
        with open(log) as f:
            argv.append(json.loads(f.readlines()[-1]))
    for got, tag in zip(argv, ("port", "jax")):
        sim = os.path.abspath(scenes[tag][7])
        assert got == ["--no-cache", "--no-gui", "--no-initial-pause",
                       "--output-dir", sim, os.path.join(sim, "scene.json")]
    # the exports of the two scene directories are the same files
    _same_tree(os.path.join(scenes["port"][7], "partio"),
               os.path.join(scenes["jax"][7], "partio"))


def test_pack_records_writes_jaxs_shards(tmp_path, scenes):
    """The same partio exports -> 16 shards each, byte for byte JAX's; the
    port's read_sim equals JAX's on them (and chip_smoke.py's shard-less
    reader of the exports) and gives the exports' frames in id order with
    per-fluid viscosity and mass = density0 * (2r)^3; a shard that exists
    is not rewritten."""
    sim = scenes["port"][3]
    bin_ = _standin(tmp_path / "standin")
    for tag in ("port", "jax"):
        if not os.path.isdir(os.path.join(scenes[tag][3], "partio")):
            assert pf.run_simulator(bin_, scenes[tag][3]) == 0
    out = {}
    for tag, mod in (("port", pf), ("jax", jf)):
        d = tmp_path / tag / "records"
        os.makedirs(d)
        shards = mod.pack_scene_records(scenes[tag][3], "sim_0003",
                                        str(d / "sim_0001"), radius=R_TEST)
        assert len(shards) == 16 and all(os.path.isfile(s) for s in shards)
        out[tag] = d
    _same_tree(out["port"], out["jax"])
    got = read_sim(str(tmp_path / "port"), "records", 1)
    want = jax_read_sim(str(tmp_path / "jax"), "records", 1)
    # chip_smoke.py's phase 18 reads the exports without shards (where
    # zstandard is not installed): the same arrays
    unpacked = _script("scene_sim", os.path.join(REPO, "chip_smoke.py")
                       ).scene_sim(sim, radius=R_TEST)
    for a, b, c in zip(got, want, unpacked):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype == c.dtype
    pos, vel, visc, mass = got
    with open(os.path.join(sim, "scene.json")) as f:
        scene = json.load(f)
    truth, ev, em = [], [], []
    for fm in scene["FluidModels"]:
        p0, v0 = pb.numpy_from_bgeo(os.path.join(sim, fm["particleFile"]))
        truth.append(np.stack([p0 + 0.01 * t * v0 for t in range(T_FRAMES)]))
        ev.append(np.full(p0.shape[0], scene[fm["id"]]["viscosity"]))
        em.append(np.full(p0.shape[0], scene[fm["id"]]["density0"]
                          * (2 * R_TEST) ** 3))
    np.testing.assert_allclose(pos, np.concatenate(truth, axis=1), atol=1e-6)
    np.testing.assert_allclose(visc, np.concatenate(ev), rtol=1e-6)
    np.testing.assert_allclose(mass, np.concatenate(em), rtol=1e-6)
    assert vel.shape == pos.shape
    # existing shards are skipped: a marker byte survives a second pack
    first = str(out["port"] / "sim_0001_00.msgpack.zst")
    with open(first, "ab") as f:
        f.write(b"\0")
    size = os.path.getsize(first)
    pf.pack_scene_records(sim, "sim_0003", str(out["port"] / "sim_0001"),
                          radius=R_TEST)
    assert os.path.getsize(first) == size


def _script(name, path=None):
    """A script of the repo loaded as a module (default: scripts/<name>)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", path or os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_writes_what_the_jax_scripts_write(tmp_path, monkeypatch,
                                               capsys):
    """``generate`` (scene + the stand-in simulator from $SIMULATOR_BIN)
    then ``pack`` through the port's command line, and the same flags
    through the JAX package's two scripts' main(): the same scene
    directory, exports and shards, file for file."""
    monkeypatch.setenv("SIMULATOR_BIN", _standin(tmp_path / "standin"))
    gen = ["--seed", "5", "--radius", "0.2", "--num-objects", "2",
           "--min-fluid-particles", "100", "--default-density"]
    scripts = (_script("generate_fluid_scenes"),
               _script("pack_fluid_records"))
    for tag in ("port", "jax"):
        scenes_dir = str(tmp_path / tag / "scenes")
        records = str(tmp_path / tag / "records")
        g = ["--output", scenes_dir] + gen
        p = ["--input", scenes_dir, "--output", records,
             "--radius", "0.2", "--splits", "4"]
        if tag == "port":
            assert pf.main(["generate"] + g) == 0
            assert pf.main(["pack"] + p) == 0
        else:
            for script, args in zip(scripts, (g, p)):
                with mock.patch.object(sys, "argv", ["x"] + args):
                    assert script.main() == 0
    names = _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len([n for n in names if n.endswith(".msgpack.zst")]) == 4
    assert f"scenes/sim_0005/partio/ParticleData_fluid1_{T_FRAMES - 1}" \
        ".bgeo" in names
    out = capsys.readouterr().out
    assert "sim_0005: 4 shards" in out
    # pack without scene directories fails as JAX's script does
    assert pf.main(["pack", "--input", str(tmp_path / "none"),
                    "--output", str(tmp_path / "none_out")]) == 1
