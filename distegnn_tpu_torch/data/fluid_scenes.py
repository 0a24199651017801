"""Fluid113K offline scene generation (port of
``distegnn_tpu/data/fluid_scenes.py``, itself the in-tree port of the
reference's SPlisHSPlasH pipeline, dataset_generation/Fluid113K/
create_physics_scenes.py:1-497 and create_physics_records.py:1-148).

The reference synthesizes random fluid scenes (randomly rotated/scaled fluid
volumes dropped into a box, random viscosity/density), writes a SPlisHSPlasH
scene description (JSON + bgeo particle files), runs the external
``DynamicBoundarySimulator`` C++ binary, and packs the exported frames into
the ``sim_XXXX_YY.msgpack.zst`` shards that ``data/fluid113k.py``
``read_sim`` reads. The code is the JAX package's numpy, so a scene and its
shards are the JAX package's byte for byte. Two re-designs of the reference
carry over from it:

- mesh volume/surface sampling is done in-tree with numpy (parity ray casts
  and area-weighted surface draws) instead of the ``VolumeSampling`` binary
  and open3d Poisson-disk sampling (create_physics_scenes.py:120-145);
- the O(grid^3 * window^3) Python placement scan
  (find_valid_fluid_start_positions, create_physics_scenes.py:183-224) is an
  FFT cross-correlation plus a first-valid-per-column reduction.

Only the physics simulation itself stays external: ``run_simulator`` drives
any SPlisHSPlasH build via subprocess exactly like the reference
(create_physics_scenes.py:225-231); without the binary the synthesized scene
directories are still complete and portable to a machine that has one.

The command line (the counterpart of ``scripts/generate_fluid_scenes.py``
and ``scripts/pack_fluid_records.py``, flag for flag)::

    python -m distegnn_tpu_torch.data.fluid_scenes generate \
        --output data/fluid_scenes --seed 1 [--simulator-bin BIN]
    python -m distegnn_tpu_torch.data.fluid_scenes pack \
        --input data/fluid_scenes --output data/LargeFluid/Fluid113K

``generate`` runs the simulator when ``--simulator-bin`` or
``$SIMULATOR_BIN`` names one, else writes the scene only; ``pack`` turns
every ``sim_*`` directory's partio exports into 16 shards. Both are host
numpy: no device is involved until the shards are read for training.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np

from distegnn_tpu_torch.data.bgeo import (list_partio_frames,
                                          numpy_from_bgeo,
                                          write_bgeo_from_numpy)

PARTICLE_RADIUS = 0.025
MAX_FLUID_START_VELOCITY_XZ = 4.0
MAX_FLUID_START_VELOCITY_Y = 1.0

# SPlisHSPlasH scene-file parameter blocks (simulator API configuration;
# values per reference create_physics_scenes.py:36-90).
DEFAULT_CONFIGURATION = {
    "pause": False, "stopAt": 4.0, "particleRadius": 0.025,
    "numberOfStepsPerRenderUpdate": 1, "density0": 1000, "simulationMethod": 4,
    "gravitation": [0, -9.81, 0], "cflMethod": 0, "cflFactor": 1,
    "cflMaxTimeStepSize": 0.005, "maxIterations": 100, "maxError": 0.01,
    "maxIterationsV": 100, "maxErrorV": 0.1, "stiffness": 50000, "exponent": 7,
    "velocityUpdateMethod": 0, "enableDivergenceSolver": True,
    "enablePartioExport": True, "enableRigidBodyExport": True,
    "particleFPS": 50.0, "partioAttributes": "density;velocity",
}
DEFAULT_SIMULATION = {"contactTolerance": 0.0125}
DEFAULT_FLUID = {
    "surfaceTension": 0.2, "surfaceTensionMethod": 0, "viscosity": 0.01,
    "viscosityMethod": 3, "viscoMaxIter": 200, "viscoMaxError": 0.05,
}
DEFAULT_RIGIDBODY = {
    "translation": [0, 0, 0], "rotationAxis": [0, 1, 0], "rotationAngle": 0,
    "scale": [1.0, 1.0, 1.0], "color": [0.1, 0.4, 0.6, 1.0], "isDynamic": False,
    "isWall": True, "restitution": 0.6, "friction": 0.0,
    "collisionObjectType": 5, "collisionObjectScale": [1.0, 1.0, 1.0],
    "invertSDF": True,
}


# ---------------------------------------------------------------- meshes ---

def box_mesh(size=(5.0, 10.0, 5.0), base_y: float = 0.0):
    """Axis-aligned box triangle mesh: the reference's Box.obj is a 5x10x5
    container with its floor at y=0, Fluid.obj a 2.5^3 cube about the origin
    (dataset_generation/Fluid113K/models/)."""
    sx, sy, sz = size
    xs, ys, zs = (-sx / 2, sx / 2), (base_y, base_y + sy), (-sz / 2, sz / 2)
    verts = np.array([[x, y, z] for x in xs for y in ys for z in zs], np.float64)
    # 12 triangles, outward-facing winding
    quads = [(0, 1, 3, 2), (4, 6, 7, 5),  # x- x+
             (0, 4, 5, 1), (2, 3, 7, 6),  # z- z+  (indices: bit order x,y,z)
             (0, 2, 6, 4), (1, 5, 7, 3)]  # y- y+
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return verts, np.array(tris, np.int32)


def fluid_mesh():
    return box_mesh(size=(2.5, 2.5, 2.5), base_y=-1.25)


def load_obj(path: str):
    """Minimal OBJ reader (v/f lines, fan-triangulated) so user meshes can
    replace the procedural defaults."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[i], idx[i + 1]))
    return np.asarray(verts, np.float64), np.asarray(tris, np.int32)


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def _triangle_geometry(verts, tris):
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    cross = np.cross(b - a, c - a)
    area2 = np.linalg.norm(cross, axis=1)
    normals = cross / np.maximum(area2, 1e-30)[:, None]
    return a, b, c, area2 / 2.0, normals


def points_inside_mesh(points: np.ndarray, verts: np.ndarray,
                       tris: np.ndarray) -> np.ndarray:
    """Parity test: count +x ray/triangle crossings (vectorized
    Moller-Trumbore) — replaces the external VolumeSampling binary's inside
    test for watertight meshes."""
    rng = np.random.default_rng(0)
    d = np.array([1.0, 0.0, 0.0]) + rng.normal(scale=1e-4, size=3)  # dodge edges
    d /= np.linalg.norm(d)
    a, b, c, _, _ = _triangle_geometry(verts, tris)
    e1, e2 = b - a, c - a                                      # [T,3]
    pvec = np.cross(d, e2)                                     # [T,3]
    det = np.einsum("tk,tk->t", e1, pvec)                      # [T]
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    hits = np.zeros(points.shape[0], np.int64)
    for t in np.nonzero(ok)[0]:                                # few triangles
        tvec = points - a[t]
        u = tvec @ pvec[t] * inv[t]
        qvec = np.cross(tvec, e1[t])
        v = qvec @ d * inv[t]
        w = qvec @ e2[t] * inv[t]
        hits += ((u >= 0) & (v >= 0) & (u + v <= 1) & (w > 0)).astype(np.int64)
    return hits % 2 == 1


def sample_volume(verts: np.ndarray, tris: np.ndarray, scale: float = 1.0,
                  radius: float = PARTICLE_RADIUS) -> np.ndarray:
    """Particles on a 2r grid filling the (scaled) mesh interior — the role
    of ``obj_volume_to_particles`` (create_physics_scenes.py:120-132)."""
    verts = verts * scale
    lo, hi = verts.min(0) + radius, verts.max(0) - radius
    axes = [np.arange(lo[k], hi[k] + 1e-9, 2 * radius) for k in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return grid[points_inside_mesh(grid, verts, tris)].astype(np.float32)


def sample_surface(verts: np.ndarray, tris: np.ndarray,
                   radius: float = PARTICLE_RADIUS):
    """(points, inward_normals) covering the mesh surface at SPlisHSPlasH
    boundary density: 1.9 * area / (pi r^2) samples (the open3d Poisson-disk
    count, create_physics_scenes.py:134-145), drawn area-weighted and thinned
    on a hash grid to approximate the Poisson-disk spacing."""
    a, b, c, area, normals = _triangle_geometry(verts, tris)
    target = max(int(1.9 * area.sum() / (np.pi * radius**2)), 1)
    rng = np.random.default_rng(1)
    tri_idx = rng.choice(len(area), size=3 * target, p=area / area.sum())
    r1, r2 = rng.random(3 * target), rng.random(3 * target)
    flip = r1 + r2 > 1
    r1, r2 = np.where(flip, 1 - r1, r1), np.where(flip, 1 - r2, r2)
    pts = a[tri_idx] + r1[:, None] * (b - a)[tri_idx] + r2[:, None] * (c - a)[tri_idx]
    nrm = normals[tri_idx]

    spacing = np.sqrt(area.sum() / target) * 0.72
    cell = np.floor(pts / spacing).astype(np.int64)
    _, keep = np.unique(cell, axis=0, return_index=True)
    keep = np.sort(keep)[:target]
    return pts[keep].astype(np.float32), -nrm[keep].astype(np.float32)


def random_rotation_matrix(rng: np.random.Generator, strength: float = 1.0):
    """Uniform random rotation (Arvo's method, as the reference uses at
    create_physics_scenes.py:93-120)."""
    x = rng.random(3)
    theta, phi, z = x[0] * 2 * np.pi * strength, x[1] * 2 * np.pi, x[2] * strength
    r = np.sqrt(z)
    V = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    Rz = np.array([[ct, st, 0], [-st, ct, 0], [0, 0, 1]])
    return ((np.outer(V, V) - np.eye(3)) @ Rz).astype(np.float32)


# ---------------------------------------------------- placement rasters ---

def rasterize_points(points: np.ndarray, voxel_size: float,
                     particle_radius: float):
    """(grid_origin_index, voxel_size, occupancy) — each particle marks the
    voxels its 8 radius-offset corners land in (reference rasterize_points,
    create_physics_scenes.py:147-180)."""
    if not voxel_size > 2 * particle_radius:
        raise ValueError(f"voxel_size {voxel_size} must exceed 2*{particle_radius}")
    arr_min = np.floor_divide(points.min(0) - particle_radius, voxel_size).astype(np.int32)
    arr_max = np.floor_divide(points.max(0) + particle_radius, voxel_size).astype(np.int32) + 1
    arr = np.zeros(arr_max - arr_min, dtype=bool)
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                off = np.array([sx, sy, sz]) * particle_radius
                idx = np.floor_divide(points + off, voxel_size).astype(np.int32) - arr_min
                arr[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return arr_min, voxel_size, arr


def find_valid_fluid_start_positions(box_raster, fluid_raster,
                                     rng: np.random.Generator) -> np.ndarray:
    """Pick a random placement of the fluid occupancy inside the box's free
    space, preferring the lowest feasible y per column, and carve the chosen
    volume out of the free space (mutates ``box_raster``'s occupancy).
    Same contract as the reference's triple loop
    (create_physics_scenes.py:183-224), computed as one FFT correlation."""
    from scipy.signal import fftconvolve

    b_min, voxel, box = box_raster
    _, _, fluid = fluid_raster
    fs, bs = np.array(fluid.shape), np.array(box.shape)
    if np.any(fs > bs):
        raise ValueError("fluid volume larger than box free space")
    # window at p is feasible iff no fluid voxel overlaps a blocked voxel:
    # correlate blocked-space with the fluid mask and demand an exact zero
    overlap = fftconvolve((~box).astype(np.float32),
                          fluid[::-1, ::-1, ::-1].astype(np.float32), mode="valid")
    feasible = overlap < 0.5
    # keep only the lowest feasible y in each (x, z) column (reference keeps
    # idx where nothing below it in the column is feasible)
    lowest = np.zeros_like(feasible)
    first = np.argmax(feasible, axis=1)
    any_f = feasible.any(axis=1)
    ii, kk = np.nonzero(any_f)
    lowest[ii, first[ii, kk], kk] = True
    valid = np.stack(np.nonzero(lowest), axis=-1)
    if valid.shape[0] == 0:
        raise RuntimeError("no valid fluid start position")
    pos = valid[rng.integers(valid.shape[0])]
    sl = tuple(slice(p, p + s) for p, s in zip(pos, fs))
    box[sl] &= ~fluid
    return (pos + b_min).astype(np.float32) * voxel


# ------------------------------------------------------- scene synthesis ---

def synthesize_scene(output_dir: str, seed: int, *,
                     radius: float = PARTICLE_RADIUS,
                     num_objects: int = 0,
                     uniform_viscosity: bool = False,
                     log10_uniform_viscosity: bool = False,
                     default_viscosity: bool = False,
                     default_density: bool = False,
                     const_fluid_particles: int = 0,
                     max_fluid_particles: int = 0,
                     min_fluid_particles: int = 100_000,
                     box_size=(5.0, 10.0, 5.0),
                     fluid_size=(2.5, 2.5, 2.5)) -> str:
    """Create ``sim_{seed:04d}/`` with scene.json + box/fluid bgeo files —
    the full behavior of the reference's create_fluid_data
    (create_physics_scenes.py:233-437): 1-3 randomly rotated/scaled fluid
    volumes placed without overlap in the eroded free space of the box,
    exponential/uniform/log10 viscosity, density U(500, 2000), random start
    velocities, trimming to an exact particle budget when requested."""
    from scipy.ndimage import binary_erosion

    rng = np.random.default_rng(seed)
    n_obj = int(num_objects) if num_objects > 0 else int(rng.choice([1, 2, 3]))

    box_v, box_t = box_mesh(box_size)
    fl_v, fl_t = box_mesh(fluid_size, base_y=-fluid_size[1] / 2)
    bb_pts, bb_nrm = sample_surface(box_v, box_t, radius)
    bb_vol = sample_volume(box_v, box_t, radius=radius)

    b_min, voxel, occ = rasterize_points(
        np.concatenate([bb_vol, bb_pts], 0), 2.01 * radius, radius)
    occ = binary_erosion(occ, structure=np.ones((3, 3, 3)), iterations=3)
    box_raster = (b_min, voxel, occ)

    objects = []
    for _ in range(n_obj):
        for _attempt in range(10):
            try:
                fluid = sample_volume(fl_v, fl_t, scale=rng.uniform(0.90, 1.00),
                                      radius=radius)
                fluid = fluid @ random_rotation_matrix(rng)
                fl_raster = rasterize_points(fluid, 2.01 * radius, radius)
                sel = find_valid_fluid_start_positions(box_raster, fl_raster, rng)
                fluid = fluid + (sel - fl_raster[0] * fl_raster[1])

                vel = np.zeros_like(fluid)
                vel[:, 0] = rng.uniform(-MAX_FLUID_START_VELOCITY_XZ,
                                        MAX_FLUID_START_VELOCITY_XZ)
                vel[:, 2] = rng.uniform(-MAX_FLUID_START_VELOCITY_XZ,
                                        MAX_FLUID_START_VELOCITY_XZ)
                vel[:, 1] = rng.uniform(-MAX_FLUID_START_VELOCITY_Y,
                                        MAX_FLUID_START_VELOCITY_Y)

                density = 1000.0 if default_density else rng.uniform(500, 2000)
                if default_viscosity:
                    viscosity = 0.01
                elif uniform_viscosity:
                    viscosity = rng.uniform(0.01, 0.3)
                elif log10_uniform_viscosity:
                    viscosity = 0.01 * 10 ** rng.uniform(0.0, 1.5)
                else:
                    viscosity = rng.exponential(scale=1 / 20) + 0.01
                objects.append({"positions": fluid, "velocities": vel,
                                "density": float(density),
                                "viscosity": float(viscosity)})
                break
            except (RuntimeError, ValueError):
                continue

    def total():
        return sum(o["positions"].shape[0] for o in objects)

    if const_fluid_particles:
        if const_fluid_particles > total():
            raise RuntimeError(f"scene has {total()} < {const_fluid_particles} particles")
        while total() != const_fluid_particles:
            diff = total() - const_fluid_particles
            smallest = min(range(len(objects)),
                           key=lambda i: objects[i]["positions"].shape[0])
            if objects[smallest]["positions"].shape[0] < diff:
                del objects[smallest]
            else:
                for k in ("positions", "velocities"):
                    objects[smallest][k] = objects[smallest][k][:-diff]
    if max_fluid_particles and total() > max_fluid_particles:
        raise RuntimeError(f"scene has {total()} > {max_fluid_particles} particles")
    if total() < min_fluid_particles:
        raise RuntimeError(f"scene has only {total()} fluid particles")

    sim_dir = os.path.join(output_dir, f"sim_{seed:04d}")
    os.makedirs(sim_dir, exist_ok=False)

    scene = {"Configuration": dict(DEFAULT_CONFIGURATION,
                                   particleRadius=radius),
             "Simulation": dict(DEFAULT_SIMULATION),
             "RigidBodies": [], "FluidModels": []}

    write_bgeo_from_numpy(os.path.join(sim_dir, "box.bgeo"), bb_pts, bb_nrm)
    write_obj(os.path.join(sim_dir, "box.obj"), box_v, box_t)
    rigid = copy.deepcopy(DEFAULT_RIGIDBODY)
    rigid.update(id=1, geometryFile="box.obj", resolutionSDF=[64, 64, 64])
    scene["RigidBodies"].append(rigid)

    for i, obj in enumerate(objects):
        fid = f"fluid{i}"
        scene[fid] = dict(DEFAULT_FLUID, viscosity=obj["viscosity"],
                          density0=obj["density"])
        write_bgeo_from_numpy(os.path.join(sim_dir, f"{fid}.bgeo"),
                              obj["positions"], obj["velocities"])
        scene["FluidModels"].append({"translation": [0.0, 0.0, 0.0],
                                     "scale": [1.0, 1.0, 1.0], "id": fid,
                                     "particleFile": f"{fid}.bgeo"})

    with open(os.path.join(sim_dir, "scene.json"), "w") as f:
        json.dump(scene, f, indent=4)
    return sim_dir


def run_simulator(simulator_bin: str, scene_dir: str) -> int:
    """Drive an external SPlisHSPlasH DynamicBoundarySimulator on a scene
    directory (reference run_simulator, create_physics_scenes.py:225-231);
    frame exports land in ``<scene_dir>/partio/``."""
    scene = os.path.abspath(os.path.join(scene_dir, "scene.json"))
    proc = subprocess.run([simulator_bin, "--no-cache", "--no-gui",
                           "--no-initial-pause", "--output-dir",
                           os.path.abspath(scene_dir), scene])
    return proc.returncode


# --------------------------------------------------------- record packing ---

def pack_scene_records(scene_dir: str, scene_id: str, out_prefix: str,
                       splits: int = 16,
                       radius: float = PARTICLE_RADIUS) -> List[str]:
    """Partio frame exports -> ``<out_prefix>_YY.msgpack.zst`` shards in the
    training format (reference create_scene_files,
    create_physics_records.py:14-97): frames split evenly over ``splits``
    files; the box surface only on each shard's first frame; per-particle
    mass = density0 * (2r)^3; particles id-sorted for cross-frame stability."""
    import msgpack
    import zstandard as zstd

    with open(os.path.join(scene_dir, "scene.json")) as f:
        scene = json.load(f)
    box, box_normals = numpy_from_bgeo(os.path.join(scene_dir, "box.bgeo"))
    frames_by_fluid = list_partio_frames(os.path.join(scene_dir, "partio"))
    if not frames_by_fluid:
        raise FileNotFoundError(f"no partio exports under {scene_dir}/partio "
                                "(run the simulator first)")
    counts = {len(v) for v in frames_by_fluid.values()}
    if len(counts) != 1:
        raise ValueError(f"fluids exported different frame counts: {counts}")

    def encode_np(o):
        if isinstance(o, np.ndarray):
            return {b"nd": True, b"type": o.dtype.str.encode(),
                    b"shape": list(o.shape), b"data": o.tobytes()}
        return o

    n_frames = counts.pop()
    sublists = np.array_split(np.arange(n_frames), splits)
    cctx = zstd.ZstdCompressor(level=22)
    written = []
    for s, sub in enumerate(sublists):
        out_path = f"{out_prefix}_{s:02d}.msgpack.zst"
        written.append(out_path)
        if os.path.isfile(out_path):
            continue
        data = []
        for frame_i in sub:
            feat: Dict = {}
            if frame_i == sub[0]:
                feat["box"] = box.astype(np.float32)
                feat["box_normals"] = box_normals.astype(np.float32)
            feat["frame_id"] = int(frame_i)
            feat["scene_id"] = scene_id
            pos, vel, mass, visc = [], [], [], []
            for fid, paths in frames_by_fluid.items():
                p, v = numpy_from_bgeo(paths[frame_i])
                pos.append(p)
                vel.append(v if v is not None else np.zeros_like(p))
                visc.append(np.full(p.shape[0], scene[fid]["viscosity"], np.float32))
                mass.append(np.full(p.shape[0], scene[fid]["density0"], np.float32))
            feat["pos"] = np.concatenate(pos, 0).astype(np.float32)
            feat["vel"] = np.concatenate(vel, 0).astype(np.float32)
            feat["m"] = (np.concatenate(mass, 0) * (2 * radius) ** 3).astype(np.float32)
            feat["viscosity"] = np.concatenate(visc, 0).astype(np.float32)
            data.append(feat)
        with open(out_path, "wb") as f:
            f.write(cctx.compress(msgpack.packb(data, default=encode_np)))
    return written


# ----------------------------------------------------------- command line ---

def _generate(args) -> int:
    """``generate``: one scene directory, then the simulator when given
    (``scripts/generate_fluid_scenes.py``)."""
    os.makedirs(args.output, exist_ok=True)
    sim_dir = synthesize_scene(
        args.output, args.seed, radius=args.radius,
        num_objects=args.num_objects,
        uniform_viscosity=args.uniform_viscosity,
        log10_uniform_viscosity=args.log10_uniform_viscosity,
        default_viscosity=args.default_viscosity,
        default_density=args.default_density,
        const_fluid_particles=args.const_fluid_particles,
        max_fluid_particles=args.max_fluid_particles,
        min_fluid_particles=args.min_fluid_particles)
    print(f"scene written: {sim_dir}")  # noqa: obs-print

    if args.simulator_bin:
        rc = run_simulator(args.simulator_bin, sim_dir)
        print(f"simulator exit code {rc}; exports under {sim_dir}/partio/")  # noqa: obs-print
        return rc
    print("no --simulator-bin: scene-only mode (run SPlisHSPlasH elsewhere, "  # noqa: obs-print
          "then the pack subcommand)")
    return 0


def _pack(args) -> int:
    """``pack``: every ``sim_*`` directory's exports -> its shards
    (``scripts/pack_fluid_records.py``)."""
    os.makedirs(args.output, exist_ok=True)
    scene_dirs = sorted(glob.glob(os.path.join(args.input, "sim_*")))
    if not scene_dirs:
        print(f"no sim_* directories under {args.input}", file=sys.stderr)  # noqa: obs-print
        return 1
    for scene_dir in scene_dirs:
        name = os.path.basename(scene_dir)
        try:
            shards = pack_scene_records(scene_dir, name,
                                        os.path.join(args.output, name),
                                        splits=args.splits, radius=args.radius)
        except FileNotFoundError as e:
            print(f"skipping {name}: {e}", file=sys.stderr)  # noqa: obs-print
            continue
        print(f"{name}: {len(shards)} shards")  # noqa: obs-print
    return 0


def main(argv=None) -> int:
    """``generate`` (Fluid113K generation stage 1, the reference's
    create_physics_scenes.py CLI) or ``pack`` (stage 2,
    create_physics_records.py), with the flags of the JAX package's two
    scripts."""
    ap = argparse.ArgumentParser(
        description="Fluid113K scene synthesis and record packing")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("generate",
                       help="generate one random SPlisHSPlasH fluid scene")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--seed", type=int, required=True, help="scene RNG seed (= sim id)")
    p.add_argument("--uniform-viscosity", action="store_true")
    p.add_argument("--log10-uniform-viscosity", action="store_true")
    p.add_argument("--default-viscosity", action="store_true")
    p.add_argument("--default-density", action="store_true")
    p.add_argument("--num-objects", type=int, default=0,
                   help="fluid object count; 0 = random 1-3")
    p.add_argument("--const-fluid-particles", type=int, default=0)
    p.add_argument("--max-fluid-particles", type=int, default=0)
    p.add_argument("--min-fluid-particles", type=int, default=100_000,
                   help="reject scenes below this budget (reference asserts >100k)")
    p.add_argument("--radius", type=float, default=0.025)
    p.add_argument("--simulator-bin", default=os.environ.get("SIMULATOR_BIN", ""),
                   help="SPlisHSPlasH DynamicBoundarySimulator path; scene-only if unset")
    p.set_defaults(func=_generate)

    p = sub.add_parser("pack", help="pack simulated scenes into training shards")
    p.add_argument("--input", required=True, help="directory of sim_* scene dirs")
    p.add_argument("--output", required=True, help="shard output directory")
    p.add_argument("--splits", type=int, default=16,
                   help="shards per simulation (default 16 = fluid113k.SHARDS_PER_SIM)")
    p.add_argument("--radius", type=float, default=0.025)
    p.set_defaults(func=_pack)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
