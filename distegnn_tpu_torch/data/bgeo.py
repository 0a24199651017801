"""Pure-Python codec for the classic Houdini BGEO v5 particle format as
written/read by Disney's partio library (port of
``distegnn_tpu/data/bgeo.py``: the same numpy code, so the files it writes
are the JAX package's byte for byte).

The reference pipeline moves particles between its scene generator and
SPlisHSPlasH as ``.bgeo`` files through the partio Python module
(dataset_generation/Fluid113K/physics_data_helper.py:28-82); SPlisHSPlasH
itself reads fluid ``particleFile``s and writes per-frame ``ParticleData``
exports with partio. partio is not a dependency, so this module implements
the same on-disk layout directly:

  header (big-endian): int32 magic "Bgeo", char 'V', int32 version=5,
    int32 nPoints nPrims nPointGroups nPrimGroups,
    int32 nPointAttrib nVertexAttrib nPrimAttrib nDetailAttrib
  per point attribute (position is implicit, never listed):
    uint16 name-length + name bytes, int32 size, int32 houdini-type
    (0=float, 1=int, 5=vector; 4=indexed-string with its string table),
    then ``size`` int32 default-value slots
  per point: 4 float32 (x, y, z, w=1) then each attribute's payload
  trailer: bytes 0x00 0xff (no primitives)

Files gzipped by partio (``.bgeo.gz`` or transparently compressed) are
detected by magic and decompressed on read.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = 0x4267656F  # "Bgeo"
_HTYPE_FLOAT, _HTYPE_INT, _HTYPE_STRING, _HTYPE_VECTOR = 0, 1, 4, 5


def write_bgeo(path: str, position: np.ndarray,
               attributes: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write particles. ``attributes`` maps name -> [N] or [N, k] arrays;
    float arrays with k==3 are declared VECTOR (partio's convention for
    velocity), other float widths FLOAT, integer arrays INT."""
    position = np.asarray(position, np.float32)
    if position.ndim != 2 or position.shape[1] != 3:
        raise ValueError(f"position must be [N, 3], got {position.shape}")
    n = position.shape[0]
    attributes = dict(attributes or {})

    spec: List[Tuple[str, np.ndarray, int]] = []
    for name, arr in attributes.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.shape[0] != n:
            raise ValueError(f"attribute {name}: {arr.shape[0]} rows != {n} points")
        if np.issubdtype(arr.dtype, np.integer):
            spec.append((name, arr.astype(">i4"), _HTYPE_INT))
        else:
            htype = _HTYPE_VECTOR if arr.shape[1] == 3 else _HTYPE_FLOAT
            spec.append((name, arr.astype(">f4"), htype))

    out = bytearray()
    out += struct.pack(">i", _MAGIC)
    out += b"V"
    out += struct.pack(">i", 5)
    out += struct.pack(">4i", n, 0, 0, 0)
    out += struct.pack(">4i", len(spec), 0, 0, 0)
    for name, arr, htype in spec:
        nb = name.encode()
        out += struct.pack(">H", len(nb)) + nb
        out += struct.pack(">2i", arr.shape[1], htype)
        out += struct.pack(f">{arr.shape[1]}i", *([0] * arr.shape[1]))

    # interleave: position as homogeneous 4-float + attribute payloads
    row = np.empty((n, 4 + sum(a.shape[1] for _, a, _ in spec)), dtype=">f4")
    row[:, :3] = position
    row[:, 3] = 1.0
    col = 4
    for _, arr, htype in spec:
        k = arr.shape[1]
        # int payloads are stored bit-exact in the f4-typed staging buffer
        row[:, col:col + k] = arr.view(">f4") if htype == _HTYPE_INT else arr
        col += k
    out += row.tobytes()
    out += b"\x00\xff"

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(out))


def read_bgeo(path: str) -> Dict[str, np.ndarray]:
    """Read particles -> {'position': [N,3], <attr>: [N,k]...} (k==1 squeezed)."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        data = f.read()
    if head == b"\x1f\x8b":
        data = gzip.decompress(data)

    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return vals

    (magic,) = take(">i")
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a BGEO file (magic {magic:#x})")
    (vchar,) = take("c")
    (version,) = take(">i")
    if vchar != b"V" or version != 5:
        raise ValueError(f"{path}: unsupported BGEO version {vchar!r}{version}")
    n, _nprims, _npg, _nprg = take(">4i")
    nattr, _nva, _npa, _nda = take(">4i")

    names, sizes, htypes = [], [], []
    for _ in range(nattr):
        (ln,) = take(">H")
        names.append(data[off:off + ln].decode())
        off += ln
        size, htype = take(">2i")
        if htype in (_HTYPE_FLOAT, _HTYPE_INT, _HTYPE_VECTOR):
            take(f">{size}i")  # defaults
        elif htype == _HTYPE_STRING:
            (nidx,) = take(">i")
            for _ in range(nidx):
                (sl,) = take(">H")
                off += sl
        else:
            raise ValueError(f"{path}: unsupported attribute type {htype}")
        sizes.append(size)
        htypes.append(htype)

    width = 4 + sum(sizes)
    raw = np.frombuffer(data, dtype=">f4", count=n * width, offset=off)
    raw = raw.reshape(n, width)
    out: Dict[str, np.ndarray] = {"position": raw[:, :3].astype(np.float32)}
    col = 4
    for name, size, htype in zip(names, sizes, htypes):
        block = raw[:, col:col + size]
        if htype == _HTYPE_INT or htype == _HTYPE_STRING:
            arr = block.view(">i4").astype(np.int64)
        else:
            arr = block.astype(np.float32)
        out[name] = arr[:, 0] if size == 1 else arr
        col += size
    return out


def numpy_from_bgeo(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(position, velocity-or-None), sorted by the 'id'/'trackid' attribute
    when present — the contract of the reference's partio-backed
    numpy_from_bgeo (physics_data_helper.py:28-60), which SPlisHSPlasH frame
    exports need because particle order is not stable across frames."""
    d = read_bgeo(path)
    pos = d["position"]
    vel = d.get("velocity") if d.get("velocity") is not None else d.get("v")
    ids = d.get("trackid")
    if ids is None:
        ids = d.get("id")
    if ids is not None:
        order = np.argsort(np.asarray(ids).reshape(-1), kind="stable")
        pos = pos[order]
        vel = vel[order] if vel is not None else None
    return pos, vel


def write_bgeo_from_numpy(path: str, pos: np.ndarray, vel: np.ndarray) -> None:
    """Positions + a 3-vector attribute named 'velocity' (the generator also
    stores surface normals under this name for box.bgeo, mirroring
    create_physics_scenes.py:400-401)."""
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    if pos.shape != vel.shape or pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"invalid shapes {pos.shape} / {vel.shape}")
    write_bgeo(path, pos, {"velocity": vel})


def list_partio_frames(partio_dir: str) -> Dict[str, List[str]]:
    """SPlisHSPlasH export dir -> {fluid_id: frame-ordered bgeo paths}
    (reference get_fluid_ids_from_partio_dir / get_fluid_bgeo_files,
    physics_data_helper.py:8-25). Files are named
    ``ParticleData_<fluid>_<frame>.bgeo``."""
    import re

    pat = re.compile(r"ParticleData_(.+)_(\d+)\.bgeo(\.gz)?$")
    by_id: Dict[str, List[Tuple[int, str]]] = {}
    for fn in os.listdir(partio_dir):
        m = pat.match(fn)
        if m:
            by_id.setdefault(m.group(1), []).append(
                (int(m.group(2)), os.path.join(partio_dir, fn)))
    return {k: [p for _, p in sorted(v)] for k, v in sorted(by_id.items())}
