"""A numpy reader and writer for the HDF5 files of the Water-3D layout (the
port does not need ``h5py``).

The Water-3D raw files (the reference's converted DeepMind layout) are one
group per trajectory holding ``particle_type`` [N] and ``position``
[T, N, 3]. :class:`H5File` reads such a file, memory-mapped, one dataset at
a time, as the HDF5 library writes it by default (``h5py.File(path, 'w')``): superblock version 0, version-1
object headers (with continuation blocks), groups as symbol tables (a
version-1 B-tree of symbol-table nodes over a local heap), and datasets of
little- or big-endian integers and IEEE floats stored compact, contiguous,
or chunked through a version-1 B-tree with the deflate and shuffle filters
(``compression='gzip'``, as ``scripts/water3d_tfrecord_to_h5.py`` writes
``position``). Anything else raises ``NotImplementedError`` naming the
feature. :func:`write_groups` writes the same layout (contiguous, no
filters), which ``h5py`` reads.

Field layouts follow the HDF5 file format specification, version 2.0
(sections II.A superblock, III.A.1 version-1 B-trees, III.B group symbol
table nodes, III.D local heaps, IV.A.1 version-1 object headers, IV.A.2
header messages).
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Dict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS = 0x1, 0x3, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11


class H5File:
    """An HDF5 file opened read-only and memory-mapped: ``keys()`` names the
    root's groups, ``read(group, name)`` reads one dataset (only that
    dataset's bytes are touched). Use it as a context manager."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            self._superblock()
            self._root = self.group(self.root)
        except BaseException:
            self.buf.close()
            raise

    def _superblock(self):
        path = self.path
        if self.buf[:8] != SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file (no signature at 0)")
        version = self.buf[8]
        if version != 0:
            raise NotImplementedError(
                f"{path}: HDF5 superblock version {version}; this reader "
                "takes version 0 (the library's default)")
        if (self.buf[13], self.buf[14]) != (8, 8):
            raise NotImplementedError(
                f"{path}: {self.buf[13]}-byte offsets, {self.buf[14]}-byte "
                "lengths (this reader takes 8 and 8)")
        # the root group's symbol-table entry follows the 4 addresses
        self.root = self.entry(24 + 4 * 8)[1]

    def close(self) -> None:
        self.buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def keys(self):
        return list(self._root)

    def read(self, group: str, name: str) -> np.ndarray:
        """Dataset ``group/name`` in native byte order."""
        members = self.group(self._root[group])
        if name not in members:
            raise KeyError(f"{self.path}: no dataset {group}/{name}")
        return self.dataset(members[name])

    def u(self, at: int, n: int) -> int:
        return int.from_bytes(self.buf[at:at + n], "little")

    def entry(self, at: int):
        """A symbol-table entry: (link-name heap offset, object header
        address)."""
        return self.u(at, 8), self.u(at + 8, 8)

    def messages(self, at: int):
        """(type, body offset, body size) of a version-1 object header's
        messages, continuation blocks included."""
        if self.buf[at] != 1:
            raise NotImplementedError(
                f"{self.path}: object header version {self.buf[at]} at "
                f"{at:#x} (this reader takes version 1)")
        n = self.u(at + 2, 2)
        blocks = [(at + 16, self.u(at + 8, 4))]
        out = []
        while blocks and len(out) < n:
            start, size = blocks.pop(0)
            p = start
            while p + 8 <= start + size and len(out) < n:
                mtype, msize = self.u(p, 2), self.u(p + 2, 2)
                if mtype == _CONTINUATION:
                    blocks.append((self.u(p + 8, 8), self.u(p + 16, 8)))
                out.append((mtype, p + 8, msize))
                p += 8 + msize
        return out

    def group(self, header: int) -> Dict[str, int]:
        """A symbol-table group's {name: object header address}."""
        table = [m for m in self.messages(header) if m[0] == _SYMBOL_TABLE]
        if not table:
            raise NotImplementedError(
                f"{self.path}: a group at {header:#x} without a symbol table "
                "(a link-message group of the newer file format)")
        body = table[0][1]
        btree, heap = self.u(body, 8), self.u(body + 8, 8)
        if self.buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap:#x}")
        data = self.u(heap + 24, 8)
        out = {}

        def walk(node):
            if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 0:
                raise ValueError(f"{self.path}: no group B-tree at {node:#x}")
            level, used = self.buf[node + 5], self.u(node + 6, 2)
            for i in range(used):
                child = self.u(node + 24 + 8 + i * 16, 8)
                if level:
                    walk(child)
                    continue
                if self.buf[child:child + 4] != b"SNOD":
                    raise ValueError(f"{self.path}: no symbol-table node at "
                                     f"{child:#x}")
                for j in range(self.u(child + 6, 2)):
                    name_at, obj = self.entry(child + 8 + 40 * j)
                    end = self.buf.find(b"\0", data + name_at)
                    out[self.buf[data + name_at:end].decode("utf-8")] = obj

        walk(btree)
        return out

    def dtype(self, body: int) -> np.dtype:
        cls, bits = self.buf[body] & 0x0F, self.buf[body + 1]
        size = self.u(body + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            kind = "i" if bits & 0x08 else "u"
        elif cls == 1 and size in (4, 8):
            kind = "f"
        else:
            raise NotImplementedError(
                f"{self.path}: datatype class {cls} of {size} bytes (this "
                "reader takes integers and IEEE floats)")
        return np.dtype(f"{order}{kind}{size}")

    def shape(self, body: int):
        version, rank = self.buf[body], self.buf[body + 1]
        first = body + (8 if version == 1 else 4)
        return tuple(self.u(first + 8 * i, 8) for i in range(rank))

    def dataset(self, header: int) -> np.ndarray:
        msgs = {t: (b, s) for t, b, s in self.messages(header)}
        if _DATASPACE not in msgs or _DATATYPE not in msgs \
                or _LAYOUT not in msgs:
            raise ValueError(f"{self.path}: object at {header:#x} is not a "
                             "dataset")
        shape = self.shape(msgs[_DATASPACE][0])
        dt = self.dtype(msgs[_DATATYPE][0])
        body = msgs[_LAYOUT][0]
        if self.buf[body] != 3:
            raise NotImplementedError(
                f"{self.path}: data layout message version {self.buf[body]}")
        cls = self.buf[body + 1]
        count = int(np.prod(shape, dtype=np.int64))
        if cls == 0:       # compact: the data in the message
            raw = self.buf[body + 4:body + 4 + self.u(body + 2, 2)]
            out = np.frombuffer(raw, dt, count)
        elif cls == 1:     # contiguous
            addr = self.u(body + 2, 8)
            out = (np.zeros(count, dt) if addr == UNDEF
                   else np.frombuffer(self.buf, dt, count, addr))
        elif cls == 2:
            out = self.chunked(body, shape, dt, msgs.get(_FILTERS))
        else:
            raise NotImplementedError(f"{self.path}: data layout class {cls}")
        return out.reshape(shape).astype(dt.newbyteorder("="))

    def filters(self, msg):
        """The filter pipeline's ids, in the order they were applied."""
        if msg is None:
            return []
        body = msg[0]
        version, n = self.buf[body], self.buf[body + 1]
        p = body + (8 if version == 1 else 2)
        ids = []
        for _ in range(n):
            fid = self.u(p, 2)
            if version == 1 or fid >= 256:   # a name length field
                name_len, q = self.u(p + 2, 2), p + 4
            else:
                name_len, q = 0, p + 2
            n_vals = self.u(q + 2, 2)        # after the flags
            p = q + 4 + name_len + 4 * n_vals
            if version == 1 and n_vals % 2:
                p += 4                       # values padded to 8 bytes
            ids.append(fid)
        for fid in ids:
            if fid not in (1, 2):
                raise NotImplementedError(
                    f"{self.path}: filter {fid} (this reader takes deflate "
                    "and shuffle)")
        return ids

    def chunked(self, body, shape, dt, filters_msg):
        rank = self.buf[body + 2] - 1        # the last dim is the element
        btree = self.u(body + 3, 8)
        chunk = tuple(self.u(body + 11 + 4 * i, 4) for i in range(rank))
        ids = self.filters(filters_msg)
        out = np.zeros(shape, dt)
        key = 8 + 8 * (rank + 1)

        def walk(node):
            if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 1:
                raise ValueError(f"{self.path}: no chunk B-tree at {node:#x}")
            level, used = self.buf[node + 5], self.u(node + 6, 2)
            for i in range(used):
                k = node + 24 + i * (key + 8)
                child = self.u(k + key, 8)
                if level:
                    walk(child)
                    continue
                size, mask = self.u(k, 4), self.u(k + 4, 4)
                start = [self.u(k + 8 + 8 * d, 8) for d in range(rank)]
                raw = self.buf[child:child + size]
                for j, fid in reversed(list(enumerate(ids))):
                    if mask & (1 << j):
                        continue
                    if fid == 1:
                        raw = zlib.decompress(raw)
                    else:            # shuffle: bytes grouped by position
                        raw = np.frombuffer(raw, np.uint8).reshape(
                            dt.itemsize, -1).T.tobytes()
                block = np.frombuffer(raw, dt).reshape(chunk)
                region = tuple(slice(s, min(s + c, n))
                               for s, c, n in zip(start, chunk, shape))
                out[region] = block[tuple(slice(0, r.stop - r.start)
                                          for r in region)]

        walk(btree)
        return out


def read_groups(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Every group under the root of ``path`` as {group name: {dataset name:
    array}} (native byte order)."""
    with H5File(path) as f:
        return {g: {k: f.dataset(v)
                    for k, v in f.group(f._root[g]).items()}
                for g in f.keys()}


# ------------------------------------------------------------------ writer

_K_LEAF, _K_NODE = 4, 16        # the library's default group B-tree ranks


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _header(messages) -> bytes:
    data = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data)) + data


def _datatype(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    if dt.kind == "f" and dt.itemsize in (4, 8):
        prec = dt.itemsize * 8
        exp_size, mant = (8, 23) if prec == 32 else (11, 52)
        bits = bytes([0x20, prec - 1, 0])
        props = struct.pack("<HHBBBBI", 0, prec, mant, exp_size, 0, mant,
                            (1 << (exp_size - 1)) - 1)
        return bytes([0x11]) + bits + struct.pack("<I", dt.itemsize) + props
    if dt.kind in "iu":
        bits = bytes([0x08 if dt.kind == "i" else 0, 0, 0])
        props = struct.pack("<HH", 0, dt.itemsize * 8)
        return bytes([0x10]) + bits + struct.pack("<I", dt.itemsize) + props
    raise NotImplementedError(f"write_groups: dtype {dt}")


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def put(self, b: bytes) -> int:
        at = len(self.out)
        self.out += _pad8(b)
        return at

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        data = self.put(arr.tobytes())
        space = struct.pack("<BBB5x", 1, arr.ndim, 0) + b"".join(
            struct.pack("<Q", n) for n in arr.shape)
        layout = struct.pack("<BBQQ", 3, 1, data, arr.nbytes)
        return self.put(_header([_message(_DATASPACE, space),
                                 _message(_DATATYPE, _datatype(arr.dtype)),
                                 _message(_LAYOUT, layout)]))

    def group(self, children: Dict[str, tuple]):
        """children: {name: (object header address, cache scratch or None)}.
        Returns (object header address, B-tree address, heap address)."""
        names = sorted(children, key=lambda s: s.encode("utf-8"))
        per = 2 * _K_LEAF
        if len(names) > per * 2 * _K_NODE:
            raise NotImplementedError(
                f"write_groups: {len(names)} members in one group")
        heap_data, offsets = bytearray(b"\0" * 8), {}
        for n in names:
            offsets[n] = len(heap_data)
            heap_data += _pad8(n.encode("utf-8") + b"\0")
        heap_data = bytes(heap_data)
        data_at = self.put(heap_data)
        heap = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                              1, data_at))
        snods = []
        for s0 in range(0, max(len(names), 1), per):
            chunk = names[s0:s0 + per]
            entries = b""
            for n in chunk:
                obj, scratch = children[n]
                entries += struct.pack("<QQII", offsets[n], obj,
                                       0 if scratch is None else 1, 0)
                entries += (b"\0" * 16 if scratch is None
                            else struct.pack("<QQ", *scratch))
            entries += b"\0" * 40 * (per - len(chunk))
            snods.append((self.put(b"SNOD" + struct.pack("<BxH", 1,
                                                         len(chunk))
                                   + entries),
                          offsets[chunk[-1]] if chunk else 0))
        keys = struct.pack("<Q", 0)
        body = b""
        for addr, last in snods:
            body += struct.pack("<QQ", addr, last)
        body = keys + body
        body += b"\0" * ((2 * _K_NODE + 1) * 8 + 2 * _K_NODE * 8 - len(body))
        btree = self.put(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods),
                                               UNDEF, UNDEF) + body)
        header = self.put(_header([_message(_SYMBOL_TABLE, struct.pack(
            "<QQ", btree, heap))]))
        return header, btree, heap


def write_groups(path: str, groups: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write {group name: {dataset name: array}} under the root of a new
    HDF5 file at ``path`` (superblock version 0, symbol-table groups,
    contiguous little-endian datasets)."""
    w = _Writer()
    w.put(b"\0" * 96)                    # the superblock, written last
    members = {}
    for name, arrays in groups.items():
        kids = {k: (w.dataset(np.asarray(a)), None)
                for k, a in arrays.items()}
        header, btree, heap = w.group(kids)
        members[name] = (header, (btree, heap))
    root, btree, heap = w.group(members)
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                 _K_LEAF, _K_NODE, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, len(w.out), UNDEF)
    sb += struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree,
                                                            heap)
    w.out[:len(sb)] = sb
    with open(path + ".tmp", "wb") as f:
        f.write(bytes(w.out))
    os.replace(path + ".tmp", path)
