"""Mitsuba .serialized mesh reader and writer (port of
vimg_tpu.scene.serialized; pure Python, zlib, numpy).

Format per reference src/scene_loading/serialized_file.{h,cpp}: uint16
magic + uint16 version header, then a zlib DEFLATE stream per shape; the
file ends with an offset table (+uint32 count) — uint64 offsets in v4,
uint32 in v3. Flags word selects normals/uvs/double precision.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from vimg_tpu_torch.core.math import xform_dir, xform_point

HAS_NORMALS = 0x0001
HAS_TEXCOORDS = 0x0002
HAS_COLORS = 0x0008
DOUBLE_PRECISION = 0x2000


class _ZReader:
    """Incremental zlib inflater over a byte buffer."""

    def __init__(self, data, offset):
        self.de = zlib.decompressobj()
        self.data = data
        self.pos = offset
        self.buf = b""

    def read(self, n):
        while len(self.buf) < n:
            chunk = self.data[self.pos:self.pos + 32768]
            if not chunk:
                raise EOFError("serialized stream truncated")
            self.pos += len(chunk)
            self.buf += self.de.decompress(chunk)
        out = self.buf[:n]
        self.buf = self.buf[n:]
        return out


def read_serialized(path, shape_index=0, to_world=None):
    """Returns (vertices (V,3) f32, indices (T,3) i64, normals or None,
    uvs or None), with to_world applied to vertices/normals."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)

    offset = 4
    if shape_index > 0:
        count = struct.unpack_from("<I", data, len(data) - 4)[0]
        if version == 4:
            off_pos = len(data) - 8 * (count - shape_index) - 4
            offset = struct.unpack_from("<Q", data, off_pos)[0] + 4
        else:
            off_pos = len(data) - 4 * (count - shape_index + 1)
            offset = struct.unpack_from("<I", data, off_pos)[0] + 4

    z = _ZReader(data, offset)
    flags = struct.unpack("<I", z.read(4))[0]
    if version == 4:
        # null-terminated name
        name = b""
        while True:
            c = z.read(1)
            if c == b"\x00":
                break
            name += c
    vcount = struct.unpack("<Q", z.read(8))[0]
    tcount = struct.unpack("<Q", z.read(8))[0]

    ftype = np.float64 if flags & DOUBLE_PRECISION else np.float32
    fsize = 8 if flags & DOUBLE_PRECISION else 4

    verts = np.frombuffer(z.read(vcount * 3 * fsize), ftype).reshape(-1, 3)
    normals = None
    if flags & HAS_NORMALS:
        normals = np.frombuffer(z.read(vcount * 3 * fsize),
                                ftype).reshape(-1, 3)
    uvs = None
    if flags & HAS_TEXCOORDS:
        uvs = np.frombuffer(z.read(vcount * 2 * fsize), ftype).reshape(-1, 2)
    if flags & HAS_COLORS:
        z.read(vcount * 3 * fsize)
    idx = np.frombuffer(z.read(tcount * 3 * 4), np.uint32).reshape(-1, 3)

    verts = np.asarray(verts, np.float32)
    if to_world is not None:
        m = np.asarray(to_world, np.float32)
        verts = xform_point(m, verts)
        if normals is not None:
            n_x = np.linalg.inv(m[:3, :3]).T
            normals = xform_dir(n_x, np.asarray(normals, np.float32))
            ln = np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                            1e-12)
            normals = normals / ln
    return (verts, idx.astype(np.int64),
            None if normals is None else np.asarray(normals, np.float32),
            None if uvs is None else np.asarray(uvs, np.float32))


def write_serialized(path, verts, idx, normals=None, uvs=None):
    """Writer (v3 single-precision) — used by tests and as a utility."""
    flags = 0x1000
    if normals is not None:
        flags |= HAS_NORMALS
    if uvs is not None:
        flags |= HAS_TEXCOORDS
    payload = struct.pack("<I", flags)
    payload += struct.pack("<QQ", len(verts), len(idx))
    payload += np.asarray(verts, np.float32).tobytes()
    if normals is not None:
        payload += np.asarray(normals, np.float32).tobytes()
    if uvs is not None:
        payload += np.asarray(uvs, np.float32).tobytes()
    payload += np.asarray(idx, np.uint32).tobytes()
    comp = zlib.compress(payload)
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", 0x041C, 3))
        f.write(comp)
        f.write(struct.pack("<I", 0))   # offset of shape 0
        f.write(struct.pack("<I", 1))   # count
