"""Minimal Wavefront OBJ loader (port of vimg_tpu.scene.obj_loader:
vertices + triangle indices, numpy).

The reference loads OBJ via tinyobjloader but only consumes positions and
indices (src/geometry/mesh_loading.cpp:36-37, "only load vertices ... for
now"). We match that: v / f records, fan-triangulating polygons.
"""
from __future__ import annotations

import numpy as np


def load_obj(path):
    verts = []
    faces = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    return v, f
