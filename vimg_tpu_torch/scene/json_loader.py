"""Loader for the reference's JSON scene schema (port of
vimg_tpu.scene.json_loader): camera, sampler, integrator, materials
(lambertian / diffuse_light / dielectric / principled, constant or
checkered textures), quads, spheres and OBJ meshes with transform
stacks; and the SceneBuilder that the other loaders and procedural scenes
use (image textures through an atlas, env maps, normal-map and metal-rough
UV sets).

As in vimg_tpu, the parsed ``background`` color is ignored and a black
background installed, and a mesh whose OBJ file is missing takes a
procedural stand-in where one is registered (``cube.obj``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from vimg_tpu_torch.core.math import look_at, xform_point
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.obj_loader import load_obj


def _quat_to_mat3(q):
    """glm quaternion [x, y, z, w] -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def parse_transform(surf_json) -> np.ndarray:
    """Transform stack -> 4x4 matrix; each entry left-multiplies."""
    xform = np.eye(4, dtype=np.float32)
    for entry in surf_json.get("transform", []):
        m = np.eye(4, dtype=np.float32)
        if "scale" in entry:
            s = entry["scale"]
            s = [s, s, s] if not isinstance(s, list) else s
            m[0, 0], m[1, 1], m[2, 2] = s
        elif "rotate" in entry:
            m[:3, :3] = _quat_to_mat3(entry["rotate"])
        elif "translate" in entry:
            m[:3, 3] = entry["translate"]
        elif any(k in entry for k in ("x", "y", "z", "o")):
            m[:3, 0] = entry.get("x", [1, 0, 0])
            m[:3, 1] = entry.get("y", [0, 1, 0])
            m[:3, 2] = entry.get("z", [0, 0, 1])
            m[:3, 3] = entry.get("o", [0, 0, 0])
        else:
            raise ValueError(f"unknown transform entry: {entry}")
        xform = m @ xform
    return xform


def _synth_mesh_asset(filename):
    """Procedural stand-ins for reference assets absent from the scene
    folder. ``cube.obj`` (used by MIS_light_tests/odyssey_mis.json) is a
    unit cube centered at the origin: the scene's translate(0,.5,0) +
    scale(1,9,4) stack then yields the 1:4:9 monolith standing on the
    floor, as in the reference render."""
    if Path(str(filename)).name == "cube.obj":
        h = 0.5
        v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                      [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]],
                     np.float32)
        idx = np.array([
            [0, 2, 1], [0, 3, 2],      # -z (outward CCW)
            [4, 5, 6], [4, 6, 7],      # +z
            [0, 1, 5], [0, 5, 4],      # -y
            [3, 7, 6], [3, 6, 2],      # +y
            [0, 4, 7], [0, 7, 3],      # -x
            [1, 2, 6], [1, 6, 5],      # +x
        ], np.int64)
        return v, idx
    raise FileNotFoundError(f"mesh asset not found and no synthetic "
                            f"stand-in registered: {filename}")


QUAD_VERTS = np.array([[-1, -1, 0], [-1, 1, 0], [1, 1, 0], [1, -1, 0]],
                      np.float32)
QUAD_UVS = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
QUAD_IDX = np.array([[0, 2, 1], [2, 0, 3]], np.uint32)

class SceneBuilder:
    """Accumulates host-side buffers, then emits an ir.Scene."""

    def __init__(self):
        for name in ("verts", "vnormals", "vuv", "vuv_nmap", "vuv_mr",
                     "tri_vidx", "tri_mat", "tri_flags",
                     "sph_center", "sph_radius", "sph_mat", "mat_type",
                     "mat_base", "mat_scalars", "mat_tex", "tex_type",
                     "tex_cols", "tex_wh", "tex_atlas", "light_type",
                     "light_idx"):
            setattr(self, name, [])
        self._nv = 0

    # -- materials -------------------------------------------------------
    def add_material(self, mtype, base=(0.0, 0.0, 0.0), scalars=None,
                     tex=(-1, -1, -1)):
        s = np.zeros(ir.N_MAT_SCALARS, np.float32)
        for k, v in (scalars or {}).items():
            s[k] = v
        self.mat_type.append(mtype)
        self.mat_base.append(np.asarray(base, np.float32))
        self.mat_scalars.append(s)
        self.mat_tex.append(np.asarray(tex, np.int32))
        return len(self.mat_type) - 1

    def add_texture(self, ttype, col_a=(0, 0, 0), col_b=(0, 0, 0), wh=(1, 1),
                    atlas_id=-1):
        """A constant (col_a), checker (col_a / col_b on a wh board) or
        image texture (an entry of the scene's atlas)."""
        self.tex_type.append(ttype)
        self.tex_cols.append(np.stack([np.asarray(col_a, np.float32),
                                       np.asarray(col_b, np.float32)]))
        self.tex_wh.append(np.asarray(wh, np.float32))
        self.tex_atlas.append(atlas_id)
        return len(self.tex_type) - 1

    def _mat_is_emissive(self, mat_id):
        return self.mat_type[mat_id] == ir.MAT_DIFFUSE_LIGHT

    # -- geometry --------------------------------------------------------
    def add_mesh(self, verts, tri_idx, mat_id, normals=None, uvs=None,
                 uvs_nmap=None, uvs_mr=None):
        """Triangles, optionally with per-vertex normals and colour,
        normal-map and metal-rough UV sets; each sets its TRI_HAS_* flag
        like vimg_tpu (absent ones are stored as zeros)."""
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        tri_idx = np.asarray(tri_idx, np.int64).reshape(-1, 3)
        n = verts.shape[0]

        def uvset(u):
            return (np.zeros((n, 2), np.float32) if u is None
                    else np.asarray(u, np.float32).reshape(-1, 2))

        self.verts.append(verts)
        self.vnormals.append(
            np.zeros((n, 3), np.float32) if normals is None
            else np.asarray(normals, np.float32).reshape(-1, 3))
        self.vuv.append(uvset(uvs))
        self.vuv_nmap.append(uvset(uvs_nmap))
        self.vuv_mr.append(uvset(uvs_mr))
        flags = ((ir.TRI_HAS_NORMALS if normals is not None else 0)
                 | (ir.TRI_HAS_UV if uvs is not None else 0)
                 | (ir.TRI_HAS_UV_NORMALMAP if uvs_nmap is not None else 0)
                 | (ir.TRI_HAS_UV_MR if uvs_mr is not None else 0))
        t0 = len(self.tri_vidx)
        self.tri_vidx.extend(list((tri_idx + self._nv).astype(np.int32)))
        nt = tri_idx.shape[0]
        self.tri_mat.extend([mat_id] * nt)
        self.tri_flags.extend([flags] * nt)
        self._nv += n
        if self._mat_is_emissive(mat_id):
            # the reference registers emissive tris in reverse order
            for i in range(t0 + nt - 1, t0 - 1, -1):
                self.light_type.append(ir.LIGHT_TRI)
                self.light_idx.append(i)

    def add_quad(self, mat_id, xform):
        self.add_mesh(xform_point(xform, QUAD_VERTS), QUAD_IDX, mat_id,
                      uvs=QUAD_UVS)

    def add_sphere(self, center, radius, mat_id):
        self.sph_center.append(np.asarray(center, np.float32))
        self.sph_radius.append(float(radius))
        self.sph_mat.append(mat_id)
        if self._mat_is_emissive(mat_id):
            self.light_type.append(ir.LIGHT_SPHERE)
            self.light_idx.append(len(self.sph_center) - 1)

    def add_background_light(self):
        self.light_type.append(ir.LIGHT_BACKGROUND)
        self.light_idx.append(0)

    # -- emit ------------------------------------------------------------
    def build(self, camera, bg_color=(0, 0, 0), env=None, atlas=None,
              bg_light=False, device="cuda"):
        """``camera``: a Camera or a dict of Camera.make arguments; ``env``
        and ``atlas`` as ir.build_scene takes them; ``bg_light`` adds the
        background to the light table (NEE toward it). A CUDA ``device``
        (the default) raises without CUDA."""
        if bg_light:
            self.add_background_light()

        def opt(xs, dtype):
            """Array of the list, or None (build_scene's default) if empty."""
            return np.asarray(np.stack(xs), dtype) if xs else None
        return ir.build_scene(
            verts=(np.concatenate(self.verts) if self.verts
                   else np.zeros((0, 3), np.float32)),
            vnormals=(np.concatenate(self.vnormals) if self.vnormals
                      else None),
            vuv=np.concatenate(self.vuv) if self.vuv else None,
            vuv_nmap=np.concatenate(self.vuv_nmap) if self.vuv_nmap else None,
            vuv_mr=np.concatenate(self.vuv_mr) if self.vuv_mr else None,
            tri_vidx=(np.stack(self.tri_vidx) if self.tri_vidx
                      else np.zeros((0, 3), np.int32)),
            tri_mat=np.asarray(self.tri_mat, np.int32),
            tri_flags=np.asarray(self.tri_flags, np.int32),
            sph_center=opt(self.sph_center, np.float32),
            sph_radius=opt(self.sph_radius, np.float32),
            sph_mat=opt(self.sph_mat, np.int32),
            mat_type=np.asarray(self.mat_type, np.int32),
            mat_base=np.stack(self.mat_base),
            mat_scalars=np.stack(self.mat_scalars),
            mat_tex=np.stack(self.mat_tex),
            tex_type=opt(self.tex_type, np.int32),
            tex_cols=opt(self.tex_cols, np.float32),
            tex_wh=opt(self.tex_wh, np.float32),
            tex_atlas=opt(self.tex_atlas, np.int32),
            light_type=opt(self.light_type, np.int32),
            light_idx=opt(self.light_idx, np.int32),
            bg_color=bg_color, camera=camera, env=env, atlas=atlas,
            device=device)


def _texture_from_json(builder: SceneBuilder, mat_json):
    """Texture id of a material's texture block, or -1 for plain albedo."""
    if "texture" not in mat_json:
        return -1
    tex = mat_json["texture"]
    if tex["type"] == "constant":
        return builder.add_texture(ir.TEX_CONST, col_a=tex["albedo"])
    if tex["type"] == "checkered":
        return builder.add_texture(ir.TEX_CHECKER, col_a=tex["col1"],
                                   col_b=tex["col2"],
                                   wh=(tex["width"], tex["height"]))
    raise ValueError(f"unknown texture type {tex['type']}")


def load_json_scene(path, device="cuda"):
    """Parse a reference-format JSON scene onto ``device`` (CUDA by
    default; raises without CUDA unless ``device="cpu"`` is passed).

    Returns (scene: ir.Scene, settings: ir.RenderSettings)."""
    device = ir.check_device(device)
    path = Path(path)
    cfg = json.loads(path.read_text())
    b = SceneBuilder()

    cam_cfg = cfg.get("camera", {})
    res = cam_cfg.get("resolution", [500, 500])
    tf = cam_cfg.get("transform", {})
    c2w = look_at(tf.get("from", [0, 0, 0]), tf.get("at", [0, 0, 0]),
                  tf.get("up", [0, 1, 0]))
    camera = dict(cam2world=c2w, width=res[0], height=res[1],
                  vfov_deg=cam_cfg.get("vfov", 40.0))

    sampler = cfg.get("sampler", {})
    depth = sampler.get("depth", 30)
    if depth < 0:
        depth = 2 ** 31 - 1  # reference: uint32 wrap ~= infinite
    settings = ir.RenderSettings(
        width=int(res[0]), height=int(res[1]),
        spp=int(sampler.get("samples", 30)), max_depth=int(depth),
        integrator=cfg.get("integrator", {}).get("type", "s_normal"))

    name_to_id = {}
    for m in cfg.get("materials", []):
        t = m["type"]
        if t == "lambertian":
            tex = _texture_from_json(b, m)
            mid = b.add_material(ir.MAT_LAMBERTIAN,
                                 base=m.get("albedo", [0.5, 0.5, 0.5]),
                                 tex=(tex, -1, -1))
        elif t == "diffuse_light":
            mid = b.add_material(ir.MAT_DIFFUSE_LIGHT,
                                 base=m.get("albedo", [0.5, 0.5, 0.5]))
        elif t == "dielectric":
            mid = b.add_material(ir.MAT_DIELECTRIC,
                                 scalars={ir.MS_IOR: m.get("ior", 1.5)})
        elif t == "principled":
            mid = b.add_material(
                ir.MAT_PRINCIPLED, base=m["base_color"],
                scalars={
                    ir.MS_IOR: m.get("eta", 1.5),
                    ir.MS_SPEC_TRANS: m.get("spec_trans", 0.0),
                    ir.MS_SUBSURFACE: m.get("subsurface", 0.0),
                    ir.MS_SPECULAR: m.get("specular", 0.5),
                    ir.MS_SPEC_TINT: m.get("spec_tint", 0.0),
                    ir.MS_ANISO: m.get("anisotropic", 0.0),
                    ir.MS_SHEEN: m.get("sheen", 0.0),
                    ir.MS_SHEEN_TINT: m.get("sheen_tint", 0.5),
                    ir.MS_CLEARCOAT: m.get("clearcoat", 0.0),
                    ir.MS_CLEARCOAT_GLOSS: m.get("clearcoat_gloss", 1.0),
                    ir.MS_METALLIC: m.get("metallic", 0.0),
                    ir.MS_ROUGHNESS: m.get("roughness", 0.5),
                })
        else:
            raise ValueError(f"unknown material type {t}")
        name_to_id[m["name"]] = mid

    for s in cfg.get("surfaces", []):
        mat_id = name_to_id[s["mat_name"]]
        if s["type"] == "quad":
            b.add_quad(mat_id, parse_transform(s))
        elif s["type"] == "sphere":
            b.add_sphere(s["center"], s.get("radius", 1.0), mat_id)
        elif s["type"] == "mesh":
            xform = parse_transform(s)
            obj_path = path.parent / s["filename"]
            if obj_path.exists():
                v, idx = load_obj(obj_path)
            else:
                v, idx = _synth_mesh_asset(s["filename"])
            b.add_mesh(xform_point(xform, v), idx, mat_id)
        else:
            raise ValueError(f"unknown surface type {s['type']}")

    scene = b.build(camera=camera, bg_color=(0.0, 0.0, 0.0), device=device)
    return scene, settings
