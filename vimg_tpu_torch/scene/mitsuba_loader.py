"""Mitsuba XML scene loader (port of vimg_tpu.scene.mitsuba_loader; pure
Python, xml.etree, numpy).

Feature set per reference src/scene_loading/mitsuba_scene.cpp: sensor/film/
sampler -> camera (fov-axis conversion, row-major matrix with x/z flip),
integrators path/mat/s_normal/g_normal, envmap/constant emitters, shapes
rectangle/cube/serialized/sphere/obj, diffuse/principled/area-emitter
materials with id-based dedup and checkerboard textures. The env map is
read by ``scene/images.py`` (Radiance .hdr without cv2).
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from vimg_tpu_torch.core.math import xform_dir, xform_point
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.json_loader import SceneBuilder
from vimg_tpu_torch.scene.obj_loader import load_obj
from vimg_tpu_torch.scene.serialized import read_serialized

# reference cube_mesh (mitsuba_scene.cpp:23-49)
CUBE_VERTS = np.array(
    [[1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
     [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],
     [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],
     [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
     [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],
     [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float32)
CUBE_NORMALS = np.repeat(np.array(
    [[0, -1, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1], [-1, 0, 0], [0, 0, -1]],
    np.float32), 4, axis=0)
CUBE_UVS = np.tile(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
                   (6, 1))
CUBE_IDX = np.array(
    [[0, 1, 2], [3, 0, 2], [4, 5, 6], [7, 4, 6], [8, 9, 10], [11, 8, 10],
     [12, 13, 14], [15, 12, 14], [16, 17, 18], [19, 16, 18],
     [20, 21, 22], [23, 20, 22]], np.int64)


def _parse_value(txt, default=None):
    if txt is None:
        return default
    return [float(v) for v in txt.replace(",", " ").split()]


def parse_transform_elem(elem):
    """<transform> children composed in order, each left-multiplying."""
    m = np.eye(4, dtype=np.float32)
    if elem is None:
        return m
    for child in elem:
        t = np.eye(4, dtype=np.float32)
        tag = child.tag
        if tag == "matrix":
            vals = _parse_value(child.get("value"))
            t = np.asarray(vals, np.float32).reshape(4, 4)  # row-major
        elif tag == "translate":
            t[:3, 3] = [float(child.get(a, 0)) for a in "xyz"]
        elif tag == "scale":
            if child.get("value") is not None:
                v = _parse_value(child.get("value"))
                if len(v) == 1:
                    v = v * 3
            else:
                v = [float(child.get(a, 1)) for a in "xyz"]
            t[0, 0], t[1, 1], t[2, 2] = v
        elif tag == "rotate":
            ax = np.array([float(child.get(a, 0)) for a in "xyz"], np.float32)
            ax = ax / max(np.linalg.norm(ax), 1e-12)
            ang = math.radians(float(child.get("angle", 0)))
            c, s = math.cos(ang), math.sin(ang)
            x, y, z = ax
            t[:3, :3] = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)]], np.float32)
        elif tag == "lookat":
            # Mitsuba convention: +z points TOWARD the target (the sensor
            # path then flips x/z into our -z-forward convention)
            origin = np.asarray(_parse_value(child.get("origin")), np.float32)
            target = np.asarray(_parse_value(child.get("target")), np.float32)
            up = np.asarray(_parse_value(child.get("up"), [0, 1, 0]),
                            np.float32)
            fwd = target - origin
            fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
            left = np.cross(up, fwd)
            left = left / max(np.linalg.norm(left), 1e-12)
            new_up = np.cross(fwd, left)
            t = np.eye(4, dtype=np.float32)
            t[:3, 0] = left
            t[:3, 1] = new_up
            t[:3, 2] = fwd
            t[:3, 3] = origin
        m = t @ m
    return m


def _props(elem):
    """Collect property children into a dict by name."""
    out = {}
    for c in elem:
        name = c.get("name")
        if c.tag in ("float", "integer"):
            out[name] = float(c.get("value"))
        elif c.tag == "string":
            out[name] = c.get("value")
        elif c.tag == "boolean":
            out[name] = c.get("value") == "true"
        elif c.tag in ("rgb", "color", "spectrum"):
            v = _parse_value(c.get("value"))
            out[name] = v * 3 if len(v) == 1 else v
        elif c.tag in ("point", "vector"):
            out[name] = [float(c.get(a, 0)) for a in "xyz"]
        elif c.tag == "transform":
            out[name] = parse_transform_elem(c)
    return out


def _hfov_to_vfov(h_deg, width, height):
    """reference mitsuba_scene.cpp:14-21 (NB: keeps its aspect convention)."""
    hrad = math.radians(h_deg)
    aspect = width / height
    return math.degrees(2.0 * math.atan(math.tan(hrad / 2.0) * aspect))


class _MatBuilder:
    def __init__(self, b: SceneBuilder):
        self.b = b
        self.by_id = {}

    def from_elem(self, elem):
        mid = elem.get("id", "")
        if mid and mid in self.by_id:
            return self.by_id[mid]
        plugin = elem.get("type")
        p = _props(elem)
        if elem.tag == "emitter" and plugin == "area":
            out = self.b.add_material(ir.MAT_DIFFUSE_LIGHT,
                                      base=p.get("radiance", [1, 1, 1]))
        elif plugin == "diffuse":
            tex = -1
            for c in elem:
                if c.tag == "texture" and c.get("type") == "checkerboard":
                    cp = _props(c)
                    tex = self.b.add_texture(
                        ir.TEX_CHECKER, col_a=cp.get("color0", [0, 0, 0]),
                        col_b=cp.get("color1", [1, 1, 1]),
                        wh=(cp.get("uscale", 1) * 2, cp.get("vscale", 1) * 2))
            out = self.b.add_material(
                ir.MAT_LAMBERTIAN, base=p.get("reflectance", [0.5, 0.5, 0.5]),
                tex=(tex, -1, -1))
        elif plugin == "principled":
            out = self.b.add_material(
                ir.MAT_PRINCIPLED, base=p.get("base_color", [0.5, 0.5, 0.5]),
                scalars={
                    ir.MS_IOR: p.get("eta", 1.5),
                    ir.MS_SPEC_TRANS: p.get("spec_trans", 0.0),
                    ir.MS_SUBSURFACE: p.get("subsurface", 0.0),
                    ir.MS_SPECULAR: p.get("specular", 0.5),
                    ir.MS_SPEC_TINT: p.get("spec_tint", 0.0),
                    ir.MS_ANISO: p.get("anisotropic", 0.0),
                    ir.MS_SHEEN: p.get("sheen", 0.0),
                    ir.MS_SHEEN_TINT: p.get("sheen_tint", 0.5),
                    ir.MS_CLEARCOAT: p.get("clearcoat", 0.0),
                    ir.MS_CLEARCOAT_GLOSS: p.get("clearcoat_gloss", 1.0),
                    ir.MS_METALLIC: p.get("metallic", 0.0),
                    ir.MS_ROUGHNESS: p.get("roughness", 0.5),
                })
        else:
            raise ValueError(f"unsupported bsdf plugin {plugin}")
        if mid:
            self.by_id[mid] = out
        return out


def load_mitsuba_scene(path, device="cuda"):
    """Parse a Mitsuba XML scene onto ``device`` (CUDA by default; raises
    without CUDA unless ``device="cpu"`` is passed).

    Returns (scene: ir.Scene, settings: ir.RenderSettings)."""
    device = ir.check_device(device)
    path = Path(path)
    root = ET.parse(path).getroot()
    b = SceneBuilder()
    mats = _MatBuilder(b)

    width, height, spp = 768, 576, 32
    vfov = 40.0
    cam_m = np.eye(4, dtype=np.float32)
    integrator = "mis"
    max_depth = 64
    env = None
    bg_color = (0.0, 0.0, 0.0)
    bg_light = False

    # defaults like $spp
    defaults = {d.get("name"): d.get("value") for d in root.iter("default")}

    def subst(v):
        if isinstance(v, str) and v.startswith("$"):
            return defaults.get(v[1:], v)
        return v

    for sensor in root.iter("sensor"):
        p = _props(sensor)
        fov = float(subst(p.get("fov", 40.0)))
        fov_axis = p.get("fov_axis", "x")
        film = sensor.find("film")
        if film is not None:
            fp = _props(film)
            width = int(fp.get("width", width))
            height = int(fp.get("height", height))
        sampler = sensor.find("sampler")
        if sampler is not None:
            sp = _props(sampler)
            spp = int(float(subst(sp.get("sample_count", spp))))
        if fov_axis == "x" or (fov_axis == "smaller" and width < height) \
                or (fov_axis == "larger" and width > height):
            vfov = _hfov_to_vfov(fov, width, height)
        else:
            vfov = fov
        to_world = p.get("to_world")
        if to_world is not None:
            cam_m = np.asarray(to_world, np.float32).copy()
            # flip x and z axes (mitsuba_scene.cpp:263-278)
            cam_m[:, 0] *= -1.0
            cam_m[:, 2] *= -1.0

    for integ in root.iter("integrator"):
        p = _props(integ)
        max_depth = int(p.get("max_depth", max_depth))
        plugin = integ.get("type", "path")
        integrator = {"path": "mis", "mat": "material",
                      "s_normal": "s_normal", "g_normal": "g_normal"} \
            .get(plugin, "mis")

    for emitter in root.findall("emitter"):
        plugin = emitter.get("type")
        p = _props(emitter)
        if plugin == "envmap":
            from vimg_tpu_torch.lights.envmap import build_env_tables
            from vimg_tpu_torch.scene.images import load_hdr_image
            img = load_hdr_image(path.parent / p["filename"])
            env = build_env_tables(
                img, env_to_world=p.get("to_world"),
                radiance_scale=p.get("scale", 1.0))
            bg_light = True
        elif plugin == "constant":
            bg_color = tuple(p.get("radiance", [1, 1, 1]))
            bg_light = True

    for shape in root.iter("shape"):
        plugin = shape.get("type")
        p = _props(shape)
        xform = p.get("to_world", np.eye(4, dtype=np.float32))

        mat_id = None
        for child in shape.findall("emitter"):
            mat_id = mats.from_elem(child)
            break
        if mat_id is None:
            for child in shape.findall("bsdf"):
                mat_id = mats.from_elem(child)
                break
        if mat_id is None:
            ref = shape.find("ref")
            if ref is not None and ref.get("id") in mats.by_id:
                mat_id = mats.by_id[ref.get("id")]
        if mat_id is None:
            raise ValueError(f"shape {plugin} has no material")

        if plugin == "rectangle":
            b.add_quad(mat_id, xform)
        elif plugin == "cube":
            n_x = np.linalg.inv(xform[:3, :3]).T
            b.add_mesh(xform_point(xform, CUBE_VERTS), CUBE_IDX, mat_id,
                       normals=xform_dir(n_x, CUBE_NORMALS), uvs=CUBE_UVS)
        elif plugin == "sphere":
            center = p.get("center", [0, 0, 0])
            b.add_sphere(center, p.get("radius", 1.0), mat_id)
        elif plugin == "serialized":
            v, idx, n, uv = read_serialized(
                path.parent / p["filename"],
                shape_index=int(p.get("shape_index", 0)), to_world=xform)
            b.add_mesh(v, idx, mat_id, normals=n, uvs=uv)
        elif plugin == "obj":
            v, idx = load_obj(path.parent / p["filename"])
            b.add_mesh(xform_point(xform, v), idx, mat_id)
        else:
            raise ValueError(f"unsupported shape plugin {plugin}")

    camera = dict(cam2world=cam_m, width=width, height=height,
                  vfov_deg=vfov)
    scene = b.build(camera=camera, bg_color=bg_color, env=env,
                    bg_light=bg_light, device=device)
    settings = ir.RenderSettings(
        width=width, height=height, spp=spp,
        max_depth=max_depth if max_depth >= 0 else 2 ** 31 - 1,
        integrator=integrator)
    return scene, settings
