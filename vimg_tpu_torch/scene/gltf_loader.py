"""glTF 2.0 / GLB scene loader (port of vimg_tpu.scene.gltf_loader; pure
Python + numpy; PNG textures and .hdr backgrounds decoded by
``scene/images.py``, other formats through PIL / cv2).

Feature set per reference src/scene_loading/gltf_loading.cpp: scene-graph
walk with world transforms, indexed primitives with POSITION/NORMAL/
TEXCOORD_n, per-purpose UV-set dedup, pbrMetallicRoughness -> Principled,
emissive -> DiffuseLight, KHR extensions (emissive_strength, specular, ior,
transmission, clearcoat, sheen, anisotropy), companion json for render
settings (spp/depth/integrator/yres/background/radiance_scale/camera
fdist+aperture), first perspective camera node, env-map background with
importance-sampling tables.
"""
from __future__ import annotations

import base64
import json
import math
import struct
from pathlib import Path

import numpy as np

from vimg_tpu_torch.core.math import look_at, xform_dir, xform_point
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.images import image_pixels, load_hdr_image
from vimg_tpu_torch.scene.json_loader import SceneBuilder
from vimg_tpu_torch.textures.mipmap import (AtlasBuilder, rgb_to_normal,
                                            srgb_to_linear)

_COMPONENT = {
    5120: (np.int8, 1), 5121: (np.uint8, 1), 5122: (np.int16, 2),
    5123: (np.uint16, 2), 5125: (np.uint32, 4), 5126: (np.float32, 4),
}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTF:
    """Minimal glTF asset: json dict + binary buffers."""

    def __init__(self, path):
        path = Path(path)
        self.dir = path.parent
        data = path.read_bytes()
        if data[:4] == b"glTF":
            # GLB container: header(12) + chunks
            _, version, length = struct.unpack("<III", data[:12])
            off = 12
            self.json = None
            self.bin = None
            while off < length:
                clen, ctype = struct.unpack("<II", data[off:off + 8])
                chunk = data[off + 8:off + 8 + clen]
                if ctype == 0x4E4F534A:      # 'JSON'
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:    # 'BIN'
                    self.bin = chunk
                off += 8 + clen
        else:
            self.json = json.loads(data)
            self.bin = None
        self._buffers = {}

    def buffer(self, i):
        if i not in self._buffers:
            b = self.json["buffers"][i]
            uri = b.get("uri")
            if uri is None:
                self._buffers[i] = self.bin
            elif uri.startswith("data:"):
                self._buffers[i] = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote
                self._buffers[i] = (self.dir / unquote(uri)).read_bytes()
        return self._buffers[i]

    def accessor(self, i):
        """Decode accessor i to a float32/int numpy array (N, ncomp)."""
        acc = self.json["accessors"][i]
        n = acc["count"]
        ncomp = _NCOMP[acc["type"]]
        dtype, csize = _COMPONENT[acc["componentType"]]
        if "bufferView" not in acc:
            out = np.zeros((n, ncomp), dtype)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            buf = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0) or ncomp * csize
            if stride == ncomp * csize:
                raw = np.frombuffer(buf, dtype, count=n * ncomp, offset=start)
                out = raw.reshape(n, ncomp)
            else:
                rows = np.frombuffer(buf, np.uint8,
                                     count=(n - 1) * stride + ncomp * csize,
                                     offset=start)
                idx = (np.arange(n)[:, None] * stride
                       + np.arange(ncomp * csize)[None, :])
                out = rows[idx].copy().view(dtype).reshape(n, ncomp)
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        return np.array(out)

    def image_bytes(self, i):
        """The encoded bytes of image i (buffer view, data URI or file)."""
        img = self.json["images"][i]
        if "bufferView" in img:
            bv = self.json["bufferViews"][img["bufferView"]]
            buf = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0)
            return bytes(buf[start:start + bv["byteLength"]])
        uri = img["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        from urllib.parse import unquote
        return (self.dir / unquote(uri)).read_bytes()

    def image_pixels(self, i):
        """Decode image i -> (H, W, 3) float [0, 255]."""
        return image_pixels(self.image_bytes(i))


def _node_matrix(node):
    if "matrix" in node:
        # glTF matrices are column-major
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[0, 0], m[1, 1], m[2, 2] = node["scale"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        rm = np.eye(4, dtype=np.float32)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4, dtype=np.float32)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def load_gltf_scene(path, companion_json=None, device="cuda"):
    """Parse a glTF / GLB scene (and its companion JSON of render
    settings) onto ``device`` (CUDA by default; raises without CUDA unless
    ``device="cpu"`` is passed).

    Returns (scene: ir.Scene, settings: ir.RenderSettings)."""
    device = ir.check_device(device)
    path = Path(path)
    g = GLTF(path)
    b = SceneBuilder()
    atlas = AtlasBuilder()

    extra = {}
    if companion_json:
        extra = json.loads(Path(companion_json).read_text())

    # ---- decode images by usage type --------------------------------------
    # (image index, kind) -> atlas id; kind in {"color", "normal", "mr"}
    textures = g.json.get("textures", [])
    materials_json = g.json.get("materials", [])
    usage = {}
    for mat in materials_json:
        pbr = mat.get("pbrMetallicRoughness", {})
        if "baseColorTexture" in pbr:
            ti = pbr["baseColorTexture"]["index"]
            usage[(textures[ti].get("source"), "color")] = None
        if "metallicRoughnessTexture" in pbr:
            ti = pbr["metallicRoughnessTexture"]["index"]
            usage[(textures[ti].get("source"), "mr")] = None
        if "normalTexture" in mat:
            ti = mat["normalTexture"]["index"]
            usage[(textures[ti].get("source"), "normal")] = \
                mat["normalTexture"].get("scale", 1.0)

    atlas_ids = {}
    for (img_idx, kind), scale in usage.items():
        if img_idx is None:
            continue
        px = g.image_pixels(img_idx)
        if kind == "color":
            data = srgb_to_linear(px / 255.0)
            atlas_ids[(img_idx, kind)] = atlas.add(data, build_mips=True)
        elif kind == "normal":
            data = rgb_to_normal(px, scale or 1.0)
            atlas_ids[(img_idx, kind)] = atlas.add(data, build_mips=False)
        else:  # metallic-roughness: raw linear [0,1], G=rough B=metal
            atlas_ids[(img_idx, kind)] = atlas.add(px / 255.0,
                                                   build_mips=False)

    def _tex_atlas_id(tex_index, kind):
        if tex_index is None:
            return -1
        src = textures[tex_index].get("source")
        return atlas_ids.get((src, kind), -1)

    # ---- materials --------------------------------------------------------
    # (reference gltf_loading.cpp:547-690: emissive -> DiffuseLight, else
    # everything becomes Principled)
    for mat in materials_json:
        emissive = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
        if np.any(emissive != 0.0):
            strength = mat.get("extensions", {}).get(
                "KHR_materials_emissive_strength", {}).get(
                "emissiveStrength", 1.0)
            b.add_material(ir.MAT_DIFFUSE_LIGHT, base=emissive * strength)
            continue

        pbr = mat.get("pbrMetallicRoughness", {})
        ext = mat.get("extensions", {})
        base_color = pbr.get("baseColorFactor", [1, 1, 1, 1])[:3]
        metallic = pbr.get("metallicFactor", 1.0)
        roughness = pbr.get("roughnessFactor", 1.0)
        aniso = ext.get("KHR_materials_anisotropy", {}).get(
            "anisotropyStrength", 0.0)
        sheen_ext = ext.get("KHR_materials_sheen", {})
        sheen = sheen_ext.get("sheenRoughnessFactor", 0.0)
        sheen_tint = sheen_ext.get("sheenColorFactor", [0.5])[0] \
            if sheen_ext else 0.5
        cc = ext.get("KHR_materials_clearcoat", {})
        clearcoat = cc.get("clearcoatFactor", 0.0)
        clearcoat_gloss = 1.0 - cc.get("clearcoatRoughnessFactor", 0.0)
        eta = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
        spec_ext = ext.get("KHR_materials_specular", {})
        specular = spec_ext.get("specularFactor", 0.5)
        spec_tint = spec_ext.get("specularColorFactor", [0.0])[0] \
            if spec_ext else 0.0
        spec_trans = ext.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0)

        base_tex_idx = pbr.get("baseColorTexture", {}).get("index")
        mr_tex_idx = pbr.get("metallicRoughnessTexture", {}).get("index")
        nm_tex_idx = mat.get("normalTexture", {}).get("index")

        base_atlas = _tex_atlas_id(base_tex_idx, "color")
        if base_atlas >= 0:
            tex_id = b.add_texture(ir.TEX_IMAGE, atlas_id=base_atlas)
        else:
            tex_id = -1

        b.add_material(
            ir.MAT_PRINCIPLED, base=base_color,
            scalars={
                ir.MS_IOR: eta, ir.MS_SPEC_TRANS: spec_trans,
                ir.MS_SUBSURFACE: 0.0, ir.MS_SPECULAR: specular,
                ir.MS_SPEC_TINT: spec_tint, ir.MS_ANISO: aniso,
                ir.MS_SHEEN: sheen, ir.MS_SHEEN_TINT: sheen_tint,
                ir.MS_CLEARCOAT: clearcoat,
                ir.MS_CLEARCOAT_GLOSS: clearcoat_gloss,
                ir.MS_METALLIC: metallic, ir.MS_ROUGHNESS: roughness,
            },
            tex=(tex_id, _tex_atlas_id(nm_tex_idx, "normal"),
                 _tex_atlas_id(mr_tex_idx, "mr")))

    if not materials_json:
        b.add_material(ir.MAT_LAMBERTIAN, base=(0.8, 0.8, 0.8))

    # ---- scene graph ------------------------------------------------------
    nodes = g.json.get("nodes", [])
    cam_matrix = None
    cam_json = None

    def walk(node_idx, parent_m):
        nonlocal cam_matrix
        node = nodes[node_idx]
        m = parent_m @ _node_matrix(node)
        if "camera" in node and cam_matrix is None:
            cam_matrix = m
        if "mesh" in node:
            _emit_mesh(node["mesh"], m)
        for c in node.get("children", []):
            walk(c, m)

    def _emit_mesh(mesh_idx, m):
        mesh = g.json["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs or "indices" not in prim:
                continue
            pos = g.accessor(attrs["POSITION"])[:, :3]
            pos = xform_point(m, pos)
            normals = None
            if "NORMAL" in attrs:
                nrm = g.accessor(attrs["NORMAL"])[:, :3]
                n_xform = np.linalg.inv(m[:3, :3]).T
                nrm = xform_dir(n_xform, nrm)
                ln = np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                                1e-12)
                normals = (nrm / ln).astype(np.float32)
            idx = g.accessor(prim["indices"]).reshape(-1)
            tris = idx.reshape(-1, 3)

            mat_idx = prim.get("material")
            if mat_idx is None:
                continue  # reference skips material-less primitives

            mat = materials_json[mat_idx]
            pbr = mat.get("pbrMetallicRoughness", {})

            def uvset(texinfo):
                if not texinfo:
                    return None
                uv_i = texinfo.get("texCoord", 0)
                key = f"TEXCOORD_{uv_i}"
                if key not in attrs:
                    return None
                return g.accessor(attrs[key])[:, :2].astype(np.float32)

            uvs = uvset(pbr.get("baseColorTexture"))
            uvs_nmap = uvset(mat.get("normalTexture"))
            uvs_mr = uvset(pbr.get("metallicRoughnessTexture"))

            b.add_mesh(pos, tris, mat_idx, normals=normals, uvs=uvs,
                       uvs_nmap=uvs_nmap, uvs_mr=uvs_mr)

    scene_def = g.json.get("scenes", [{}])[g.json.get("scene", 0)]
    for root in scene_def.get("nodes", []):
        walk(root, np.eye(4, dtype=np.float32))

    # ---- camera -----------------------------------------------------------
    vfov_deg = 40.0
    aspect = 1.0
    cameras = g.json.get("cameras", [])
    if cameras and cameras[0].get("type") == "perspective":
        p = cameras[0]["perspective"]
        vfov_deg = math.degrees(p.get("yfov", 0.7))
        aspect = p.get("aspectRatio", 1.0)
    yres = int(extra.get("yres", 768))
    xres = int(math.ceil(yres * aspect))

    integrator = extra.get("integrator", "s_normal")
    cam_kwargs = {}
    if "camera" in extra and integrator in ("mis", "material"):
        cam_kwargs["focal_dist"] = extra["camera"].get("fdist", 1.0)
        cam_kwargs["aperture_radius"] = extra["camera"].get(
            "aperture_radius", 0.0)
    if cam_matrix is None:
        cam_matrix = look_at([0, 0, 5], [0, 0, 0], [0, 1, 0])
    camera = dict(cam2world=cam_matrix, width=xres, height=yres,
                  vfov_deg=vfov_deg, **cam_kwargs)

    # ---- background -------------------------------------------------------
    env = None
    bg_color = (0.0, 0.0, 0.0)
    bg_light = False
    bg = extra.get("background")
    if isinstance(bg, list):
        bg_color = tuple(bg)
        bg_light = True
    elif isinstance(bg, str):
        from vimg_tpu_torch.lights.envmap import build_env_tables
        img = load_hdr_image(path.parent / bg)
        env = build_env_tables(img, radiance_scale=extra.get(
            "radiance_scale", 1.0))
        bg_light = True

    atlas_arr, atlas_meta, _ = atlas.finalize()
    atlas_dict = (dict(atlas=atlas_arr, atlas_meta=atlas_meta)
                  if atlas.metas else None)
    scene = b.build(camera=camera, bg_color=bg_color, env=env,
                    atlas=atlas_dict, bg_light=bg_light, device=device)

    depth = int(extra.get("depth", 64))
    settings = ir.RenderSettings(
        width=xres, height=yres, spp=int(extra.get("spp", 32)),
        max_depth=depth if depth >= 0 else 2 ** 31 - 1,
        integrator=integrator)
    return scene, settings
