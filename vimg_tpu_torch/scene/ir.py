"""Scene intermediate representation: flat tensors on one device (port of
vimg_tpu.scene.ir).

Field names, type ids and the static layout flags are vimg_tpu's, so a
scene built by either package can be handed to the other as numpy arrays
(``scene_from_numpy``). Every tensor of a Scene lives on ``Scene.device``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from vimg_tpu_torch.render.camera import Camera

# material type ids
MAT_LAMBERTIAN = 0
MAT_DIELECTRIC = 1
MAT_DIFFUSE_LIGHT = 2
MAT_PRINCIPLED = 3

# columns of mat_scalars
MS_IOR = 0
MS_SPEC_TRANS = 1
MS_SUBSURFACE = 2
MS_SPECULAR = 3
MS_SPEC_TINT = 4
MS_ANISO = 5
MS_SHEEN = 6
MS_SHEEN_TINT = 7
MS_CLEARCOAT = 8
MS_CLEARCOAT_GLOSS = 9
MS_METALLIC = 10
MS_ROUGHNESS = 11
N_MAT_SCALARS = 12

# texture type ids
TEX_CONST = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

# light type ids
LIGHT_TRI = 0
LIGHT_SPHERE = 1
LIGHT_BACKGROUND = 2

# prim type ids
PRIM_TRI = 0
PRIM_SPHERE = 1

# triangle flag bits
TRI_HAS_NORMALS = 1
TRI_HAS_UV = 2
TRI_HAS_UV_NORMALMAP = 4
TRI_HAS_UV_MR = 8

# (name, dtype) of every tensor field, in vimg_tpu.scene.ir.Scene order
TENSOR_FIELDS = (
    ("verts", torch.float32), ("vnormals", torch.float32),
    ("vuv", torch.float32), ("vuv_nmap", torch.float32),
    ("vuv_mr", torch.float32), ("tri_vidx", torch.int64),
    ("tri_mat", torch.int64), ("tri_flags", torch.int64),
    ("sph_center", torch.float32), ("sph_radius", torch.float32),
    ("sph_mat", torch.int64), ("mat_type", torch.int64),
    ("mat_base", torch.float32), ("mat_scalars", torch.float32),
    ("mat_tex", torch.int64), ("tex_type", torch.int64),
    ("tex_cols", torch.float32), ("tex_wh", torch.float32),
    ("tex_atlas", torch.int64), ("light_type", torch.int64),
    ("light_idx", torch.int64), ("bg_color", torch.float32),
    ("atlas", torch.float32), ("atlas_meta", torch.int64),
    ("env_alias", torch.int64), ("env_prob", torch.float32),
    ("env_pdf_w", torch.float32), ("env_to_world", torch.float32),
    ("world_to_env", torch.float32), ("env_scale", torch.float32),
)

META_FIELDS = (
    "has_lambertian", "has_dielectric", "has_diffuse_light",
    "has_principled", "has_envmap", "has_image_tex", "has_normal_maps",
    "bg_is_emissive", "lights_have_tri", "lights_have_sphere",
    "lights_have_bg", "has_sheen", "has_clearcoat", "has_aniso",
    "has_spec_trans", "has_checker",
)

CAMERA_FIELDS = ("cam2world", "vfov_deg", "aperture_radius", "focal_dist")


def check_device(device) -> torch.device:
    """Resolve ``device``; a CUDA request without CUDA raises (nothing in
    this package silently moves work to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available in this PyTorch build/machine")
    return device


@dataclass(frozen=True)
class Scene:
    # ---- geometry ----
    verts: torch.Tensor        # (V, 3) f32
    vnormals: torch.Tensor     # (V, 3) f32 (zeros when absent)
    vuv: torch.Tensor          # (V, 2) f32
    vuv_nmap: torch.Tensor     # (V, 2) f32
    vuv_mr: torch.Tensor       # (V, 2) f32
    tri_vidx: torch.Tensor     # (T, 3) i64
    tri_mat: torch.Tensor      # (T,) i64
    tri_flags: torch.Tensor    # (T,) i64 bitmask of TRI_HAS_*
    sph_center: torch.Tensor   # (S, 3) f32
    sph_radius: torch.Tensor   # (S,) f32
    sph_mat: torch.Tensor      # (S,) i64
    # ---- materials / textures ----
    mat_type: torch.Tensor     # (NM,) i64
    mat_base: torch.Tensor     # (NM, 3) f32
    mat_scalars: torch.Tensor  # (NM, N_MAT_SCALARS) f32
    mat_tex: torch.Tensor      # (NM, 3) i64, -1 none
    tex_type: torch.Tensor     # (NT,) i64
    tex_cols: torch.Tensor     # (NT, 2, 3) f32
    tex_wh: torch.Tensor       # (NT, 2) f32
    tex_atlas: torch.Tensor    # (NT,) i64
    # ---- lights ----
    light_type: torch.Tensor   # (L,) i64
    light_idx: torch.Tensor    # (L,) i64
    # ---- background ----
    bg_color: torch.Tensor     # (3,) f32
    # ---- image texture atlas: flat rows + per-texture-per-level table ----
    atlas: torch.Tensor        # (N, 3) f32: all mips of all textures
    atlas_meta: torch.Tensor   # (NT, L, 3) i64: offset, w, h
    # ---- env map (lights/envmap.py) ----
    env_mips: Tuple[torch.Tensor, ...]   # (H_l, W_l, 3) radiance levels
    env_alias: torch.Tensor    # (H*W,) i64 alias table
    env_prob: torch.Tensor     # (H*W,) f32 accept probability
    env_pdf_w: torch.Tensor    # (H*W,) f32: p_texel * W*H / (2 pi^2)
    env_to_world: torch.Tensor  # (4, 4)
    world_to_env: torch.Tensor  # (4, 4)
    env_scale: torch.Tensor    # () radiance scale
    # ---- camera ----
    camera: Camera
    # ---- static meta ----
    has_lambertian: bool = False
    has_dielectric: bool = False
    has_diffuse_light: bool = False
    has_principled: bool = False
    has_envmap: bool = False
    has_image_tex: bool = False
    has_normal_maps: bool = False
    bg_is_emissive: bool = False
    lights_have_tri: bool = False
    lights_have_sphere: bool = False
    lights_have_bg: bool = False
    has_sheen: bool = False
    has_clearcoat: bool = False
    has_aniso: bool = False
    has_spec_trans: bool = False
    has_checker: bool = False
    # the scene's copies on other devices (parallel.sharding.replicate); a
    # replaced scene starts empty
    replicas: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def tensors(self):
        """Every tensor of the scene, the camera's and the env map's
        levels included."""
        return ([getattr(self, name) for name, _ in TENSOR_FIELDS]
                + list(self.env_mips)
                + [getattr(self.camera, name) for name in CAMERA_FIELDS])

    @property
    def needs_uv(self):
        return self.has_image_tex or self.has_checker

    @property
    def needs_cones(self):
        return self.has_image_tex or self.has_envmap

    def n_tris(self):
        return self.tri_vidx.shape[0]

    def n_spheres(self):
        return self.sph_center.shape[0]

    def n_mats(self):
        return self.mat_type.shape[0]

    def n_lights(self):
        return self.light_type.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        """Copy of the scene with every tensor on ``device``."""
        device = check_device(device)
        kw = {name: getattr(self, name).to(device)
              for name, _ in TENSOR_FIELDS}
        kw["env_mips"] = tuple(m.to(device) for m in self.env_mips)
        kw["camera"] = self.camera.to(device)
        return self.replace(**kw)


@dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (vimg_tpu.scene.ir.RenderSettings)."""
    width: int = 512
    height: int = 512
    spp: int = 30
    max_depth: int = 30
    integrator: str = "s_normal"   # s_normal | g_normal | material | mis
    tonemap: str = "clamp"         # clamp | agx | reinhard | aces
    # paths per chunk of the loop renderer; None = 1 << 20
    batch_size: int | None = None
    # kept for field parity with vimg_tpu; only "f32" is implemented
    shading_dtype: str = "f32"


def _empty_env():
    eye = np.eye(4, dtype=np.float32)
    return dict(env_mips=(np.zeros((1, 1, 3), np.float32),),
                env_alias=np.zeros((1,), np.int32),
                env_prob=np.ones((1,), np.float32),
                env_pdf_w=np.zeros((1,), np.float32),
                env_to_world=eye, world_to_env=eye,
                env_scale=np.float32(1.0))


def _empty_atlas():
    return dict(atlas=np.zeros((1, 3), np.float32),
                atlas_meta=np.zeros((1, 1, 3), np.int32))


def scene_to_numpy(scene):
    """(fields, meta) of ``scene_from_numpy`` from any scene object with
    vimg_tpu's field names (this package's Scene on the CPU, or a
    vimg_tpu.scene.ir.Scene); arrays are read with ``np.asarray``."""
    fields = {name: np.asarray(getattr(scene, name))
              for name, _ in TENSOR_FIELDS}
    fields["env_mips"] = [np.asarray(m) for m in scene.env_mips]
    fields.update({k: np.asarray(getattr(scene.camera, k))
                   for k in CAMERA_FIELDS})
    meta = {k: bool(getattr(scene, k)) for k in META_FIELDS}
    meta.update(width=scene.camera.width, height=scene.camera.height)
    return fields, meta


def scene_from_numpy(fields: dict, meta: dict, device="cuda") -> Scene:
    """Scene from numpy arrays plus static flags.

    ``fields`` holds every name of TENSOR_FIELDS, ``env_mips`` (a sequence
    of arrays) and the camera's CAMERA_FIELDS; ``meta`` holds every name of
    META_FIELDS plus the camera's ``width`` and ``height``. Arrays are
    copied as they are (no recomputation), so both packages trace the same
    bytes. A CUDA ``device`` (the default) raises without CUDA."""
    device = check_device(device)
    kw = {name: torch.as_tensor(np.array(fields[name]), dtype=dt,
                                device=device)
          for name, dt in TENSOR_FIELDS}
    kw["env_mips"] = tuple(torch.as_tensor(np.array(m), dtype=torch.float32,
                                           device=device)
                           for m in fields["env_mips"])
    kw["camera"] = Camera.make(
        np.asarray(fields["cam2world"]), meta["width"], meta["height"],
        np.asarray(fields["vfov_deg"]),
        aperture_radius=np.asarray(fields["aperture_radius"]),
        focal_dist=np.asarray(fields["focal_dist"]), device=device)
    kw.update({name: bool(meta[name]) for name in META_FIELDS})
    return Scene(**kw)


def build_scene(
    *,
    verts, tri_vidx, tri_mat, tri_flags,
    vnormals=None, vuv=None, vuv_nmap=None, vuv_mr=None,
    sph_center=None, sph_radius=None, sph_mat=None,
    mat_type, mat_base, mat_scalars, mat_tex=None,
    tex_type=None, tex_cols=None, tex_wh=None, tex_atlas=None,
    light_type=None, light_idx=None,
    bg_color=(0.0, 0.0, 0.0), camera=None, env=None, atlas=None,
    device="cuda",
) -> Scene:
    """Assemble a Scene from host (numpy) buffers, filling defaults and
    deriving the static flags exactly as vimg_tpu.scene.ir.build_scene.
    ``camera`` is a dict of Camera.make arguments (or a Camera); a dict
    builds its camera on ``device``. ``env`` is the dict of
    lights.envmap.build_env_tables, ``atlas`` a dict of the ``atlas`` and
    ``atlas_meta`` arrays of textures.mipmap.AtlasBuilder.finalize. A CUDA
    ``device`` (the default) raises without CUDA."""
    device = check_device(device)
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    nv = verts.shape[0]
    tri_vidx = np.asarray(tri_vidx, np.int32).reshape(-1, 3)
    nt = tri_vidx.shape[0]

    def _opt(x, shape, dtype=np.float32):
        if x is None:
            return np.zeros(shape, dtype)
        return np.asarray(x, dtype).reshape(shape)

    ns = 0 if sph_center is None else np.asarray(sph_center).reshape(-1, 3).shape[0]
    mat_type = np.asarray(mat_type, np.int32).reshape(-1)
    nm = mat_type.shape[0]
    mat_scalars = np.asarray(mat_scalars, np.float32).reshape(nm, N_MAT_SCALARS)
    mat_tex = (-np.ones((nm, 3), np.int32) if mat_tex is None
               else np.asarray(mat_tex, np.int32).reshape(nm, 3))
    if tex_type is None:
        tex_type = np.zeros((1,), np.int32)
        tex_cols = np.zeros((1, 2, 3), np.float32)
        tex_wh = np.ones((1, 2), np.float32)
        tex_atlas = -np.ones((1,), np.int32)
    else:
        tex_type = np.asarray(tex_type, np.int32).reshape(-1)
        ntex = tex_type.shape[0]
        tex_cols = np.asarray(tex_cols, np.float32).reshape(ntex, 2, 3)
        tex_wh = np.asarray(tex_wh, np.float32).reshape(ntex, 2)
        tex_atlas = (-np.ones((ntex,), np.int32) if tex_atlas is None
                     else np.asarray(tex_atlas, np.int32).reshape(ntex))
    nl = 0 if light_type is None else np.asarray(light_type).reshape(-1).shape[0]
    light_type = _opt(light_type, (nl,), np.int32)
    bg_color = np.asarray(bg_color, np.float32).reshape(3)

    fields = dict(
        verts=verts, vnormals=_opt(vnormals, (nv, 3)), vuv=_opt(vuv, (nv, 2)),
        vuv_nmap=_opt(vuv_nmap, (nv, 2)), vuv_mr=_opt(vuv_mr, (nv, 2)),
        tri_vidx=tri_vidx, tri_mat=_opt(tri_mat, (nt,), np.int32),
        tri_flags=_opt(tri_flags, (nt,), np.int32),
        sph_center=_opt(sph_center, (ns, 3)), sph_radius=_opt(sph_radius, (ns,)),
        sph_mat=_opt(sph_mat, (ns,), np.int32), mat_type=mat_type,
        mat_base=np.asarray(mat_base, np.float32).reshape(nm, 3),
        mat_scalars=mat_scalars, mat_tex=mat_tex, tex_type=tex_type,
        tex_cols=tex_cols, tex_wh=tex_wh, tex_atlas=tex_atlas,
        light_type=light_type, light_idx=_opt(light_idx, (nl,), np.int32),
        bg_color=bg_color, **(_empty_env() if env is None else env),
        **(_empty_atlas() if atlas is None else atlas))
    if isinstance(camera, Camera):
        cam = camera
    else:
        cam = Camera.make(**{"device": device, **camera})
    fields.update({k: getattr(cam, k).cpu().numpy() for k in CAMERA_FIELDS})

    meta = dict(
        width=cam.width, height=cam.height,
        has_lambertian=bool(np.any(mat_type == MAT_LAMBERTIAN)),
        has_dielectric=bool(np.any(mat_type == MAT_DIELECTRIC)),
        has_diffuse_light=bool(np.any(mat_type == MAT_DIFFUSE_LIGHT)),
        has_principled=bool(np.any(mat_type == MAT_PRINCIPLED)),
        has_envmap=env is not None, has_image_tex=atlas is not None,
        has_normal_maps=bool(np.any(mat_tex[:, 1] >= 0)),
        bg_is_emissive=env is not None or bool(np.any(bg_color != 0.0)),
        lights_have_tri=bool(np.any(light_type == LIGHT_TRI)),
        lights_have_sphere=bool(np.any(light_type == LIGHT_SPHERE)),
        lights_have_bg=bool(np.any(light_type == LIGHT_BACKGROUND)),
        has_sheen=bool(np.any(mat_scalars[:, MS_SHEEN] != 0.0)),
        has_clearcoat=bool(np.any(mat_scalars[:, MS_CLEARCOAT] != 0.0)),
        has_aniso=bool(np.any(mat_scalars[:, MS_ANISO] != 0.0)),
        has_spec_trans=bool(np.any(mat_scalars[:, MS_SPEC_TRANS] != 0.0)),
        has_checker=bool(np.any(tex_type == TEX_CHECKER)))
    return scene_from_numpy(fields, meta, device=device)
