"""The scene-file loaders against vimg_tpu's on the CPU: OBJ, Mitsuba
.serialized, JSON mesh surfaces, Mitsuba XML, glTF (data URIs and a
companion JSON) and GLB, the many-lights and multi-material scenes, and
the port's own PNG and Radiance .hdr decoders against PIL and cv2.

Criteria: every scene table (scene_to_numpy, env mips included) and every
RenderSettings field equal to vimg_tpu's, byte for byte; the decoders
bit-equal to PIL's ``convert("RGB")`` and to cv2's float32 RGB. Every file
is written small by the test.
"""
import base64
import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest

from vimg_tpu_torch.scene import images
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn
from vimg_tpu_torch.scene.synthetic import terrain_mesh


def _same_scene(js, ts):
    jf, jm = tir.scene_to_numpy(js)
    tf, tm = tir.scene_to_numpy(ts)
    assert jm == tm
    for k in jf:
        if k == "env_mips":
            assert len(jf[k]) == len(tf[k])
            for a, b in zip(jf[k], tf[k]):
                assert np.array_equal(a, b)
        else:
            a = np.asarray(jf[k])
            assert a.shape == tf[k].shape and np.array_equal(a, tf[k]), k


def _same_settings(jst, tst):
    assert dataclasses.asdict(jst) == dataclasses.asdict(tst)


# ---------------------------------------------------------------------------
# OBJ and .serialized
# ---------------------------------------------------------------------------

def _write_obj(path):
    rs = np.random.RandomState(3)
    v = rs.uniform(-1, 1, (9, 3))
    lines = ["# test", "o thing"] + [f"v {a:.6f} {b:.6f} {c:.6f}"
                                     for a, b, c in v]
    lines += ["vt 0 0", "vn 0 1 0", "f 1 2 3", "f 4/1 5/1 6/1 7/1",
              "f 8//1 9//1 1//1", "f -1 -2 -3", "f 2/1/1 3/1/1 4/1/1 5/1/1 6/1/1"]
    path.write_text("\n".join(lines) + "\n")


def test_obj_round_trip(tmp_path):
    from vimg_tpu.scene.obj_loader import load_obj as jload
    from vimg_tpu_torch.scene.obj_loader import load_obj
    p = tmp_path / "m.obj"
    _write_obj(p)
    jv, jf = jload(p)
    tv, tf = load_obj(p)
    assert tf.shape == (1 + 2 + 1 + 1 + 3, 3)
    for a, b in ((jv, tv), (jf, tf)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _v4_two_shapes(path, shapes):
    """A version-4 file of several shapes (named, with the offset table of
    uint64s) as Mitsuba writes it."""
    out, offsets = bytearray(struct.pack("<HH", 0x041C, 4)), []
    for name, (v, idx, n) in shapes.items():
        flags = 0x1000 | (1 if n is not None else 0)
        payload = struct.pack("<I", flags) + name.encode() + b"\x00"
        payload += struct.pack("<QQ", len(v), len(idx))
        payload += np.asarray(v, np.float32).tobytes()
        if n is not None:
            payload += np.asarray(n, np.float32).tobytes()
        payload += np.asarray(idx, np.uint32).tobytes()
        offsets.append(len(out) - 4)
        out += zlib.compress(payload)
    for o in offsets:
        out += struct.pack("<Q", o)
    out += struct.pack("<I", len(offsets))
    path.write_bytes(bytes(out))


def test_serialized_round_trip(tmp_path):
    from vimg_tpu.scene.serialized import read_serialized as jread
    from vimg_tpu_torch.scene.serialized import (read_serialized,
                                                 write_serialized)
    rs = np.random.RandomState(4)
    v = rs.uniform(-1, 1, (40, 3)).astype(np.float32)
    idx = rs.randint(0, 40, (30, 3))
    n = rs.normal(size=(40, 3)).astype(np.float32)
    uv = rs.uniform(0, 1, (40, 2)).astype(np.float32)
    m = np.array([[0, 2, 0, 1], [1, 0, 0, 2], [0, 0, 3, -1], [0, 0, 0, 1]],
                 np.float32)
    p = tmp_path / "a.serialized"
    write_serialized(p, v, idx, normals=n, uvs=uv)
    for xform in (None, m):
        got, ref = read_serialized(p, to_world=xform), jread(p, to_world=xform)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    back = read_serialized(p)
    assert np.array_equal(back[0], v) and np.array_equal(back[1], idx)
    p4 = tmp_path / "b.serialized"
    _v4_two_shapes(p4, {"first": (v[:10], idx[:3] % 10, None),
                        "second": (v, idx, n)})
    for k in (0, 1):
        got = read_serialized(p4, shape_index=k, to_world=m)
        ref = jread(p4, shape_index=k, to_world=m)
        for a, b in zip(ref, got):
            assert (a is None and b is None) or np.array_equal(a, b)
    assert read_serialized(p4, shape_index=1)[0].shape == (40, 3)


def test_json_mesh_surface(tmp_path):
    """A JSON scene with OBJ mesh surfaces under transform stacks."""
    from vimg_tpu.scene.json_loader import load_json_scene as jload
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    from vimg_tpu_torch.scene.obj_loader import load_obj
    v, t = terrain_mesh(300, 1)
    (tmp_path / "t.obj").write_text(
        "".join(f"v {a!r} {b!r} {c!r}\n" for a, b, c in v.tolist())
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in t.tolist()))
    assert np.array_equal(load_obj(tmp_path / "t.obj")[0], v)
    cfg = {
        "camera": {"transform": {"from": [0, 2, 5], "at": [0, 0, 0]},
                   "resolution": [32, 16], "vfov": 50},
        "sampler": {"samples": 3, "depth": -1},
        "integrator": {"type": "mis"},
        "materials": [{"name": "g", "type": "lambertian",
                       "albedo": [0.4, 0.5, 0.6]},
                      {"name": "l", "type": "diffuse_light",
                       "albedo": [5, 5, 5]}],
        "surfaces": [
            {"type": "mesh", "mat_name": "g", "filename": "t.obj",
             "transform": [{"scale": 0.5}, {"rotate": [0, 0.38, 0, 0.92]},
                           {"translate": [0, -0.2, 0]}]},
            {"type": "mesh", "mat_name": "l", "filename": "cube.obj",
             "transform": [{"translate": [0, 2, 0]}]},
            {"type": "sphere", "mat_name": "g", "center": [1, 0, 0],
             "radius": 0.3}]}
    p = tmp_path / "s.json"
    p.write_text(json.dumps(cfg))
    js, jst = jload(p)
    ts, tst = load_json_scene(p, device="cpu")
    _same_scene(js, ts)
    _same_settings(jst, tst)
    assert ts.n_tris() == t.shape[0] + 12 and ts.lights_have_tri


# ---------------------------------------------------------------------------
# Mitsuba XML
# ---------------------------------------------------------------------------

def _mitsuba_files(tmp_path):
    import cv2
    from vimg_tpu_torch.scene.serialized import write_serialized
    rs = np.random.RandomState(6)
    sky = (rs.rand(8, 16, 3) ** 2 * 4).astype(np.float32)
    cv2.imwrite(str(tmp_path / "sky.hdr"), sky[..., ::-1].copy())
    v, t = terrain_mesh(200, 2)
    (tmp_path / "t.obj").write_text(
        "".join(f"v {a!r} {b!r} {c!r}\n" for a, b, c in v.tolist())
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in t.tolist()))
    n = rs.normal(size=v.shape).astype(np.float32)
    write_serialized(tmp_path / "m.serialized", v, t, normals=n)
    xml = """<scene version="2.0.0">
  <default name="spp" value="6"/>
  <integrator type="path"><integer name="max_depth" value="7"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <string name="fov_axis" value="x"/>
    <transform name="to_world">
      <lookat origin="0, 3, 6" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><string name="sample_count" value="$spp"/></sampler>
    <film type="hdrfilm"><integer name="width" value="40"/><integer name="height" value="20"/></film>
  </sensor>
  <emitter type="envmap">
    <string name="filename" value="sky.hdr"/><float name="scale" value="0.5"/>
    <transform name="to_world"><rotate y="1" angle="30"/></transform>
  </emitter>
  <shape type="obj">
    <string name="filename" value="t.obj"/>
    <transform name="to_world"><scale value="0.7"/><translate x="0.1" y="-0.3"/></transform>
    <bsdf type="diffuse" id="grey"><rgb name="reflectance" value="0.3, 0.4, 0.5"/></bsdf>
  </shape>
  <shape type="serialized">
    <string name="filename" value="m.serialized"/>
    <transform name="to_world">
      <matrix value="0 0 1 1  0 1 0 0.5  -1 0 0 0  0 0 0 1"/>
    </transform>
    <bsdf type="principled" id="shiny">
      <rgb name="base_color" value="0.8 0.2 0.1"/>
      <float name="roughness" value="0.3"/><float name="metallic" value="0.7"/>
      <float name="clearcoat" value="0.5"/><float name="sheen" value="0.2"/>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="90"/><translate y="3"/></transform>
    <emitter type="area"><rgb name="radiance" value="9, 8, 7"/></emitter>
  </shape>
  <shape type="cube">
    <transform name="to_world"><scale x="0.2" y="0.4" z="0.3"/></transform>
    <bsdf type="diffuse">
      <texture type="checkerboard" name="reflectance">
        <rgb name="color0" value="0.1"/><rgb name="color1" value="0.9"/>
        <float name="uscale" value="3"/>
      </texture>
    </bsdf>
  </shape>
  <shape type="sphere"><point name="center" x="1" y="0.5" z="0"/>
    <float name="radius" value="0.25"/><ref id="shiny"/></shape>
  <shape type="sphere"><point name="center" x="-1" y="0.5" z="0"/>
    <float name="radius" value="0.2"/><ref id="grey"/></shape>
</scene>
"""
    p = tmp_path / "scene.xml"
    p.write_text(xml)
    return p


def test_mitsuba_scene(tmp_path):
    from vimg_tpu.scene.mitsuba_loader import load_mitsuba_scene as jload
    from vimg_tpu_torch.scene.mitsuba_loader import load_mitsuba_scene
    p = _mitsuba_files(tmp_path)
    js, jst = jload(p)
    ts, tst = load_mitsuba_scene(p, device="cpu")
    _same_scene(js, ts)
    _same_settings(jst, tst)
    assert ts.has_envmap and ts.lights_have_bg and ts.has_checker
    assert ts.n_spheres() == 2 and tst.spp == 6 and tst.max_depth == 7


def test_mitsuba_default_in_a_number_raises(tmp_path):
    """ROADMAP C22, pinned: both loaders raise on a ``$name`` default in an
    <integer> or <float> property (``_props`` converts the value before
    the default is substituted; only string properties take defaults) and
    on a <ref> to a <bsdf id> declared at the top level (only a bsdf built
    inside an earlier shape is registered under its id)."""
    from vimg_tpu.scene.mitsuba_loader import load_mitsuba_scene as jload
    from vimg_tpu_torch.scene.mitsuba_loader import load_mitsuba_scene
    p = _mitsuba_files(tmp_path)
    text = p.read_text()
    top = text.replace('<integrator', '<bsdf type="diffuse" id="top"/>\n'
                       '  <integrator', 1).replace(
        '<float name="radius" value="0.2"/><ref id="grey"/>',
        '<float name="radius" value="0.2"/><ref id="top"/>')
    cases = ((text.replace('<string name="sample_count" value="$spp"/>',
                           '<integer name="sample_count" value="$spp"/>'),
              "spp"), (top, "no material"))
    for xml, what in cases:
        p.write_text(xml)
        for load in (jload, lambda q: load_mitsuba_scene(q, device="cpu")):
            with pytest.raises(ValueError, match=what):
                load(p)


# ---------------------------------------------------------------------------
# glTF / GLB
# ---------------------------------------------------------------------------

def _png(mode, size, seed):
    from PIL import Image
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.stack([xx * 7, yy * 5, (xx + yy) * 3], -1) % 256
    img = (img + rs.randint(0, 4, img.shape)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "PNG")
    return buf.getvalue()


def _gltf_doc(images_bytes):
    """A glTF document with one terrain mesh (interleaved positions and
    normals, two UV sets, one of them normalised uint16), an emissive quad
    (uint16 indices), three textures, KHR materials, a TRS node under a
    matrix node, and a perspective camera node. Returns (doc, binary)."""
    v, t = terrain_mesh(400, 4)
    n = np.tile(np.array([[0, 1, 0]], np.float32), (v.shape[0], 1))
    n[::3] = [0.1, 0.9, 0.2]
    uv0 = (v[:, [0, 2]] / 8.0 + 0.5).astype(np.float32)
    uv1 = (np.clip(uv0, 0, 1) * 65535).astype(np.uint16)
    quad_v = np.array([[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]],
                      np.float32)
    quad_i = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blobs, views, accessors = bytearray(), [], []

    def view(data, stride=None):
        while len(blobs) % 4:
            blobs.append(0)
        views.append(dict(buffer=0, byteOffset=len(blobs),
                          byteLength=len(data),
                          **({"byteStride": stride} if stride else {})))
        blobs.extend(data)
        return len(views) - 1

    def acc(bv, ctype, count, kind, offset=0, **kw):
        accessors.append(dict(bufferView=bv, componentType=ctype, count=count,
                              type=kind, byteOffset=offset, **kw))
        return len(accessors) - 1

    inter = np.concatenate([v, n], axis=1).astype(np.float32)
    iv = view(inter.tobytes(), stride=24)
    pos = acc(iv, 5126, v.shape[0], "VEC3")
    nrm = acc(iv, 5126, v.shape[0], "VEC3", offset=12)
    tc0 = acc(view(uv0.tobytes()), 5126, v.shape[0], "VEC2")
    tc1 = acc(view(uv1.tobytes()), 5123, v.shape[0], "VEC2", normalized=True)
    idx = acc(view(t.astype(np.uint32).tobytes()), 5125, t.size, "SCALAR")
    qp = acc(view(quad_v.tobytes()), 5126, 4, "VEC3")
    qi = acc(view(quad_i.tobytes()), 5123, 6, "SCALAR")
    imgs = [dict(bufferView=view(b), mimeType="image/png")
            for b in images_bytes]
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.2, -0.1, 0, 1],
             "children": [1]},
            {"mesh": 0, "scale": [0.6, 0.8, 0.6],
             "rotation": [0, 0.2588190, 0, 0.9659258],
             "translation": [0.1, 0, 0.2]},
            {"camera": 0, "translation": [0, 2, 5],
             "rotation": [-0.1305262, 0, 0, 0.9914449]}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.8, "aspectRatio": 1.5,
                                     "znear": 0.01}}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": pos, "NORMAL": nrm,
                            "TEXCOORD_0": tc0, "TEXCOORD_1": tc1},
             "indices": idx, "material": 0},
            {"attributes": {"POSITION": qp}, "indices": qi, "material": 1},
            {"attributes": {"POSITION": qp}, "indices": qi}]}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                "metallicFactor": 0.3, "roughnessFactor": 0.6,
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 2, "texCoord": 1}},
             "normalTexture": {"index": 1, "scale": 0.8, "texCoord": 1},
             "extensions": {
                 "KHR_materials_ior": {"ior": 1.4},
                 "KHR_materials_specular": {"specularFactor": 0.4,
                                            "specularColorFactor": [0.3]},
                 "KHR_materials_transmission": {"transmissionFactor": 0.1},
                 "KHR_materials_clearcoat": {
                     "clearcoatFactor": 0.5,
                     "clearcoatRoughnessFactor": 0.2},
                 "KHR_materials_sheen": {"sheenRoughnessFactor": 0.3,
                                         "sheenColorFactor": [0.6]},
                 "KHR_materials_anisotropy": {"anisotropyStrength": 0.4}}},
            {"emissiveFactor": [1.0, 0.9, 0.8],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 12.0}}}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": imgs,
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": 0}]}
    while len(blobs) % 4:
        blobs.append(0)
    doc["buffers"][0]["byteLength"] = len(blobs)
    return doc, bytes(blobs)


def _write_glb(path, doc, blob):
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body))
                     + body)


def _to_data_uris(doc, blob):
    """The same document as a .gltf: the buffer and each image a base64
    data URI."""
    doc = json.loads(json.dumps(doc))
    for img in doc["images"]:
        bv = doc["bufferViews"][img.pop("bufferView")]
        data = blob[bv["byteOffset"]:bv["byteOffset"] + bv["byteLength"]]
        img["uri"] = ("data:image/png;base64,"
                      + base64.b64encode(data).decode())
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode())
    return doc


@pytest.mark.parametrize("form", ["glb", "gltf"])
def test_gltf_scene(tmp_path, form):
    import cv2
    from vimg_tpu.scene.gltf_loader import load_gltf_scene as jload
    from vimg_tpu_torch.scene.gltf_loader import load_gltf_scene
    pngs = [_png("RGB", 32, 1), _png("RGBA", 16, 2), _png("L", 16, 3)]
    doc, blob = _gltf_doc(pngs)
    if form == "glb":
        path = tmp_path / "s.glb"
        _write_glb(path, doc, blob)
        comp = {"spp": 5, "depth": 9, "integrator": "mis", "yres": 20,
                "background": [0.1, 0.2, 0.3],
                "camera": {"fdist": 4.0, "aperture_radius": 0.02}}
    else:
        path = tmp_path / "s.gltf"
        path.write_text(json.dumps(_to_data_uris(doc, blob)))
        sky = (np.random.RandomState(8).rand(8, 16, 3) * 3).astype(np.float32)
        cv2.imwrite(str(tmp_path / "sky.hdr"), sky[..., ::-1].copy())
        comp = {"spp": 3, "integrator": "material", "yres": 16,
                "background": "sky.hdr", "radiance_scale": 0.5}
    cj = tmp_path / "c.json"
    cj.write_text(json.dumps(comp))
    js, jst = jload(path, cj)
    ts, tst = load_gltf_scene(path, cj, device="cpu")
    _same_scene(js, ts)
    _same_settings(jst, tst)
    assert ts.has_image_tex and ts.has_normal_maps and ts.lights_have_tri
    assert ts.has_envmap == (form == "gltf")
    # no companion JSON: vimg_tpu's defaults
    js, jst = jload(path)
    ts, tst = load_gltf_scene(path, device="cpu")
    _same_scene(js, ts)
    _same_settings(jst, tst)


# ---------------------------------------------------------------------------
# the A11 scenes
# ---------------------------------------------------------------------------

def test_many_lights_and_multi_material_scenes():
    from vimg_tpu.scene import synthetic as jsyn
    _same_scene(jsyn.many_lights_scene(100, 16, 8),
                tsyn.many_lights_scene(100, 16, 8, device="cpu"))
    ts = tsyn.many_lights_scene(256, 16, 8, device="cpu")
    _same_scene(jsyn.many_lights_scene(256, 16, 8), ts)
    assert ts.n_spheres() == 256 and ts.n_lights() == 256
    _same_scene(jsyn.multi_material_terrain_scene(900, 24, 16, 8),
                tsyn.multi_material_terrain_scene(900, 24, 16, 8,
                                                  device="cpu"))


def test_many_lights_ground_is_a_sliver():
    """ROADMAP C23, pinned: many_lights_scene's "ground" is
    ``add_quad(diag(30, 1e-3, 30))``, but the quad's vertices lie in the
    xy plane, so it is a 60 x 0.002 sliver standing at z = 0, as in
    vimg_tpu's scene (equal bytes above); camera rays hit only spheres."""
    from vimg_tpu.scene.synthetic import many_lights_scene as jml
    ts = tsyn.many_lights_scene(256, 16, 8, device="cpu")
    v = ts.verts.numpy()
    assert v.shape == (4, 3) and np.all(v[:, 2] == 0.0)
    assert np.ptp(v[:, 0]) == 60.0 and np.isclose(np.ptp(v[:, 1]), 2e-3)
    assert np.array_equal(np.asarray(jml(256, 16, 8).verts), v)


# ---------------------------------------------------------------------------
# the decoders
# ---------------------------------------------------------------------------

def _refilter(data, ftype):
    """Rewrite a PNG with every scanline under filter ``ftype`` (PIL
    writes only filters 0, 1 and 4)."""
    chunks, pos, ihdr, idat = [], 8, None, b""
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        if tag == b"IDAT":
            idat += body
        else:
            chunks.append((tag, body))
    w, h, _, ctype, _, _, _ = ihdr
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = w * bpp
    px = images._unfilter(zlib.decompress(idat), h, stride, bpp).astype(
        np.int64)
    rows = []
    for y in range(h):
        x, up = px[y], px[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
            f = x - pred
        rows.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
    out = bytearray(data[:8])
    for tag, body in chunks:
        if tag == b"IEND":
            comp = zlib.compress(b"".join(rows))
            out += struct.pack(">I", len(comp)) + b"IDAT" + comp
            out += struct.pack(">I", zlib.crc32(b"IDAT" + comp))
        out += struct.pack(">I", len(body)) + tag + body
        out += struct.pack(">I", zlib.crc32(tag + body))
    return bytes(out)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decoder_matches_pil(mode):
    from PIL import Image
    rs = np.random.RandomState(2)
    yy, xx = np.mgrid[0:23, 0:37]
    img = ((np.stack([xx * 6, yy * 9, (xx + 2 * yy) * 4], -1) % 256)
           + rs.randint(0, 5, (23, 37, 3))).astype(np.uint8)
    im = Image.fromarray(img)
    im = (im.convert("P", palette=Image.ADAPTIVE, colors=61) if mode == "P"
          else im.convert(mode))
    buf = io.BytesIO()
    im.save(buf, "PNG")
    for ftype in range(5):
        data = _refilter(buf.getvalue(), ftype)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = images.decode_png(data)
        assert got.dtype == np.uint8 and np.array_equal(got, ref), ftype
        assert np.array_equal(images.image_pixels(data), ref.astype(
            np.float32))
    # PIL's own filter choice, and a 16-bit image, which PIL decodes
    ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    assert np.array_equal(images.decode_png(buf.getvalue()), ref)
    if mode == "L":
        b16 = io.BytesIO()
        Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(b16, "PNG")
        with pytest.raises(images._NotDecodedHere):
            images.decode_png(b16.getvalue())
        ref = np.asarray(Image.open(io.BytesIO(b16.getvalue())).convert("RGB"))
        assert np.array_equal(images.image_pixels(b16.getvalue()),
                              ref.astype(np.float32))


def test_hdr_reader_matches_cv2(tmp_path):
    import cv2
    rs = np.random.RandomState(7)
    for h, w in ((9, 31), (4, 6)):          # run-length and flat scanlines
        img = (rs.rand(h, w, 3) ** 3 * 40).astype(np.float32)
        img[0, :3] = 0.0
        img[1] = 2.5
        p = tmp_path / f"cv{w}.hdr"
        cv2.imwrite(str(p), img[..., ::-1].copy())
        ref = cv2.imread(str(p), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        got = images.load_hdr_image(p)
        assert got.dtype == np.float32
        assert np.array_equal(got, np.ascontiguousarray(ref[..., ::-1]))
        # the port's writer: cv2 reads it back as the port does
        q = tmp_path / f"own{w}.hdr"
        images.write_hdr(q, img)
        ref = cv2.imread(str(q), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        assert np.array_equal(images.load_hdr_image(q),
                              np.ascontiguousarray(ref[..., ::-1]))
        assert np.abs(images.load_hdr_image(q) - img).max() <= (
            img.max() / 128)


def test_missing_decoders_name_a8b(monkeypatch, tmp_path):
    """Without PIL / cv2, the formats this package does not decode raise
    an ImportError naming ROADMAP item A8b."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name in ("PIL", "cv2"):
            raise ImportError(f"no {name}")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="JPEG.*A8b"):
        images.image_pixels(b"\xff\xd8\xff\xe0" + b"\0" * 16)
    with pytest.raises(ImportError, match="A8b"):
        images.load_hdr_image(tmp_path / "x.exr")
