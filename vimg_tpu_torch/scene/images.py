"""Image decoding for the scene loaders, without PIL or OpenCV where it
can: the port decodes 8-bit PNG and Radiance ``.hdr`` itself (``zlib`` +
numpy), so the glTF and Mitsuba loaders run on a machine that has
neither. Everything else goes through the library vimg_tpu uses: JPEG,
16-bit, sub-byte and interlaced PNG through PIL, OpenEXR through cv2;
where that library is missing, ``ImportError`` names the format (decoding
them here is ROADMAP item A8b).

- ``decode_png(data)``: (H, W, 3) uint8, what PIL's ``convert("RGB")``
  gives (grey replicated, alpha dropped, palette looked up);
- ``read_hdr(data)``: (H, W, 3) float32 linear RGB, what
  ``cv2.imread(path, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` gives after its
  BGR -> RGB flip (flat and new-style run-length scanlines);
- ``image_pixels(data)``: any supported texture as (H, W, 3) float32 in
  [0, 255]; ``load_hdr_image(path)``: an env map as linear float32;
- ``write_hdr(path, img)``: a run-length ``.hdr`` writer (tests, smoke).
"""
from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples


class _NotDecodedHere(Exception):
    """A valid image this module leaves to PIL / cv2."""


def _unfilter(raw, height, stride, bpp):
    """Undo the PNG scanline filters (types 0-4) of ``raw``: ``height``
    rows of a filter byte and ``stride`` bytes."""
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)]
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # Sub: a running sum mod 256 over each byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = _unfilter_seq(line.tolist(), prior.tolist(), bpp, ftype)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def _unfilter_seq(line, prior, bpp, ftype):
    """Average (3) and Paeth (4), byte by byte (each depends on the byte
    one pixel to its left)."""
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG of any colour type -> (H, W, 3) uint8 as
    PIL's ``convert("RGB")``. Raises ``_NotDecodedHere`` for 16-bit,
    sub-byte and interlaced images."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, ihdr = 8, [], None, None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace != 0:
        raise _NotDecodedHere(f"{depth}-bit PNG, interlace {interlace}")
    nch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * nch, nch)
    px = px.reshape(height, width, nch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)     # missing entries: black
        full[:palette.shape[0]] = palette
        return full[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _pil_rgb(data: bytes, what):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {what} needs PIL, which is not installed: this "
            f"package decodes 8-bit PNG itself; other formats without PIL "
            f"are ROADMAP item A8b") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def image_pixels(data: bytes) -> np.ndarray:
    """A texture's encoded bytes -> (H, W, 3) float32 in [0, 255]."""
    if data[:8] == PNG_SIGNATURE:
        try:
            return decode_png(data).astype(np.float32)
        except _NotDecodedHere as e:
            return _pil_rgb(data, f"PNG ({e})").astype(np.float32)
    what = "JPEG" if data[:3] == b"\xff\xd8\xff" else "this image format"
    return _pil_rgb(data, what).astype(np.float32)


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE)
# ---------------------------------------------------------------------------

def _rgbe_to_float(rgbe):
    """(..., 4) uint8 RGBE -> (..., 3) float32 as OpenCV's rgbe2float:
    channel x 2^(e - 136), zero where e == 0."""
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    f = np.where(e > 0, f, np.float32(0.0))
    return rgbe[..., :3].astype(np.float32) * f[..., None]


def _read_scanline(buf, pos, width):
    """One scanline -> ((width, 4) uint8, next position)."""
    if (width < 8 or width > 0x7FFF or buf[pos] != 2 or buf[pos + 1] != 2
            or buf[pos + 2] & 0x80):
        flat = np.frombuffer(buf, np.uint8, count=4 * width, offset=pos)
        if width and flat[0] == 1 and flat[1] == 1 and flat[2] == 1:
            raise ValueError(".hdr: old-style run-length scanlines are not "
                             "supported")
        return flat.reshape(width, 4), pos + 4 * width
    if (buf[pos + 2] << 8 | buf[pos + 3]) != width:
        raise ValueError(".hdr: scanline width mismatch")
    pos += 4
    line = np.empty((4, width), np.uint8)
    for ch in range(4):
        x = 0
        while x < width:
            count = buf[pos]
            if count > 128:
                count -= 128
                line[ch, x:x + count] = buf[pos + 1]
                pos += 2
            else:
                if count == 0 or x + count > width:
                    raise ValueError(".hdr: bad scanline run")
                line[ch, x:x + count] = np.frombuffer(
                    buf, np.uint8, count=count, offset=pos + 1)
                pos += 1 + count
            x += count
        if x != width:
            raise ValueError(".hdr: scanline overrun")
    return line.T, pos


def read_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE bytes ("-Y H +X W" orientation) -> (H, W, 3) float32
    RGB."""
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    pos = data.index(b"\n\n") + 2
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f".hdr: unsupported orientation {res!r}")
    height, width = int(res[1]), int(res[3])
    pos = end + 1
    img = np.empty((height, width, 4), np.uint8)
    for y in range(height):
        img[y], pos = _read_scanline(data, pos, width)
    return _rgbe_to_float(img)


def load_hdr_image(path):
    """An env map (.hdr here, anything else through cv2 as vimg_tpu) as
    linear (H, W, 3) float32 RGB."""
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        return read_hdr(path.read_bytes())
    import os
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading {path.suffix or 'this'} images needs cv2, which is not "
            f"installed: this package reads Radiance .hdr itself; OpenEXR "
            f"without cv2 is ROADMAP item A8b") from e
    img = cv2.imread(str(path), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    if img is None:
        raise IOError(f"could not read HDR image {path}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., ::-1].astype(np.float32))


def _float_to_rgbe(img):
    img = np.asarray(img, np.float32)
    v = img.max(axis=-1)
    m, e = np.frexp(v)
    ok = v >= 1e-32
    scale = np.where(ok, m * 256.0 / np.where(ok, v, 1.0), 0.0)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(ok, e + 128, 0).astype(np.uint8)
    return out


def _rle_channel(row):
    """New-style run-length bytes of one channel of a scanline."""
    out, n, i = bytearray(), len(row), 0
    while i < n:
        j = i
        while j < n and j - i < 127 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes((128 + j - i, row[i]))
            i = j
            continue
        k = i                        # a literal run up to the next repeat
        while k < n and k - i < 128 and not (
                k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        out += bytes((k - i,)) + bytes(row[i:k])
        i = k
    return out


def write_hdr(path, img):
    """Write (H, W, 3) float32 linear RGB as a run-length Radiance .hdr."""
    rgbe = _float_to_rgbe(img)
    height, width = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {height} +X {width}\n".encode()
    for y in range(height):
        if 8 <= width <= 0x7FFF:
            out += bytes((2, 2, width >> 8, width & 0xFF))
            for ch in range(4):
                out += _rle_channel(rgbe[y, :, ch].tolist())
        else:
            out += rgbe[y].tobytes()
    Path(path).write_bytes(bytes(out))
