"""Accumulation-buffer checkpoints for long renders (port of
vimg_tpu.render.checkpoint).

The radiance of sample s of pixel p depends only on (p, s), so a
checkpoint is the accumulated film and the samples done. A render
proceeds in sample slabs (each with its ``sample_offset``); after each
slab the checkpoint file is replaced atomically. The file has vimg_tpu's
layout (an ``.npz`` of ``accum``, ``spp_done`` and ``digest``), and the
digest hashes the bytes vimg_tpu's hashes (the scene's arrays in
vimg_tpu's dtypes), so either package resumes the other's checkpoint of
the same scene and settings.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile

import numpy as np
import torch

from vimg_tpu_torch.core.math import div

# the scene arrays the digest hashes, in vimg_tpu's dtypes
_DIGEST_ARRAYS = (("verts", np.float32), ("tri_vidx", np.int32),
                  ("sph_center", np.float32), ("sph_radius", np.float32),
                  ("mat_base", np.float32), ("mat_scalars", np.float32),
                  ("light_type", np.int32), ("light_idx", np.int32))


def save_checkpoint(path, accum, spp_done, meta=None):
    """Atomic write of the accumulation state (``accum`` a tensor or an
    array)."""
    if isinstance(accum, torch.Tensor):
        accum = accum.detach().cpu().numpy()
    d = os.path.dirname(os.path.abspath(path)) or "."
    # the suffix ends in .npz so that np.savez writes into tmp itself
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, accum=np.asarray(accum), spp_done=np.int64(spp_done),
                 **(meta or {}))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path):
    """``dict(accum, spp_done[, digest])`` (numpy) or None without a
    file."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        out = dict(accum=z["accum"], spp_done=int(z["spp_done"]))
        if "digest" in z.files:
            out["digest"] = str(z["digest"])
        return out


def _takes_megakernel(scene, settings, use_wavefront):
    """Whether a slab of these settings goes to the megakernel: the
    port's dispatch rule (``render.megakernel_takes``, CUDA scenes only),
    read by both ``render_with_checkpoints`` (whether to build a tracer)
    and ``_render_slab``."""
    from vimg_tpu_torch.render.render import megakernel_takes
    return (use_wavefront and scene.device.type == "cuda"
            and megakernel_takes(scene, settings))


def _render_digest(scene, settings, use_wavefront, slab_spp):
    """Fingerprint of (scene, settings, renderer path), vimg_tpu's bytes:
    the settings without spp (a larger sample target resumes), the path a
    slab of ``slab_spp`` takes, the scene's arrays."""
    h = hashlib.sha256()
    h.update(repr(dataclasses.astuple(
        dataclasses.replace(settings, spp=0))).encode())
    slab = dataclasses.replace(settings, spp=slab_spp)
    h.update(b"mega" if _takes_megakernel(scene, slab, use_wavefront)
             else b"wavefront")
    for name, dtype in _DIGEST_ARRAYS:
        arr = getattr(scene, name, None)
        if arr is not None:
            arr = arr.detach().cpu().numpy().astype(dtype, copy=False)
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


def render_with_checkpoints(scene, settings, path, slab_spp=16, tracer=None,
                            progress=False, use_wavefront=True, stats=None):
    """Render in sample slabs of ``slab_spp``, checkpointing to ``path``
    after each; resumes from a checkpoint there (a digest of another
    scene, settings or path raises ``ValueError``). Returns the linear
    (H, W, 3) image on the scene's device. ``stats`` (a dict) gets the
    slabs' summed ``segments`` and ``shadow_rays`` and their ``slabs``."""
    slab_st = dataclasses.replace(settings, spp=slab_spp)
    # one tracer for every slab, and none where the megakernel takes them
    if tracer is None and not _takes_megakernel(scene, slab_st,
                                                use_wavefront):
        from vimg_tpu_torch.geometry.trace import make_tracer
        tracer = make_tracer(scene)
    W, H = settings.width, settings.height
    total_spp = settings.spp
    digest = _render_digest(scene, settings, use_wavefront, slab_spp)

    accum = torch.zeros((H, W, 3), dtype=torch.float32, device=scene.device)
    done = 0
    ck = load_checkpoint(path)
    if ck is not None and ck["accum"].shape == tuple(accum.shape):
        if ck.get("digest") not in (None, digest):
            raise ValueError(
                f"checkpoint {path} was written by a different "
                f"scene/settings/renderer (digest {ck['digest']} != "
                f"{digest}); delete it or change the path")
        accum = torch.from_numpy(ck["accum"].astype(np.float32)).to(
            scene.device)
        done = min(ck["spp_done"], total_spp)
        if progress:
            print(f"resumed at {done}/{total_spp} spp")

    while done < total_spp:
        n = min(slab_spp, total_spp - done)
        slab = dataclasses.replace(settings, spp=n)
        # sample ids shifted so that slab k continues the RNG streams
        img = _render_slab(scene, slab, tracer, sample_offset=done,
                           use_wavefront=use_wavefront, stats=stats)
        accum += img * n
        done += n
        save_checkpoint(path, accum, done, meta=dict(digest=digest))
        if progress:
            print(f"checkpoint: {done}/{total_spp} spp")
    return div(accum, max(total_spp, 1))


def _render_slab(scene, settings, tracer, sample_offset=0,
                 use_wavefront=True, stats=None):
    """One sample slab through the path ``render_frame`` would take."""
    from vimg_tpu_torch.render.render import render
    from vimg_tpu_torch.render.wavefront import render_wavefront
    want = stats is not None
    if _takes_megakernel(scene, settings, use_wavefront):
        from vimg_tpu_torch.render.mega import render_megakernel
        out = render_megakernel(scene, settings, sample_offset=sample_offset,
                                return_stats=want)
    elif use_wavefront and settings.integrator == "mis":
        out = render_wavefront(scene, settings, tracer=tracer,
                               sample_offset=sample_offset,
                               return_stats=want)
    else:
        slab = {"segments": 0, "shadow_rays": 0}
        out = render(scene, settings, tracer=tracer,
                     sample_offset=sample_offset, stats=slab)
        out = (out, slab) if want else out
    if not want:
        return out
    img, st = out
    for k in ("segments", "shadow_rays"):
        stats[k] = stats.get(k, 0) + int(st[k])
    stats["slabs"] = stats.get("slabs", 0) + 1
    return img
