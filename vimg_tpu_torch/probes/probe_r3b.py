"""What a vector -> scalar any() costs (port of tools/probe_r3b.py's
microbench_sync).

N steps of ``x = x * 1.0000001 + 1e-9`` over a (32, 128) float32 block,
plus per step, by mode: ``novec`` the scalar chain n += x[0, 0] * 1e-12
(no any), ``scalar`` and ``cond`` n += any(x > 0.5) (as a select and as a
branch), ``any8`` eight anys at 0.5 + 0.01 k. Output ``x + n``.

``sync`` is kernel P2 (``csrc/probe_scalar.cu``; the any() is a block-wide
vote, ``__syncthreads_or``) for CUDA tensors and ``sync_plain`` for CPU
tensors. ``microbench_sync`` is the probe: records carry the TPU probe's
keys (probe, mode, us_per_iter, n_any, us_per_any).

The tool's other measurements run the port's own path:

- ``bounce_batches``: the tool's synthetic bounce rays (numpy, the same
  rays from the same seed);
- ``cluster_bounce``: ClusterTracer on those rays over terrain 100k,
  unsorted and Morton-sorted by origin and by direction: us_per_ray, the
  walk's node and triangle steps per warp (``trace_stats``: a warp of 32
  rays is the group that walks together on the card, where the tool
  counted TPU tiles of tile_rows x 128 rays; tile_rows is a TPU knob and
  is dropped), hit_frac;
- ``sort_tax``: argsort and a row gather of a (B, 32) state at 131,072 and
  1,048,576 rays;
- ``wavefront_e2e``: render_wavefront on terrain 100k and the bumpy sphere
  100k at 512x256 @ 8 spp.
``mega_small_rows`` sweeps the TPU megakernel's ``rows``, a TPU knob, and
is not ported. Times are None on the CPU.

Run: ``python -m vimg_tpu_torch.probes.probe_r3b [--device cpu]
[--n-iter N] [--out records.jsonl]``: the kernel probe, then the
leftovers at the tool's sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

MODES = ("novec", "scalar", "cond", "any8")
N_ANY = {"novec": 0, "scalar": 1, "cond": 1, "any8": 8}
SHAPE = (32, 128)
N_ITER = 20000
# the weak-typed constants as XLA rounds them (float32); the any8
# thresholds 0.5 + 0.01 k are computed in double and rounded once
A, B, NOVEC_SCALE = common.f32(1.0000001), common.f32(1e-9), common.f32(1e-12)
THRESHOLDS = [common.f32(0.5 + 0.01 * k) for k in range(8)]


def sync_plain(x, mode, n_iter=N_ITER):
    """Plain version of kernel P2: (32, 128) float32 x -> x_N + n. Every
    element follows the same float32 recurrence, so the steps run on the
    block's distinct values (an any() over them is the any() over the
    block) and the result is scattered back."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({MODES})")
    v, inv = torch.unique(x, return_inverse=True)
    first = inv.reshape(-1)[0]                 # x[0, 0] among the values
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    thr = torch.tensor(THRESHOLDS, dtype=torch.float32, device=x.device)
    for _ in range(n_iter):
        v = v * A + B
        if mode == "novec":
            n = n + v[first] * NOVEC_SCALE
        elif mode in ("scalar", "cond"):
            n = n + (v > 0.5).any().to(torch.float32)
        else:
            # eight 0/1 terms: their float32 sum is exact in any order
            n = n + (v[:, None] > thr).any(0).to(torch.float32).sum()
    return v[inv] + n


def sync(x, mode, n_iter=N_ITER):
    """Kernel P2 on a CUDA tensor, sync_plain on a CPU tensor.

    Replaces tools/probe_r3b.py::microbench_sync (pallas_call :68). One
    block of 1024 threads, 4 elements each; every any() is one
    __syncthreads_or over the block. Bounded by the latency of the serial
    chain and its barriers (a latency probe)."""
    if not common.on_card(x):
        return sync_plain(x, mode, n_iter)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({MODES})")
    if not 0 <= n_iter < 2 ** 31:
        raise ValueError(f"n_iter {n_iter} out of range")
    common.check_tensor(x, "x", torch.float32, SHAPE, x.device)
    out = torch.empty(SHAPE, dtype=torch.float32, device=x.device)
    common.launch("probe_sync", "vimg_probe_sync", x.device, x,
                  MODES.index(mode), n_iter, out)
    return out


def microbench_sync(device="cuda", n_iter=N_ITER, log=None):
    """The probe: each mode on x = 0.1 everywhere; logs (mode, us_per_iter,
    n_any, us_per_any) per mode (device times; None on the CPU). Returns
    (x, {mode: (out, ms per launch)})."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    x = torch.full(SHAPE, 0.1, dtype=torch.float32, device=dev)
    res = {}
    for mode in MODES:
        out = sync(x, mode, n_iter)
        ms = (common.device_ms(lambda: sync(x, mode, n_iter))
              if dev.type == "cuda" else None)
        per = None if ms is None else ms * 1e3 / n_iter
        log(probe="sync", mode=mode, n_iter=n_iter, us_per_iter=per,
            n_any=N_ANY[mode],
            us_per_any=None if per is None else per / max(N_ANY[mode], 1))
        res[mode] = (out, ms)
    return x, res


def bounce_batches(scene, B=131072, seed=0):
    """Synthetic bounce rays: origins on random mesh surface points,
    cosine-hemisphere directions about the face normal (the tool's numpy,
    tools/probe_r3b.py:84-110). Returns (ro, rd) float32 on the scene's
    device."""
    rs = np.random.RandomState(seed)
    verts = scene.verts.detach().cpu().numpy()
    tv = scene.tri_vidx.cpu().numpy()
    tid = rs.randint(0, tv.shape[0], B)
    p = verts[tv[tid]]
    u = rs.rand(B, 2)
    su = np.sqrt(u[:, 0:1])
    bary = np.concatenate([1 - su, su * (1 - u[:, 1:2]), su * u[:, 1:2]], 1)
    ro = (p * bary[:, :, None]).sum(1)
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    r1, r2 = rs.rand(B), rs.rand(B)
    st = np.sqrt(r1)
    phi = 2 * np.pi * r2
    lx, ly = st * np.cos(phi), st * np.sin(phi)
    lz = np.sqrt(np.maximum(1 - r1, 0))
    up = np.where(np.abs(fn[:, 2:3]) < 0.9,
                  np.array([[0, 0, 1.0]]), np.array([[1.0, 0, 0]]))
    t1 = np.cross(up, fn)
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
    t2 = np.cross(fn, t1)
    rd = (t1 * lx[:, None] + t2 * ly[:, None] + fn * lz[:, None])
    ro = ro + fn * 1e-4
    dev = scene.device
    return (torch.from_numpy(ro.astype(np.float32)).to(dev),
            torch.from_numpy(rd.astype(np.float32)).to(dev))


def cluster_bounce(device="cuda", n_tris=100_000, B=131072, log=None):
    """The tool's bounce_trace over the port's ClusterTracer (sort none /
    origin / dir); logs us_per_ray, the mean node and triangle steps per
    warp, n_warps and hit_frac per mode. Returns {mode: record}."""
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    scene = terrain_scene(n_tris, 512, 256, device=dev)
    ro, rd = bounce_batches(scene, B)
    minT = torch.full((B,), 1e-4, device=dev)
    maxT = torch.full((B,), float("inf"), device=dev)
    res, data = {}, None
    for mode in ("none", "origin", "dir"):
        tr = ClusterTracer(scene, sort_rays=mode != "none",
                           sort_mode="origin" if mode == "none" else mode,
                           data=data)
        data = tr.data
        tr.closest(scene, ro, rd, minT, maxT)                # warm
        dt, hr = common.host_seconds(
            lambda: tr.closest(scene, ro, rd, minT, maxT), dev)
        st = tr.trace_stats(ro, rd, minT, maxT)
        card = dev.type == "cuda"
        res[mode] = log(
            probe="bounce_trace", sort=mode, walk=tr.walk, rays=B,
            us_per_ray=dt / B * 1e6 if card else None,
            secs=dt if card else None,
            visits_per_warp=float(st[:, 0].mean()),
            tri_steps_per_warp=float(st[:, 1].mean()),
            n_warps=int(st.shape[0]),
            hit_frac=float(hr.hit.float().mean()))
    return res


def sort_tax(device="cuda", sizes=(131072, 1048576), log=None):
    """The tool's rebinning tax: argsort of B random int32 keys and the
    gather of a (B, 32) float32 state by the permutation; logs the device
    ms per call (None on the CPU). Returns {B: (key, state, out)}."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    res = {}
    for B in sizes:
        key = torch.from_numpy(np.random.RandomState(0).randint(
            0, 1 << 30, B).astype(np.int32)).to(dev)
        state = torch.from_numpy(np.random.RandomState(1).rand(
            B, 32).astype(np.float32)).to(dev)

        def f():
            return torch.index_select(state, 0, torch.argsort(key))
        out = f()
        ms = common.device_ms(f) if dev.type == "cuda" else None
        log(probe="sort_tax", B=B, ms=ms)
        res[B] = (key, state, out)
    return res


def wavefront_e2e(device="cuda", n_tris=100_000, size=(512, 256), spp=8,
                  log=None):
    """The tool's wavefront frames: terrain and the bumpy sphere (n_tris
    each) at ``size`` @ ``spp`` MIS, batch 2^17, over ClusterTracer; the
    second of two renders is timed. Logs mpaths, secs (None on the CPU)
    and the image mean. Returns {scene: image}."""
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.render.wavefront import render_wavefront
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import (bumpy_sphere_scene,
                                                terrain_scene)
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    W, H = size
    res = {}
    for name, make in (("terrain", terrain_scene),
                       ("bumpy", bumpy_sphere_scene)):
        scene = make(n_tris, W, H, device=dev)
        st = ir.RenderSettings(W, H, spp=spp, max_depth=64,
                               integrator="mis", batch_size=1 << 17)
        tr = ClusterTracer(scene)
        render_wavefront(scene, st, tracer=tr)
        dt, img = common.host_seconds(
            lambda: render_wavefront(scene, st, tracer=tr), dev)
        card = dev.type == "cuda"
        log(probe="wavefront_e2e", scene=f"{name}{n_tris}",
            mpaths=W * H * spp / dt / 1e6 if card else None,
            secs=dt if card else None, mean=float(img.mean()))
        res[name] = img
    return res


def main(argv=None):
    args = common.parse_args(__doc__, argv, (
        ("--n-iter", dict(type=int, default=N_ITER)),))
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    microbench_sync(dev, args.n_iter, log)
    sort_tax(dev, log=log)
    cluster_bounce(dev, log=log)
    wavefront_e2e(dev, log=log)


if __name__ == "__main__":
    main()
