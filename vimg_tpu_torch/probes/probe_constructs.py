"""Which kernel constructs build and run (port of tools/probe_constructs.py,
steps 1-3).

Over 8 clusters of an (8, 8) box table, an (8, 128) tile of rays x = 1:

- ``k1``: ``acc += aabb[c, 0] * x``, a loop with dynamic scalar reads
  (kernel P29);
- ``k2``: k1 plus a copy of cluster c's (8, 16) triangle block into a
  buffer a step; adds ``buf[0, 0]`` (kernel P30);
- ``k3``: the copy in flight across the live test ``aabb[c, 0] * x < 5``,
  then a branch on any(live) around an unrolled 8-triangle accumulate
  ``acc += buf[k, 0] * where(live, x, 0)`` (kernel P31).

The tool's step 4 only calls the cluster tracer, whose kernels are B3/B4.
The inputs are the tool's: aabb = arange(64), tris = arange(1024) * 1e-3,
x = 1. ``run`` logs the tool's keys (name, ok, sum) with the time of each
kernel's call.

Run: ``python -m vimg_tpu_torch.probes.probe_constructs [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.probes import common

R, L, C, K = 8, 128, 8, 8          # rows, lanes, clusters, tris a cluster
NAMES = {1: "1 fori+dyn-smem-read", 2: "2 +dma-any", 3: "3 +cond-unroll"}
LAUNCH_NAMES = {1: "probe_k1", 2: "probe_k2", 3: "probe_k3"}


def inputs(device="cpu"):
    """(aabbs (8, 8), tris (64, 16), rays (8, 128)) as the tool builds
    them."""
    aabbs = torch.arange(C * 8, dtype=torch.float32,
                         device=device).reshape(C, 8)
    tris = torch.arange(C * K * 16, dtype=torch.float32,
                        device=device).reshape(C * K, 16) * common.f32(1e-3)
    return aabbs, tris, torch.ones((R, L), dtype=torch.float32, device=device)


def constructs_plain(aabbs, tris, rays, which):
    """Plain version of kernels P29-P31 (``which`` 1, 2, 3)."""
    acc = torch.zeros((R, L), dtype=torch.float32, device=rays.device)
    for c in range(C):
        s = aabbs[c, 0]
        buf = tris[c * K:(c + 1) * K]
        if which < 3:
            acc = acc + s * rays
            if which == 2:
                acc = acc + buf[0, 0]
            continue
        live = s * rays < 5.0
        if bool(live.any()):
            for k in range(K):
                acc = acc + buf[k, 0] * torch.where(live, rays, 0.0)
    return acc


def constructs(aabbs, tris, rays, which):
    """Kernel P29, P30 or P31 on CUDA tensors, constructs_plain on CPU
    tensors.

    Replaces tools/probe_constructs.py k1 (pallas_call :39), k2 (:55) and
    k3 (:79). One block of 128 threads, 8 rows each; the box table in
    shared memory (a dynamic read every thread makes at one address); the
    triangle block by cp.async (32 threads x 16 bytes) into shared memory,
    waited on before use; any(live) is one __syncthreads_or. Bounded by
    launch latency."""
    if which not in NAMES:
        raise ValueError(f"which is 1, 2 or 3 (got {which})")
    if not common.on_card(rays):
        return constructs_plain(aabbs, tris, rays, which)
    dev = rays.device
    common.check_tensor(aabbs, "aabbs", torch.float32, (C, 8), dev)
    common.check_tensor(tris, "tris", torch.float32, (C * K, 16), dev)
    common.check_tensor(rays, "rays", torch.float32, (R, L), dev)
    if tris.data_ptr() % 16:
        raise ValueError("tris must start on a 16-byte boundary (cp.async)")
    out = torch.empty((R, L), dtype=torch.float32, device=dev)
    common.launch(LAUNCH_NAMES[which], "vimg_probe_constructs", dev, aabbs,
                  tris, rays, which, out)
    return out


def run(device="cuda", log=None):
    """The three steps on the tool's inputs; logs (name, ok, sum, us).
    Returns ((aabbs, tris, rays), {which: (out, ms)})."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    args = inputs(dev)
    res = {}
    for which, name in NAMES.items():
        out = constructs(*args, which)
        ms = (common.device_ms(lambda: constructs(*args, which))
              if dev.type == "cuda" else None)
        log(probe="constructs", name=name,
            ok=bool(torch.isfinite(out).all()), sum=float(out.sum()),
            us=None if ms is None else ms * 1e3)
        res[which] = (out, ms)
    return args, res


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    run(dev, common.Log(dev, args.out))


if __name__ == "__main__":
    main()
