"""The packet kernel built up construct by construct (port of
tools/probe_r4c.py).

Per workgroup, an (8, 128) block of ``xt`` (lane column c * 16 + p holds
ray component c = ox oy oz dx dy dz minT maxT of the 8 rays of packet p),
an (8, 128) block of ``meta`` (row 0 cluster ids, row 1 packet masks,
row 2 lane 0 the chain length) and the whole triangle table ``tri``
(12 constant rows of 128 lanes per cluster):

  stage 0  setup: sum over packets of (ox + maxT) per row, every lane
  stage 1  + the chain loop: each entry's 12 constant rows summed, plus its
           packet mask
  stage 2  + one unconditional triangle test of packet 0 per entry:
           (bt, code) per (ray, lane), output bt + code
  stage 3  + the test gated by bit 0 of the packet mask
  stage 4  n_packets packets, each gated by its bit, (bt, code) per (ray,
           lane) reduced at the end: the least bt over the lanes into lane
           p, the least code at it into lane 16 + p

``packet_stage`` is kernel P11 (``csrc/probe_packet_stages.cu``) for CUDA
tensors and ``packet_stage_plain`` for CPU tensors. ``run_stage`` is the
probe, on the TPU probe's own inputs (RandomState(0), 8 workgroups, 40
chain entries); records carry its keys (stage, n_packets, ok, mean) and
the launch time ``ms`` where it has the compile time. Cluster ids are
clamped into the table and the chain length into [0, 128] by kernel and
plain version alike.

Run: ``python -m vimg_tpu_torch.probes.probe_r4c [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

W, CP, NTRI_ROWS = 8, 128, 64 * 12
N_CONST = 12
STAGES = (0, 1, 2, 3, 4)
MAX_PACKETS = 16


def _test(q, ray, bt):
    """The probe's triangle test: q (..., 12, 128) constants, ray
    components (..., 8, 1) each; returns (t, hit below bt)."""
    ox, oy, oz, dx, dy, dz, mnt = ray
    nx, ny, nz, d0, m1x, m1y, m1z, c1, m2x, m2y, m2z, c2 = q.unbind(-2)
    nx, ny, nz, d0, m1x, m1y, m1z, c1, m2x, m2y, m2z, c2 = (
        v[..., None, :] for v in (nx, ny, nz, d0, m1x, m1y, m1z, c1, m2x,
                                  m2y, m2z, c2))
    ro_n = ox * nx + oy * ny + oz * nz
    rd_n = dx * nx + dy * ny + dz * nz
    par = rd_n.abs() < 1e-22
    t = (d0 - ro_n) / torch.where(par, 1.0, rd_n)
    u = (ox * m1x + oy * m1y + oz * m1z - c1
         + t * (dx * m1x + dy * m1y + dz * m1z))
    v = (ox * m2x + oy * m2y + oz * m2z - c2
         + t * (dx * m2x + dy * m2y + dz * m2z))
    hit = (~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= mnt)
           & (t < bt))
    return t, hit


def packet_stage_plain(xt, meta, tri, stage, n_packets=MAX_PACKETS):
    """Plain version of kernel P11: the TPU kernel's per-lane state
    vectorised over workgroups (and packets). Returns (n_work * 8, 128)
    float32."""
    _check_stage(stage, n_packets)
    dev = xt.device
    n_work = xt.shape[0] // 8
    x = xt.view(n_work, 8, 128)
    m = meta.view(n_work, 8, CP).to(torch.int64)
    n_cl = tri.shape[0] // N_CONST
    consts = tri.view(n_cl, N_CONST, 128)
    P = n_packets
    comp = torch.arange(8, device=dev)[:, None] * 16 + torch.arange(
        P, device=dev)
    # (W, P, component, ray)
    ray = x[:, :, comp].permute(0, 3, 2, 1)
    lane = torch.arange(128, device=dev)
    if stage == 0:
        acc = torch.zeros((n_work, 8), device=dev)
        for p in range(P):
            acc = acc + ray[:, p, 0] + ray[:, p, 7]
        return acc[..., None].expand(n_work, 8, 128).reshape(-1, 128)
    count = m[:, 2, 0].clamp(0, CP)
    cl = m[:, 0].clamp(0, n_cl - 1)
    pm = m[:, 1] & 0xFFFFFFFF                  # shifted as uint32
    steps = int(count.max()) if n_work else 0
    if stage == 1:
        acc = torch.zeros((n_work, 128), device=dev)
        for i in range(steps):
            q = consts[cl[:, i]]
            s = q[:, 0]
            for j in range(1, N_CONST):
                s = s + q[:, j]
            new = acc + s * 1.0 + m[:, 1, i].to(torch.float32)[:, None]
            acc = torch.where((i < count)[:, None], new, acc)
        return acc[:, None].expand(n_work, 8, 128).reshape(-1, 128)
    npk = 1 if stage in (2, 3) else P
    # per (workgroup, packet, ray, lane); ray components (W, npk, 8, 1)
    comps = [ray[:, :npk, c, :, None] for c in range(8)]
    bt = comps[7].expand(n_work, npk, 8, 128).clone()
    code = torch.full_like(bt, -1.0)
    bits = torch.arange(npk, device=dev)
    for i in range(steps):
        c = cl[:, i]
        live = (i < count)[:, None].expand(n_work, npk)
        if stage != 2:
            live = live & (((pm[:, i, None] >> bits) & 1) > 0)
        t, hit = _test(consts[c][:, None], comps[:7], bt)
        hit = hit & live[..., None, None]
        cbase = (c * 128).to(torch.float32)[:, None, None, None]
        bt = torch.where(hit, t, bt)
        code = torch.where(hit, cbase + lane.to(torch.float32), code)
    if stage in (2, 3):
        return (bt + code)[:, 0].reshape(-1, 128)
    btmin = bt.amin(-1, keepdim=True)
    kcode = torch.where(bt == btmin, code, float("inf")).amin(-1,
                                                             keepdim=True)
    out = torch.zeros((n_work, 8, 128), device=dev)
    for p in range(P):
        out = out + torch.where(lane == p, btmin[:, p], 0.0)
        out = out + torch.where(lane == 16 + p, kcode[:, p], 0.0)
    return out.reshape(-1, 128)


def _check_stage(stage, n_packets):
    if stage not in STAGES or not 1 <= n_packets <= MAX_PACKETS:
        raise ValueError(f"stage {stage} / n_packets {n_packets}: stages "
                         f"{STAGES}, 1 to {MAX_PACKETS} packets")


def packet_stage(xt, meta, tri, stage, n_packets=MAX_PACKETS):
    """Kernel P11 on CUDA tensors, packet_stage_plain on CPU tensors.

    Replaces tools/probe_r4c.py::make_kernel (pallas_call in run_stage
    :158). One 128-thread block per workgroup; stages 0-3 a thread per
    lane, stage 4 a thread per ray with kernel B5's 128-bit lane-mask tie
    rule (equal to the per-lane rule). Bounded by launch latency and the
    serial chain (a latency probe)."""
    if not common.on_card(xt):
        return packet_stage_plain(xt, meta, tri, stage, n_packets)
    _check_stage(stage, n_packets)
    dev = xt.device
    if xt.dim() != 2 or xt.shape[0] % 8 or tri.dim() != 2 \
            or tri.shape[0] % N_CONST or tri.shape[0] == 0:
        raise ValueError(f"xt {tuple(xt.shape)} / tri {tuple(tri.shape)}: "
                         f"expected (n * 8, 128) and (c * 12, 128)")
    common.check_tensor(xt, "xt", torch.float32, (xt.shape[0], 128), dev)
    common.check_tensor(meta, "meta", torch.int32, (xt.shape[0], CP), dev)
    common.check_tensor(tri, "tri", torch.float32, (tri.shape[0], 128), dev)
    out = torch.empty((xt.shape[0], 128), dtype=torch.float32, device=dev)
    if xt.shape[0]:
        common.launch("probe_packet_stages", "vimg_probe_packet_stage", dev,
                      xt, meta, tri, xt.shape[0] // 8,
                      tri.shape[0] // N_CONST, stage, n_packets, out)
    return out


def stage_inputs(device):
    """The TPU probe's inputs, drawn in its order: xt (64, 128), meta
    (64, 128) (cluster ids below 60, 16-bit packet masks, 40 entries), tri
    (768, 128)."""
    rs = np.random.RandomState(0)
    xt = rs.rand(W * 8, 128).astype(np.float32)
    meta = np.zeros((W, 8, CP), np.int32)
    meta[:, 0, :] = rs.randint(0, 60, (W, CP))
    meta[:, 1, :] = rs.randint(0, 1 << 16, (W, CP))
    meta[:, 2, 0] = 40
    tri = rs.rand(NTRI_ROWS, 128).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (xt, meta.reshape(W * 8, CP), tri))


def run_stage(stage, n_packets=MAX_PACKETS, device="cuda", log=None):
    """The probe for one stage: logs (stage, n_packets, ok, ms per launch
    (None on the CPU), mean). Returns (inputs, out, ms)."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    args = stage_inputs(dev)
    out = packet_stage(*args, stage, n_packets)
    ms = (common.device_ms(lambda: packet_stage(*args, stage, n_packets))
          if dev.type == "cuda" else None)
    log(stage=stage, n_packets=n_packets, ok=True, ms=ms,
        mean=float(out.mean()))
    return args, out, ms


RUNS = ((0, 16), (1, 16), (2, 16), (3, 16), (4, 1), (4, 4), (4, 16))


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for stage, n_packets in RUNS:
        run_stage(stage, n_packets, dev, log)


if __name__ == "__main__":
    main()
