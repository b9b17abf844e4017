"""The constructs the megakernel needs, checked on the card (port of
tools/probe_pallas.py).

- ``t_grid``: a 4-step grid writing ``col + 1000 g`` into (8, 256) blocks
  (kernel P23);
- ``t_while``: ``while max(v) < 100 and it < 1000: v = v * 1.1 + 0.01``
  over an (8, 128) tile of 0.5 (kernel P24);
- ``t_pcg``: ``r1 + 2 r2 + 4 r3 + 8 r4`` of ``uniform4(pixel = lane,
  sample = row, 3, 7)``, bit for bit against ``core.rng.uniform4``
  (kernel P25);
- ``t_scalars``: the sum of six static-index scalars of a (2, 12) table
  (kernel P26);
- ``t_transcendental``: sin + cos + sqrt + log + exp + atan2 + pow,
  within rtol 1e-4 of float64 (kernel P27; CUDA's sinf and the others are
  not correctly rounded);
- ``t_throughput``: a ~60-flop body (one rsqrt, written 1 / sqrt, and one
  select), 2,000 steps over 16 grid steps of (64, 128) lanes (kernel P28),
  at the probe's 131,072 lanes and on the full card.

Each check logs the tool's verdict (``ok``) and the time of the kernel's
call; a kernel that fails to build or launch raises. The kernels are in
``csrc/probe_lowering.cu``; each wrapper takes its plain version for CPU
tensors.

Run: ``python -m vimg_tpu_torch.probes.probe_pallas [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.core import rng
from vimg_tpu_torch.core.math import sqrt_cr
from vimg_tpu_torch.probes import common

LS, LANES = 8, 128
TILE = (LS, LANES)
TP_ROWS, TP_STEPS, TP_ITERS = 64, 16, 2000
TP_SHAPE = (TP_STEPS * TP_ROWS, LANES)
TP_BLOCKS = TP_SHAPE[0] * LANES // 1024     # 1,024 lanes a block
TP_FLOPS_PER_ITER = 60                      # the tool's count
F = common.f32


def _out(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# P23-P27: one tile each
# ---------------------------------------------------------------------------

def grid_plain(device="cpu"):
    """Plain version of kernel P23: (32, 256) of col + 1000 g."""
    col = torch.arange(256, dtype=torch.float32, device=device)
    g = torch.arange(4, dtype=torch.float32, device=device) * 1000.0
    return (col[None, None, :] + g[:, None, None]).expand(4, 8, 256) \
        .reshape(32, 256)


def grid(device):
    """Kernel P23 on the card, grid_plain on the CPU.

    Replaces tools/probe_pallas.py::t_grid (pallas_call :54): 4 blocks
    of 256 threads, a block a grid step. Bounded by launch latency."""
    dev = torch.device(device)
    if not common.on_card(torch.empty(0, device=dev)):
        return grid_plain(dev)
    out = _out((32, 256), dev)
    common.launch("probe_grid", "vimg_probe_grid", dev, out)
    return out


def while_plain(x):
    """Plain version of kernel P24."""
    v, it = x, 0
    while bool(v.max() < 100.0) and it < 1000:
        v = v * F(1.1) + F(0.01)
        it += 1
    return v + float(it) * 0.0


def while_loop(x):
    """Kernel P24 on a CUDA tensor, while_plain on a CPU tensor.

    Replaces tools/probe_pallas.py::t_while (pallas_call :81): one block
    of 128 threads, 8 rows each; the loop's max-reduction condition is one
    __syncthreads_or a step. Bounded by the serial loop (latency)."""
    if not common.on_card(x):
        return while_plain(x)
    common.check_tensor(x, "x", torch.float32, TILE, x.device)
    out = _out(TILE, x.device)
    common.launch("probe_while", "vimg_probe_while", x.device, x, out)
    return out


def pcg_plain(device="cpu"):
    """Plain version of kernel P25, on core.rng.uniform4."""
    pix = torch.arange(LANES, dtype=torch.int32, device=device).expand(TILE)
    samp = torch.arange(LS, dtype=torch.int32,
                        device=device)[:, None].expand(TILE)
    r1, r2, r3, r4 = rng.uniform4(pix, samp, 3, 7)
    return r1 + r2 * 2.0 + r3 * 4.0 + r4 * 8.0


def pcg(device):
    """Kernel P25 on the card, pcg_plain on the CPU.

    Replaces tools/probe_pallas.py::t_pcg (pallas_call :100): PCG4D of
    csrc/rng.cuh (the megakernel's) a lane. Bounded by launch latency."""
    dev = torch.device(device)
    if not common.on_card(torch.empty(0, device=dev)):
        return pcg_plain(dev)
    out = _out(TILE, dev)
    common.launch("probe_pcg", "vimg_probe_pcg", dev, out)
    return out


def scalars_table(device="cpu"):
    return torch.arange(24, dtype=torch.float32,
                        device=device).reshape(2, 12) + 0.5


def scalars_plain(tbl):
    """Plain version of kernel P26: the six scalars summed in order."""
    acc = torch.zeros(TILE, dtype=torch.float32, device=tbl.device)
    for i in range(2):
        for k in range(3):
            acc = acc + tbl[i, k]
    return acc


def scalars(tbl):
    """Kernel P26 on a CUDA tensor, scalars_plain on a CPU tensor.

    Replaces tools/probe_pallas.py::t_scalars (pallas_call :125): the
    table in shared memory, six static-index reads every thread makes at
    one address. Bounded by launch latency."""
    if not common.on_card(tbl):
        return scalars_plain(tbl)
    common.check_tensor(tbl, "tbl", torch.float32, (2, 12), tbl.device)
    out = _out(TILE, tbl.device)
    common.launch("probe_scalars", "vimg_probe_scalars", tbl.device, tbl, out)
    return out


def transc_input(device="cpu"):
    """linspace(0, 1, 1024) in float32, as jnp.linspace computes it."""
    x = np.linspace(0, 1, LS * LANES, dtype=np.float32).reshape(TILE)
    return torch.from_numpy(x).to(device)


def transc_plain(x):
    """Plain version of kernel P27, in float32, summed left to right."""
    return (torch.sin(x) + torch.cos(x) + sqrt_cr(x + 1.0)
            + torch.log(x + 2.0) + torch.exp(-x)
            + torch.atan2(x, x + 1.0) + torch.pow(x + 1.0, F(1.7)))


def transc_exact(x):
    """The float64 reference the probe gates on."""
    xs = x.double()
    return (torch.sin(xs) + torch.cos(xs) + torch.sqrt(xs + 1)
            + torch.log(xs + 2) + torch.exp(-xs) + torch.atan2(xs, xs + 1)
            + torch.pow(xs + 1, 1.7))


def transcendental(x):
    """Kernel P27 on a CUDA tensor, transc_plain on a CPU tensor.

    Replaces tools/probe_pallas.py::t_transcendental (pallas_call :145):
    sinf, cosf, sqrtf, logf, expf, atan2f and powf of CUDA's math library
    (not correctly rounded; the gate is rtol 1e-4 against float64).
    Bounded by launch latency."""
    if not common.on_card(x):
        return transc_plain(x)
    common.check_tensor(x, "x", torch.float32, TILE, x.device)
    out = _out(TILE, x.device)
    common.launch("probe_transcendental", "vimg_probe_transc", x.device, x,
                  out)
    return out


# ---------------------------------------------------------------------------
# P28: the throughput body
# ---------------------------------------------------------------------------

def throughput_plain(device="cpu", iters=TP_ITERS):
    """Plain version of kernel P28. Every lane of every grid step starts
    at (0.3, 0.7) and adds g * 0.0 = 0, so all lanes follow one chain: it
    runs on one element per grid step and is broadcast."""
    g0 = torch.arange(TP_STEPS, dtype=torch.float32, device=device) * 0.0
    a = torch.full((TP_STEPS,), F(0.3), dtype=torch.float32, device=device)
    b = torch.full((TP_STEPS,), F(0.7), dtype=torch.float32, device=device)
    for _ in range(iters):
        t = a * F(1.000001) + b * 0.5
        u = b * a + 0.25
        v = 1.0 / sqrt_cr(t * t + u * u + 1.0)
        w = t * v + u * F(0.1)
        a2 = torch.where(w > 0.5, w * F(0.99), w + F(0.01))
        b2 = u * v - t * F(0.001)
        x = a2 * b2 + v
        y = x * x + a2
        z = y * 0.5 + x * b2
        a, b = z, y + g0
    return (a + b)[:, None].expand(TP_STEPS, TP_ROWS * LANES) \
        .reshape(TP_SHAPE).contiguous()


def throughput(device, iters=TP_ITERS, n_blocks=TP_BLOCKS):
    """Kernel P28 on the card, throughput_plain on the CPU; returns (out,
    blocks): ``n_blocks`` 128 is the probe's 131,072 lanes, 0 the full
    card (blocks past the 128th compute and write nothing).

    Replaces tools/probe_pallas.py::t_throughput (pallas_call :188): a
    thread a lane, 1,024 lanes a block. Bounded by the FP32 rate (and the
    sqrt and the divide) on the full card; by latency per lane."""
    dev = torch.device(device)
    if not common.on_card(torch.empty(0, device=dev)):
        return throughput_plain(dev, iters), TP_BLOCKS
    if not 0 <= iters < 2 ** 31:
        raise ValueError(f"iters {iters} out of range")
    out = _out(TP_SHAPE, dev)
    grid_used = common.card_grid()
    common.launch("probe_throughput", "vimg_probe_throughput", dev, iters,
                  n_blocks, grid_used, out)
    return out, grid_used.value


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def run(device="cuda", iters=TP_ITERS, log=None):
    """Every check of the tool (its verdict as ``ok``, and the time of the
    kernel's call), then the throughput body at the probe's size and on
    the full card (Gflop-eq/s at the tool's 60 flops a step, and M
    lane-iterations/s). Returns {check: (out, ms)} and, under
    "throughput", {card: (out, ms, blocks)}."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    x_w = torch.full(TILE, 0.5, dtype=torch.float32, device=dev)
    tbl = scalars_table(dev)
    x_t = transc_input(dev)
    scalar_sum = sum(float(tbl[i, k]) for i in range(2) for k in range(3))
    checks = (
        ("grid+blocked-output", lambda: grid(dev),
         lambda o: bool(o[9, 5] == 1005.0) and bool(o[25, 7] == 3007.0)),
        ("while_loop", lambda: while_loop(x_w),
         lambda o: bool(o.max() >= 100.0)),
        ("pcg4d", lambda: pcg(dev), lambda o: torch.equal(o, pcg_plain(dev))),
        ("smem-scalars", lambda: scalars(tbl),
         lambda o: abs(float(o[0, 0]) - scalar_sum) < 1e-4),
        ("transcendentals", lambda: transcendental(x_t),
         lambda o: bool(((o.double() - transc_exact(x_t)).abs()
                         <= 1e-4 * transc_exact(x_t).abs()).all())))
    res = {}
    for name, kernel, verdict in checks:
        out = kernel()
        ms = common.device_ms(kernel) if dev.type == "cuda" else None
        log(probe="pallas", check=name, ok=verdict(out),
            us=None if ms is None else ms * 1e3)
        res[name] = (out, ms)
    res["throughput"] = {}
    for card in ((False, True) if dev.type == "cuda" else (False,)):
        n_blocks = 0 if card else TP_BLOCKS
        out, blocks = throughput(dev, iters, n_blocks)
        ms = (common.device_ms(lambda: throughput(dev, iters, n_blocks), 5)
              if dev.type == "cuda" else None)
        lane_iters = blocks * 1024 * iters
        log(probe="pallas", check="throughput",
            grid="card" if card else "probe", blocks=blocks,
            ok=bool(torch.isfinite(out).all()), iters=iters,
            ms=ms, gflop_eq_per_s=None if ms is None else
            lane_iters * TP_FLOPS_PER_ITER / (ms * 1e-3) / 1e9,
            mlane_iters_per_s=None if ms is None else
            lane_iters / (ms * 1e-3) / 1e6)
        res["throughput"][card] = (out, ms, blocks)
    return res


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    run(dev, log=common.Log(dev, args.out))


if __name__ == "__main__":
    main()
