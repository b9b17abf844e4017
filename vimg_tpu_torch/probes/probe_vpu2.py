"""Vector-unit issue rate in float32 and bf16 (port of tools/probe_vpu2.py).

- ``fma_throughput``: 8 independent chains ``a = a * 1.000001 + 1e-7 (i +
  1)`` from ``x + 0.001 i`` over a (32, 128) tile, 300 steps, summed in the
  working type: the multiply-add issue rate, not its latency.
- ``mix_throughput``: the triangle test's blend, 4 states with a
  multiply-add, a compare and a select each step, 200 steps.

Each runs in float32 and in bf16 (``x`` rounded to bf16; the constants
rounded to the working type, so in bf16 1.000001 and 1.0000013 are 1.0),
and each multiply-add in two forms: separate (two roundings, as the TPU
probe) and fused (one rounding: what dropping ``-fmad=false`` would buy).

``vpu`` launches kernels P13 (``kind="fma"``), P14 (``"mix"``) and P20
(``"rate"``, probe_r2c.vpu_rate) of ``csrc/probe_vpu.cu`` for CUDA tensors;
``fma_plain`` / ``mix_plain`` are the plain versions. The probes log the
tool's rate (Gflop/s, Gop/s) for one block, the probe's size, and for the
full card (every SM times the kernel's occupancy, the same per-block
work).

Run: ``python -m vimg_tpu_torch.probes.probe_vpu2 [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

ROWS = 32
SHAPE = (ROWS, 128)
CHAINS, FMA_ITERS, MIX_ITERS = 8, 300, 200
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
KINDS = ("fma", "mix", "rate")
LAUNCH_NAMES = {"fma": "probe_fma", "mix": "probe_mix",
                "rate": "probe_vpu_rate"}


def rounded(values, dtype):
    """Python floats rounded to the working type (0-d tensors' values)."""
    rnd = common.f32 if dtype == "f32" else common.bf16
    return [rnd(v) for v in values]


def fma_consts(dtype):
    return rounded([1.000001] + [0.001 * i for i in range(CHAINS)]
                   + [1e-7 * (i + 1) for i in range(CHAINS)], dtype)


def mix_consts(dtype):
    return rounded([1.0000013, 0.5, 0.25, 0.75, 1e-7, 2e-7], dtype)


def tile(seed, device="cpu"):
    """The probe's (32, 128) input: RandomState(seed).rand, as the tool."""
    x = np.random.RandomState(seed).rand(*SHAPE).astype(np.float32)
    return torch.from_numpy(x).to(device)


def const_tensors(values, dtype, device):
    """Python floats as 0-d tensors of the working type."""
    return [torch.tensor(v, dtype=DTYPES[dtype], device=device)
            for v in values]


def fma_plain(x, dtype, fused=False, iters=FMA_ITERS):
    """Plain version of kernel P13: (32, 128) float32 -> float32."""
    k = const_tensors(fma_consts(dtype), dtype, x.device)
    xd = x.to(DTYPES[dtype])
    accs = [xd + k[1 + i] for i in range(CHAINS)]
    for _ in range(iters):
        accs = [common.madd(a, k[0], k[1 + CHAINS + i], fused)
                for i, a in enumerate(accs)]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc.float()


def mix_plain(x, dtype, fused=False, iters=MIX_ITERS):
    """Plain version of kernel P14: (32, 128) float32 -> float32."""
    c1, h, q, tq, e1, e2 = const_tensors(mix_consts(dtype), dtype,
                                         x.device)
    a = x.to(DTYPES[dtype])
    b, c, d = a + h, a + q, a + tq
    for _ in range(iters):
        a = common.madd(a, c1, e1, fused)
        b = common.madd(b, c1, e2, fused)
        hit = (a > b) & (c < d)
        c = torch.where(hit, a, c) * c1
        d = torch.where(hit, b, d) + e1
    return (a + b + c + d).float()


def vpu(kind, x, k, dtype, fused, iters, n_blocks=1):
    """Kernel P13, P14 or P20 (``kind`` fma, mix, rate) of
    csrc/probe_vpu.cu on a CUDA tile ``x`` with the constants ``k`` (already
    rounded to ``dtype``). Returns (out, blocks launched): ``n_blocks`` 1
    is the probe's size, 0 the full card (every block computes, block 0
    writes)."""
    dev = x.device
    common.check_tensor(x, "x", torch.float32, SHAPE, dev)
    if not 0 <= iters < 2 ** 31:
        raise ValueError(f"iters {iters} out of range")
    kt = common.device_consts(k, dev)
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    grid = common.card_grid()
    common.launch(LAUNCH_NAMES[kind], "vimg_probe_vpu", dev, x, kt,
                  KINDS.index(kind), int(dtype == "bf16"), int(fused), iters,
                  n_blocks, grid, out)
    return out, grid.value


def fma(x, dtype, fused=False, iters=FMA_ITERS, n_blocks=1):
    """Kernel P13 on a CUDA tensor, fma_plain on a CPU tensor; returns
    (out, blocks).

    Replaces tools/probe_vpu2.py::fma_throughput (pallas_call :59). One
    block of 1024 threads, 4 float32 elements or 2 bf16 pairs each, 8
    chains an element. Bounded by the FP32 / bf16 issue rate on the full
    card; at one block, by one SM's."""
    if not common.on_card(x):
        return fma_plain(x, dtype, fused, iters), 1
    return vpu("fma", x, fma_consts(dtype), dtype, fused, iters,
               n_blocks)


def mix(x, dtype, fused=False, iters=MIX_ITERS, n_blocks=1):
    """Kernel P14 on a CUDA tensor, mix_plain on a CPU tensor; returns
    (out, blocks).

    Replaces tools/probe_vpu2.py::mix_throughput (pallas_call :91). Layout
    as P13; 4 dependent states an element, so one block is bounded by
    latency and the full card by the issue rate."""
    if not common.on_card(x):
        return mix_plain(x, dtype, fused, iters), 1
    return vpu("mix", x, mix_consts(dtype), dtype, fused, iters,
               n_blocks)


def fma_throughput(dtype, device="cuda", iters=FMA_ITERS, log=None):
    """The probe: P13 in both forms, one block and the full card; logs
    Gflop/s (2 flops a step of each chain, as the tool counts). Returns
    (x, {(fused, card): (out, ms, blocks)})."""
    dev = common.resolve_device(device)
    x = tile(3, dev)
    flops = 2 * CHAINS * iters * ROWS * 128
    return x, common.rate_probe(
        lambda f, nb: fma(x, dtype, f, iters, nb), flops,
        log or common.Log(dev), probe="fma", dtype=dtype, iters=iters)


def mix_throughput(dtype, device="cuda", iters=MIX_ITERS, log=None):
    """The probe: P14 in both forms, one block and the full card; logs
    Gop/s (10 vector ops a step, as the tool counts). Returns (x, {(fused,
    card): (out, ms, blocks)})."""
    dev = common.resolve_device(device)
    x = tile(4, dev)
    ops = 10 * iters * ROWS * 128
    return x, common.rate_probe(
        lambda f, nb: mix(x, dtype, f, iters, nb), ops,
        log or common.Log(dev), probe="mix", dtype=dtype, iters=iters)


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for dtype in DTYPES:
        fma_throughput(dtype, dev, log=log)
        mix_throughput(dtype, dev, log=log)


if __name__ == "__main__":
    main()
