"""What one traversal primitive costs (port of tools/probe_prims.py).

A loop of ITERS steps over a (16, 128) float32 tile whose body is n_rep
(1 or 4) copies of one primitive:

- ``vec22``: 11 x ``v = v * 1.000001 + 1e-7`` (22 elementwise ops);
- ``anyred``: ``any(v > 100)`` added to an int32 carry, then ``v *=
  1.000001``;
- ``cond``: a branch on ``any(v > 100)``: ``v *= 0.5`` or ``v *=
  1.000001``;
- ``vload`` / ``sload``: 6 dynamic-offset scalar reads of an (8, 128)
  table, from device memory / from shared memory (the TPU's VMEM / SMEM).

The tile starts at ``init + 1e-6`` and the output is ``v + acc * 1e-20``.
The TPU kernel reads its own output buffer as ``init``, which Pallas leaves
undefined (interpret mode fills it with NaN); here ``init`` is an input,
zeros by default. The cost of one primitive is the slope (t4 - t1) /
(3 ITERS) between the n_rep = 4 and n_rep = 1 launches.

``prims`` is kernel P12 (``csrc/probe_vpu.cu``) for CUDA tensors and
``prims_plain`` for CPU tensors. ``run`` is the probe of one primitive: it
logs the tool's quantities (t1, t4, ns a primitive, the loop floor) for one
block, the probe's size, and for the full card (every SM times the
kernel's occupancy, the same per-block work).

Run: ``python -m vimg_tpu_torch.probes.probe_prims [--device cpu]
[--iters N] [--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

PRIMS = ("vec22", "anyred", "cond", "vload", "sload")
ITERS = 200_000
ROWS = 16
SHAPE = (ROWS, 128)
# the weak-typed constants as XLA rounds them (float32), in the kernel's
# order: 1.000001, 1e-7, 1e-6, 1e-12, 1e-20, 100, 0.5
K = tuple(common.f32(v) for v in (1.000001, 1e-7, 1e-6, 1e-12, 1e-20,
                                  100.0, 0.5))


def table(device="cpu"):
    """The probe's (8, 128) table: default_rng(0).random, as the tool."""
    tab = np.random.default_rng(0).random((8, 128)).astype(np.float32)
    return torch.from_numpy(tab).to(device)


def _reads(tab, prim, n_rep, iters):
    """The scalar each vload / sload step adds, for every (step, rep): the
    float32 sum of its 6 reads in order, times 1e-12."""
    i = torch.arange(iters, dtype=torch.int64)[:, None, None]
    r = torch.arange(n_rep, dtype=torch.int64)[None, :, None]
    q = torch.arange(6, dtype=torch.int64)[None, None, :]
    off = (i * 7 + r * 13) % 900
    flat = tab.reshape(-1)
    x = flat[((off // 128) * 128 + (off + q) % 128).to(flat.device)]
    if prim == "sload":                    # tab[0, 0] * 0.0 + tab[...]
        x = flat[0] * 0.0 + x
    s = 0.0 + x[..., 0]
    for k in range(1, 6):
        s = s + x[..., k]
    return s * K[3]


def prims_plain(tab, init, prim, n_rep, iters=ITERS):
    """Plain version of kernel P12: (16, 128) init -> the tile after
    ``iters`` steps. Every element follows the same recurrence, so the
    steps run on the tile's distinct values (an any() over them is the
    any() over the tile) and the result is scattered back."""
    if prim not in PRIMS:
        raise ValueError(f"unknown primitive {prim!r} ({PRIMS})")
    c, d, eps, _, s20, lim, half = K
    v, inv = torch.unique(init + eps, return_inverse=True)
    acc = 0
    adds = _reads(tab, prim, n_rep, iters) if prim in ("vload", "sload") \
        else None
    for i in range(iters):
        for r in range(n_rep):
            if prim == "vec22":
                for _ in range(11):
                    v = v * c + d
            elif prim in ("anyred", "cond"):
                s = bool((v > lim).any())
                if prim == "anyred":
                    acc += int(s)
                    v = v * c
                else:
                    v = v * (half if s else c)
            else:
                v = v + adds[i, r]
    return v[inv] + torch.tensor(float(acc), dtype=torch.float32) * s20


def prims(tab, init, prim, n_rep, iters=ITERS, n_blocks=1):
    """Kernel P12 on CUDA tensors, prims_plain on CPU tensors. Returns
    (out, blocks launched): ``n_blocks`` 1 is the probe's size, 0 the full
    card (every block computes, block 0 writes).

    Replaces tools/probe_prims.py::run (pallas_call :73, kernel
    make_kernel :29). One block of 256 threads, 8 elements each; an any()
    is one __syncthreads_or. Bounded by the latency of the dependent chain
    (a latency probe at one block)."""
    if not common.on_card(tab):
        return prims_plain(tab, init, prim, n_rep, iters), 1
    if prim not in PRIMS or n_rep not in (1, 4):
        raise ValueError(f"unknown primitive {prim!r} x {n_rep}")
    if not 0 <= iters < 2 ** 31 // 7:
        raise ValueError(f"iters {iters} out of range")
    dev = tab.device
    common.check_tensor(tab, "tab", torch.float32, (8, 128), dev)
    common.check_tensor(init, "init", torch.float32, SHAPE, dev)
    k = common.device_consts(K, dev)
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    grid = common.card_grid()
    common.launch("probe_prims", "vimg_probe_prims", dev, tab, init, k,
                  PRIMS.index(prim), n_rep, iters, n_blocks, grid, out)
    return out, grid.value


def run(prim, device="cuda", iters=ITERS, log=None):
    """The probe of one primitive: n_rep 1 and 4 on one block and on the
    full card; logs (t1, t4, ns_per_prim, loop_floor_ns) of each (device
    times; None on the CPU). Returns {(n_rep, card): (out, ms, blocks)}."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    tab = table(dev)
    init = torch.zeros(SHAPE, dtype=torch.float32, device=dev)
    res = {}
    for card in (False, True):
        if card and dev.type != "cuda":
            continue
        for n_rep in (1, 4):
            n_blocks = 0 if card else 1
            out, blocks = prims(tab, init, prim, n_rep, iters, n_blocks)
            ms = (common.device_ms(lambda: prims(tab, init, prim, n_rep,
                                                 iters, n_blocks), reps=5)
                  if dev.type == "cuda" else None)
            res[(n_rep, card)] = (out, ms, blocks)
        t1, t4 = res[(1, card)][1], res[(4, card)][1]
        per = None if t1 is None else (t4 - t1) * 1e6 / (3 * iters)
        blocks = res[(1, card)][2]
        log(probe="prims", prim=prim, iters=iters,
            grid="card" if card else "block", blocks=blocks, t1_ms=t1,
            t4_ms=t4, ns_per_prim=per,
            loop_floor_ns=None if t1 is None else t1 * 1e6 / iters)
    return res


def main(argv=None):
    args = common.parse_args(__doc__, argv, (
        ("--iters", dict(type=int, default=ITERS)),))
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for prim in PRIMS:
        run(prim, dev, args.iters, log)


if __name__ == "__main__":
    main()
