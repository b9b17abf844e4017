"""What a vector -> scalar any() costs (port of tools/probe_r3b.py's
microbench_sync).

N steps of ``x = x * 1.0000001 + 1e-9`` over a (32, 128) float32 block,
plus per step, by mode: ``novec`` the scalar chain n += x[0, 0] * 1e-12
(no any), ``scalar`` and ``cond`` n += any(x > 0.5) (as a select and as a
branch), ``any8`` eight anys at 0.5 + 0.01 k. Output ``x + n``.

``sync`` is kernel P2 (``csrc/probe_scalar.cu``; the any() is a block-wide
vote, ``__syncthreads_or``) for CUDA tensors and ``sync_plain`` for CPU
tensors. ``microbench_sync`` is the probe: records carry the TPU probe's
keys (probe, mode, us_per_iter, n_any, us_per_any). The other measurements
of tools/probe_r3b.py (cluster_bounce, sort_tax, wavefront_e2e, mega_rows)
drive package tracers and TPU knobs and are not ported yet (ROADMAP).

Run: ``python -m vimg_tpu_torch.probes.probe_r3b [--device cpu]
[--n-iter N] [--out records.jsonl]``.
"""
from __future__ import annotations

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


def main(argv=None):
    args = common.parse_args(__doc__, argv, (
        ("--n-iter", dict(type=int, default=N_ITER)),))
    dev = common.resolve_device(args.device)
    microbench_sync(dev, args.n_iter, common.Log(dev, args.out))


if __name__ == "__main__":
    main()
