"""Exact per-lane table lookup through one-hot products on the matrix unit
(port of tools/probe_r4j.py).

A float32 (n_params, n_mats) table is split into three bf16 terms (hi, mid,
lo: 8 bits of mantissa each) that sum back to it exactly. A one-hot of a
lane's material id times each term is one exact bf16 product, so ``hi @
oh + mid @ oh + lo @ oh`` is ``table[:, id]`` bit for bit, at a cost that
does not grow with n_mats in steps of the matrix unit.

- ``mxu``: rows x (3 one-hot products, summed over the parameters), reps
  times (kernel P21, tensor cores);
- ``chain``: the same lookup of t_hi as an n_mats x n_params select chain
  (kernel P21's chain form), for n_mats <= 64;
- ``check``: one row of ids, the (n_params, 128) values themselves,
  bit-exact to ``table[:, ids]`` (kernel P22).

Inputs come from RandomState(0) (the table, then the ids), and ``split3``
rounds as ``tools/probe_r4j.split3`` does. ``run`` is the probe of one
n_mats; records carry the tool's keys (method, n_mats, bit_exact,
max_abs_err, us, ns_per_row_gather) and the card.

Run: ``python -m vimg_tpu_torch.probes.probe_r4j [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

N_MATS = (48, 128, 256, 512)
N_PARAMS, ROWS, REPS = 32, 8, 8
CHAIN_MAX_MATS = 64
BF = torch.bfloat16


def _pad8(n):
    return -(-n // 8) * 8


def split3(table):
    """float32 -> three bf16 terms that sum back to it exactly."""
    t = table.float()
    hi = t.to(BF)
    r1 = t - hi.float()
    mid = r1.to(BF)
    lo = (r1 - mid.float()).to(BF)
    return hi, mid, lo


def inputs(n_mats, n_params=N_PARAMS, rows=ROWS, device="cpu"):
    """The probe's table (ppad, npad), zero past n_mats, and ids (rows,
    128) int32, from one RandomState(0) as the tool draws them."""
    rs = np.random.RandomState(0)
    table = rs.randn(_pad8(n_params), _pad8(n_mats)).astype(np.float32)
    table[:, n_mats:] = 0.0
    ids = rs.randint(0, n_mats, (rows, 128)).astype(np.int32)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(ids).to(device))


def lookup_values(ids_row, hi, mid, lo):
    """(ppad, 128): (hi + mid) + lo of each lane's column, in float32
    (each term is one one-hot product, exact)."""
    i = ids_row.long()
    return (hi.float()[:, i] + mid.float()[:, i]) + lo.float()[:, i]


def mxu_plain(ids, hi, mid, lo, reps=REPS):
    """Plain version of kernel P21 (mxu): per repetition the float32 sum
    over rows, in order, of each row's values summed over the parameters
    in order (XLA's CPU reduction order); every output row is that sum."""
    acc = torch.zeros(128, dtype=torch.float32, device=ids.device)
    for _ in range(reps):
        s = torch.zeros(128, dtype=torch.float32, device=ids.device)
        for r in range(ids.shape[0]):
            v = lookup_values(ids[r], hi, mid, lo)
            t = v[0]
            for p in range(1, v.shape[0]):
                t = t + v[p]
            s = s + t
        acc = acc + s
    return acc.expand(ids.shape).contiguous()


def chain_plain(ids, hi, n_mats, n_params=N_PARAMS, reps=REPS):
    """Plain version of kernel P21 (chain): the chain adds 0.0 for every
    other material and t_hi[p, id] for the lane's own, p in order."""
    h = hi.float()[:n_params, :n_mats]
    i = ids.long()
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    for _ in range(reps):
        tot = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        for p in range(n_params):
            tot = tot + h[p][i]
        acc = acc + tot
    return acc


def check_plain(ids, hi, mid, lo):
    """Plain version of kernel P22: the first row's (ppad, 128) values."""
    return lookup_values(ids[0], hi, mid, lo)


def _check_tables(ids, tables, rows):
    dev = ids.device
    ppad, npad = tables[0].shape
    if ppad % 16 or ppad > 64 or npad % 8:
        raise ValueError(f"the lookup kernel takes n_params padded to a "
                         f"multiple of 16 up to 64 and n_mats to a multiple "
                         f"of 8 (got {ppad}, {npad})")
    common.check_tensor(ids, "ids", torch.int32, (rows, 128), dev)
    for name, t in zip(("hi", "mid", "lo"), tables):
        common.check_tensor(t, name, BF, (ppad, npad), dev)
    return ppad, npad


def lookup_mxu(ids, hi, mid, lo, reps=REPS):
    """Kernel P21 (mxu) on CUDA tensors, mxu_plain on CPU tensors.

    Replaces tools/probe_r4j.py::make_fn (pallas_call :94), method "mxu".
    One block of 16 warps; warp w takes lanes 8w..8w+7, a one-hot B
    fragment from its ids, the table terms as A (mma.sync m16n8k16, bf16
    -> f32); the values go through shared memory and 128 threads sum them
    over the parameters. Bounded by the one-hot products (ppad x npad x
    128 MACs a row and term) and their latency on one SM."""
    if not common.on_card(ids):
        return mxu_plain(ids, hi, mid, lo, reps)
    ppad, npad = _check_tables(ids, (hi, mid, lo), ids.shape[0])
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    common.launch("probe_lookup", "vimg_probe_lookup_mxu", ids.device, ids,
                  *(t.view(torch.int16) for t in (hi, mid, lo)), ppad, ppad,
                  npad, ids.shape[0], reps, 0, out)
    return out


def lookup_chain(ids, hi, n_mats, n_params=N_PARAMS, reps=REPS):
    """Kernel P21 (chain) on CUDA tensors, chain_plain on CPU tensors.

    Replaces tools/probe_r4j.py::make_fn (pallas_call :94), method
    "chain". One block, a thread a lane; t_hi widened to float32 in shared
    memory; n_mats x n_params compare-select-adds a repetition
    (operations)."""
    if not common.on_card(ids):
        return chain_plain(ids, hi, n_mats, n_params, reps)
    if n_mats > CHAIN_MAX_MATS:
        raise ValueError(f"the chain runs for n_mats <= {CHAIN_MAX_MATS}")
    common.check_tensor(ids, "ids", torch.int32, ids.shape, ids.device)
    common.check_tensor(hi, "hi", BF, hi.shape, ids.device)
    if n_params > hi.shape[0] or n_mats > hi.shape[1]:
        raise ValueError(f"t_hi {tuple(hi.shape)} is smaller than "
                         f"({n_params}, {n_mats})")
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    common.launch("probe_lookup", "vimg_probe_lookup_chain", ids.device, ids,
                  hi.view(torch.int16), n_mats, n_params, hi.shape[1],
                  ids.shape[0], reps, out)
    return out


def lookup_check(ids, hi, mid, lo):
    """Kernel P22 on CUDA tensors, check_plain on CPU tensors.

    Replaces tools/probe_r4j.py::make_check_fn (pallas_call :115): the
    first row of ids through the three one-hot products, the (ppad, 128)
    values written out. One warp an output tile of 16 parameters x 8
    lanes; it multiplies only the k-tiles of 16 materials its 8 ids touch,
    which leaves every bit as it is (the skipped products are +-0 added
    to a +0 accumulator), and stages them with cp.async (16-byte aligned
    tables). Bounded by latency (one launch, two dependent loads)."""
    if not common.on_card(ids):
        return check_plain(ids, hi, mid, lo)
    ppad, npad = _check_tables(ids, (hi, mid, lo), ids.shape[0])
    if any(t.data_ptr() % 16 for t in (hi, mid, lo)):
        raise ValueError("the lookup check copies 16-byte aligned tables")
    out = torch.empty((ppad, 128), dtype=torch.float32, device=ids.device)
    common.launch("probe_lookup_check", "vimg_probe_lookup_mxu", ids.device,
                  ids, *(t.view(torch.int16) for t in (hi, mid, lo)), ppad,
                  ppad, npad, 1, 1, 1, out)
    return out


def run(n_mats, n_params=N_PARAMS, rows=ROWS, reps=REPS, device="cuda",
        log=None):
    """The probe of one n_mats: the bit-exactness check, then mxu and (for
    n_mats <= 64) chain; device times (None on the CPU). Returns
    {"inputs": (table, ids, hi, mid, lo), method: (out, ms)}."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    table, ids = inputs(n_mats, n_params, rows, dev)
    hi, mid, lo = split3(table)
    res = {"inputs": (table, ids, hi, mid, lo)}
    out = lookup_check(ids, hi, mid, lo)
    want = table[:, ids[0].long()]
    log(method="mxu_exact", n_mats=n_mats,
        bit_exact=bool(torch.equal(out, want)),
        max_abs_err=float((out - want).abs().max()))
    res["check"] = (out, None)
    methods = [("mxu", lambda: lookup_mxu(ids, hi, mid, lo, reps))]
    if n_mats <= CHAIN_MAX_MATS:
        methods.append(("chain", lambda: lookup_chain(ids, hi, n_mats,
                                                      n_params, reps)))
    for method, fn in methods:
        out = fn()
        ms = common.device_ms(fn) if dev.type == "cuda" else None
        log(method=method, n_mats=n_mats, n_params=n_params, rows=rows,
            reps=reps, us=None if ms is None else ms * 1e3,
            ns_per_row_gather=None if ms is None else
            ms * 1e6 / (reps * rows))
        res[method] = (out, ms)
    return res


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for n in N_MATS:
        run(n, device=dev, log=log)


if __name__ == "__main__":
    main()
