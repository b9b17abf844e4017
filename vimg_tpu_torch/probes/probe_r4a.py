"""Cost of the packet tracer's primitives (port of tools/probe_r4a.py).

Six tiny kernels over one (8, 128) float32 tile, each timed over many
repetitions inside one launch:

  P5  setup (static and dynamic packet index): extract 6 lane columns
      c * 16 + p per packet p = r % 16, chain them (a * 1.000001 + b) and
      add the result into lane p only
  P6  dynrow: 12 dynamic (1, 128) row loads per step at idx[i % 64] * 12,
      chained with a * 1.000001 + b
  P7  ffs: a find-first-set loop over a 128-lane mask, summing the table
      row of each set lane in ascending lane order
  P8  epilogue: per row the minimum over the lanes and the least lane at
      it, then a strict-less update of (bt, code)
  P9  dynblock: one (12, 128) block load per step (parallel or chained sum)
  P10 dynrow_par: P6's row loads with P9's parallel sum

Each ``name(...)`` is the kernel (``csrc/probe_packet.cu``) for CUDA
tensors and ``name_plain(...)`` for CPU tensors; ``probe_name(...)`` is
the probe, whose records carry the TPU probe's keys. Row indices are
clamped into the table by kernel and plain version alike (Pallas reads
past the table unchecked). The TPU probes take nrows = 12, fixed here.

Run: ``python -m vimg_tpu_torch.probes.probe_r4a [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

SHAPE = (8, 128)
NROWS = 12
N_IDX = 64
TABLE_BLOCKS = 1024
A, EPS = common.f32(1.000001), common.f32(1e-6)


def _chain(vals):
    """((v0 * 1.000001 + v1) * 1.000001 + v2) ... as the probe's reduce."""
    v = vals[0]
    for b in vals[1:]:
        v = v * A + b
    return v


def _parallel(r):
    """(acc + (a + b)) + c of the probe's parallel sum, without acc."""
    a = r[0] * r[1] + r[2] * r[3]
    b = r[4] * r[5] + r[6] * r[7]
    c = r[8] * r[9] + r[10] * r[11]
    return (a + b), c


def _tile(row):
    """A (128,) lane vector broadcast over the 8 rows."""
    return row.expand(SHAPE).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def setup_plain(x, reps):
    """Plain version of kernel P5 (static and dynamic give the same
    tile)."""
    lane = torch.arange(128, device=x.device)
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=x.device)
    for r in range(reps):
        p = r % 16
        v = _chain([x[:, c * 16 + p] for c in range(6)])
        acc = acc + torch.where(lane == p, v[:, None], 0.0)
    return acc


def rows_plain(tbl, idx, reps, parallel):
    """Plain version of kernels P6 (chained), P9 and P10: the loads differ
    on the card, the arithmetic does not."""
    nb = tbl.shape[0] // NROWS
    ids = [min(max(b, 0), nb - 1) for b in idx.tolist()]
    acc = torch.zeros(128, dtype=torch.float32, device=tbl.device)
    for i in range(reps):
        r = tbl[ids[i % N_IDX] * NROWS:(ids[i % N_IDX] + 1) * NROWS]
        if parallel:
            ab, c = _parallel(r)
            acc = acc + ab + c
        else:
            acc = acc + _chain(list(r))
    return _tile(acc)


def ffs_plain(mask, tbl, reps):
    """Plain version of kernel P7."""
    lanes = torch.nonzero(mask.reshape(-1) > 0.5)[:, 0].tolist()
    acc = torch.zeros(128, dtype=torch.float32, device=tbl.device)
    for _ in range(reps):
        for lane in lanes:                  # ascending lane order
            acc = acc + tbl[lane]
    return _tile(acc)


def epilogue_plain(x, reps):
    """Plain version of kernel P8: (8, 1) bt + code."""
    lanef = torch.arange(128, device=x.device).to(torch.float32)
    bt = torch.full((8, 1), float("inf"), device=x.device)
    code = torch.zeros((8, 1), device=x.device)
    for i in range(reps):
        fi = torch.tensor(float(i), dtype=torch.float32, device=x.device)
        t = x * (1.0 + EPS * fi)
        tmin = t.amin(1, keepdim=True)
        kwin = torch.where(t == tmin, lanef, 1e9).amin(1, keepdim=True)
        upd = tmin < bt
        bt = torch.where(upd, tmin, bt)
        code = torch.where(upd, kwin + fi, code)
    return bt + code


# ---------------------------------------------------------------------------
# kernel wrappers (P5-P10)
# ---------------------------------------------------------------------------

def _check_reps(reps):
    if not 0 <= reps < 2 ** 31:
        raise ValueError(f"reps {reps} out of range")


def setup(x, static_packet, reps):
    """Kernel P5 on a CUDA tensor, setup_plain on a CPU tensor. Replaces
    tools/probe_r4a.py::probe_setup (pallas_call :86): a lane-column
    extract is a shared-memory broadcast, with the column in the
    instruction (static) or computed (dynamic)."""
    if not common.on_card(x):
        return setup_plain(x, reps)
    _check_reps(reps)
    common.check_tensor(x, "x", torch.float32, SHAPE, x.device)
    out = torch.empty(SHAPE, dtype=torch.float32, device=x.device)
    common.launch("probe_setup", "vimg_probe_setup", x.device, x,
                  int(static_packet), reps, out)
    return out


def _rows(name, tbl, idx, reps, block_load, parallel):
    if not common.on_card(tbl):
        return rows_plain(tbl, idx, reps, parallel)
    _check_reps(reps)
    dev = tbl.device
    if tbl.dim() != 2 or tbl.shape[1] != 128 or tbl.shape[0] < NROWS:
        raise ValueError(f"tbl: expected (n * {NROWS}, 128), got "
                         f"{tuple(tbl.shape)}")
    common.check_tensor(tbl, "tbl", torch.float32, tuple(tbl.shape), dev)
    common.check_tensor(idx, "idx", torch.int32, (N_IDX,), dev)
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    common.launch(name, "vimg_probe_rows", dev, tbl, idx,
                  tbl.shape[0] // NROWS, reps, int(block_load),
                  int(parallel), out)
    return out


def dynrow(tbl, idx, reps):
    """Kernel P6 (row loads, chained sum). Replaces
    tools/probe_r4a.py::probe_dynrow (pallas_call :117)."""
    return _rows("probe_dynrow", tbl, idx, reps, False, False)


def dynblock(tbl, idx, reps, parallel):
    """Kernel P9 (one 12-row block load, parallel or chained sum).
    Replaces tools/probe_r4a.py::probe_dynblock (pallas_call :257)."""
    return _rows("probe_dynblock", tbl, idx, reps, True, parallel)


def dynrow_par(tbl, idx, reps):
    """Kernel P10 (row loads, parallel sum). Replaces
    tools/probe_r4a.py::probe_dynrow_par (pallas_call :287)."""
    return _rows("probe_dynrow_par", tbl, idx, reps, False, True)


def ffs(mask, tbl, reps):
    """Kernel P7 on CUDA tensors, ffs_plain on CPU tensors. Replaces
    tools/probe_r4a.py::probe_ffs (pallas_call :160): the mask is four warp
    ballots and each step takes the lowest set bit with __ffs."""
    if not common.on_card(mask):
        return ffs_plain(mask, tbl, reps)
    _check_reps(reps)
    dev = mask.device
    common.check_tensor(mask, "mask", torch.float32, (1, 128), dev)
    common.check_tensor(tbl, "tbl", torch.float32, (128, 128), dev)
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    common.launch("probe_ffs", "vimg_probe_ffs", dev, mask, tbl, reps, out)
    return out


def epilogue(x, reps):
    """Kernel P8 on a CUDA tensor, epilogue_plain on a CPU tensor.
    Replaces tools/probe_r4a.py::probe_epilogue (pallas_call :198): one
    warp per row, the minimum and the least lane at it by warp shuffles."""
    if not common.on_card(x):
        return epilogue_plain(x, reps)
    _check_reps(reps)
    common.check_tensor(x, "x", torch.float32, SHAPE, x.device)
    out = torch.empty((8, 1), dtype=torch.float32, device=x.device)
    common.launch("probe_epilogue", "vimg_probe_epilogue", x.device, x, reps,
                  out)
    return out


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

def _run(dev, log, fn, args, keys, per):
    """Run ``fn(*args)``, time it on the card and log ``keys`` plus the
    launch time ``us`` and ``per`` = {key: divisor} of it in ns."""
    out = fn(*args)
    ms = (common.device_ms(lambda: fn(*args))
          if dev.type == "cuda" else None)
    rec = dict(keys, us=None if ms is None else ms * 1e3)
    for k, div in per.items():
        rec[k] = None if ms is None else ms * 1e6 / div
    log(**rec)
    return args, out, ms


def _table(dev):
    """A (12288, 128) table and 64 block ids in [0, 1024), drawn as the
    probe draws them (from RandomState(0) here)."""
    rs = np.random.RandomState(0)
    tbl = torch.from_numpy(rs.rand(TABLE_BLOCKS * NROWS, 128)
                           .astype(np.float32)).to(dev)
    idx = torch.from_numpy(rs.randint(0, TABLE_BLOCKS, N_IDX)
                           .astype(np.int32)).to(dev)
    return tbl, idx


def probe_setup(static_packet, reps=512, device="cuda", log=None):
    dev = common.resolve_device(device)
    x = torch.from_numpy(np.random.RandomState(0).rand(*SHAPE)
                         .astype(np.float32)).to(dev)
    return _run(dev, log or common.Log(dev), setup, (x, static_packet, reps),
                dict(probe="setup", static=static_packet, reps=reps),
                dict(ns_per_packet=reps))


def probe_dynrow(reps=512, device="cuda", log=None):
    dev = common.resolve_device(device)
    tbl, idx = _table(dev)
    return _run(dev, log or common.Log(dev), dynrow, (tbl, idx, reps),
                dict(probe="dynrow", reps=reps, nrows=NROWS),
                dict(ns_per_cluster=reps, ns_per_row=reps * NROWS))


def probe_ffs(n_live=16, reps=64, device="cuda", log=None):
    dev = common.resolve_device(device)
    rs = np.random.RandomState(0)
    m = np.zeros((1, 128), np.float32)
    m[0, rs.choice(128, n_live, replace=False)] = 1.0
    tbl = torch.from_numpy(rs.rand(128, 128).astype(np.float32)).to(dev)
    return _run(dev, log or common.Log(dev), ffs,
                (torch.from_numpy(m).to(dev), tbl, reps),
                dict(probe="ffs", n_live=n_live, reps=reps),
                dict(ns_per_extract=reps * n_live))


def probe_epilogue(reps=512, device="cuda", log=None):
    dev = common.resolve_device(device)
    x = torch.from_numpy(np.random.RandomState(0).rand(*SHAPE)
                         .astype(np.float32)).to(dev)
    return _run(dev, log or common.Log(dev), epilogue, (x, reps),
                dict(probe="epilogue", reps=reps), dict(ns_per_block=reps))


def probe_dynblock(reps=512, parallel=True, device="cuda", log=None):
    dev = common.resolve_device(device)
    tbl, idx = _table(dev)
    return _run(dev, log or common.Log(dev), dynblock,
                (tbl, idx, reps, parallel),
                dict(probe="dynblock", parallel=parallel, reps=reps,
                     nrows=NROWS), dict(ns_per_cluster=reps))


def probe_dynrow_par(reps=512, device="cuda", log=None):
    dev = common.resolve_device(device)
    tbl, idx = _table(dev)
    return _run(dev, log or common.Log(dev), dynrow_par, (tbl, idx, reps),
                dict(probe="dynrow_par", reps=reps, nrows=NROWS),
                dict(ns_per_cluster=reps))


PROBES = (
    ("setup_static", lambda **kw: probe_setup(True, **kw)),
    ("setup_dynamic", lambda **kw: probe_setup(False, **kw)),
    ("dynrow", probe_dynrow),
    ("ffs16", lambda **kw: probe_ffs(16, **kw)),
    ("ffs4", lambda **kw: probe_ffs(4, **kw)),
    ("epilogue", probe_epilogue),
    ("dynblock_par", lambda **kw: probe_dynblock(parallel=True, **kw)),
    ("dynblock_chain", lambda **kw: probe_dynblock(parallel=False, **kw)),
    ("dynrow_par", probe_dynrow_par),
)


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for _, fn in PROBES:
        fn(device=dev, log=log)


if __name__ == "__main__":
    main()
