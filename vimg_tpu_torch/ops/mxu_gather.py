"""Exact small-table row lookup (port of vimg_tpu.ops.mxu_gather).

vimg_tpu looks table rows up inside its Pallas kernels as a one-hot bf16
matmul on the TPU's matrix unit (MXU), because Mosaic has no per-lane
gather. Hopper has no MXU, and a GPU thread loads by index; what is kept is
the contract: ``split3`` splits a float32 table into three bfloat16 tables
whose float32 sum (hi + mid) + lo is the entry bit for bit, and
``gather_row`` returns ``table[:, ids]`` exactly from them.

``gather_row`` is kernel B6 (the device helper ``csrc/gather_row.cuh``
and its launcher ``csrc/gather_row.cu``) for CUDA tensors, counted in
``LAUNCHES``, and ``gather_row_plain`` for CPU tensors only.
"""
from __future__ import annotations

import torch

LAUNCHES = 0


def split3(table):
    """float32 table -> three bfloat16 tables whose (exact, float32) sum is
    the original: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)
    (round to nearest even). Exact for |v| = 0 or |v| >= 2^-109: nearer the
    subnormal floor the residuals lose bits, so such values are refused.
    Byte-identical to vimg_tpu's numpy split."""
    t = torch.as_tensor(table, dtype=torch.float32)
    a = t.abs()
    if not bool(((a == 0) | (a >= 2.0 ** -109)).all()):
        raise ValueError(
            "split3: values in (0, 2^-109) lose bits in the bf16 residuals")
    hi = t.to(torch.bfloat16)
    r1 = t - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def gather_row_plain(t_hi, t_mid, t_lo, ids, n_rows):
    """Plain version of kernel B6: (p, n) float32, column j = hi[:, id] +
    mid[:, id] + lo[:, id] in that order for id = ids[j]; 0 for an id
    outside [0, n_rows), as vimg_tpu's one-hot product gives."""
    ids = ids.reshape(-1).long()
    ok = (ids >= 0) & (ids < n_rows)
    i = torch.where(ok, ids, 0)
    out = (t_hi[:, i].float() + t_mid[:, i].float()) + t_lo[:, i].float()
    return torch.where(ok, out, 0.0)


def gather_row(t_hi, t_mid, t_lo, ids_row, n_rows):
    """Look up ``ids_row`` ((n,) or (1, n) int32 table-row ids) in the split
    tables ((p, n_rows) bfloat16 each). Returns (p, n) float32: column j
    holds table[:, ids_row[j]] exactly (vimg_tpu's call takes n = 128).
    Kernel B6 on CUDA tensors, gather_row_plain on CPU tensors."""
    global LAUNCHES
    dev = ids_row.device
    if dev.type == "cpu":
        return gather_row_plain(t_hi, t_mid, t_lo, ids_row, n_rows)
    if dev.type != "cuda":
        raise NotImplementedError(f"no gather_row for device {dev}")
    from vimg_tpu_torch.runtime.cuda import check, load_library
    p = t_hi.shape[0]
    for name, x in (("t_hi", t_hi), ("t_mid", t_mid), ("t_lo", t_lo)):
        if (x.device != dev or x.dtype != torch.bfloat16
                or tuple(x.shape) != (p, n_rows) or not x.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous bfloat16 "
                             f"({p}, {n_rows}) tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if (ids_row.dtype != torch.int32 or not ids_row.is_contiguous()
            or ids_row.dim() not in (1, 2)
            or (ids_row.dim() == 2 and ids_row.shape[0] != 1)):
        raise ValueError(f"ids_row: expected a contiguous int32 (n,) or "
                         f"(1, n) tensor, got {ids_row.dtype} "
                         f"{tuple(ids_row.shape)}")
    n = ids_row.numel()
    out = torch.empty((p, n), dtype=torch.float32, device=dev)
    if n == 0 or p == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vimg_gather_rows(t_hi.data_ptr(), t_mid.data_ptr(),
                                  t_lo.data_ptr(), ids_row.data_ptr(), p,
                                  n_rows, n, out.data_ptr(), stream)
    check(rc, "vimg_gather_rows")
    LAUNCHES += 1
    return out
