"""Gather forms, matrix precision and the dependent-chain rate (port of
tools/probe_r2c.py).

1. Per-lane gathers over a (32, 128) tile of indices:
   - ``gather_take(n)``: sum over k < 100 of ``tab[(idx + k) % n, lane]``,
     tab (n, 128) = arange (kernel P16: an indexed load a step);
   - ``gather_onehot(n)``: 10 x (one-hot(idx) @ bf16(tab))[:, 0], tab (n,
     4) = RandomState(1).rand (kernel P17: bf16 tensor-core products). As
     the TPU kernel, the one-hot is built from ``idx``, not from ``idx +
     k`` (ROADMAP C15): the tool's ``max_err`` compares the sum with ten
     different rows and is logged as it computes it, beside
     ``max_err_bf16 = max |out - 10 tab[idx, 0]|``, the bf16 rounding it
     meant to measure;
   - ``gather_selchain(n)``: sum over k < 10 of a select chain over the n
     rows of tab[:, 0], tab (n, 4) = arange (kernel P18).
2. ``mxu_precision``: a 256 x 256 float32 product, "default" (TF32 tensor
   cores) and "highest" (float32 FMA) (kernel P19). Each form is held to
   its plain version, the float64 product of its inputs as the kernel
   reads them (rounded to TF32 by ``tf32`` for "default"), within ``2 K u
   (|A~| |B~|)``, K = 256, u = 2^-24: float32 accumulation, with room for
   tensor-core adds that truncate. Logged beside it: the tool's metric,
   ``|out - exact| / max(|exact|, 1e-3)`` (it reads cancellation, ROADMAP
   C18), and the ratio to ``2 K u (|A| |B|)`` against the float64 product
   of the unrounded inputs, u = 2^-11 for TF32 and 2^-24 for float32.
3. ``vpu_rate``: two dependent chains ``a = a * 1.000001 + 1e-6``, ``b = b
   * 1.000001 + a * 1e-6``, 2,000 steps, float32 and bf16, separate and
   fused (kernel P20 of csrc/probe_vpu.cu; a latency probe by design).

Indices come from RandomState(0), as in the tool. Each kernel wrapper
takes its plain version for CPU tensors. Records carry the tool's keys (us
a gather, correctness, errors, Gop/s) and the card.

Run: ``python -m vimg_tpu_torch.probes.probe_r2c [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common
from vimg_tpu_torch.probes.probe_vpu2 import (ROWS, SHAPE, const_tensors,
                                              rounded, tile, vpu)

TAKE_N = (8, 32, 256, 2048)
ONEHOT_N = (256, 2048)
SELCHAIN_N = (64, 256)
TAKE_REPS, ONEHOT_REPS, SELCHAIN_REPS = 100, 10, 10
MM = 256
RATE_ITERS = 2000
# 2 K u (|A| |B|) against the float64 product, K = 256: u of each form's
# arithmetic (logged); the gate against the plain version takes u = 2^-24
MM_U = {"default": 2.0 ** -11, "highest": 2.0 ** -24}
MM_ACC_U = 2.0 ** -24


def indices(n, device="cpu"):
    """RandomState(0).randint(0, n, (32, 128)), as the tool."""
    idx = np.random.RandomState(0).randint(0, n, SHAPE).astype(np.int32)
    return torch.from_numpy(idx).to(device)


def take_table(n, device="cpu"):
    return torch.arange(n * 128, dtype=torch.float32,
                        device=device).reshape(n, 128)


def onehot_table(n, device="cpu"):
    tab = np.random.RandomState(1).rand(n, 4).astype(np.float32)
    return torch.from_numpy(tab).to(device)


def selchain_table(n, device="cpu"):
    return torch.arange(n * 4, dtype=torch.float32,
                        device=device).reshape(n, 4)


# ---------------------------------------------------------------------------
# P16: indexed load
# ---------------------------------------------------------------------------

def take_plain(tab, idx, reps=TAKE_REPS):
    """Plain version of kernel P16: the float32 sum over k < reps, in k
    order, of tab[(idx + k) % n, lane]."""
    n = tab.shape[0]
    lane = torch.arange(128, device=tab.device)
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=tab.device)
    for k in range(reps):
        acc = acc + tab[((idx.long() + k) % n), lane]
    return acc


def take(tab, idx, reps=TAKE_REPS):
    """Kernel P16 on CUDA tensors, take_plain on CPU tensors.

    Replaces tools/probe_r2c.py::gather_take (pallas_call :79). A thread an
    output, one __ldg of the table a step (the n = 2,048 table is 1 MiB).
    Bounded by the latency of its loads at 4,096 lanes."""
    if not common.on_card(tab):
        return take_plain(tab, idx, reps)
    n = tab.shape[0]
    common.check_tensor(tab, "tab", torch.float32, (n, 128), tab.device)
    common.check_tensor(idx, "idx", torch.int32, SHAPE, tab.device)
    out = torch.empty(SHAPE, dtype=torch.float32, device=tab.device)
    common.launch("probe_take", "vimg_probe_take", tab.device, tab, idx, n,
                  reps, out)
    return out


# ---------------------------------------------------------------------------
# P17: one-hot product on the tensor cores
# ---------------------------------------------------------------------------

def onehot_plain(tab, idx, reps=ONEHOT_REPS):
    """Plain version of kernel P17: reps x bf16(tab)[idx, 0] summed in
    float32 (one exact product a lane, the one-hot's other terms zero)."""
    v = tab.to(torch.bfloat16).float()[idx.long(), 0]
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=tab.device)
    for _ in range(reps):
        acc = acc + v
    return acc


def onehot(tab, idx, reps=ONEHOT_REPS):
    """Kernel P17 on CUDA tensors, onehot_plain on CPU tensors.

    Replaces tools/probe_r2c.py::gather_onehot (pallas_call :115). A warp
    a 16-lane tile: the one-hot A fragment from its 16 indices, the bf16
    table (transposed, padded to 8 columns) as B from shared memory,
    mma.sync m16n8k16 over n / 16 steps. Bounded by the tensor cores'
    rate on the dense one-hot (4,096 x n x 8 MACs a repetition). The
    kernel rounds the table to bf16 and transposes it into shared memory
    itself, as the TPU kernel casts it."""
    if not common.on_card(tab):
        return onehot_plain(tab, idx, reps)
    n = tab.shape[0]
    if n % 16 or n > 2048:
        raise ValueError(f"the one-hot kernel takes n % 16 == 0, n <= 2048 "
                         f"(got {n})")
    common.check_tensor(tab, "tab", torch.float32, (n, 4), tab.device)
    common.check_tensor(idx, "idx", torch.int32, SHAPE, tab.device)
    out = torch.empty(SHAPE, dtype=torch.float32, device=tab.device)
    common.launch("probe_onehot", "vimg_probe_onehot", tab.device, tab, idx,
                  n, reps, out)
    return out


# ---------------------------------------------------------------------------
# P18: select chain
# ---------------------------------------------------------------------------

def selchain_plain(tab, idx, reps=SELCHAIN_REPS):
    """Plain version of kernel P18: the chain selects tab[(idx + k) % n,
    0], summed in float32 in k order."""
    n = tab.shape[0]
    acc = torch.zeros(SHAPE, dtype=torch.float32, device=tab.device)
    for k in range(reps):
        acc = acc + tab[(idx.long() + k) % n, 0]
    return acc


def selchain(tab, idx, reps=SELCHAIN_REPS):
    """Kernel P18 on CUDA tensors, selchain_plain on CPU tensors.

    Replaces tools/probe_r2c.py::gather_selchain (pallas_call :142). A
    thread a lane, the unrolled n-step compare-select chain over a shared
    copy of tab[:, 0] (n 64 or 256). Bounded by the chain's n selects a
    step (operations)."""
    if not common.on_card(tab):
        return selchain_plain(tab, idx, reps)
    n = tab.shape[0]
    if n not in SELCHAIN_N:
        raise ValueError(f"the select-chain kernel takes n in {SELCHAIN_N}")
    common.check_tensor(tab, "tab", torch.float32, (n, 4), tab.device)
    common.check_tensor(idx, "idx", torch.int32, SHAPE, tab.device)
    out = torch.empty(SHAPE, dtype=torch.float32, device=tab.device)
    common.launch("probe_selchain", "vimg_probe_selchain", tab.device, tab,
                  idx, n, reps, out)
    return out


# ---------------------------------------------------------------------------
# P19: matrix precision
# ---------------------------------------------------------------------------

def tf32(x):
    """float32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 does: to 10
    mantissa bits, to nearest, ties away from zero (finite inputs)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def mm_inputs(a, b, form):
    """The inputs as the kernel's ``form`` multiplies them."""
    return (tf32(a), tf32(b)) if form == "default" else (a, b)


def matmul_plain(a, b, form):
    """Plain version of kernel P19: the float64 product of the form's
    inputs (``mm_inputs``), rounded to float32."""
    a, b = mm_inputs(a, b, form)
    return (a.double() @ b.double()).float()


def matmul(a, b, form):
    """Kernel P19 on CUDA tensors, matmul_plain on CPU tensors.

    Replaces tools/probe_r2c.py::mxu_precision (pallas_call :170).
    ``form`` "default": TF32 mma.sync m16n8k8 (inputs rounded by
    cvt.rna.tf32.f32), a warp a 16 x 8 tile; "highest": 16 x 16 float32
    tiles through shared memory, fmaf in k order. Bounded by the tensor
    cores' / FP32 rate (2 x 256^3 flops)."""
    if form not in MM_U:
        raise ValueError(f"unknown form {form!r} ({tuple(MM_U)})")
    if not common.on_card(a):
        return matmul_plain(a, b, form)
    for name, t in (("a", a), ("b", b)):
        common.check_tensor(t, name, torch.float32, (MM, MM), a.device)
    out = torch.empty((MM, MM), dtype=torch.float32, device=a.device)
    common.launch("probe_mxu_precision", "vimg_probe_matmul", a.device, a, b,
                  int(form == "default"), out)
    return out


def matmul_inputs(device="cpu"):
    rs = np.random.RandomState(2)
    a = rs.randn(MM, MM).astype(np.float32)
    b = rs.randn(MM, MM).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def matmul_errors(a, b, out, form):
    """(the tool's metric, the largest |out - exact| / (2 K u (|A| |B|))
    with the form's u and exact the float64 product of a and b): both
    logged only."""
    exact = a.double() @ b.double()
    err = (out.double() - exact).abs()
    tool = float((err / exact.abs().clamp_min(1e-3)).max())
    bound = 2 * MM * MM_U[form] * (a.double().abs() @ b.double().abs())
    return tool, float((err / bound).max())


def matmul_held(a, b, out, form):
    """The largest |out - matmul_plain| / (2 K 2^-24 (|A~| |B~|)), A~, B~
    the form's inputs: P19's gate, at most 1 for a kernel that computes
    the form's product."""
    ra, rb = mm_inputs(a, b, form)
    err = (out.double() - matmul_plain(a, b, form).double()).abs()
    bound = 2 * MM * MM_ACC_U * (ra.double().abs() @ rb.double().abs())
    return float((err / bound).max())


# ---------------------------------------------------------------------------
# P20: two dependent chains
# ---------------------------------------------------------------------------

def rate_consts(dtype):
    return rounded([1.000001, 1e-6, 1.0], dtype)


def rate_plain(x, dtype, fused=False, iters=RATE_ITERS):
    """Plain version of kernel P20: (32, 128) float32 -> float32."""
    c1, c2, one = const_tensors(rate_consts(dtype), dtype, x.device)
    a = x.to(c1.dtype)
    b = a + one
    for _ in range(iters):
        a = common.madd(a, c1, c2, fused)
        b = common.madd(b, c1, a * c2, fused)
    return (a + b).float()


def rate(x, dtype, fused=False, iters=RATE_ITERS, n_blocks=1):
    """Kernel P20 on a CUDA tensor, rate_plain on a CPU tensor; returns
    (out, blocks).

    Replaces tools/probe_r2c.py::vpu_rate (pallas_call :203). Layout as
    P13; two dependent chains an element, so bounded by latency at one
    block (by design) and by the issue rate on the full card."""
    if not common.on_card(x):
        return rate_plain(x, dtype, fused, iters), 1
    return vpu("rate", x, rate_consts(dtype), dtype, fused, iters, n_blocks)


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

def _time(fn, dev, reps=20):
    return common.device_ms(fn, reps) if dev.type == "cuda" else None


def gather_take(n, device="cuda", log=None):
    """Logs (us a gather, correct); returns (tab, idx, out, ms)."""
    dev = common.resolve_device(device)
    tab, idx = take_table(n, dev), indices(n, dev)
    out = take(tab, idx)
    ms = _time(lambda: take(tab, idx), dev)
    # the tool's check: its float32 sum, compared with np.allclose
    lane = torch.arange(128, device=dev)
    exp = sum(tab[(idx.long() + k) % n, lane] for k in range(TAKE_REPS))
    (log or common.Log(dev))(
        probe="gather_take", n=n,
        us_per_gather=None if ms is None else ms * 1e3 / TAKE_REPS,
        correct=bool(torch.allclose(out, exp)))
    return tab, idx, out, ms


def gather_onehot(n, device="cuda", log=None):
    """Logs (us a gather, max_err as the tool computes it, max_err_bf16);
    returns (tab, idx, out, ms)."""
    dev = common.resolve_device(device)
    tab, idx = onehot_table(n, dev), indices(n, dev)
    out = onehot(tab, idx)
    ms = _time(lambda: onehot(tab, idx), dev)
    i = idx.long()
    exp = sum(tab[(i + k) % n, 0] for k in range(ONEHOT_REPS))
    (log or common.Log(dev))(
        probe="gather_onehot", n=n,
        us_per_gather=None if ms is None else ms * 1e3 / ONEHOT_REPS,
        max_err=float((out - exp).abs().max()),
        max_err_bf16=float((out.double()
                            - ONEHOT_REPS * tab.double()[i, 0]).abs().max()))
    return tab, idx, out, ms


def gather_selchain(n, device="cuda", log=None):
    """Logs (us a gather, correct); returns (tab, idx, out, ms)."""
    dev = common.resolve_device(device)
    tab, idx = selchain_table(n, dev), indices(n, dev)
    out = selchain(tab, idx)
    ms = _time(lambda: selchain(tab, idx), dev)
    exp = sum(tab[(idx.long() + k) % n, 0] for k in range(SELCHAIN_REPS))
    (log or common.Log(dev))(
        probe="gather_selchain", n=n,
        us_per_gather=None if ms is None else ms * 1e3 / SELCHAIN_REPS,
        correct=bool(torch.allclose(out, exp)))
    return tab, idx, out, ms


def mxu_precision(device="cuda", log=None):
    """Both forms; logs the tool's metric, the ratio to the bound against
    float64, the ratio to the gate against the plain version (<= 1 holds)
    and the time. Returns (a, b, {form: (out, ms)})."""
    dev = common.resolve_device(device)
    a, b = matmul_inputs(dev)
    log = log or common.Log(dev)
    res = {}
    for form in MM_U:
        out = matmul(a, b, form)
        ms = _time(lambda: matmul(a, b, form), dev)
        tool, ratio = matmul_errors(a, b, out, form)
        log(probe="mxu_precision", form=form, rel_err=tool,
            bound_ratio=ratio, held_ratio=matmul_held(a, b, out, form),
            us=None if ms is None else ms * 1e3)
        res[form] = (out, ms)
    return a, b, res


def vpu_rate(dtype, device="cuda", iters=RATE_ITERS, log=None):
    """P20 in both forms, one block and the full card; logs Gop/s (4 ops
    a step, as the tool counts). Returns (x, {(fused, card): (out, ms,
    blocks)})."""
    dev = common.resolve_device(device)
    x = tile(3, dev)
    return x, common.rate_probe(
        lambda f, nb: rate(x, dtype, f, iters, nb), iters * 4 * ROWS * 128,
        log or common.Log(dev), probe="vpu", dtype=dtype, iters=iters)


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for n in TAKE_N:
        gather_take(n, dev, log)
    for n in ONEHOT_N:
        gather_onehot(n, dev, log)
    for n in SELCHAIN_N:
        gather_selchain(n, dev, log)
    mxu_precision(dev, log)
    for dtype in ("f32", "bf16"):
        vpu_rate(dtype, dev, log=log)


if __name__ == "__main__":
    main()
