"""Which mixed-precision select forms run, and at what rate (port of
tools/probe_vpu3.py).

Four bodies over a (32, 128) tile, 200 steps, the four states summed in
float32 at the end:

- ``f32cmp+bf16where``: the mix of probe_vpu2 in bf16, compared in float32;
- ``f32cmp+arith-sel``: the same with the select written as ``m * a + (1
  - m) * c`` (``m`` the 0/1 mask in bf16);
- ``bf16math+f32state``: float32 state, each multiply rounded through
  bf16;
- ``bf16 sqrt/exp``: ``a = sqrt(a * a + 0.1)``, ``b = exp(-b * 0.01)`` in
  bf16.

Each runs in two forms of its multiply-adds: separate (as the TPU probe)
and fused (one rounding). ``bf16math+f32state`` has none to fuse: its
product is rounded to bf16 before the float32 add.

``vpu3`` is kernel P15 (``csrc/probe_vpu.cu``) for CUDA tensors and
``vpu3_plain`` for CPU tensors. ``run`` is the probe of one form; it logs
the tool's Gop/s (10 ops a step, as the tool counts) and whether the output
is finite, for one block (the probe's size) and for the full card.

Run: ``python -m vimg_tpu_torch.probes.probe_vpu3 [--device cpu]
[--out records.jsonl]``.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.probes import common
from vimg_tpu_torch.probes.probe_vpu2 import ROWS, SHAPE, tile

FORMS = ("f32cmp+bf16where", "f32cmp+arith-sel", "bf16math+f32state",
         "bf16 sqrt/exp")
ITERS = 200
BF = torch.bfloat16
# [c1, 0.5, 0.25, 0.75, 1e-7, 2e-7, 1.0, 0.1, 0.01] rounded to bf16, then
# [0.5, 0.25, 0.75, 1e-7, 2e-7] rounded to float32 (bf16math+f32state)
K = ([common.bf16(v) for v in (1.0000013, 0.5, 0.25, 0.75, 1e-7, 2e-7, 1.0,
                               0.1, 0.01)]
     + [common.f32(v) for v in (0.5, 0.25, 0.75, 1e-7, 2e-7)])


def _sqrt(v):
    """bf16 square root, correctly rounded (the float64 root rounds
    correctly to float32 and then to bf16)."""
    return torch.sqrt(v.double()).to(BF)


def _exp(v):
    """bf16 exp: the float32 exp rounded once to bf16, as the kernel and
    XLA compute it."""
    return torch.exp(v.float()).to(BF)


def vpu3_plain(x, form, fused=False, iters=ITERS):
    """Plain version of kernel P15: (32, 128) float32 -> float32."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r} ({FORMS})")
    kb = [torch.tensor(v, dtype=BF, device=x.device) for v in K[:9]]
    c1, h, q, tq, e1, e2, one, tenth, hundredth = kb
    if form == "bf16math+f32state":
        hf, qf, tqf, e1f, e2f = K[9:]
        a, b, c, d = x, x + hf, x + qf, x + tqf
        for _ in range(iters):
            a = (a.to(BF) * c1).float() + e1f
            b = (b.to(BF) * c1).float() + e2f
            hit = (a > b) & (c < d)
            c = torch.where(hit, a, c)
            d = torch.where(hit, b, d) + e1f
        return a + b + c + d
    xb = x.to(BF)
    if form == "bf16 sqrt/exp":
        a = b = xb + h
        for _ in range(iters):
            a = _sqrt(common.madd(a, a, tenth, fused))
            b = _exp(-b * hundredth)
        return a.float() + b.float()
    a, b, c, d = xb, xb + h, xb + q, xb + tq
    for _ in range(iters):
        a = common.madd(a, c1, e1, fused)
        b = common.madd(b, c1, e2, fused)
        hit = (a.float() > b.float()) & (c.float() < d.float())
        if form == "f32cmp+bf16where":
            c = torch.where(hit, a, c) * c1
            d = torch.where(hit, b, d) + e1
        else:
            m = hit.float().to(BF)
            im = one - m
            c = common.madd(m, a, im * c, fused) * c1
            d = common.madd(m, b, im * d, fused) + e1
    return a.float() + b.float() + c.float() + d.float()


def vpu3(x, form, fused=False, iters=ITERS, n_blocks=1):
    """Kernel P15 on a CUDA tensor, vpu3_plain on a CPU tensor; returns
    (out, blocks): ``n_blocks`` 1 is the probe's size, 0 the full card.

    Replaces tools/probe_vpu3.py::run (pallas_call :55) with the bodies
    mix_f32cmp_bf16sel (:67), mix_f32cmp_arith_sel (:84),
    mix_f32sel_bf16math (:103) and bf16_transcendentals (:118). One block
    of 1024 threads, 2 bf16 pairs (or 4 float32 elements) each. Bounded by
    the dependent chain at one block, by the issue rate on the full
    card."""
    if not common.on_card(x):
        return vpu3_plain(x, form, fused, iters), 1
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r} ({FORMS})")
    if not 0 <= iters < 2 ** 31:
        raise ValueError(f"iters {iters} out of range")
    dev = x.device
    common.check_tensor(x, "x", torch.float32, SHAPE, dev)
    k = common.device_consts(K, dev)
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    grid = common.card_grid()
    common.launch("probe_vpu3", "vimg_probe_vpu3", dev, x, k,
                  FORMS.index(form), int(fused), iters, n_blocks, grid, out)
    return out, grid.value


def run(form, device="cuda", iters=ITERS, log=None):
    """The probe of one form on the tool's input (RandomState(4)); logs
    Gop/s and finiteness per form of its multiply-adds, one block and the
    full card. Returns (x, {(fused, card): (out, ms, blocks)})."""
    dev = common.resolve_device(device)
    x = tile(4, dev)
    log = log or common.Log(dev)
    res = common.rate_probe(lambda f, nb: vpu3(x, form, f, iters, nb),
                            10 * iters * ROWS * 128, log, probe="vpu3",
                            name=form, iters=iters)
    log(probe="vpu3", name=form, finite=all(
        bool(torch.isfinite(out).all()) for out, _, _ in res.values()))
    return x, res


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    for form in FORMS:
        run(form, dev, log=log)


if __name__ == "__main__":
    main()
