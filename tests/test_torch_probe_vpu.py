"""The arithmetic-rate probes of vimg_tpu_torch.probes against vimg_tpu's own
tools/ probes on the CPU: P12 (probe_prims), P13/P14 (probe_vpu2), P15
(probe_vpu3) and P20 (probe_r2c.vpu_rate).

The tools run as they are in a child process, with pl.pallas_call made to
interpret and to record each call's inputs and output, and jax.jit made the
identity (memoised on its last arguments, so a probe's timing loop
interprets its kernel once). Two cost cuts, not defect hiding (the card
runs the full counts): probe_prims.ITERS is 2,000 (the tool's 200,000
would take about 100 times longer in interpret mode), and the TPU kernel
of probe_prims reads its own output buffer before it writes it, which
Pallas leaves undefined (interpret mode fills it with NaN), so the child
writes zeros into that buffer before the kernel's body runs, as the port's
kernel takes an explicit initial tile (zeros).

Tolerance: bit-equality for every output. The child's XLA computes as the
kernels are written, under three flags: ``--xla_cpu_max_isa=AVX`` (no FMA
contraction of a * b + c), ``--xla_allow_excess_precision=false`` (every
bf16 op rounds to bf16, as the port's plain versions and the card's
__hmul2_rn / __hadd2_rn do; with excess precision XLA keeps bf16
intermediates in float32 and 3,628 of probe_vpu2's 4,096 bf16 fma outputs
differ) and ``--xla_disable_hlo_passes=algsimp`` (the algebraic simplifier
folds probe_prims' four ``v * 1.000001`` of anyred into one ``v *
1.000001**4``, a different rounding). P15's bf16 exp is XLA's and
torch's float32 exp rounded to bf16; the two float32 exps are not
correctly rounded, but on these inputs their bf16 roundings agree
everywhere.
"""
import importlib
import os
import subprocess
import sys
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vimg_tpu_torch.probes import (common, probe_prims, probe_r2c,
                                   probe_vpu2, probe_vpu3)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PALLAS_CALL = pl.pallas_call
XLA_AS_WRITTEN = (" --xla_cpu_max_isa=AVX --xla_allow_excess_precision=false"
                  " --xla_disable_hlo_passes=algsimp")
PRIMS_ITERS = 2000
VPU3_BODIES = ("mix_f32cmp_bf16sel", "mix_f32cmp_arith_sel",
               "mix_f32sel_bf16math", "bf16_transcendentals")


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _saveable(a):
    """An array np.savez keeps: bf16 widened to float32 (exact)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def record_pallas(zero_outputs=False):
    """For the rest of this (child) process: pallas_call interprets and
    records (inputs, output; bf16 widened to float32) of each call (with
    ``zero_outputs`` the kernel's output buffer is zeroed before its body
    runs), and jax.jit is the identity memoised on its last arguments.
    Returns the list of calls."""
    calls = []

    def pallas_call(kernel, **kw):
        kw.pop("interpret", None)
        body = kernel
        if zero_outputs:
            def body(*refs):
                refs[-1][...] = jax.numpy.zeros(refs[-1].shape,
                                                refs[-1].dtype)
                kernel(*refs)
        fn = PALLAS_CALL(body, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            calls.append(([_saveable(a) for a in args], _saveable(out)))
            return out
        return run

    def jit(f, *a, **k):
        last = []

        def run(*args):
            if not (last and len(args) == len(last[0])
                    and all(x is y for x, y in zip(args, last[0]))):
                last[:] = [args, f(*args)]
            return last[1]
        return run

    pl.pallas_call = pallas_call
    jax.jit = jit
    return calls


def run_child(test_module, name, tmp_path_factory):
    """``test_module._references(path)`` in a child process whose XLA
    computes as written (module docstring); returns the saved arrays."""
    path = str(tmp_path_factory.mktemp("probe_refs") / f"{name}.npz")
    env = dict(os.environ, XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + XLA_AS_WRITTEN, JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import {test_module} as t; t._references({path!r})")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _references(path):
    """Child process: the last recorded call of every probe (inputs,
    output) into ``path``."""
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    ref, seen = {}, []

    def keep(name, calls):
        assert len(calls) > len(seen), name          # the probe ran a kernel
        seen[:] = calls
        args, out = calls[-1]
        ref.update({f"{name}_in{k}": a for k, a in enumerate(args)})
        ref[f"{name}_out"] = out

    prims = importlib.import_module("tools.probe_prims")
    prims.ITERS = PRIMS_ITERS
    calls = record_pallas(zero_outputs=True)
    for prim in probe_prims.PRIMS:
        for n_rep in (1, 4):
            prims.run(prim, n_rep, prim == "sload")
            keep(f"prims_{prim}_{n_rep}", calls)
    calls = record_pallas()
    seen.clear()
    vpu2 = importlib.import_module("tools.probe_vpu2")
    vpu3 = importlib.import_module("tools.probe_vpu3")
    r2c = importlib.import_module("tools.probe_r2c")
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        vpu2.fma_throughput(dt)
        keep(f"fma_{name}", calls)
        vpu2.mix_throughput(dt)
        keep(f"mix_{name}", calls)
        r2c.vpu_rate(dt)
        keep(f"rate_{name}", calls)
    for form, body in zip(probe_vpu3.FORMS, VPU3_BODIES):
        vpu3.run(form, getattr(vpu3, body))
        keep(f"vpu3_{VPU3_BODIES.index(body)}", calls)
    np.savez(path, **ref)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_child(__name__.split(".")[-1], "vpu", tmp_path_factory)


def _same(got, ref):
    assert got.shape == ref.shape
    assert np.array_equal(bits(got.numpy()), bits(ref))
    assert np.isfinite(ref).all()


@pytest.mark.parametrize("prim", probe_prims.PRIMS)
@pytest.mark.parametrize("n_rep", [1, 4])
def test_prims_matches_the_probe(refs, prim, n_rep):
    name = f"prims_{prim}_{n_rep}"
    tab = torch.from_numpy(refs[f"{name}_in0"])
    assert torch.equal(tab, probe_prims.table())
    init = torch.zeros(probe_prims.SHAPE)
    before = dict(common.LAUNCHES)
    got, blocks = probe_prims.prims(tab, init, prim, n_rep, PRIMS_ITERS)
    assert common.LAUNCHES == before and blocks == 1    # the plain version
    _same(got, refs[f"{name}_out"])


@pytest.mark.parametrize("kind", ["fma", "mix", "rate"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vpu2_and_rate_match_the_probe(refs, kind, dtype):
    fn, seed = {"fma": (probe_vpu2.fma, 3), "mix": (probe_vpu2.mix, 4),
                "rate": (probe_r2c.rate, 3)}[kind]
    x = torch.from_numpy(refs[f"{kind}_{dtype}_in0"])
    assert torch.equal(x, probe_vpu2.tile(seed))
    got, _ = fn(x, dtype)
    _same(got, refs[f"{kind}_{dtype}_out"])


@pytest.mark.parametrize("form", probe_vpu3.FORMS)
def test_vpu3_matches_the_probe(refs, form):
    i = probe_vpu3.FORMS.index(form)
    x = torch.from_numpy(refs[f"vpu3_{i}_in0"])
    assert torch.equal(x, probe_vpu2.tile(4))
    got, _ = probe_vpu3.vpu3(x, form)
    _same(got, refs[f"vpu3_{i}_out"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rounds_once(dtype):
    """common.fused, the plain version of __fmaf_rn / __hfma2, returns the
    representable value nearest the exact a * c + d (ties to even)."""
    rs = np.random.RandomState(5)
    a, c, d = (torch.from_numpy(v.astype(np.float32)).to(dtype) for v in (
        rs.rand(400), rs.rand(400) * 2, rs.randn(400) * 1e-3))
    got = common.fused(a, c, d)
    view = torch.int32 if dtype == torch.float32 else torch.int16
    for i in range(400):
        exact = Fraction(float(a[i])) * Fraction(float(c[i])) \
            + Fraction(float(d[i]))
        g = got[i:i + 1]
        err = abs(Fraction(float(g)) - exact)
        for nb in (g.view(view) - 1, g.view(view) + 1):
            assert err <= abs(Fraction(float(nb.view(dtype))) - exact)
    assert not torch.equal(got, a * c + d)     # it is not two roundings


def test_fused_forms_on_cpu():
    """The fused plain versions run and differ from the separate ones in
    float32; in bf16 the multiplier is 1.0 (ROADMAP C16), so they agree."""
    x3, x4 = probe_vpu2.tile(3), probe_vpu2.tile(4)
    for fn, x in ((probe_vpu2.fma, x3), (probe_vpu2.mix, x4),
                  (probe_r2c.rate, x3)):
        sep, fus = fn(x, "f32")[0], fn(x, "f32", True)[0]
        assert not torch.equal(sep, fus)
        # one rounding fewer a step; mix's compare-selects can amplify it
        assert float((sep - fus).abs().max()) < 1e-3 * float(sep.abs().max())
        assert torch.equal(fn(x, "bf16")[0], fn(x, "bf16", True)[0])


def test_probe_entry_points_on_cpu():
    """device="cpu" runs the plain versions, logs the tool's keys and no
    time."""
    log = common.Log(torch.device("cpu"))
    res = probe_prims.run("anyred", "cpu", iters=20, log=log)
    assert set(res) == {(1, False), (4, False)}
    probe_vpu2.fma_throughput("bf16", "cpu", iters=5, log=log)
    probe_vpu2.mix_throughput("f32", "cpu", iters=5, log=log)
    probe_vpu3.run("bf16 sqrt/exp", "cpu", iters=5, log=log)
    probe_r2c.vpu_rate("f32", "cpu", iters=5, log=log)
    recs = log.records
    assert recs[0]["prim"] == "anyred" and recs[0]["ns_per_prim"] is None
    assert all(r["card"].startswith("cpu") for r in recs)
    assert [r["form"] for r in recs[1:3]] == ["separate", "fused"]
    assert [r["finite"] for r in recs if "finite" in r] == [True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            probe_vpu2.fma_throughput("f32")
