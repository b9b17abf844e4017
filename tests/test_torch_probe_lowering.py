"""The construct checks of vimg_tpu_torch.probes against vimg_tpu's own
tools/ probes on the CPU: P23-P28 (probe_pallas: grid, while, pcg,
scalars, transcendentals, throughput) and P29-P31 (probe_constructs k1-k3).

The tools run as they are in a child process, as in
tests/test_torch_probe_vpu.py (interpret-mode pallas_call recording its
calls, jax.jit the identity memoised on its last arguments, XLA computing
as written). tools/probe_pallas.py runs its six checks (each asserts its
own verdict); tools/probe_constructs.py runs at import and ends by
building vimg_tpu's ClusterTracer (step 4, kernels B3/B4, ported), so only
its source above ``# 4. the real thing`` is executed. t_pcg imports
vimg_tpu.core.rng, which is the reference here.

Tolerances: bit-equality for every output but P27's, and P25 also bit for
bit against the port's core.rng.uniform4. P27 keeps the probe's own gate,
rtol 1e-4 against float64, for the interpreted kernel and the plain
version alike (neither sin, cos, log, exp, atan2 nor pow is correctly
rounded); the two are also held within rtol 1e-6 of each other (56 of
their 1,024 outputs differ in bits on the host this was written on). P28
runs at the probe's full size (2,000 steps, 131,072 lanes), held at rtol
1e-6: its 131,072 outputs are one value, and the interpreted one differs
from the plain version's by 2 ulps here. XLA's CPU rsqrt is an
approximation (it differs from the correctly rounded 1 / sqrt in 190 of
1,024 random inputs on this host, and the approximation depends on the
host's CPU), while the kernel and the plain version both compute 1 /
sqrt(x) in IEEE float32 and are bit-equal on the card. The loop is a
contraction: a 1-ulp change of one step's rsqrt moves the output by at
most about 3e-7 relative.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_probe_vpu import bits, record_pallas, run_child
from vimg_tpu_torch.probes import common, probe_constructs as pc
from vimg_tpu_torch.probes import probe_pallas as pp

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHECKS = ("t_grid", "t_while", "t_pcg", "t_scalars", "t_transcendental",
          "t_throughput")


def _references(path):
    """Child process: each kernel's recorded call into ``path``."""
    import importlib
    jax.config.update("jax_platforms", "cpu")
    calls = record_pallas()
    ref = {}

    def keep(name):
        args, out = calls[-1]
        ref.update({f"{name}_in{k}": a for k, a in enumerate(args)})
        ref[f"{name}_out"] = out

    tool = importlib.import_module("tools.probe_pallas")
    for check in CHECKS:
        n = len(calls)
        getattr(tool, check)()
        assert len(calls) == n + 1, check
        keep(check)
    src = open(os.path.join(ROOT, "tools", "probe_constructs.py")).read()
    src = src[:src.index("# 4. the real thing")]
    printed = []
    scope = {"__name__": "probe_constructs",
             "print": lambda *a, **k: printed.append(" ".join(map(str, a)))}
    n = len(calls)
    exec(compile(src, "tools/probe_constructs.py", "exec"), scope)
    assert len(calls) == n + 3, printed
    for which, (args, out) in zip((1, 2, 3), calls[n:]):
        ref.update({f"k{which}_in{k}": a for k, a in enumerate(args)})
        ref[f"k{which}_out"] = out
    ref["constructs_printed"] = np.array(json.dumps(printed))
    np.savez(path, **ref)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_child(__name__.split(".")[-1], "lowering", tmp_path_factory)


def _args(refs, name):
    args = []
    while f"{name}_in{len(args)}" in refs:
        args.append(torch.from_numpy(refs[f"{name}_in{len(args)}"]))
    return args


def _same(got, ref):
    assert got.shape == ref.shape
    assert np.array_equal(bits(got.numpy()), bits(ref))


def test_grid_matches_the_probe(refs):
    _same(pp.grid("cpu"), refs["t_grid_out"])


def test_while_matches_the_probe(refs):
    (x,) = _args(refs, "t_while")
    assert torch.equal(x, torch.full(pp.TILE, 0.5))
    got = pp.while_loop(x)
    _same(got, refs["t_while_out"])
    assert float(got.max()) >= 100.0


def test_pcg_matches_the_probe_and_the_port_rng(refs):
    got = pp.pcg("cpu")
    _same(got, refs["t_pcg_out"])
    from vimg_tpu_torch.core import rng
    r = rng.uniform4(torch.arange(128), torch.zeros(128, dtype=torch.int64),
                     3, 7)
    assert torch.equal(got[0], r[0] + r[1] * 2.0 + r[2] * 4.0 + r[3] * 8.0)


def test_scalars_match_the_probe(refs):
    (tbl,) = _args(refs, "t_scalars")
    assert torch.equal(tbl, pp.scalars_table())
    got = pp.scalars(tbl)
    _same(got, refs["t_scalars_out"])
    assert float(got[0, 0]) == 45.0


def test_transcendental_within_the_probes_gate(refs):
    (x,) = _args(refs, "t_transcendental")
    assert torch.equal(x, pp.transc_input())
    got = pp.transcendental(x)
    ref = refs["t_transcendental_out"]
    exact = pp.transc_exact(x).numpy()
    for out in (got.numpy(), ref):
        assert np.all(np.abs(out - exact) <= 1e-4 * np.abs(exact))
    # a few ulps apart where they differ (56 of 1,024 outputs on the host
    # this was written on; the count depends on the host's libm and XLA's)
    assert np.all(np.abs(got.numpy() - ref) <= 1e-6 * np.abs(ref))


def test_throughput_matches_the_probe(refs):
    got, blocks = pp.throughput("cpu")
    assert blocks == pp.TP_BLOCKS
    ref = refs["t_throughput_out"]
    assert got.shape == ref.shape and (ref == ref[0, 0]).all()
    assert (got == got[0, 0]).all()
    assert np.all(np.abs(got.numpy() - ref) <= 1e-6 * np.abs(ref))


@pytest.mark.parametrize("which", [1, 2, 3])
def test_constructs_match_the_probe(refs, which):
    args = _args(refs, f"k{which}")
    if which == 1:                       # k1 takes no triangle table
        args.insert(1, pc.inputs()[1])
    for mine, theirs in zip(pc.inputs(), args):
        assert torch.equal(mine, theirs)
    before = dict(common.LAUNCHES)
    got = pc.constructs(*args, which)
    assert common.LAUNCHES == before                  # the plain version
    _same(got, refs[f"k{which}_out"])
    printed = json.loads(str(refs["constructs_printed"]))
    line = next(p for p in printed if p.startswith(f"ok   {which} "))
    assert f"sum={float(got.sum()):.3f}" in line


def test_probe_entry_points_on_cpu():
    """device="cpu" runs the plain versions, logs the tool's verdicts and
    no time."""
    log = common.Log(torch.device("cpu"))
    res = pp.run("cpu", iters=20, log=log)
    assert set(res) == {"grid+blocked-output", "while_loop", "pcg4d",
                        "smem-scalars", "transcendentals", "throughput"}
    pc.run("cpu", log)
    recs = log.records
    assert all(r["ok"] for r in recs) and len(recs) == 6 + 3
    assert all(r["card"].startswith("cpu") for r in recs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            pp.run()
