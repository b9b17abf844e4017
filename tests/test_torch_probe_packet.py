"""The packet-primitive probes of vimg_tpu_torch.probes against vimg_tpu's
own tools/ probes on the CPU: P5-P10 (probe_r4a) and P11 (probe_r4c).

The probe functions of tools/probe_r4a.py and tools/probe_r4c.py run as
they are, at reduced repetitions (reps 16, ffs reps 4) and packet counts
(4 for stages 0-3, 1 and 4 for stage 4), with pl.pallas_call made to
interpret and to record each call's inputs and outputs, jax.jit made the
identity (so the recording sees arrays, not tracers), the module's log
captured and its OUT file moved
under the test's temporary directory. np.random is seeded before each
probe (probe_r4a draws from the global generator). The port's plain
versions are held to the recorded outputs.

Tolerance: bit-equality for every output. XLA's CPU backend contracts
a * b + c into one fused multiply-add where the host has FMA, so an
interpret-mode kernel there rounds otherwise than the kernel it
interprets, the port's plain version and the card (built with
-fmad=false), which round every product. The references are therefore
computed in a child process whose XLA may use no instruction set above AVX
(``--xla_cpu_max_isa=AVX``: no FMA), where XLA rounds as written.
"""
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vimg_tpu_torch.probes import common, probe_r4a, probe_r4c

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PALLAS_CALL = pl.pallas_call
REPS, FFS_REPS = 16, 4
# (name, probe_r4a function, keyword arguments) as tools/probe_r4a.main
R4A = (("setup_static", "probe_setup", dict(static_packet=True, reps=REPS)),
       ("setup_dynamic", "probe_setup", dict(static_packet=False, reps=REPS)),
       ("dynrow", "probe_dynrow", dict(reps=REPS)),
       ("ffs16", "probe_ffs", dict(n_live=16, reps=FFS_REPS)),
       ("ffs4", "probe_ffs", dict(n_live=4, reps=FFS_REPS)),
       ("epilogue", "probe_epilogue", dict(reps=REPS)),
       ("dynblock_par", "probe_dynblock", dict(reps=REPS, parallel=True)),
       ("dynblock_chain", "probe_dynblock", dict(reps=REPS, parallel=False)),
       ("dynrow_par", "probe_dynrow_par", dict(reps=REPS)))
R4C = ((0, 4), (1, 4), (2, 4), (3, 4), (4, 1), (4, 4))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _record(module, out_dir):
    """For the rest of this (child) process: pallas_call interprets and
    records, jax.jit is the identity, ``module.log`` is captured and
    ``module.OUT`` lies in ``out_dir``. Returns the lists the probe
    fills."""
    calls, records = [], []

    def pallas_call(kernel, **kw):
        fn = PALLAS_CALL(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            return out
        return run

    pl.pallas_call = pallas_call
    jax.jit = lambda f, *a, **k: f
    module.log = lambda **kw: records.append(kw)
    module.OUT = os.path.join(out_dir, os.path.basename(module.OUT))
    return calls, records


def _references(path):
    """Child process: every reference of this file into ``path`` (npz):
    the last recorded call of each probe (inputs, output) and its record."""
    jax.config.update("jax_platforms", "cpu")
    out_dir = os.path.dirname(path)
    ref = {}
    r4a = importlib.import_module("tools.probe_r4a")
    calls, records = _record(r4a, out_dir)
    for seed, (name, fn, kw) in enumerate(R4A):
        np.random.seed(seed)
        n = len(calls)
        getattr(r4a, fn)(**kw)
        assert len(calls) > n and "err" not in records[-1], records[-1]
        args, out = calls[-1]
        ref.update({f"{name}_in{k}": a for k, a in enumerate(args)})
        ref[f"{name}_out"] = out
        ref[f"{name}_record"] = np.array(json.dumps(records[-1]))
    r4c = importlib.import_module("tools.probe_r4c")
    calls, records = _record(r4c, out_dir)
    for stage, n_packets in R4C:
        r4c.run_stage(stage, n_packets)
        args, out = calls[-1]
        name = f"stage{stage}_{n_packets}"
        ref.update({f"{name}_in{k}": a for k, a in enumerate(args)})
        ref[f"{name}_out"] = out
        ref[f"{name}_record"] = np.array(json.dumps(records[-1]))
    np.savez(path, **ref)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The TPU probes' outputs, computed in a child process whose XLA emits
    no FMA (module docstring)."""
    path = str(tmp_path_factory.mktemp("probe_refs") / "packet.npz")
    env = dict(os.environ, XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import {__name__.split('.')[-1]} as t; t._references({path!r})")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _case(refs, name):
    args = []
    while f"{name}_in{len(args)}" in refs:
        args.append(torch.from_numpy(refs[f"{name}_in{len(args)}"]))
    return (args, refs[f"{name}_out"],
            json.loads(str(refs[f"{name}_record"])))


@pytest.mark.parametrize("name", [r[0] for r in R4A])
def test_r4a_matches_the_probe(refs, name):
    args, ref, rec = _case(refs, name)
    kw = next(r[2] for r in R4A if r[0] == name)
    before = dict(common.LAUNCHES)
    reps = kw["reps"]
    if name.startswith("setup"):
        got = probe_r4a.setup(args[0], kw["static_packet"], reps)
    elif name == "dynrow":
        got = probe_r4a.dynrow(*args, reps)
    elif name.startswith("ffs"):
        got = probe_r4a.ffs(*args, reps)
    elif name == "epilogue":
        got = probe_r4a.epilogue(args[0], reps)
    elif name.startswith("dynblock"):
        got = probe_r4a.dynblock(*args, reps, kw["parallel"])
    else:
        got = probe_r4a.dynrow_par(*args, reps)
    assert common.LAUNCHES == before              # CPU: the plain version
    assert rec["reps"] == reps
    assert got.shape == ref.shape
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    assert np.isfinite(ref).all() and np.abs(ref).sum() > 0


@pytest.mark.parametrize("stage,n_packets", R4C)
def test_r4c_matches_the_probe(refs, stage, n_packets):
    args, ref, rec = _case(refs, f"stage{stage}_{n_packets}")
    inputs = probe_r4c.stage_inputs("cpu")
    assert all(torch.equal(a, b) for a, b in zip(args, inputs))
    assert (rec["stage"], rec["n_packets"], rec["ok"]) == (stage, n_packets,
                                                          True)
    got = probe_r4c.packet_stage(*args, stage, n_packets)
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    assert float(got.mean()) == pytest.approx(rec["mean"], rel=1e-6)


def _mask_rule(xt, meta, tri, n_packets):
    """Stage 4 as kernel P11 computes it, one ray at a time: the lanes'
    least bt, its code and the set of lanes at it (kernel B5's rule)."""
    out = np.zeros((xt.shape[0], 128), np.float32)
    consts = tri.reshape(-1, 12, 128)
    for w in range(xt.shape[0] // 8):
        x, m = xt[w * 8:(w + 1) * 8], meta[w * 8:(w + 1) * 8]
        for p in range(n_packets):
            for r in range(8):
                ray = torch.tensor([x[r, c * 16 + p] for c in range(8)])
                bt, code, lanes = ray[7], -1, set()
                for i in range(int(m[2, 0])):
                    if not (int(m[1, i]) >> p) & 1:
                        continue
                    c = int(m[0, i])
                    t, hit = probe_r4c._test(
                        torch.from_numpy(consts[c])[None],
                        [v.reshape(1, 1) for v in ray[:7]],
                        torch.tensor(float("inf")))
                    for k in torch.nonzero(hit[0, 0])[:, 0].tolist():
                        tk = t[0, 0, k]
                        if tk < bt:
                            bt, code, lanes = tk, c * 128 + k, {k}
                        elif tk == bt and code >= 0 and k not in lanes:
                            lanes.add(k)
                            code = min(code, c * 128 + k)
                out[w * 8 + r, p] = 0.0 + float(bt)
                out[w * 8 + r, 16 + p] = code
    return out


def test_stage4_lane_mask_rule_equals_the_per_lane_rule():
    """The kernel's per-ray rule (one bt, its code, a lane mask) gives the
    plain version's per-lane result, also under exact ties: two lanes with
    the same triangle, and clusters repeated along the chain."""
    xt, meta, tri = (a.numpy().copy() for a in probe_r4c.stage_inputs("cpu"))
    c = tri.reshape(-1, 12, 128)
    c[:, :, 77] = c[:, :, 5]                      # lane 77 ties with lane 5
    c[7] = c[3]                                   # cluster 7 ties with 3
    meta = meta[:16].copy()
    meta[0, :40] = np.arange(40) % 9              # ids repeat in the chain
    meta[1, :40] |= 1                             # packet 0 always live
    got = probe_r4c.packet_stage_plain(torch.from_numpy(xt[:16]),
                                       torch.from_numpy(meta),
                                       torch.from_numpy(tri), 4, 2)
    assert np.array_equal(_bits(got.numpy()),
                          _bits(_mask_rule(xt[:16], meta, tri, 2)))
    assert (got[:, 16:18] >= 0).any()             # some rays hit


def test_probe_entry_points_on_cpu():
    """device="cpu" runs the plain versions and reports no time."""
    log = common.Log(torch.device("cpu"))
    for _, fn in probe_r4a.PROBES:
        args, out, ms = fn(device="cpu", log=log)
        assert ms is None and np.isfinite(out.numpy()).all()
    for stage, n_packets in probe_r4c.RUNS:
        probe_r4c.run_stage(stage, n_packets, "cpu", log)
    assert len(log.records) == len(probe_r4a.PROBES) + len(probe_r4c.RUNS)
    assert all(r["card"].startswith("cpu") for r in log.records)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            probe_r4a.probe_epilogue()
        with pytest.raises(RuntimeError, match="cpu"):
            probe_r4c.run_stage(0)
