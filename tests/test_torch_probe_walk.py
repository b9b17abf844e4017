"""The walk-cost probes of vimg_tpu_torch.probes against vimg_tpu's own
tools/ probes on the CPU: the bounce rays (probes/rays.py), P1
(probe_walkablate), P2 (probe_r3b.microbench_sync), P3
(probe_r3c.smem_read_cost) and P4 (probe_regen.probe_smem_dynamic_write).

The TPU probes' own Pallas kernels run in interpret mode, built as the
probes build them; no Pallas kernel of the vimg_tpu package runs. For
P2-P4 the probe functions run as they are, with pl.pallas_call made to
interpret and to record each call's inputs and outputs, jax.jit made the
identity (so the recording sees arrays, not tracers) and the module's log
captured; the port's plain versions are held to the recorded outputs.

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
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vimg_tpu_torch.geometry.cluster_trace import ClusterData
from vimg_tpu_torch.probes import (common, probe_r3b, probe_r3c, probe_regen,
                                   probe_walkablate as pw)
from vimg_tpu_torch.probes.rays import bounce_batches
from vimg_tpu_torch.scene.synthetic import terrain_scene

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N_RAYS, TILE_ROWS = 2048, 8
PALLAS_CALL = pl.pallas_call
RECORDED = (("sync", "tools.probe_r3b", "microbench_sync"),
            ("smem_read", "tools.probe_r3c", "smem_read_cost"),
            ("stack", "tools.probe_regen", "probe_smem_dynamic_write"))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _walk_case():
    scene = terrain_scene(2000, 64, 32, device="cpu")
    data = ClusterData(scene)
    return (data, pw.probe_tables(data, "cpu"),
            pw.sorted_bounce_rays(scene, data, N_RAYS))


def _probe_kernel(data, rays, variant):
    """tools/probe_walkablate.py's kernel in interpret mode, built as its
    main() builds it (tile_rows 8 here); returns (bt, visits per tile)."""
    tools_walk = importlib.import_module("tools.probe_walkablate")
    n_tiles = N_RAYS // (TILE_ROWS * 128)
    shape = jax.ShapeDtypeStruct((N_RAYS // 128, 128), jnp.float32)
    ray_spec = pl.BlockSpec((TILE_ROWS, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)
    ro, rd, mn, mx = (x.numpy() for x in rays)

    def pack(x):
        return jnp.asarray(x).reshape(-1, 128)

    args = ([pack(ro[:, k]) for k in range(3)]
            + [pack(rd[:, k]) for k in range(3)] + [pack(mn), pack(mx)])
    kern = tools_walk.make_kernel(data.n_nodes, data.max_k, variant)
    fn = pl.pallas_call(
        kern, grid=(n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 3
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] + [ray_spec] * 8,
        out_shape=(shape, jax.ShapeDtypeStruct((n_tiles * 8, 128),
                                               jnp.float32)),
        out_specs=(ray_spec, pl.BlockSpec((8, 128), lambda i: (i, 0),
                                          memory_space=pltpu.VMEM)),
        interpret=True)
    bt, nv = fn(data.node_aabbs, data.node_cid, data.node_skip,
                data.tri_rows, *args)
    return (np.asarray(bt).reshape(-1),
            np.asarray(nv).reshape(n_tiles, 8, 128)[:, 0, 0])


def _record(module):
    """For the rest of this (child) process: pallas_call interprets and
    records, jax.jit is the identity, ``module.log`` is captured. Returns
    the (calls, records) lists the probe fills."""
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
    return calls, records


def _references(path):
    """Child process: every reference of this file into ``path`` (npz)."""
    jax.config.update("jax_platforms", "cpu")
    ref = {}
    data, _, rays = _walk_case()
    for v in pw.VARIANTS:
        ref[f"walk_{v}_bt"], ref[f"walk_{v}_nv"] = _probe_kernel(data, rays, v)
    for name, mod_name, fn in RECORDED:
        module = importlib.import_module(mod_name)
        calls, records = _record(module)
        getattr(module, fn)()
        ref[f"{name}_records"] = np.array(json.dumps(records))
        for j, (args, out) in enumerate(calls):
            for k, a in enumerate(args):
                ref[f"{name}_{j}_in{k}"] = a
            ref[f"{name}_{j}_out"] = out
    np.savez(path, **ref)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The TPU probes' outputs, computed in a child process whose XLA emits
    no FMA (module docstring)."""
    path = str(tmp_path_factory.mktemp("probe_refs") / "walk.npz")
    env = dict(os.environ, XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import {__name__.split('.')[-1]} as t; t._references({path!r})")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# bounce rays and P1
# ---------------------------------------------------------------------------

def test_bounce_batches_match_the_probe():
    from vimg_tpu.scene.synthetic import terrain_scene as jax_terrain
    tools_r3b = importlib.import_module("tools.probe_r3b")
    ro_j, rd_j = tools_r3b.bounce_batches(jax_terrain(2000, 64, 32), B=N_RAYS)
    ro, rd = bounce_batches(terrain_scene(2000, 64, 32, device="cpu"),
                            B=N_RAYS)
    assert ro.dtype == rd.dtype == torch.float32
    assert np.array_equal(_bits(ro_j), _bits(ro.numpy()))
    assert np.array_equal(_bits(rd_j), _bits(rd.numpy()))


@pytest.fixture(scope="module")
def walk_case():
    return _walk_case()


@pytest.mark.parametrize("variant", pw.VARIANTS)
def test_walkablate_matches_the_probe_kernel(refs, walk_case, variant):
    data, tables, rays = walk_case
    bt_ref, nv_ref = refs[f"walk_{variant}_bt"], refs[f"walk_{variant}_nv"]
    before = dict(common.LAUNCHES)
    bt, nv = pw.walkablate(*tables, *rays, variant, TILE_ROWS * 128)
    assert common.LAUNCHES == before              # CPU: the plain version
    assert np.array_equal(_bits(bt.numpy()), _bits(bt_ref))
    assert np.array_equal(nv.numpy(), nv_ref.astype(np.int32))
    if variant == "full":
        assert np.isfinite(bt_ref).mean() > 0.25  # 31% of these rays hit
    else:
        assert np.isinf(bt_ref).all()
    if variant == "no_slab":
        assert (nv_ref == data.n_nodes).all()


def test_walkablate_groups(walk_case):
    """bt does not depend on the group; a group's visits are at least the
    most any of its rays makes alone and at most the nodes."""
    data, tables, rays = walk_case
    bt1, nv1 = pw.walkablate_plain(*tables, *rays, "full", 1)
    for group in (32, 1024):
        bt, nv = pw.walkablate_plain(*tables, *rays, "full", group)
        assert torch.equal(bt.view(torch.int32), bt1.view(torch.int32))
        most = nv1.view(-1, group).amax(1)
        assert bool((nv >= most).all() and (nv <= data.n_nodes).all())
    with pytest.raises(ValueError, match="groups"):
        pw.walkablate_plain(*tables, *rays, "full", 3)


# ---------------------------------------------------------------------------
# P2-P4: the probes' own functions, recorded
# ---------------------------------------------------------------------------

def _calls(refs, name):
    """[(inputs, output)] of the recorded probe ``name``, and its records."""
    n = sum(1 for k in refs if k.startswith(f"{name}_") and k.endswith("_out"))
    calls = [([torch.from_numpy(refs[f"{name}_{j}_in{k}"])
               for k in range(sum(1 for key in refs
                                  if key.startswith(f"{name}_{j}_in")))],
              refs[f"{name}_{j}_out"]) for j in range(n)]
    return calls, json.loads(str(refs[f"{name}_records"]))


def test_sync_matches_the_probe(refs):
    calls, records = _calls(refs, "sync")
    assert [r["mode"] for r in records] == list(probe_r3b.MODES)
    assert len(calls) == 2 * len(probe_r3b.MODES)     # warm-up + timed
    for i, mode in enumerate(probe_r3b.MODES):
        (x,), ref = calls[2 * i + 1]
        got = probe_r3b.sync(x, mode)
        assert np.array_equal(_bits(got.numpy()), _bits(ref)), mode


def test_smem_read_matches_the_probe(refs):
    calls, records = _calls(refs, "smem_read")
    configs = [(r["packed"], r["n_reads"]) for r in records]
    assert configs == list(probe_r3c.CONFIGS)
    for i, (packed, n_reads) in enumerate(configs):
        (x, tab), ref = calls[2 * i + 1]
        assert torch.equal(tab, probe_r3c.probe_table("cpu"))
        got = probe_r3c.smem_read(x, tab, n_reads, packed)
        assert np.array_equal(_bits(got.numpy()), _bits(ref)), (packed,
                                                               n_reads)


def test_stack_matches_the_probe(refs):
    calls, records = _calls(refs, "stack")
    assert records == [dict(probe="smem_dynamic_write", ok=True, v=423.0)]
    (x,), ref = calls[0]
    got = probe_regen.stack_sum(x)
    assert np.array_equal(_bits(got.numpy()), _bits(ref))


# ---------------------------------------------------------------------------
# entry points and package boundary
# ---------------------------------------------------------------------------

def test_probe_entry_points_on_cpu(capsys, tmp_path):
    """device="cpu" runs the plain versions and reports no time; every
    record names the device; --out appends the records."""
    out = tmp_path / "records.jsonl"
    log = common.Log(torch.device("cpu"), str(out))
    x, res = probe_r3b.microbench_sync("cpu", n_iter=50, log=log)
    assert all(ms is None for _, ms in res.values())
    _, _, res = probe_r3c.smem_read_cost("cpu", n_iter=50, log=log)
    _, got, _ = probe_regen.probe_smem_dynamic_write("cpu", log=log)
    assert float(got[0, 0]) == 423.0
    lines = out.read_text().splitlines()
    assert len(lines) == len(probe_r3b.MODES) + len(probe_r3c.CONFIGS) + 1
    assert all('"card": "cpu' in line for line in lines)
    assert all(r["card"].startswith("cpu") for r in log.records)
    assert log.records[0]["us_per_iter"] is None
    assert len(capsys.readouterr().out.splitlines()) == len(lines)


def test_probes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for call in (lambda: probe_r3b.microbench_sync(),
                 lambda: probe_r3c.smem_read_cost(),
                 lambda: probe_regen.probe_smem_dynamic_write(),
                 lambda: common.resolve_device()):
        with pytest.raises(RuntimeError, match="cpu"):
            call()
    with pytest.raises(NotImplementedError):
        common.resolve_device("meta")


def test_probes_import_no_jax_vimg_tpu_or_tools():
    code = ("import importlib, pkgutil, sys\n"
            "import vimg_tpu_torch.probes as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vimg_tpu', 'tools')]\n"
            "assert not bad, bad\n"
            "print(sum(m.startswith('vimg_tpu_torch.probes.') "
            "for m in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 8
