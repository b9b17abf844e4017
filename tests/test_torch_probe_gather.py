"""The gather-form probes of vimg_tpu_torch.probes against vimg_tpu's own
tools/ probes on the CPU: P16-P19 (probe_r2c: take, onehot, selchain,
mxu_precision) and P21/P22 (probe_r4j: the one-hot lookup and its check).

The tools run as they are in a child process, as in
tests/test_torch_probe_vpu.py (interpret-mode pallas_call recording its
calls, jax.jit the identity memoised on its last arguments, XLA computing
as written), with probe_r4j's OUT file moved under the test's temporary
directory (left alone, it would overwrite bench_records/r4_probe_j.json)
and its log captured. One cost cut, not defect hiding (the card runs the
probe's own counts): probe_r4j's chain runs at reps 1 (its 48 x 32 x 8
unrolled select chain takes about 94 s in interpret mode at reps 8); the
mxu and check forms run at the probe's reps 8 for n_mats 128, 256 and 512.

Tolerances: bit-equality for P16, P17, P18, P21 and P22. P19 is held to
the float64 product within 2 K u (|A| |B|), K = 256, u = 2^-24 (the
interpreted product is float32 whatever its precision argument, so both
forms meet the float32 bound); the tool's own metric divides by max(|exact|,
1e-3), which reads cancellation (ROADMAP C18), and is only logged.
"""
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_probe_vpu import bits, record_pallas, run_child
from vimg_tpu_torch.probes import common, probe_r2c as r2c, probe_r4j as r4j

R4J_REPS = {48: 1, 128: 8, 256: 8, 512: 8}


def _references(path):
    """Child process: every probe's last recorded call (inputs, output)
    and the tool's own results into ``path``."""
    jax.config.update("jax_platforms", "cpu")
    out_dir = os.path.dirname(path)
    ref = {}
    calls = record_pallas()

    def keep(name, text=None):
        args, out = calls[-1]
        ref.update({f"{name}_in{k}": a for k, a in enumerate(args)})
        ref[f"{name}_out"] = out
        if text is not None:
            ref[f"{name}_text"] = np.array(json.dumps(text))

    tool = importlib.import_module("tools.probe_r2c")
    for n in r2c.TAKE_N:
        keep(f"take_{n}", tool.gather_take(n))
    for n in r2c.ONEHOT_N:
        keep(f"onehot_{n}", tool.gather_onehot(n))
    for n in r2c.SELCHAIN_N:
        keep(f"selchain_{n}", tool.gather_selchain(n))
    n = len(calls)
    text = tool.mxu_precision()
    assert len(calls) == n + 2, text
    for form, (args, out) in zip(("default", "highest"), calls[-2:]):
        ref.update({f"mm_{form}_in0": args[0], f"mm_{form}_in1": args[1],
                    f"mm_{form}_out": out})
    ref["mm_text"] = np.array(json.dumps(text))
    tool = importlib.import_module("tools.probe_r4j")
    records = []
    tool.log = lambda **kw: records.append(kw)
    tool.OUT = os.path.join(out_dir, os.path.basename(tool.OUT))
    for n_mats, reps in R4J_REPS.items():
        n = len(calls)
        tool.run(n_mats, reps=reps)
        assert all("err" not in rec for rec in records), records
        methods = ["check", "mxu"] + (["chain"] if n_mats <= 64 else [])
        assert len(calls) == n + len(methods), records
        for method, (args, out) in zip(methods, calls[n:]):
            name = f"r4j_{method}_{n_mats}"
            ref.update({f"{name}_in{k}": a for k, a in enumerate(args)})
            ref[f"{name}_out"] = out
    ref["r4j_records"] = np.array(json.dumps(records))
    np.savez(path, **ref)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_child(__name__.split(".")[-1], "gather", tmp_path_factory)


def _case(refs, name):
    args = []
    while f"{name}_in{len(args)}" in refs:
        args.append(torch.from_numpy(refs[f"{name}_in{len(args)}"]))
    return args, refs[f"{name}_out"]


def _same(got, ref):
    assert got.shape == ref.shape
    assert np.array_equal(bits(got.numpy()), bits(ref))


@pytest.mark.parametrize("n", r2c.TAKE_N)
def test_take_matches_the_probe(refs, n):
    (tab, idx), ref = _case(refs, f"take_{n}")
    assert torch.equal(tab, r2c.take_table(n))
    assert torch.equal(idx, r2c.indices(n))
    before = dict(common.LAUNCHES)
    _same(r2c.take(tab, idx), ref)
    assert common.LAUNCHES == before                  # the plain version
    assert "correct=True" in json.loads(str(refs[f"take_{n}_text"]))


@pytest.mark.parametrize("n", r2c.ONEHOT_N)
def test_onehot_matches_the_probe(refs, n):
    """Bit for bit, including the tool's one-hot of idx, not idx + k
    (ROADMAP C15): the output is exactly 10 bf16(tab)[idx, 0]."""
    (tab, idx), ref = _case(refs, f"onehot_{n}")
    assert torch.equal(tab, r2c.onehot_table(n))
    got = r2c.onehot(tab, idx)
    _same(got, ref)
    assert torch.equal(got, 10 * tab.to(torch.bfloat16).float()[
        idx.long(), 0])
    log = common.Log(torch.device("cpu"))
    r2c.gather_onehot(n, "cpu", log)
    text = json.loads(str(refs[f"onehot_{n}_text"]))
    assert f"max_err={log.records[0]['max_err']:.2e}" in text
    assert log.records[0]["max_err_bf16"] <= 10 * 2.0 ** -9


@pytest.mark.parametrize("n", r2c.SELCHAIN_N)
def test_selchain_matches_the_probe(refs, n):
    (tab, idx), ref = _case(refs, f"selchain_{n}")
    assert torch.equal(tab, r2c.selchain_table(n))
    _same(r2c.selchain(tab, idx), ref)


@pytest.mark.parametrize("form", ["default", "highest"])
def test_matmul_within_its_bound(refs, form):
    (a, b), ref = _case(refs, f"mm_{form}")
    ra, rb = r2c.matmul_inputs()
    assert torch.equal(a, ra) and torch.equal(b, rb)
    got = r2c.matmul(a, b, form)
    # the interpreted product is float32; "default" rounds its inputs to
    # TF32 first, so each is within its form's bound of the other
    bound = 2 * r2c.MM * r2c.MM_U[form] * (a.double().abs()
                                           @ b.double().abs())
    assert bool(((got.double() - torch.from_numpy(ref).double()).abs()
                 <= 2 * bound).all())
    assert r2c.matmul_errors(a, b, got, form)[1] <= 1.0
    assert r2c.matmul_held(a, b, got, form) <= 0.5
    # the interpreted float32 product is within the float32 bound, yet the
    # tool's metric reads 1.87e-3 on it (cancellation: ROADMAP C18)
    tool, ratio = r2c.matmul_errors(a, b, torch.from_numpy(ref), "highest")
    assert ratio <= 1.0 and tool > 1e-3
    assert json.loads(str(refs["mm_text"]))[form] == f"{tool:.2e}"


def test_tf32_rounds_as_cvt_rna():
    """10 mantissa bits kept, to nearest, ties away from zero."""
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -23,
                      1 + 2.0 ** -10 + 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 2.0 ** -12, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10,
                         1 + 2.0 ** -9, -(1 + 2.0 ** -10), 1.0, 3.0e-39],
                        dtype=torch.float32)
    got = r2c.tf32(x)
    assert torch.equal(got[:6], want[:6])
    # a subnormal keeps its top 10 of 23 fraction bits, rounded
    assert (got[6].view(torch.int32) & 0x1FFF) == 0
    assert abs(float(got[6]) - 3.0e-39) <= 2.0 ** -136


@pytest.mark.parametrize("form", ["default", "highest"])
def test_matmul_gate_fails_a_wrong_product(form):
    """P19's gate holds the form's own product and refuses one that
    drops a k-step (8 of 256 terms), or the other form's product."""
    a, b = r2c.matmul_inputs()
    ra, rb = r2c.mm_inputs(a, b, form)
    keep = torch.ones(r2c.MM, dtype=torch.float64)
    keep[8:16] = 0
    dropped = ((ra.double() * keep) @ rb.double()).float()
    assert r2c.matmul_held(a, b, r2c.matmul_plain(a, b, form), form) <= 0.5
    assert r2c.matmul_held(a, b, dropped, form) > 100
    other = "highest" if form == "default" else "default"
    assert r2c.matmul_held(a, b, r2c.matmul_plain(a, b, other), form) > 1


def _tile_order_product(a, b, step_sum):
    """P19's TF32 kernel's order of additions, modelled in float32: a
    block's warps hold each output over the k steps of 8 of one parity
    (even steps in one warp, odd in another), each step's mma adds one sum
    of 8 exact TF32 products to the accumulator, and the two parities are
    added at the end (even + odd). ``step_sum`` models the mma's inner sum:
    "rounded" the 8 products summed exactly then rounded to float32,
    "sequential" added one by one in float32."""
    ra, rb = (x.double() for x in r2c.mm_inputs(a, b, "default"))
    d = [torch.zeros((r2c.MM, r2c.MM), dtype=torch.float32)
         for _ in range(2)]
    for s in range(r2c.MM // 8):
        ks = slice(8 * s, 8 * s + 8)
        if step_sum == "rounded":
            d[s % 2] = d[s % 2] + (ra[:, ks] @ rb[ks, :]).float()
            continue
        for k in range(8 * s, 8 * s + 8):
            # a TF32 x TF32 product has 22 significant bits: exact in float32
            d[s % 2] = d[s % 2] + (ra[:, k:k + 1] * rb[k:k + 1, :]).float()
    return d[0] + d[1]


@pytest.mark.parametrize("step_sum", ["rounded", "sequential"])
def test_matmul_tile_order_within_gate(step_sum):
    """The redesigned TF32 kernel's order of additions (two k parities a
    tile, added at the end) stays within P19's gate on the probe's inputs,
    next to the gate's refusal of a wrong product above."""
    a, b = r2c.matmul_inputs()
    got = _tile_order_product(a, b, step_sum)
    assert not torch.equal(got, r2c.matmul_plain(a, b, "default"))
    assert r2c.matmul_held(a, b, got, "default") <= 0.5


@pytest.mark.parametrize("n_mats", list(R4J_REPS))
def test_lookup_matches_the_probe(refs, n_mats):
    reps = R4J_REPS[n_mats]
    table, ids = r4j.inputs(n_mats)
    hi, mid, lo = r4j.split3(table)
    (rids, rhi, rmid, rlo), check = _case(refs, f"r4j_check_{n_mats}")
    assert torch.equal(rids, ids)
    for mine, theirs in ((hi, rhi), (mid, rmid), (lo, rlo)):
        assert torch.equal(mine.float(), theirs.float())
    got = r4j.lookup_check(ids, hi, mid, lo)
    _same(got, check)
    assert torch.equal(got, table[:, ids[0].long()])
    _, mxu = _case(refs, f"r4j_mxu_{n_mats}")
    _same(r4j.lookup_mxu(ids, hi, mid, lo, reps), mxu)
    if n_mats <= r4j.CHAIN_MAX_MATS:
        _, chain = _case(refs, f"r4j_chain_{n_mats}")
        _same(r4j.lookup_chain(ids, hi, n_mats, reps=reps), chain)
    recs = [r for r in json.loads(str(refs["r4j_records"]))
            if r.get("n_mats") == n_mats and r["method"] == "mxu_exact"]
    assert recs[0]["bit_exact"] is True


def test_probe_entry_points_on_cpu():
    """device="cpu" runs the plain versions, logs the tool's keys and no
    time."""
    log = common.Log(torch.device("cpu"))
    r2c.gather_take(32, "cpu", log)
    r2c.gather_selchain(64, "cpu", log)
    r2c.mxu_precision("cpu", log)
    res = r4j.run(48, reps=1, device="cpu", log=log)
    assert set(res) == {"inputs", "check", "mxu", "chain"}
    recs = log.records
    assert recs[0]["correct"] and recs[1]["correct"]
    assert [r["bound_ratio"] <= 1.0 for r in recs[2:4]] == [True, True]
    assert [r["held_ratio"] <= 0.5 for r in recs[2:4]] == [True, True]
    assert recs[4]["bit_exact"] and recs[5]["us"] is None
    assert all(r["card"].startswith("cpu") for r in recs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            r2c.gather_take(8)


def _one_hot_products(ids8, term, tiles):
    """(ppad, 8): the one-hot product of one bf16 table term with 8 ids as
    kernel P22's mma.sync steps form it: a +0 float32 accumulator, then
    for each k-tile of 16 materials in ``tiles`` (in order) its 16
    products added in k order (each exact: a bf16 value times 0 or 1);
    columns past npad read as zeros."""
    ppad, npad = term.shape
    kpad = -(-npad // 16) * 16
    a = torch.zeros(ppad, kpad)
    a[:, :npad] = term.float()
    d = torch.zeros(ppad, 8)
    for kt in tiles:
        for k in range(16 * kt, 16 * kt + 16):
            d = d + a[:, k, None] * (ids8 == k).float()[None, :]
    return d


def _lookup_model(ids_row, hi, mid, lo, skip):
    """Kernel P22 on the CPU: per group of 8 lanes, the three products
    over the k-tiles the group's ids touch (``skip``) or over every
    k-tile, then (hi + mid) + lo in float32."""
    ppad, npad = hi.shape
    ids = ids_row.long()
    out = torch.empty(ppad, 128)
    for n0 in range(0, 128, 8):
        ids8 = ids[n0:n0 + 8]
        tiles = (sorted(set((ids8 // 16).tolist())) if skip
                 else range(-(-npad // 16)))
        assert len(tiles) <= 8 or not skip
        d = [_one_hot_products(ids8, t, tiles) for t in (hi, mid, lo)]
        out[:, n0:n0 + 8] = (d[0] + d[1]) + d[2]
    return out


def _lookup_case(n_mats, seed):
    """A (32, n_mats) table with -0.0, +0.0, values whose bits reach below
    each bf16 term (three non-zero terms), a tiny normal and a subnormal
    that bf16 holds (split3 is exact down to 2^-133);
    ids with tile edges, a group of 8 in one tile, the last material,
    and random ids."""
    rs = np.random.RandomState(seed)
    table = rs.randn(32, n_mats).astype(np.float32)
    special = np.float32([-0.0, 0.0, 1 + 2 ** -9 + 2 ** -17,
                          -(1 + 2 ** -23), 1.5 * 2 ** -126, 2 ** -130,
                          -3.0 + 2 ** -20])
    for k, v in enumerate(special):
        table[k::len(special), (7 * k) % n_mats] = v
    table[:, 15] = -0.0
    table[3, 16] = 0.0
    ids = rs.randint(0, n_mats, 128).astype(np.int32)
    ids[:8] = [15, 16, 15, 16, n_mats - 1, 0, 17, 31]
    ids[8:16] = 32 + np.arange(8) % (n_mats - 32)    # one tile
    ids[16:24] = [(7 * k) % n_mats for k in range(len(special))] + [15]
    return torch.from_numpy(table), torch.from_numpy(ids)[None]


@pytest.mark.parametrize("n_mats", [48, 512])
def test_lookup_tile_skipping_is_exact(n_mats):
    """Multiplying only the k-tiles a warp's ids touch (P22's design)
    gives every output bit of the dense product and of check_plain. A
    table entry of -0.0 comes back +0.0 from every form (equal as a
    value, as the tool's np.array_equal counts it); every other entry
    comes back with its own bits."""
    for seed in range(2):
        table, ids = _lookup_case(n_mats, seed)
        hi, mid, lo = r4j.split3(table)
        skip = _lookup_model(ids[0], hi, mid, lo, skip=True)
        dense = _lookup_model(ids[0], hi, mid, lo, skip=False)
        plain = r4j.check_plain(ids, hi, mid, lo)
        want = table[:, ids[0].long()]
        _same(skip, dense.numpy())
        _same(skip, plain.numpy())
        assert torch.equal(skip, want)
        differ = bits(skip.numpy()) != bits(want.numpy())
        neg_zero = bits(want.numpy()) == np.int32(-2 ** 31)
        assert neg_zero.any() and np.array_equal(differ, neg_zero)
        assert torch.equal(r4j.lookup_check(ids, hi, mid, lo), plain)
