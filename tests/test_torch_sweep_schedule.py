"""Kernel X3's decomposition (vimg_tpu_torch/geometry/sweep_schedule.py:
tiles of chunks, the tiles' aggregates and boundary flags, the look-back
that gives each tile its carries, the chunks' carries, the packed 64-bit
keys committed once a segment and chunk, their decode) against
sah_sweep_plain, and sah_sweep_plain against vimg_tpu's sweep of one
level's axis (vimg_tpu/geometry/device_build.py:104-134).

Criteria: the replay's (seg_cost, seg_j) equal the plain version's bit
for bit (any NaN as NaN) at tiles of 32 and 256 positions, with chunks of
32 inside tiles of 256 and look-backs of 4 tiles a step, on one segment
over every tile, single-position segments, segments that end exactly on
chunk edges, random runs, and boxes that give +0, INF and NaN costs. The
plain version equals vimg_tpu's sweep on the same inputs: seg_j exactly,
seg_cost bit for bit except the sign of a zero (vimg_tpu's jnp.maximum may
keep -0.0 where the port takes +0.0; no comparison sees the sign).
vimg_tpu's scans (min / max / select only) run jitted, its products and
sums op by op, so XLA contracts nothing into an FMA here. The look-back's
steps a tile follow from where the boundaries lie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.geometry import device_build as jd
from vimg_tpu_torch.geometry import device_build as db
from vimg_tpu_torch.geometry import sweep_schedule as ss

P = 2000
# (tile, chunk, look-back width): the card's shape at chunk sizes 32 and
# 256, several chunks a tile, and look-backs of several steps
SHAPES = [(32, 32, ss.WIDTH), (256, 256, ss.WIDTH), (256, 32, 4)]


def _starts(lengths):
    out, s = [], 0
    for n in lengths:
        n = min(n, P - s)
        out += [s] * n
        s += n
        if s == P:
            break
    return np.asarray(out, np.int32)


def _boxes(seed):
    r = np.random.default_rng(seed)
    c = r.random((P, 3)).astype(np.float32)
    h = (0.03 * r.random((P, 3))).astype(np.float32)
    h[::7] = 0.0
    c[1::5] = c[0]
    return c - h, c + h


def _case(name):
    """(seg_s, lo, hi) as numpy arrays, from numpy seeds."""
    r = np.random.default_rng(sum(map(ord, name)))
    lo, hi = _boxes(len(name))
    if name == "one_segment":
        seg = np.zeros(P, np.int32)
    elif name == "singles":
        seg = np.arange(P, dtype=np.int32)
    elif name == "chunk_edges":
        # lengths of whole 32-position chunks: every boundary on a chunk
        # edge, some on 256-position tile edges
        seg = _starts(r.choice([32, 64, 256], size=P))
    elif name == "runs":
        seg = _starts(r.integers(1, 41, size=P))
    elif name == "zero_costs":
        # the first half flat on two axes, at -0.0 and +0.0: costs of +0
        # and ties of equal costs at every split
        seg = _starts(r.integers(1, 300, size=P))
        for x in (lo, hi):
            x[:P // 2, :2] = np.where(r.random((P // 2, 2)) < 0.5, -0.0, 0.0)
    elif name == "inf_costs":
        # infinite extents and products that overflow: INF costs
        seg = _starts(r.integers(1, 300, size=P))
        lo[5::97, 2] = -np.inf
        hi[11::89, 0] = np.float32(3e38)
        lo[11::89, 0] = np.float32(-3e38)
    elif name == "nan_costs":
        # NaN boxes, and 0 x INF: NaN costs in some segments
        seg = _starts(r.integers(1, 300, size=P))
        lo[17::131, 1] = np.nan
        lo[40::151] = np.inf
        hi[40::151] = np.inf
    else:
        raise KeyError(name)
    return seg, lo.astype(np.float32), hi.astype(np.float32)


CASES = ["one_segment", "singles", "chunk_edges", "runs", "zero_costs",
         "inf_costs", "nan_costs"]


def _torch(case):
    seg, lo, hi = _case(case)
    return torch.from_numpy(seg), torch.from_numpy(lo), torch.from_numpy(hi)


def _bits(x):
    """float32 bits with every NaN as one NaN."""
    return torch.where(torch.isnan(x), float("nan"), x).view(torch.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES)
def test_replay_equals_plain(case, shape):
    tile, chunk, width = shape
    seg, lo, hi = _torch(case)
    cost, j, stats = ss.replay(seg, lo, hi, tile, chunk, width)
    ref_cost, ref_j = db.sah_sweep_plain(seg, lo, hi)
    assert torch.equal(_bits(cost), _bits(ref_cost))
    assert torch.equal(j, ref_j)
    assert stats["n_tiles"] == -(-P // tile)
    assert stats["n_chunks"] == -(-P // chunk)
    # one commit a (segment, chunk) pair
    pairs = {(int(s), i // chunk) for i, s in enumerate(seg.tolist())}
    assert stats["atomics"] == len(pairs)


def test_cases_cover_the_special_costs():
    """The cost cases give what their names say (so the bit tests above
    see +0, INF and NaN minima, and empty slots)."""
    got = {c: db.sah_sweep_plain(*_torch(c)) for c in CASES}
    assert (got["zero_costs"][0] == 0).any()
    assert not torch.signbit(got["zero_costs"][0]).any()
    assert torch.isinf(got["inf_costs"][0][torch.unique(
        _torch("inf_costs")[0]).long()]).any()
    nan = torch.isnan(got["nan_costs"][0])
    assert nan.any() and (got["nan_costs"][1][nan] == P + 1).all()
    assert (got["singles"][1] == 1).all() and torch.isinf(
        got["singles"][0]).all()
    assert (got["one_segment"][1][1:] == db.EMPTY_J).all()


def _vimg_sweep(seg_s, bmin, bmax):
    """vimg_tpu's _level lines 104-134 for one axis, on its sorted inputs:
    the scans jitted, the arithmetic op by op."""
    n = seg_s.shape[0]
    scan = jax.jit(jd._seg_scan_bounds, static_argnames="reverse")
    imax = jax.jit(jd._seg_imax_scan, static_argnames="reverse")
    seg_s, bmin, bmax = (jnp.asarray(x) for x in (seg_s, bmin, bmax))
    pos = jnp.arange(n, dtype=jnp.int32)
    starts = jnp.concatenate([jnp.ones((1,), bool), seg_s[1:] != seg_s[:-1]])
    lo_l, hi_l = scan(starts, bmin, bmax)
    ends = jnp.concatenate([starts[1:], jnp.ones((1,), bool)])
    lo_r, hi_r = scan(ends, bmin, bmax, reverse=True)
    seg_end = imax(ends, pos + 1, reverse=True)
    nl = pos - seg_s + 1
    nr = seg_end - pos - 1
    sa_l = jd._half_sa(lo_l, hi_l)
    sa_r = jd._half_sa(jnp.roll(lo_r, -1, axis=0), jnp.roll(hi_r, -1, axis=0))
    cost = sa_l * nl.astype(jnp.float32) + sa_r * nr.astype(jnp.float32)
    cost = jnp.where(nr > 0, cost, jnp.inf)
    seg_min = jax.ops.segment_min(cost, seg_s, num_segments=n,
                                  indices_are_sorted=True)
    j_here = jnp.where(cost == seg_min[seg_s], nl, n + 1)
    seg_j = jax.ops.segment_min(j_here, seg_s, num_segments=n,
                                indices_are_sorted=True)
    return np.asarray(seg_min), np.asarray(seg_j)


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_vimg_tpu(case):
    seg, lo, hi = _case(case)
    ref_cost, ref_j = _vimg_sweep(seg, lo, hi)
    cost, j = db.sah_sweep_plain(*(torch.from_numpy(x) for x in (seg, lo,
                                                                 hi)))
    cost = cost.numpy()
    assert np.array_equal(j.numpy(), ref_j)
    assert np.array_equal(np.isnan(cost), np.isnan(ref_cost))
    zero = cost == 0
    assert np.array_equal(zero, ref_cost == 0)
    same = ~np.isnan(cost) & ~zero
    assert np.array_equal(cost[same].view(np.int32),
                          ref_cost[same].view(np.int32))


def test_look_back_steps():
    """One segment: tile b reads back to tile 0 (the one start) and on to
    the last tile (the one end), width tiles a step; single-position
    segments: every tile holds both boundaries, so one step each way."""
    tile, width = 32, 4
    n = -(-P // tile)
    b = torch.arange(n)
    _, _, st = ss.replay(*_torch("one_segment"), tile, 32, width)
    assert torch.equal(st["steps_pre"], -(-b // width))
    assert torch.equal(st["steps_suf"], -(-(n - 1 - b) // width))
    _, _, st = ss.replay(*_torch("singles"), tile, 32, width)
    assert torch.equal(st["steps_pre"], (b > 0).long())
    assert torch.equal(st["steps_suf"], (b < n - 1).long())
    # at the card's width, a grid of up to 256 tiles looks back one step
    _, _, st = ss.replay(*_torch("one_segment"), tile, 32)
    assert int(st["steps_pre"].max()) == 1 == int(st["steps_suf"].max())


def test_replay_takes_whole_chunks():
    with pytest.raises(ValueError, match="whole chunks"):
        ss.replay(*_torch("runs"), 48, 32)
