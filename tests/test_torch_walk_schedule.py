"""Kernel P1's full walk (csrc/probe_walk.cu) replayed on the CPU:
``probe_walkablate.walk_schedule``, the warp leaf round of
``geometry/skip_schedule.py`` without its sub-box gates, held bit for bit
to the plain walk ``walkablate_plain`` (bt and visits) at groups 1 and
32: on sorted bounce rays of a terrain, with exact ties in t (every
cluster's row 1 a copy of row 0), a ragged ray count, idle lanes (maxT =
-inf), zero direction components and a finite maxT. The replay's warp
steps are what the counted kernel must reproduce on the card
(tests/test_torch_cuda.py); its lane fill is 1 by construction (four
16-triangle units a posted lane, two a step).
"""
import numpy as np
import pytest
import torch

from vimg_tpu_torch.geometry.cluster_trace import CLUSTER_K, ROW16, ClusterData
from vimg_tpu_torch.probes import probe_walkablate as pw
from vimg_tpu_torch.scene.synthetic import terrain_scene


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The replays run many small tensor ops, which threads only slow
    down; the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_RAYS = 1024


@pytest.fixture(scope="module")
def walk():
    scene = terrain_scene(5000, 32, 16, device="cpu")
    data = ClusterData(scene)
    return pw.probe_tables(data, "cpu"), pw.sorted_bounce_rays(scene, data,
                                                                N_RAYS)


def _tied(tri):
    t = tri.clone().view(-1, CLUSTER_K, ROW16)
    t[:, 1, :13] = t[:, 0, :13]
    return t.reshape(-1)


def _odd(rays):
    """Every 9th ray idle (maxT = -inf), every 7th with a finite maxT,
    zero direction components on every 5th (x) and 11th (z)."""
    ro, rd, mn, mx = (x.clone() for x in rays)
    rd[::5, 0] = 0.0
    rd[::11, 2] = -0.0
    mx[::7] = 0.5
    mx[::9] = -float("inf")
    return ro, rd, mn, mx


CASES = ("bounce", "ties", "ragged", "odd")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("group", [1, 32])
def test_walk_schedule_matches_plain_walk(walk, group, case):
    tables, rays = walk
    if case == "ties":
        tables = tables[:3] + (_tied(tables[3]),) + tables[4:]
    elif case == "ragged":
        rays = tuple(x[:N_RAYS - (64 if group == 32 else 75)] for x in rays)
    elif case == "odd":
        rays = _odd(rays)
    bt, nv = pw.walkablate_plain(*tables, *rays, "full", group)
    sbt, snv, c = pw.walk_schedule(*tables, *rays, group)
    assert torch.equal(sbt.view(torch.int32), bt.view(torch.int32))
    assert torch.equal(snv, nv) and snv.dtype == nv.dtype
    assert bool(torch.isfinite(bt).any())
    assert c["tri_tests"] == 32 * c["tri_steps"] > 0
    if group == 32:
        # one node step a warp visit; the per-lane leaf before ran 64
        # triangle steps a visit of a live leaf
        assert c["node_steps"] == int(nv.sum())
        assert 64 * c["leaf_visits"] > c["tri_steps"]
    else:
        assert c["node_steps"] <= int(nv.sum())


def test_walk_schedule_counts_agree_across_groups(walk):
    """A ray's live leaves do not depend on the group (bt at each node is
    the plain walk's), so both groups post the same (lane, leaf) pairs:
    equal triangle tests and steps."""
    tables, rays = walk
    c = [pw.walk_schedule(*tables, *rays, g)[2] for g in (1, 32)]
    assert c[0]["tri_tests"] == c[1]["tri_tests"]
    assert c[0]["tri_steps"] == c[1]["tri_steps"]


def test_walkablate_counts_steps_on_the_card_only(walk):
    tables, rays = walk
    with pytest.raises(ValueError, match="on the card"):
        pw.walkablate(*tables, *rays, "full", 32,
                      steps=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="groups"):
        pw.walk_schedule(*tables, *(x[:100] for x in rays), 32)
    np.testing.assert_array_equal(
        pw.walkablate(*tables, *rays, "full", 1)[0].numpy(),
        pw.walkablate_plain(*tables, *rays, "full", 1)[0].numpy())
