"""vimg_tpu_torch.ops.mxu_gather (kernel B6's contract) against vimg_tpu on
the CPU.

vimg_tpu's ``gather_row`` is called on plain jnp arrays (one-hot bf16 dots
in XLA), never inside a ``pallas_call``. Criteria: ``split3`` byte for byte,
``gather_row`` bit for bit (the split is exact and each one-hot product is
one bf16 entry times 1.0, so there is nothing to round), on
tests/test_mxu_gather.py's 24 x 200 table with widely spread exponents.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.ops import mxu_gather as jg
from vimg_tpu_torch.ops import mxu_gather as tg

P, N = 24, 200


def _table(seed=1):
    rs = np.random.RandomState(seed)
    table = (rs.randn(P, N) * np.exp(rs.randn(P, N) * 4)).astype(np.float32)
    table[:, 190:] = 0.0
    return table, rs


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_split3_byte_identical():
    table, _ = _table()
    jsplit = jg.split3(table)
    tsplit = tg.split3(table)
    for a, b in zip(jsplit, tsplit):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == (P, N)
        assert np.array_equal(_bits(a), _bits(b))
    total = sum(x.float() for x in tsplit).numpy()
    assert np.array_equal(total, table)
    with pytest.raises(ValueError, match="2\\^-109"):
        tg.split3(np.full((2, 2), 2.0 ** -120, np.float32))


@pytest.mark.parametrize("ids_case", ["in_range", "with_outside"])
def test_gather_row_bit_exact(ids_case):
    table, rs = _table()
    ids = rs.randint(0, 190, (1, 128)).astype(np.int32)
    if ids_case == "with_outside":
        ids[0, :4] = (-1, N, N + 7, -50)     # one-hot rows of zeros: 0.0
    want = np.asarray(jg.gather_row(*map(jnp.asarray, jg.split3(table)),
                                    jnp.asarray(ids), N))
    before = tg.LAUNCHES
    got = tg.gather_row(*tg.split3(table), torch.from_numpy(ids), N)
    assert tg.LAUNCHES == before               # the CPU takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (P, 128)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    ok = (ids[0] >= 0) & (ids[0] < N)
    assert np.array_equal(got.numpy()[:, ok], table[:, ids[0][ok]])
    assert (got.numpy()[:, ~ok] == 0).all()


def test_gather_row_dispatch():
    hi, mid, lo = tg.split3(np.ones((3, 8), np.float32))
    ids = torch.arange(8, dtype=torch.int32)
    assert torch.equal(tg.gather_row(hi, mid, lo, ids, 8), torch.ones(3, 8))
    with pytest.raises(NotImplementedError, match="meta"):
        tg.gather_row(hi, mid, lo, ids.to("meta"), 8)
