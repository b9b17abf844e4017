"""The work of kernel X3, the device build's SAH sweep
(``csrc/sah_sweep.cu``), replayed in plain PyTorch: its decomposition of
one call, not its speed.

X3 is one cooperative launch. Block b owns tile b, ``tile`` positions in
position order (k chunks of ``chunk`` positions; 1,024 on the card, k
from the launch's plan, ``device_build.sweep_plan``). Three phases,
separated by grid barriers:

1. each chunk's segmented (min lo, max hi) aggregate in the prefix
   direction (a flag: the chunk holds a segment start; the box since its
   last start) and in the suffix direction (a flag: it holds a segment
   end; the box up to its first end; that end + 1, a running max of i + 1
   otherwise); the tile's aggregates folded from its chunks';
2. each tile's carries by a look-back over the tiles' aggregates,
   ``width`` (256, a thread a tile) a step, nearest first: a step's
   tiles are folded in scan order and combined under the carry so far,
   and the look-back stops at the first step that holds a boundary (a
   start to the left, an end to the right). The tile's chunks get their
   carries from the tile's (left to right for the prefix, right to left
   for the suffix). Each position's prefix box is its chunk's carry
   combined with the chunk's own scan, its right box (of [i + 1, end))
   and its segment's end likewise; its cost is rounded product by
   product, and its key is (cost key << 32) | nl, the cost key 0 for NaN
   and its bits + 1 otherwise. A segmented minimum of the keys over each
   chunk, reset at segment ends, is committed at each segment's first
   position in the chunk: one atomic minimum a segment and chunk;
3. every slot's key is decoded: the empty key to (INF, EMPTY_J), cost key
   0 to (NaN, P + 1), any other to (its cost, its nl).

The kernel's empty key is the all-ones uint64; here, in int64, it is
``EMPTY_KEY`` = 2^63 - 1, above every key a position packs (a cost key is
at most INF's bits + 1 < 2^31). ``replay`` returns X3's two outputs and
what the decomposition did: the look-back steps of each tile in each
direction and the atomics committed. tests/test_torch_sweep_schedule.py
holds the outputs bit for bit to ``sah_sweep_plain``.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.geometry import device_build as db

WIDTH = 256                 # tiles a look-back step (a thread a tile)
CHUNK = db.SWEEP_CHUNK      # positions a chunk on the card
EMPTY_KEY = 2 ** 63 - 1
INF = float("inf")


def _block_aggregates(starts, ends, lo, hi, size):
    """Each block of ``size`` consecutive positions' aggregates:
    (pre_f, pre_lo, pre_hi, suf_f, suf_lo, suf_hi, suf_end)."""
    P = starts.shape[0]
    pos = torch.arange(P)
    blk = pos // size
    n = int(blk[-1]) + 1
    first = pos % size == 0
    last = (pos % size == size - 1) | (pos == P - 1)
    lo_p, hi_p = db._seg_scan(starts | first, lo, hi)
    lo_s, hi_s = (x.flip(0) for x in db._seg_scan(
        (ends | last).flip(0), lo.flip(0), hi.flip(0)))

    def anyb(flags):
        return torch.zeros(n, dtype=torch.long).scatter_reduce(
            0, blk, flags.long(), "amax", include_self=True) > 0
    big = torch.full((n,), P + 1, dtype=torch.long)
    first_end = big.scatter_reduce(0, blk, torch.where(ends, pos, P + 1),
                                   "amin", include_self=True)
    suf_f = anyb(ends)
    suf_end = torch.where(suf_f, first_end + 1, pos[last] + 1)
    return (anyb(starts), lo_p[last], hi_p[last], suf_f, lo_s[first],
            hi_s[first], suf_end)


def _fold(f, lo, hi, end, reverse):
    """The segmented fold of a run of aggregates in scan order (reverse:
    from the last to the first): the part from the last boundary met, its
    flag, box and end (the largest end over that part)."""
    idx = torch.nonzero(f).flatten()
    if idx.numel() == 0:
        sel = slice(None)
    elif reverse:
        sel = slice(None, int(idx[0]) + 1)
    else:
        sel = slice(int(idx[-1]), None)
    return (bool(idx.numel()), lo[sel].min(0).values, hi[sel].max(0).values,
            int(end[sel].max()))


def _under(tot, carry):
    """combine(tot, carry): tot earlier in scan order, carry later."""
    if carry[0]:
        return carry
    return (tot[0], torch.minimum(tot[1], carry[1]),
            torch.maximum(tot[2], carry[2]), max(tot[3], carry[3]))


def _identity():
    return (False, torch.full((3,), INF), torch.full((3,), -INF), 0)


def look_back(agg, width=WIDTH):
    """Each tile's carries as X3's phase 2 takes them: (pre, suf, steps_pre,
    steps_suf); pre[b] / suf[b] are (flag, lo, hi, end) tuples."""
    pre_f, pre_lo, pre_hi, suf_f, suf_lo, suf_hi, suf_end = agg
    n = pre_f.shape[0]
    zero = torch.zeros(n, dtype=torch.long)
    pre, suf, steps_pre, steps_suf = [], [], [], []
    for b in range(n):
        carry, w, steps = _identity(), 0, 0
        while b - width * w > 0:
            a = max(b - width * (w + 1), 0)
            sl = slice(a, b - width * w)
            tot = _fold(pre_f[sl], pre_lo[sl], pre_hi[sl], zero[sl], False)
            carry, steps, w = _under(tot, carry), steps + 1, w + 1
            if tot[0]:
                break
        pre.append(carry)
        steps_pre.append(steps)
        carry, w, steps = _identity(), 0, 0
        while b + 1 + width * w < n:
            sl = slice(b + 1 + width * w, min(b + 1 + width * (w + 1), n))
            tot = _fold(suf_f[sl], suf_lo[sl], suf_hi[sl], suf_end[sl], True)
            carry, steps, w = _under(tot, carry), steps + 1, w + 1
            if tot[0]:
                break
        suf.append(carry)
        steps_suf.append(steps)
    return pre, suf, torch.tensor(steps_pre), torch.tensor(steps_suf)


def _seg_min_rev(flags, vals):
    """Segmented running minimum from the right, reset at ``flags``."""
    f, v = flags.flip(0).clone(), vals.flip(0).clone()
    P, k = f.shape[0], 1
    while k < P:
        v_n, f_n = v.clone(), f.clone()
        v_n[k:] = torch.where(f[k:], v[k:], torch.minimum(v[:-k], v[k:]))
        f_n[k:] = f[:-k] | f[k:]
        v, f = v_n, f_n
        k *= 2
    return v.flip(0)


def replay(seg_s, lo, hi, tile, chunk=CHUNK, width=WIDTH):
    """X3's outputs (seg_cost, seg_j) on CPU tensors, computed as its
    decomposition computes them, and a dict: n_tiles, n_chunks,
    steps_pre / steps_suf (look-back steps of each tile) and atomics (the
    key minima committed). ``tile`` is a multiple of ``chunk``."""
    if tile % chunk:
        raise ValueError("a tile is whole chunks")
    P = seg_s.shape[0]
    seg = seg_s.long()
    pos = torch.arange(P)
    starts, ends = db._seg_flags(seg)
    # phase 1: the chunks' aggregates, folded into the tiles'
    ca = _block_aggregates(starts, ends, lo, hi, chunk)
    n_chunks = ca[0].shape[0]
    k = tile // chunk
    n_tiles = -(-n_chunks // k)
    ta = [[], [], [], [], [], [], []]
    for t in range(n_tiles):
        sl = slice(t * k, min((t + 1) * k, n_chunks))
        p = _fold(ca[0][sl], ca[1][sl], ca[2][sl],
                  torch.zeros(sl.stop - sl.start, dtype=torch.long), False)
        s = _fold(ca[3][sl], ca[4][sl], ca[5][sl], ca[6][sl], True)
        for lst, v in zip(ta, (p[0], p[1], p[2], s[0], s[1], s[2], s[3])):
            lst.append(v)
    tagg = (torch.tensor(ta[0]), torch.stack(ta[1]), torch.stack(ta[2]),
            torch.tensor(ta[3]), torch.stack(ta[4]), torch.stack(ta[5]),
            torch.tensor(ta[6]))
    # phase 2: the tiles' carries, then each chunk's
    t_pre, t_suf, steps_pre, steps_suf = look_back(tagg, width)
    c_pre, c_suf = [None] * n_chunks, [None] * n_chunks
    for t in range(n_tiles):
        js = range(t * k, min((t + 1) * k, n_chunks))
        run = t_pre[t]
        for j in js:
            c_pre[j] = run
            run = _under(run, (bool(ca[0][j]), ca[1][j], ca[2][j], 0))
        run = t_suf[t]
        for j in reversed(js):
            c_suf[j] = run
            run = _under(run, (bool(ca[3][j]), ca[4][j], ca[5][j],
                               int(ca[6][j])))
    ch = pos // chunk
    cp_lo = torch.stack([c[1] for c in c_pre])[ch]
    cp_hi = torch.stack([c[2] for c in c_pre])[ch]
    cs_lo = torch.stack([c[1] for c in c_suf])[ch]
    cs_hi = torch.stack([c[2] for c in c_suf])[ch]
    cs_end = torch.tensor([c[3] for c in c_suf])[ch]
    c_first = ch * chunk
    c_last = torch.minimum(c_first + chunk, torch.tensor(P)) - 1
    # the chunk's own scans, and whether a boundary cuts off the carry
    lo_l, hi_l = db._seg_scan(starts | (pos == c_first), lo, hi)
    last_start = torch.cummax(torch.where(starts, pos, -1), 0).values
    from_carry = (last_start < c_first)[:, None]
    lo_l = torch.where(from_carry, torch.minimum(cp_lo, lo_l), lo_l)
    hi_l = torch.where(from_carry, torch.maximum(cp_hi, hi_l), hi_l)
    lo_r, hi_r = (x.flip(0) for x in db._seg_scan(
        (ends | (pos == c_last)).flip(0), lo.flip(0), hi.flip(0)))
    # the right box of position i starts at i + 1, in the same chunk or not
    inside = pos < c_last
    nxt = torch.clamp(pos + 1, max=P - 1)
    lo_x = torch.where(inside[:, None], lo_r[nxt], INF)
    hi_x = torch.where(inside[:, None], hi_r[nxt], -INF)
    next_end = torch.flip(torch.cummin(torch.flip(
        torch.where(ends, pos, P), [0]), 0).values, [0])
    end_after = torch.where(inside, next_end[nxt], P)
    to_carry = end_after > c_last          # no end in (i, chunk end]
    lo_x = torch.where(to_carry[:, None], torch.minimum(cs_lo, lo_x), lo_x)
    hi_x = torch.where(to_carry[:, None], torch.maximum(cs_hi, hi_x), hi_x)
    seg_end = torch.where(ends, pos + 1,
                          torch.where(to_carry, cs_end, end_after + 1))
    nl = pos - seg + 1
    nr = seg_end - pos - 1
    cost = (db._half_sa(lo_l, hi_l) * nl.to(torch.float32)
            + db._half_sa(lo_x, hi_x) * nr.to(torch.float32))
    cost = torch.where(nr > 0, cost, INF)
    ck = torch.where(torch.isnan(cost), 0,
                     cost.view(torch.int32).long() + 1)
    key = (ck << 32) | nl
    # one atomic minimum a segment and chunk
    run = _seg_min_rev(ends | (pos == c_last), key)
    commit = starts | (pos == c_first)
    keys = torch.full((P,), EMPTY_KEY, dtype=torch.long).scatter_reduce(
        0, seg[commit], run[commit], "amin", include_self=True)
    # phase 3: decode
    ck = keys >> 32
    empty = keys == EMPTY_KEY
    cost_bits = torch.where(empty | (ck == 0), 0, ck - 1).to(torch.int32)
    seg_cost = torch.where(
        empty, INF, torch.where(ck == 0, float("nan"),
                                cost_bits.view(torch.float32)))
    seg_j = torch.where(empty, db.EMPTY_J, torch.where(
        ck == 0, P + 1, keys & 0xFFFFFFFF)).to(torch.int32)
    return seg_cost, seg_j, dict(n_tiles=n_tiles, n_chunks=n_chunks,
                                 steps_pre=steps_pre, steps_suf=steps_suf,
                                 atomics=int(commit.sum()))
