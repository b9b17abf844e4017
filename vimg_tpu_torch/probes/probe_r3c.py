"""What a dependent scalar table read costs (port of tools/probe_r3c.py's
smem_read_cost).

N steps of ``x = x * 1.0000001`` over an (8, 128) float32 block beside a
serial scalar chain: ``idx = (i * 7 + s) % 4096``, then ``n_reads`` reads
``tab[(idx + k) % 4096]`` summed into ``acc`` (packed: ``n_reads / 2``
reads, each unpacked as ``(w & 0xFFFF) + (w >> 16)``), ``s = (s + acc) %
65536``. Output ``x + s * 1e-20``. Each read's index depends on the last
step's sum, so nothing hoists.

``smem_read`` is kernel P3 (``csrc/probe_scalar.cu``; the table lives in
shared memory, the counterpart of SMEM) for CUDA tensors and
``smem_read_plain`` for CPU tensors. ``smem_read_cost`` is the probe:
records carry the TPU probe's keys (probe, packed, n_reads, us_per_iter,
ns_per_read).

The tool's other two measurements run the port's own path: ``xla_gather``
(row gathers of the tool's three tables, a 4 x 16 material table, 100,000
x 4 triangle attributes and a 512^2 x 4 texture, through
``torch.index_select`` and a row sum, at 131,072 and 1,048,576 ids) and
``hit_info_cost`` (``intersect.hit_info`` on 131,072 bounce rays' closest
hits over terrain 100k). Device ms a call (5 calls queued behind a
spinning kernel); None on the CPU.

Run: ``python -m vimg_tpu_torch.probes.probe_r3c [--device cpu]
[--n-iter N] [--out records.jsonl]``: the kernel probe, then
``xla_gather`` and ``hit_info_cost``.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.probes import common

SHAPE = (8, 128)
TAB = 4096
N_ITER = 20000
CONFIGS = ((False, 2), (False, 4), (False, 8), (False, 16),
           (True, 4), (True, 8), (True, 16))
A, SCALE = common.f32(1.0000001), common.f32(1e-20)


def _check_config(n_reads, packed):
    if (bool(packed), n_reads) not in CONFIGS:
        raise ValueError(f"no configuration packed={packed} "
                         f"n_reads={n_reads} ({CONFIGS})")


def probe_table(device):
    """The probe's table: arange(4096) % 7 as int32."""
    return (torch.arange(TAB, dtype=torch.int32, device=device) % 7)


def smem_read_plain(x, tab, n_reads, packed, n_iter=N_ITER):
    """Plain version of kernel P3. The chain is integer arithmetic without
    overflow (table values below 2^16), so it runs exactly on the host:
    first each window's sum ``W[j] = sum_k f(tab[(j + k) % 4096])`` for all
    4096 starts j, in PyTorch (integer sums are exact in any order), then
    the serial ``s = (s + W[(i * 7 + s) % 4096]) % 65536`` in Python ints.
    The float block is the same N multiplications."""
    _check_config(n_reads, packed)
    t = tab.to(torch.int64)
    if packed:
        t = (t & 0xFFFF) + (t >> 16)
    reads = n_reads // 2 if packed else n_reads
    win = sum(torch.roll(t, -k) for k in range(reads)).tolist()
    s = 0
    for i in range(n_iter):
        s = (s + win[(i * 7 + s) % TAB]) % 65536
    for _ in range(n_iter):
        x = x * A
    return x + torch.tensor(float(s), dtype=torch.float32,
                            device=x.device) * SCALE


def _launch(x, tab, n_reads, packed, n_iter):
    out = torch.empty(SHAPE, dtype=torch.float32, device=x.device)
    common.launch("probe_smem_read", "vimg_probe_smem_read", x.device, x,
                  tab, n_reads, int(packed), n_iter, out)
    return out


def smem_read(x, tab, n_reads, packed, n_iter=N_ITER):
    """Kernel P3 on CUDA tensors, smem_read_plain on CPU tensors.

    Replaces tools/probe_r3c.py::smem_read_cost (pallas_call :64). One
    block of 128 threads, 8 rows each; the table is staged in shared
    memory and every thread runs the same chain (each read a broadcast).
    Bounded by the latency of the chain (a latency probe). The table must
    hold values in [0, 2^16): then C's % equals the probe's floor-mod and
    every index stays in the table (checked here)."""
    if not common.on_card(x):
        return smem_read_plain(x, tab, n_reads, packed, n_iter)
    _check_config(n_reads, packed)
    if not 0 <= n_iter < 2 ** 28:
        raise ValueError(f"n_iter {n_iter} out of range")
    common.check_tensor(x, "x", torch.float32, SHAPE, x.device)
    common.check_tensor(tab, "tab", torch.int32, (TAB,), x.device)
    if not bool(((tab >= 0) & (tab < 65536)).all()):
        raise ValueError("tab: values outside [0, 2^16)")
    return _launch(x, tab, n_reads, packed, n_iter)


def smem_read_cost(device="cuda", n_iter=N_ITER, log=None):
    """The probe: each configuration on x = 0.1 everywhere and the probe's
    table; logs (packed, n_reads, us_per_iter, ns_per_read) each (device
    times; None on the CPU). Returns (x, tab, {(packed, n_reads): (out,
    ms per launch)})."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    x = torch.full(SHAPE, 0.1, dtype=torch.float32, device=dev)
    tab = probe_table(dev)
    res = {}
    for packed, n_reads in CONFIGS:
        out = smem_read(x, tab, n_reads, packed, n_iter)
        ms = (common.device_ms(lambda: _launch(x, tab, n_reads, packed,
                                               n_iter))
              if dev.type == "cuda" else None)
        per = None if ms is None else ms * 1e3 / n_iter
        log(probe="smem_read", packed=packed, n_reads=n_reads,
            n_iter=n_iter, us_per_iter=per,
            ns_per_read=None if per is None else per / n_reads * 1e3)
        res[(packed, n_reads)] = (out, ms)
    return x, tab, res


GATHER_TABLES = ((4, 16, "mat_table"), (100_000, 4, "tri_attrs"),
                 (262_144, 4, "texture512"))


def xla_gather(device="cuda", sizes=(131072, 1048576),
               tables=GATHER_TABLES, log=None):
    """The tool's gathers: index_select of B random rows of each table and
    their row sums; logs ms and ns_per_row (None on the CPU). Returns
    {(B, name): (table, ids, out)}."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    res = {}
    for B in sizes:
        for rows, width, name in tables:
            tab = torch.from_numpy(np.random.RandomState(0).rand(
                rows, width).astype(np.float32)).to(dev)
            idx = torch.from_numpy(np.random.RandomState(1).randint(
                0, rows, B).astype(np.int32)).to(dev)

            def f():
                return torch.index_select(tab, 0, idx).sum(-1)
            out = f()
            ms = common.device_ms(f, reps=5) if dev.type == "cuda" else None
            log(probe="xla_gather", B=B, table=name, rows=rows, width=width,
                ms=ms, ns_per_row=None if ms is None else ms / B * 1e6)
            res[(B, name)] = (tab, idx, out)
    return res


def hit_info_cost(device="cuda", n_tris=100_000, B=131072, log=None):
    """The tool's hit_info cost: ClusterTracer's closest hits of the
    bounce rays (probe_r3b.bounce_batches) over terrain ``n_tris``, then
    ``intersect.hit_info`` reduced to p.sum + n_s.sum + n_g.sum; logs ms
    and us_per_lane (None on the CPU). Returns the sum."""
    from vimg_tpu_torch.geometry import intersect
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.probes.probe_r3b import bounce_batches
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    scene = terrain_scene(n_tris, 512, 256, device=dev)
    ro, rd = bounce_batches(scene, B)
    hr = ClusterTracer(scene).closest(
        scene, ro, rd, torch.full((B,), 1e-4, device=dev),
        torch.full((B,), float("inf"), device=dev))

    def f():
        hi = intersect.hit_info(scene, ro, rd, hr)
        return hi.p.sum() + hi.n_s.sum() + hi.n_g.sum()
    out = f()
    ms = common.device_ms(f, reps=5) if dev.type == "cuda" else None
    log(probe="hit_info", B=B, ms=ms,
        us_per_lane=None if ms is None else ms / B * 1e3,
        value=float(out))
    return out


def main(argv=None):
    args = common.parse_args(__doc__, argv, (
        ("--n-iter", dict(type=int, default=N_ITER)),))
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    smem_read_cost(dev, args.n_iter, log)
    xla_gather(dev, log=log)
    hit_info_cost(dev, log=log)


if __name__ == "__main__":
    main()
