"""A study of kernel X1 (csrc/packet_cull.cu, the packet cull) on one
NVIDIA GPU, from the repository root:

    python3 x1_study.py [--out FILE]

X1 as shipped and without its bucket bounds (every bucket tested: the
octant planes alone; csrc/packet_cull.cu built with -DX1_NO_BOUNDS),
each csrc/packet_cull.cu compiled alone by nvcc with the library's flags
into a temporary directory and called through its own handle. On terrain
100k's camera, bounce and shadow rays (chip_smoke.py's phase 6) packed
by PacketTracer, slist and f2b: each build's meta against the plain
cull's, bit for bit, and probes.common.device_ms of a cull through that
build (20 culls queued behind a spin, so that the host's time to queue
them does not show), three readings in turns, twice (the second pass
reversed).

Per build and variant also its registers, spills and resident warps, and
its slab-test loops read from the SASS (cuobjdump -sass): the select
form's and the plain form's innermost loops, their instructions, min/max
(FMNMX), float adds and multiplies, shared loads and slab tests an
iteration (12 adds and multiplies a test), so their instructions a test.

Prints the card's name and power limit and exits non-zero on any
failure.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

READINGS = 3
# each build's extra nvcc flags
BUILDS = {"shipped": [], "no_bounds": ["-DX1_NO_BOUNDS"]}


def _build(tmp, name):
    """csrc/packet_cull.cu built alone (``name``: a key of BUILDS): the
    nvcc command and the library's path."""
    from vimg_tpu_torch.runtime import cuda
    so = os.path.join(tmp, f"libx1_{name}.so")
    return [cuda._nvcc(), *cuda.NVCC_FLAGS, *BUILDS[name], "-shared", "-o",
            so, str(cuda.CSRC / "packet_cull.cu")], so


def _bind(so):
    """The build's vimg_packet_cull and vimg_packet_cull_occupancy."""
    from vimg_tpu_torch.runtime import cuda
    lib = ctypes.CDLL(so)
    for name in ("vimg_packet_cull", "vimg_packet_cull_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = cuda.SIGNATURES[name]
    return lib


def _cull(lib, tr, packed):
    """The meta of ``tr``'s cull of ``packed`` through ``lib``, as
    packet_trace.cull_meta launches it."""
    import torch
    from vimg_tpu_torch.geometry import packet_trace as pt
    ro, rd, mn, mx = packed
    W, C = ro.shape[0] // pt.WG, tr.cl_lo.shape[0]
    f2b = tr.variant == "f2b"
    sums = pt._direction_sums(rd) if f2b else None   # held past the launch
    meta = torch.empty((W * pt.META_ROWS, tr.cp), dtype=torch.int32,
                       device=ro.device)
    rc = lib.vimg_packet_cull(
        ro.data_ptr(), rd.data_ptr(), mn.data_ptr(), mx.data_ptr(),
        tr.cl_lo.data_ptr(), tr.cl_hi.data_ptr(),
        tr.pi.data_ptr() if f2b else None, sums.data_ptr() if f2b else None,
        W, C, tr.cp, 1.0 if tr.entry_scale is None else tr.entry_scale,
        meta.data_ptr(), None,
        torch.cuda.current_stream(ro.device).cuda_stream)
    if rc:
        raise RuntimeError(f"vimg_packet_cull: CUDA error {rc}")
    return meta


def _occupancy(lib, f2b):
    """The build's registers, local and shared bytes and resident warps
    per SM, as packet_trace.cull_occupancy reports the library's."""
    per_sm, regs, local, smem = (ctypes.c_int() for _ in range(4))
    rc = lib.vimg_packet_cull_occupancy(
        int(f2b), ctypes.byref(per_sm), ctypes.byref(regs),
        ctypes.byref(local), ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"vimg_packet_cull_occupancy: CUDA error {rc}")
    return dict(regs=regs.value, local_bytes=local.value,
                smem_bytes=smem.value, blocks_per_sm=per_sm.value,
                warps_per_sm=per_sm.value * 4)


def slab_loops(sass, f2b):
    """The slab-test loops of packet_cull_kernel<f2b> in ``sass``
    (cuobjdump -sass text), among its innermost loops (a backward branch
    over no other): "select", the select form's (a test's 12 float adds
    and multiplies beside 6 FMNMX), and "plain", the plain form's (12
    beside 12), each the largest of its kind; their instruction counts
    and tests an iteration (12 adds and multiplies a test)."""
    fun = f"packet_cull_kernelILb{int(f2b)}ELb0E"
    body, on = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            on = fun in line
        elif on:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2).strip()))
    loops = []
    for a, ins in body:
        m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                        for s2, e2 in loops)]
    out = {}
    for s, e in inner:
        ins = [i for a, i in body if s <= a <= e]

        def count(pat):
            return sum(1 for i in ins if re.search(pat, i))
        c = dict(instructions=len(ins), fmnmx=count(r"\bFMNMX"),
                 fadd_fmul=count(r"\bF(ADD|MUL)\b"),
                 lds=count(r"\bLDS\b"))
        if not c["fadd_fmul"] or c["fadd_fmul"] % 12:
            continue
        c["tests"] = c["fadd_fmul"] // 12
        c["per_test"] = c["instructions"] / c["tests"]
        kind = ("select" if 2 * c["fmnmx"] <= c["fadd_fmul"] + 2 * c["tests"]
                and c["fmnmx"] < c["fadd_fmul"] else "plain")
        if kind not in out or c["fadd_fmul"] > out[kind]["fadd_fmul"]:
            out[kind] = c
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="JSON of the readings")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("x1_study.py needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.probes.common import device_ms
    from vimg_tpu_torch.runtime import cuda
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs, info = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = [_build(tmp, name) for name in BUILDS]
        t0 = time.time()
        logs = cuda._run_all([cmd for cmd, _ in builds])
        print(f"{len(builds)} builds in {time.time() - t0:.1f} s",
              flush=True)
        for name, (_, so), log in zip(BUILDS, builds, logs):
            sass = subprocess.run(
                [os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump"),
                 "-sass", so], capture_output=True, text=True,
                check=True).stdout
            libs[name] = _bind(so)
            for f2b in (False, True):
                key = f"{name}/{'f2b' if f2b else 'slist'}"
                info[key] = dict(
                    occupancy=_occupancy(libs[name], f2b),
                    loops=slab_loops(sass, f2b),
                    ptxas=cuda.ptxas_lines(
                        log, f"packet_cull_kernelILb{int(f2b)}ELb0E"))
                print(f"{key}: {info[key]}", flush=True)

    def cull(name, tr, packed):
        return _cull(libs[name], tr, packed)
    scene = terrain_scene(100_000, cs.MESH_W, cs.MESH_H, device=dev)
    rays = cs.terrain_rays(scene, ct.ClusterTracer(scene, walk="wide"))
    slist = pt.PacketTracer(scene)
    tracers = {"slist": slist,
               "f2b": pt.PacketTracer(scene, variant="f2b", data=slist.data)}
    res, bad = {}, []
    for kind, r in rays.items():
        for variant, tr in tracers.items():
            _, packed = tr.pack(*r)
            ref = pt._cull_meta(*packed, tr.cl_lo, tr.cl_hi, tr.cp,
                                tr.pi if variant == "f2b" else None,
                                tr.entry_scale)
            row = res[f"{variant}/{kind}"] = {}
            for name in BUILDS:
                n = int((cull(name, tr, packed) != ref).sum())
                if n:
                    bad.append(f"{name} {variant} {kind}: {n} meta slots "
                               f"differ from the plain cull's")
                row[name] = []
            for order in (list(BUILDS), list(BUILDS)[::-1]):
                for _ in range(READINGS):
                    for name in order:
                        row[name].append(device_ms(
                            lambda: cull(name, tr, packed)))
            print(f"{variant:5s} {kind:6s} " + " | ".join(
                f"{name}: {min(x):.4f}-{max(x):.4f} ms"
                for name, x in row.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, info=info, res=res, failures=bad), f,
                      indent=1)
    print(card)
    if bad:
        sys.exit("FAIL: " + "; ".join(bad))
    print("both builds bit-equal to the plain cull on every ray set")


if __name__ == "__main__":
    main()
