"""Build and load the CUDA kernel library.

Every ``.cu`` source under ``vimg_tpu_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a``; the sources compile in parallel (one ``nvcc`` per
file, all started together) and link into one shared library with a plain
C interface, loaded with ``ctypes``. The library lands in
``vimg_tpu_torch/_build/`` under a name that hashes the sources and flags,
so an edited source is rebuilt at its first use. Nothing here runs at
import time. ``SIGNATURES`` holds the C signature of every exported
function, for all kernels in one place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (argtypes, restype); pointers and the stream are c_void_p
SIGNATURES = {
    # csrc/megakernel.cu: 10 tables, 9 ints, group_begin, group_end,
    # blocks, film, counts, next_group, stream
    "vimg_mega_render": ([_P] * 10 + [_I] * 12 + [_P] * 4, _I),
    # mesh mode: 17 tables, 10 ints, group_begin, group_end, blocks, film,
    # counts, next_group, stream
    "vimg_mega_render_mesh": ([_P] * 17 + [_I] * 13 + [_P] * 4, _I),
    # mesh, mis, per_sm, regs, local_bytes (host int*)
    "vimg_mega_occupancy": ([_I] * 2 + [_P] * 3, _I),
    # csrc/cluster_trace.cu: 4 tables, ro, rd, minT, maxT, n_rays,
    # n_nodes (wide or binary), any_hit, t, slot, u, v, steps (device
    # uint64[2] or null), warp_steps (device uint64 (n_warps, 2) or null),
    # stream
    "vimg_cluster_wide": ([_P] * 8 + [_I] * 3 + [_P] * 7, _I),
    "vimg_cluster_skip": ([_P] * 8 + [_I] * 3 + [_P] * 7, _I),
    # csrc/packet_trace.cu: tri_t, meta, ro, rd, minT, maxT, n_rays, cp,
    # n_clusters, any_hit, f2b, unroll, entry_scale, scene box lo/hi (6),
    # t, code, steps (device uint64 or null), stream
    "vimg_packet_trace": ([_P] * 6 + [_I] * 6 + [_F] * 7 + [_P] * 4, _I),
    # csrc/packet_cull.cu: ro, rd, minT, maxT, cl_lo, cl_hi, pi (device
    # int64 or null), direction sums (device float32 (W, 3) or null),
    # n_work, n_clusters, cp, entry_scale, meta, steps (device uint64[4] or
    # null), stream
    "vimg_packet_cull": ([_P] * 8 + [_I] * 3 + [_F] + [_P] * 3, _I),
    # f2b, per_sm, regs, local_bytes, smem_bytes (host int*)
    "vimg_packet_cull_occupancy": ([_I] + [_P] * 4, _I),
    # csrc/bvh_walk.cu (X2): nodes, rows, ro, rd, minT, maxT, n_rays,
    # n_nodes, n_prims, mode, t, prim_type, prim_id, u, v, occluded, cost,
    # steps (device uint64[2] or null), stream
    "vimg_bvh_walk": ([_P] * 6 + [_I] * 4 + [_P] * 9, _I),
    # mode, per_sm, regs, local_bytes (host int*)
    "vimg_bvh_occupancy": ([_I] + [_P] * 3, _I),
    # csrc/gather_row.cu: hi, mid, lo, ids, p, n_rows, n_ids, out, stream
    "vimg_gather_rows": ([_P] * 4 + [_I] * 3 + [_P] * 2, _I),
    # csrc/probe_walk.cu (P1): aabb, cid, skip, tri, n_nodes, ro, rd, tmin,
    # tmax, n_rays, variant, group, bt, nv, steps (device uint64[2] or
    # null), stream
    "vimg_probe_walk": ([_P] * 4 + [_I] + [_P] * 4 + [_I] * 3 + [_P] * 4, _I),
    # csrc/probe_scalar.cu: P2 x, mode, n_iter, out, stream; P3 x, tab,
    # n_reads, packed, n_iter, out, stream; P4 x, out, stream
    "vimg_probe_sync": ([_P] + [_I] * 2 + [_P] * 2, _I),
    "vimg_probe_smem_read": ([_P] * 2 + [_I] * 3 + [_P] * 2, _I),
    "vimg_probe_stack": ([_P] * 3, _I),
    # csrc/probe_packet.cu: P5 x, static, reps, out, stream; P6/P9/P10
    # tbl, idx, n_blocks, reps, block_load, parallel, out, stream; P7 mask,
    # tbl, reps, out, stream; P8 x, reps, out, stream
    "vimg_probe_setup": ([_P] + [_I] * 2 + [_P] * 2, _I),
    "vimg_probe_rows": ([_P] * 2 + [_I] * 4 + [_P] * 2, _I),
    "vimg_probe_ffs": ([_P] * 2 + [_I] + [_P] * 2, _I),
    "vimg_probe_epilogue": ([_P] + [_I] + [_P] * 2, _I),
    # csrc/probe_packet_stages.cu (P11): xt, meta, tri, n_work, n_clusters,
    # stage, n_packets, out, stream
    "vimg_probe_packet_stage": ([_P] * 3 + [_I] * 4 + [_P] * 2, _I),
    # csrc/probe_vpu.cu (pointers grid_used are host int*): P12 tab, init,
    # k, prim, n_rep, iters, n_blocks, grid_used, out, stream; P13/P14/P20
    # x, k, kind, bf16, fused, iters, n_blocks, grid_used, out, stream;
    # P15 x, k, form, fused, iters, n_blocks, grid_used, out, stream
    "vimg_probe_prims": ([_P] * 3 + [_I] * 4 + [_P] * 3, _I),
    "vimg_probe_vpu": ([_P] * 2 + [_I] * 5 + [_P] * 3, _I),
    "vimg_probe_vpu3": ([_P] * 2 + [_I] * 4 + [_P] * 3, _I),
    # csrc/probe_gather.cu: P16/P17/P18 table, idx, n, reps, out, stream;
    # P19 a, b, tf32, c, stream; P21/P22 ids, hi, mid, lo, n_params, ppad,
    # npad, rows, reps, check, out, stream; P21 chain ids, t_hi, n_mats,
    # n_params, npad, rows, reps, out, stream
    "vimg_probe_take": ([_P] * 2 + [_I] * 2 + [_P] * 2, _I),
    "vimg_probe_onehot": ([_P] * 2 + [_I] * 2 + [_P] * 2, _I),
    "vimg_probe_selchain": ([_P] * 2 + [_I] * 2 + [_P] * 2, _I),
    "vimg_probe_matmul": ([_P] * 2 + [_I] + [_P] * 2, _I),
    "vimg_probe_lookup_mxu": ([_P] * 4 + [_I] * 6 + [_P] * 2, _I),
    "vimg_probe_lookup_chain": ([_P] * 2 + [_I] * 5 + [_P] * 2, _I),
    # csrc/probe_lowering.cu: P23 out; P24 x, out; P25 out; P26 tbl, out;
    # P27 x, out; P28 iters, n_blocks, grid_used, out; P29-P31 aabb, tris,
    # rays, which, out; each then the stream
    "vimg_probe_grid": ([_P] * 2, _I),
    "vimg_probe_while": ([_P] * 3, _I),
    "vimg_probe_pcg": ([_P] * 2, _I),
    "vimg_probe_scalars": ([_P] * 3, _I),
    "vimg_probe_transc": ([_P] * 3, _I),
    "vimg_probe_throughput": ([_I] * 2 + [_P] * 3, _I),
    "vimg_probe_constructs": ([_P] * 3 + [_I] + [_P] * 2, _I),
    # csrc/sah_sweep.cu (X3): seg_s, lo, hi, P, seg_cost, seg_j, scratch,
    # stream
    "vimg_sah_sweep": ([_P] * 3 + [_I] + [_P] * 4, _I),
    # P, grid, tile_chunks, smem_bytes, per_sm, regs (host int*)
    "vimg_sah_sweep_plan": ([_I] + [_P] * 5, _I),
    "vimg_cuda_error_string": ([_I], ctypes.c_char_p),
}

_LIB = None
BUILD_INFO = {}   # path, seconds (0.0 when cached), ptxas log of the build


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source and need the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvimg_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once, wait for all; raise on the first
    failure with its output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
        outs.append(out + err)
    return outs


def build():
    """Compile the library if it is missing; returns its path."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0,
                          log=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    t0 = time.time()
    logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                     for s, o in zip(srcs, objs)])
    tmp = out.with_name(f"{tag}.tmp.so")
    logs += _run_all([[nvcc, "-shared", "-o", str(tmp),
                       *(str(o) for o in objs)]])
    for o in objs:
        o.unlink()
    text = "".join(logs)
    log.write_text(text)
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.time() - t0, log=text)
    return out


def ptxas_lines(log, part):
    """ptxas -v's register and spill lines, from a build ``log``, of the
    entry functions whose mangled name holds ``part``."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else ""
        elif part in entry and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def load_library():
    """The built library with its C signatures set (built on first use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib


def check(rc, what):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + load_library().vimg_cuda_error_string(rc)
                           .decode())
