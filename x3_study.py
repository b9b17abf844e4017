"""A study of kernel X3 (csrc/sah_sweep.cu, the device build's SAH sweep)
on one NVIDIA GPU, from the repository root:

    python3 x3_study.py [--out FILE]

X3 is one cooperative launch in three phases between two grid barriers.
csrc/sah_sweep.cu is compiled alone by nvcc with the library's flags into
a temporary directory four times, with -DX3_PHASES=0, 1, 2 and 3 (0: the
launch and its two barriers with no work; 1: phase 1 too, the staging,
the aggregates and the key fill; 2: phase 2 too, the look-back, the
rescan, the costs and the atomics; 3: as shipped, with the decode), and
each is called through its own handle on the same inputs: the level-0
and middle-level axis-0 inputs of terrain 100k's and 500k's device
builds (chip_smoke.py phase 34's), and synthetic sweeps of one size at a
time (runs of 1-40 positions, and one segment) from 1,024 to 1,048,576
positions. Each (build, input) is timed by probes.common.device_ms (20
calls queued behind a spin), three readings in turns over the builds,
twice (the second pass in reverse order). The shipped build's outputs
must equal sah_sweep_plain's bit for bit. The differences between
consecutive builds split X3's time by phase.

Per build also its registers and spills (ptxas -v) and, per input, the
launch's plan (grid, chunks a tile, staged bytes). Prints the card's name
and power limit and exits non-zero on any failure.
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

READINGS = 3
BUILDS = {f"phases{n}": [f"-DX3_PHASES={n}"] for n in range(4)}
SIZES = (1024, 16384, 99460, 262144, 500002, 1048576)


def _build(tmp, name):
    """csrc/sah_sweep.cu built alone: the nvcc command and the library."""
    from vimg_tpu_torch.runtime import cuda
    so = os.path.join(tmp, f"libx3_{name}.so")
    return [cuda._nvcc(), *cuda.NVCC_FLAGS, *BUILDS[name], "-shared", "-o",
            so, str(cuda.CSRC / "sah_sweep.cu")], so


def _bind(so):
    from vimg_tpu_torch.runtime import cuda
    lib = ctypes.CDLL(so)
    for name in ("vimg_sah_sweep", "vimg_sah_sweep_plan"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = cuda.SIGNATURES[name]
    return lib


def _sweep(lib, seg, lo, hi):
    """One call of the build's X3, allocated as device_build.sah_sweep
    allocates it."""
    import torch
    from vimg_tpu_torch.geometry import device_build as db
    P = seg.shape[0]
    cost = torch.empty(P, dtype=torch.float32, device=seg.device)
    j = torch.empty(P, dtype=torch.int32, device=seg.device)
    scratch = torch.empty(-(-P // db.SWEEP_CHUNK) * db.SCRATCH_PER_CHUNK
                          + 2 * P, dtype=torch.float32, device=seg.device)
    rc = lib.vimg_sah_sweep(seg.data_ptr(), lo.data_ptr(), hi.data_ptr(), P,
                            cost.data_ptr(), j.data_ptr(), scratch.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"vimg_sah_sweep returned {rc}")
    return cost, j


def _plan(lib, P):
    out = [ctypes.c_int() for _ in range(5)]
    rc = lib.vimg_sah_sweep_plan(P, *(ctypes.byref(x) for x in out))
    if rc:
        raise RuntimeError(f"vimg_sah_sweep_plan returned {rc}")
    return dict(zip(("grid", "tile_chunks", "smem_bytes", "per_sm", "regs"),
                    (x.value for x in out)))


def _synthetic(P, seg_len, dev):
    """Runs of 1..seg_len positions (seg_len None: one segment) over
    random boxes, from a numpy seed."""
    import numpy as np
    import torch
    r = np.random.default_rng(P)
    if seg_len is None:
        seg = np.zeros(P, np.int32)
    else:
        lens = r.integers(1, seg_len + 1, size=P)
        starts = np.cumsum(np.concatenate([[0], lens]))[:-1]
        starts = starts[starts < P]
        seg = np.repeat(starts, np.diff(np.append(starts, P))).astype(
            np.int32)
    c = r.random((P, 3)).astype(np.float32)
    h = (0.03 * r.random((P, 3))).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (seg, c - h, c + h))


def _level_inputs(n, dev):
    """The level-0 and middle-level axis-0 sweep inputs of terrain n's
    device build."""
    import torch
    from chip_smoke import MESH_H, MESH_W
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(n, MESH_W, MESH_H, device=dev)
    bmin, bmax, cen, _, _ = bvh.scene_prim_bounds(scene)
    t = [torch.as_tensor(x, device=dev) for x in (bmin, bmax, cen)]
    kept = []

    def keep(seg, lo, hi):
        kept.append((seg, lo, hi))
        return db.sah_sweep(seg, lo, hi)
    db.build_levels(*t, db.max_levels_for(bmin.shape[0]), sweep=keep)
    return {f"terrain {n} level 0": kept[0],
            f"terrain {n} level {len(kept) // 6}": kept[3 * (len(kept) // 6)]}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="JSON of the readings")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("x3_study.py needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import nvidia_smi_line, sweep_differ, TIMED_LAUNCHES
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.probes.common import device_ms
    dev = torch.device("cuda", 0)
    bad, ptxas = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {name: _build(tmp, name) for name in BUILDS}
        procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                 for name, (cmd, _) in builds.items()}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                sys.exit(f"nvcc failed for {name}:\n{log}")
            ptxas[name] = [ln.strip() for ln in log.splitlines()
                           if re.search(r"registers|spill", ln)]
        libs = {name: _bind(so) for name, (_, so) in builds.items()}
        inputs = {}
        for n in (100_000, 500_000):
            inputs.update(_level_inputs(n, dev))
        for P in SIZES:
            inputs[f"P {P} runs"] = _synthetic(P, 40, dev)
            inputs[f"P {P} one segment"] = _synthetic(P, None, dev)
        res = {key: {name: [] for name in BUILDS} for key in inputs}
        for key, x in inputs.items():
            n_bad = sweep_differ(_sweep(libs["phases3"], *x),
                                 db.sah_sweep_plain(*x))
            if n_bad:
                bad.append(f"{key}: {n_bad} slots differ from the plain "
                           f"version")
        for order in (list(BUILDS), list(BUILDS)[::-1]):
            for _ in range(READINGS):
                for key, x in inputs.items():
                    for name in order:
                        res[key][name].append(device_ms(
                            lambda: _sweep(libs[name], *x), TIMED_LAUNCHES))
        plans = {key: _plan(libs["phases3"], x[0].shape[0])
                 for key, x in inputs.items()}
    for name in BUILDS:
        print(f"{name}: {' | '.join(ptxas[name])}")
    print(f"X3 ms a call (device clock, 20 calls behind a spin, "
          f"{2 * READINGS} readings a build), per build "
          f"{', '.join(BUILDS)}:")
    for key in inputs:
        pl = plans[key]
        print(f"  {key:28s} " + "  ".join(
            f"{min(v):.6f}-{max(v):.6f}" for v in res[key].values())
              + f"  (grid {pl['grid']}, {pl['tile_chunks']} chunk(s) a "
              f"tile, {pl['smem_bytes']} B staged)")
    card = nvidia_smi_line()
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".",
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, ptxas=ptxas, plans=plans, ms=res,
                           failures=bad), f, indent=1)
    if bad:
        sys.exit("FAIL: " + "; ".join(bad))
    print("the shipped build bit for bit the plain version on every input")


if __name__ == "__main__":
    main()
