"""Two studies of kernel X2 (csrc/bvh_walk.cu, the BVH tracer's walk) on
one NVIDIA GPU, from the repository root:

    python3 x2_study.py frames TREE [TREE ...] [--out FILE]
    python3 x2_study.py post-min [--out FILE]

frames: main path 11 (the Mitsuba file that chip_smoke.py writes, the
wavefront over X2) and main path 13's -b 1 frame (its JSON "mesh" file,
X2 over the sweep-SAH tree) through each checkout's own cli.main, at
512x256 @ 64 spp, one process a TREE argument, in the order given (name a
checkout more than once to run it more than once; unpack another commit
with git archive into a directory that .gitignore lists). A run renders
a 1-spp warm-up frame of each path, then FRAMES frames of each, and for
each frame reads:

- its seconds (render_frame between synchronisations, as chip_smoke.py
  times it) and supersteps;
- the host's milliseconds a superstep (the wall time of the wavefront's
  superstep calls, which wait for the device where they read a count);
- X2's host microseconds a call (the wall time in bvh_trace, which queues
  the launch and does not wait).

Then one more frame of main path 11 under torch.profiler: the device's
busy milliseconds a superstep (the sum of its kernels' device times, one
stream), the host's milliseconds a superstep spent waiting on the
device (cudaStreamSynchronize, cudaDeviceSynchronize, cudaMemcpyAsync)
and the ops of most self CPU time. The profiler slows the host; its
frame is compared only with the other runs' profiled frames. A run takes
about 280 s on an H100 host, most of it the profiled frame.

post-min: X2 rebuilt with each threshold of its leaf rounds (kPostMin,
geometry/bvh.py::POST_MIN: the waiting lanes that start a round; 33 waits
for every lane, as kernel B4's round) from copies of csrc/bvh_walk.cu
with that one constant changed, each compiled alone by nvcc with the
library's flags into a temporary directory. On terrain 100k's camera,
bounce and shadow rays (chip_smoke.py's phase 6) and many_lights_scene's,
closest and any hit: each variant's outputs against the shipped X2's, bit
for bit, its warp node and leaf steps (a counted launch) and device_ms
(20 launches queued behind a spin), three readings in turns over the
variants, twice (the second pass in reverse order).

Both print the card's name and power limit and exit non-zero on any
failure.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

FRAMES = 3
THRESHOLDS = (1, 4, 6, 8, 12, 16, 24, 33)
READINGS = 3
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaMemcpyAsync")


def _smoke(tree):
    """The checkout's own chip_smoke.py as a module; it puts the checkout
    first on sys.path, so vimg_tpu_torch is imported from there."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_us(evt):
    """A device event's own time (0 for a host op, whose device time is
    its kernels', counted in their own events)."""
    import torch
    if evt.device_type == torch.autograd.DeviceType.CPU:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def frames_worker(tree, out):
    """One checkout's frames (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cs = _smoke(tree)
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.render import render, wavefront
    from vimg_tpu_torch.scene.synthetic import terrain_mesh
    if not os.path.abspath(bvh.__file__).startswith(tree):
        sys.exit(f"vimg_tpu_torch came from {bvh.__file__}, not {tree}")
    steps, calls = [], []
    make, trace = wavefront.make_superstep, bvh.bvh_trace

    def timed_make(*a, **kw):
        """make_superstep whose supersteps note their wall time."""
        fn = make(*a, **kw)

        def superstep(s, accum):
            t0 = time.perf_counter()
            out = fn(s, accum)
            steps.append(time.perf_counter() - t0)
            return out
        return superstep

    def timed_trace(*a, **kw):
        t0 = time.perf_counter()
        out = trace(*a, **kw)
        calls.append(time.perf_counter() - t0)
        return out
    wavefront.make_superstep, bvh.bvh_trace = timed_make, timed_trace
    res = {"tree": tree}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = terrain_mesh(cs.FRONT_TERRAIN_TRIS)
        xml, js = cs.write_mitsuba(tmp, mesh), cs.write_mesh_json(tmp)
        png = os.path.join(tmp, "out.png")
        for key, argv in (("main11", ["-f", xml]),
                          ("main13_b1", ["-f", js, "-b", "1"])):
            cs.cli_run(argv + ["--spp", "1", "-o", png])
            res[key] = []
            for _ in range(FRAMES):
                steps.clear()
                calls.clear()
                with cs.Captured(render, "render_frame") as cap:
                    cs.cli_run(argv + ["--spp", str(cs.MESH_SPP), "-o", png])
                n = wavefront.LAST_STATS["supersteps"]
                res[key].append(dict(
                    s=cap.calls[0][1], supersteps=n,
                    segments=wavefront.LAST_STATS["segments"],
                    host_ms_superstep=1e3 * sum(steps) / n,
                    x2_calls=len(calls),
                    x2_host_us_call=1e6 * sum(calls) / max(len(calls), 1)))
            print(tree, key, json.dumps(res[key]), flush=True)
        steps.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with cs.Captured(render, "render_frame") as cap:
                cs.cli_run(["-f", xml, "--spp", str(cs.MESH_SPP), "-o", png])
        n = len(steps)
        ka = prof.key_averages()
        busy = sum(_device_us(e) for e in ka) / 1e3
        wait = sum(e.self_cpu_time_total for e in ka if e.key in WAITS) / 1e3
        top = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:10]
        res["profiled"] = dict(
            s=cap.calls[0][1], supersteps=n,
            host_ms_superstep=1e3 * sum(steps) / n,
            device_busy_ms_superstep=busy / n,
            host_wait_ms_superstep=wait / n,
            top_self_cpu_ms=[(e.key, e.self_cpu_time_total / 1e3, e.count)
                             for e in top])
        print(tree, "profiled", json.dumps(res["profiled"]), flush=True)
    with open(out, "w") as f:
        json.dump(res, f)


def frames(trees):
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            path = os.path.join(tmp, f"run{i}.json")
            t0 = time.time()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "frames-worker", tree, "--out", path], check=True)
            with open(path) as f:
                runs.append(json.load(f))
            print(f"run {i} ({tree}) done in {time.time() - t0:.1f} s",
                  flush=True)
    for key in ("main11", "main13_b1"):
        print(f"{key}: frame s / host ms a superstep / X2 host us a call, "
              "in run order")
        for i, r in enumerate(runs):
            print(f"  run {i} {r['tree']}: " + "; ".join(
                f"{f['s']:.3f} / {f['host_ms_superstep']:.2f} / "
                f"{f['x2_host_us_call']:.1f}" for f in r[key])
                + f" ({r[key][0]['supersteps']} supersteps, "
                f"{r[key][0]['x2_calls']} X2 calls)")
    print("main11 profiled: frame s / host ms a superstep / device busy ms "
          "a superstep / host waiting ms a superstep")
    for i, r in enumerate(runs):
        p = r["profiled"]
        print(f"  run {i} {r['tree']}: {p['s']:.3f} / "
              f"{p['host_ms_superstep']:.2f} / "
              f"{p['device_busy_ms_superstep']:.3f} / "
              f"{p['host_wait_ms_superstep']:.2f}; top self CPU ms: "
              + ", ".join(f"{k} {ms:.0f} ({c})"
                          for k, ms, c in p["top_self_cpu_ms"][:6]))
    return runs


def _variant(tmp, pm):
    """csrc/bvh_walk.cu built alone with kPostMin = pm: its vimg_bvh_walk."""
    from vimg_tpu_torch.runtime import cuda
    d = os.path.join(tmp, f"pm{pm}")
    os.makedirs(d)
    src = (cuda.CSRC / "bvh_walk.cu").read_text()
    line = "constexpr int kPostMin = 8;"
    if line not in src:
        sys.exit(f"csrc/bvh_walk.cu has no '{line}'")
    with open(os.path.join(d, "bvh_walk.cu"), "w") as f:
        f.write(src.replace(line, f"constexpr int kPostMin = {pm};"))
    with open(os.path.join(d, "cluster_walk.cuh"), "w") as f:
        f.write((cuda.CSRC / "cluster_walk.cuh").read_text())
    so = os.path.join(d, "libx2.so")
    return [cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o", so,
            os.path.join(d, "bvh_walk.cu")], so


def post_min(out):
    import torch
    import chip_smoke as cs
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.probes.common import device_ms
    from vimg_tpu_torch.runtime import cuda
    from vimg_tpu_torch.scene.synthetic import many_lights_scene, \
        terrain_scene
    lib = cuda.load_library()
    dev = torch.device("cuda", 0)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = [_variant(tmp, pm) for pm in THRESHOLDS]
        t0 = time.time()
        cuda._run_all([cmd for cmd, _ in builds])
        print(f"{len(builds)} variants built in {time.time() - t0:.1f} s",
              flush=True)
        for pm, (_, so) in zip(THRESHOLDS, builds):
            v = ctypes.CDLL(so)
            fn = v.vimg_bvh_walk
            fn.argtypes, fn.restype = cuda.SIGNATURES["vimg_bvh_walk"]
            libs[pm] = type("Variant", (), dict(
                vimg_bvh_walk=fn,
                vimg_cuda_error_string=lib.vimg_cuda_error_string))

    def walk(pm, *a, **kw):
        """bvh_trace over variant ``pm``'s launcher."""
        keep = cuda.load_library
        cuda.load_library = lambda: libs[pm]
        try:
            return bvh.bvh_trace(*a, **kw)
        finally:
            cuda.load_library = keep

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [x.t, x.prim_type, x.prim_id, x.u, x.v]
    terrain = terrain_scene(100_000, cs.MESH_W, cs.MESH_H, device=dev)
    lights = many_lights_scene(256, cs.MESH_W, cs.MESH_H, device=dev)
    cases = (("terrain", terrain, cs.terrain_rays(
        terrain, ct.ClusterTracer(terrain, walk="wide"))),
        ("lights", lights, cs.light_rays(lights)))
    res, bad = {}, []
    for label, scene, rays in cases:
        tree = bvh.BVHTracer(scene).bvh
        for kind, r in rays.items():
            for mode in ("closest", "occluded"):
                kw = dict(any_hit=mode == "occluded")
                ref = flat(bvh.bvh_trace(scene, tree, *r, **kw))
                row = res[f"{label}/{kind}/{mode}"] = {}
                for pm in THRESHOLDS:
                    st = torch.zeros(2, dtype=torch.int64, device=dev)
                    got = flat(walk(pm, scene, tree, *r, steps=st, **kw))
                    n = sum(int((a.view(torch.int32) != b.view(torch.int32))
                                .sum()) if a.dtype == torch.float32
                            else int((a != b).sum())
                            for a, b in zip(got, ref))
                    if n:
                        bad.append(f"{label} {kind} {mode} post_min {pm}: "
                                   f"{n} values differ from X2's")
                    row[pm] = dict(steps=[int(x) for x in st.cpu()], ms=[])
                for order in (THRESHOLDS, THRESHOLDS[::-1]):
                    for _ in range(READINGS):
                        for pm in order:
                            row[pm]["ms"].append(device_ms(
                                lambda: walk(pm, scene, tree, *r, **kw)))
                print(f"{label:7s} {kind:6s} {mode:8s} " + " | ".join(
                    f"{pm}: {min(x['ms']):.4f}-{max(x['ms']):.4f} ms "
                    f"{x['steps']}" for pm, x in row.items()), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(dict(res=res, failures=bad), f, indent=1)
    if bad:
        sys.exit("FAIL: " + "; ".join(bad))
    print("every variant bit-equal to X2 (kPostMin = 8) on every ray set")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("study", choices=("frames", "post-min", "frames-worker"))
    p.add_argument("trees", nargs="*", help="frames: checkouts, in order")
    p.add_argument("--out", default=None, help="JSON of the readings")
    args = p.parse_args()
    if args.study == "frames-worker":
        return frames_worker(os.path.abspath(args.trees[0]), args.out)
    import torch
    if not torch.cuda.is_available():
        sys.exit("x2_study.py needs a GPU")
    if args.study == "frames":
        if not args.trees:
            sys.exit("frames: name the checkouts to run, in order")
        runs = frames([os.path.abspath(t) for t in args.trees])
        if args.out:
            with open(args.out, "w") as f:
                json.dump(runs, f, indent=1)
    else:
        post_min(args.out)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
