"""Time this checkout's kernels B2-B5, X2, X3, the packet cull, P1 and P19
and main paths 1-11 and 13 against another checkout of the port, on one GPU,
in turns.

Unpack the other commit into a directory that .gitignore lists and run,
from the repository root on a machine with an NVIDIA GPU:

    git archive PARENT | (mkdir -p _proof/parent && tar -x -C _proof/parent)
    python3 compare_parent.py _proof/parent [--out parent.json] [--parts x3]

Each checkout runs in its own process (it builds its own kernel library
under its own vimg_tpu_torch/_build/), in the order other, this, this,
other. A process makes chip_smoke.py's phase-6 rays with that checkout's
own chip_smoke.py (terrain 100k, 131,072 camera, bounce and shadow rays),
then:

- the cull and B5: for each variant (slist, f2b) and ray kind, the rays
  in PacketTracer's order and their meta from the checkout's
  PacketTracer.cull (kernel X1 where the checkout has it, else the plain
  cull), kept; three readings of 20 culls between CUDA events; then B5 on
  that meta: one launch kept for the comparison, two warm-ups, three
  readings of 20 launches between CUDA events (chip_smoke.py's phase-12
  clock); the warp test steps where the checkout's trace_packet counts
  them;
- P19: the TF32 product of probe_r2c on its (256, 256) inputs, three
  readings of probes.common.device_ms (launches queued behind a spin);
- P1 (the walk-ablation probe, chip_smoke.py's phase 15): every variant
  at groups 32 and 1 on terrain 100k's 131,072 sorted bounce rays, bt
  and visits of one launch kept, three readings of device_ms;
- main path 6: render_frame(..., tracer_force="packet") on terrain 100k
  at 512x256 @ 64 spp after a 1-spp warm-up frame, timed once, its X1
  and B5 launches counted; then once more under
  torch.use_deterministic_algorithms, its film kept;
- B4 (skip walk) on terrain 500k's camera, bounce and shadow rays and B3
  (wide walk) on terrain 100k's, made as chip_smoke.py's phase 6 makes
  them, in the tracer's order: one launch kept, two warm-ups, three
  readings of 20 launches between CUDA events; B3's and B4's warp steps
  where the checkout's trace_wide / trace_skip count them;
- B2 at main paths 4 (terrain 100k, 4 spp MIS) and 5 (the smooth bumpy
  sphere 100k, 64 spp material), 512x256: one warm launch, then three
  launches each timed by the wrapper's CUDA events; the first one's film
  and counters (segments, shadow rays, box and triangle tests) kept;
- main paths 2 and 3: render_frame on terrain 100k and 500k at 512x256 @
  64 spp MIS (the wavefront over B3, over B4) after a 1-spp warm-up
  frame, timed once each;
- B1 on the flagship at 1800x800 @ 4 spp (its integrator body is B2's):
  one warm launch, three launches each timed by the wrapper's CUDA
  events, the first one's film and counters kept;
- main path 1: render_frame on the flagship JSON at its 1800x800 @ 512
  spp (B1) after a 1-spp warm-up frame, timed once, its film and
  counters kept;
- main paths 7 and 8: render_frame under s_normal at 4 spp on the
  flagship (1800x800) and terrain 100k (512x256) through render(), timed
  once each after a 1-spp warm-up frame, the films kept.

X3 (the device build's SAH sweep, chip_smoke.py phase 34): terrain 100k
and 500k through the checkout's level loop once with each sweep's inputs
kept; for the level-0 and the middle level's axis-0 inputs of each, one
call's outputs kept and three readings of probes.common.device_ms (20
calls queued behind a spin); the level loop and BVHTracer(builder=
"device") timed once each by the host's clock (synchronised), with the
build's own split into level loop and host assembly. The inputs must be
bit-equal across the runs (the level loop is exact) and so must X3's
outputs. ``--parts x3`` runs only this reading.

Then it checks that every meta, B3, B4 (t, slot, u, v), B5 (t, code) and
P1 (bt, visits) is bit-equal across the four runs, that B1's and B2's
films and counters (main paths 1, 4 and 5 and the 4-spp flagship) are,
that the films of main paths 7 and 8 and main path 6's deterministic
film are and its X1 and B5 launches equal, that each P19 product is held
by matmul_held, that the wavefront frames (main paths 2, 3 and 6) have
equal segment and shadow-ray counts and supersteps and agree per pixel
(their films are not bit-equal even between two runs of one checkout:
the film's atomic index_add_ adds in no fixed order), prints the table
and the card's name
and power limit, and writes the readings as JSON. Exits non-zero on any
failure.

X2 and the scene-file front door:

- X2 (the BVH walk) on terrain 100k's camera, bounce and shadow rays in
  its three modes (closest, any hit, cost), over the checkout's
  BVHTracer: one launch kept, then three readings of 20 launches between
  CUDA events and three of probes.common.device_ms (launches queued
  behind a spin, so that the host's time to queue them does not show);
  the warp steps where the checkout's bvh_trace counts them;
- main path 11 (the Mitsuba file that the checkout's chip_smoke.py
  writes, through cli.main at 64 spp, the wavefront over X2) and main
  path 13's -b 1 frame (its JSON "mesh" file, X2 over the sweep-SAH
  tree), each after a 1-spp warm-up frame: timed once, then rendered
  again under torch.use_deterministic_algorithms (the film's index_add_
  then sums in a fixed order), whose film is held bit for bit; the
  heatmap (-m 4.0 on the Mitsuba file), held bit for bit (its costs are
  multiples of 0.5, so their sums are exact in any order); each frame
  also once with every X2 call between CUDA events, their sum X2's device
  time in the frame.

Main path 9 (the envtex frame: textured_terrain_scene(100_000) at
512x256 @ 64 spp through the wavefront over B3) is timed once after a
1-spp warm-up frame and checked as main paths 2 and 3. Main path 10 (the
train step, chip_smoke.py phase 8c: 10 Adam steps of 131,072 rays on the
envtex scene through B3) runs in a checkout whose chip_smoke.py has
``train_run`` (none before the differentiable slice): its losses and
forward and backward ms are printed beside the other checkout's where
both have it; the losses are not held equal across runs (the backward's
atomics sum in no fixed order, so the parameters part after a step).
"""
import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
READINGS = 3


def _smoke(tree):
    """The checkout's own chip_smoke.py as a module; it puts the checkout
    first on sys.path, so vimg_tpu_torch is imported from there."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def x2_readings(cs, scene, rays, dev):
    """X2 on terrain 100k's phase-6 rays in its three modes: the outputs
    of one launch, three readings of 20 launches between CUDA events and
    three of device_ms, the warp steps where the checkout counts them."""
    import torch
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.probes.common import device_ms
    counts = "steps" in inspect.signature(bvh.bvh_trace).parameters
    tr = bvh.BVHTracer(scene)
    res, outs = {}, {}
    for kind, r in rays.items():
        for mode in ("closest", "occluded", "cost"):
            kw = dict(any_hit=mode == "occluded", count_cost=mode == "cost")
            fn = lambda: bvh.bvh_trace(scene, tr.bvh, *r, **kw)
            got = fn()
            steps = None
            if counts:
                st = torch.zeros(2, dtype=torch.int64, device=dev)
                bvh.bvh_trace(scene, tr.bvh, *r, steps=st, **kw)
                steps = [int(x) for x in st.cpu()]
            for _ in range(2):
                fn()
            ms = [cs.event_ms(fn, cs.TIMED_LAUNCHES)[1]
                  for _ in range(READINGS)]
            dms = [device_ms(fn, cs.TIMED_LAUNCHES) for _ in range(READINGS)]
            if mode == "occluded":
                flat = [got]
            else:
                hr, cost = (got, None) if mode == "closest" else got
                flat = [hr.t, hr.prim_type, hr.prim_id, hr.u, hr.v]
                flat += [] if cost is None else [cost]
            outs[f"{kind}/{mode}"] = [x.cpu() for x in flat]
            res[f"{kind}/{mode}"] = dict(ms=ms, device_ms=dms, steps=steps)
    return res, outs


def front_readings(cs, dev):
    """Main path 11 and main path 13's -b 1 frame through the checkout's
    CLI on the files its chip_smoke.py writes: a 1-spp warm-up frame, the
    frame timed once, then again under deterministic algorithms for its
    film; the heatmap. Returns (seconds and counts, films)."""
    import torch
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.render import heatmap, render, wavefront
    from vimg_tpu_torch.scene.synthetic import terrain_mesh
    res, imgs = {}, {}
    trace, events = bvh.bvh_trace, []

    def timed_trace(*a, **kw):
        """bvh_trace between CUDA events (X2's device time in a frame)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = trace(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out
    with tempfile.TemporaryDirectory() as tmp:
        mesh = terrain_mesh(cs.FRONT_TERRAIN_TRIS)
        xml, js = cs.write_mitsuba(tmp, mesh), cs.write_mesh_json(tmp)
        png = os.path.join(tmp, "out.png")
        for key, argv in (("main11", ["-f", xml]),
                          ("main13_b1", ["-f", js, "-b", "1"])):
            cs.cli_run(argv + ["--spp", "1", "-o", png])
            with cs.Captured(render, "render_frame") as cap:
                cs.cli_run(argv + ["--spp", str(cs.MESH_SPP), "-o", png])
            _, secs = cap.calls[0]
            res[key] = dict(s=secs, **_wf_stats(wavefront.LAST_STATS))
            # the frame once more with every X2 call between CUDA events
            events.clear()
            bvh.bvh_trace = timed_trace
            try:
                cs.cli_run(argv + ["--spp", str(cs.MESH_SPP), "-o", png])
            finally:
                bvh.bvh_trace = trace
            torch.cuda.synchronize()
            res[key].update(x2_calls=len(events), x2_ms=sum(
                a.elapsed_time(b) for a, b in events))
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with cs.Captured(render, "render_frame") as cap:
                    cs.cli_run(argv + ["--spp", str(cs.MESH_SPP), "-o", png])
            finally:
                torch.use_deterministic_algorithms(False)
            imgs[key] = cap.calls[0][0].cpu()
            res[key]["det"] = _wf_stats(wavefront.LAST_STATS)
        with cs.Captured(heatmap, "render_heatmap") as cap:
            cs.cli_run(["-f", xml, "-m", str(cs.HEATMAP_FACTOR), "-o", png])
        imgs["heatmap"], res["heatmap"] = cap.calls[0][0].cpu(), dict(
            s=cap.calls[0][1])
    return res, imgs


def p1_readings(cs, scene, dev):
    """P1 on terrain 100k's sorted bounce rays, every variant at groups 32
    and 1: bt and visits of one launch, three readings of device_ms."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.probes import probe_walkablate as pw
    from vimg_tpu_torch.probes.common import device_ms
    data = ct.ClusterData(scene)
    tables = pw.probe_tables(data, dev)
    rays = pw.sorted_bounce_rays(scene, data, cs.N_RAYS)
    res, outs = {}, {}
    for group in pw.KERNEL_GROUPS:
        for variant in pw.VARIANTS:
            fn = lambda: pw.walkablate(*tables, *rays, variant, group)
            outs[f"{variant}/{group}"] = [x.cpu() for x in fn()]
            res[f"{variant}/{group}"] = dict(ms=[
                device_ms(fn, cs.TIMED_LAUNCHES) for _ in range(READINGS)])
    return res, outs


def x3_readings(cs, dev):
    """X3 on the level-0 and middle-level inputs of terrain 100k's and
    500k's device builds: the inputs and one call's outputs, three
    readings of device_ms; the level loop and the build timed once."""
    import torch
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.probes.common import device_ms
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    res, outs = {}, {}
    for n in cs.X3_TERRAINS:
        scene = terrain_scene(n, cs.MESH_W, cs.MESH_H, device=dev)
        bmin, bmax, cen, _, _ = bvh.scene_prim_bounds(scene)
        t = [torch.as_tensor(x, device=dev) for x in (bmin, bmax, cen)]
        max_levels = db.max_levels_for(bmin.shape[0])
        kept = []

        def keep(seg, lo, hi):
            kept.append((seg, lo, hi))
            return db.sah_sweep(seg, lo, hi)
        db.build_levels(*t, max_levels, sweep=keep)
        _, loop_s = cs.timed(lambda: db.build_levels(*t, max_levels))
        _, build_s = cs.timed(lambda: bvh.BVHTracer(scene, builder="device"))
        st = db.LAST_STATS
        res[f"{n}/build"] = dict(loop_s=loop_s, build_s=build_s,
                                 level_s=st["level_seconds"],
                                 assembly_s=st["assembly_seconds"],
                                 levels=st["levels"])
        for key, inputs in (("level0", kept[0]),
                            ("middle", kept[3 * (len(kept) // 6)])):
            fn = lambda: db.sah_sweep(*inputs)
            outs[f"{n}/{key}"] = [x.cpu() for x in (*inputs, *fn())]
            res[f"{n}/{key}"] = dict(P=int(inputs[0].shape[0]), ms=[
                device_ms(fn, cs.TIMED_LAUNCHES) for _ in range(READINGS)])
    return res, outs


def x3_checks(runs):
    """X3's inputs and outputs bit-equal to run 2's (this checkout)."""
    import torch
    bad = []
    ref = runs[1]["data"]["x3"]
    for res in runs:
        for key, got in res["data"]["x3"].items():
            n = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                    for a, b in zip(got, ref[key]))
            if n:
                bad.append(f"X3 {key} run {res['name']}: {n} values differ")
    return bad


def x3_report(runs, span):
    print(f"X3 ms a call (device clock: 20 calls queued behind a spin, "
          f"{READINGS} readings a run; other runs 1 and 4, this runs 2 and "
          f"3):")
    for key in runs[0]["x3"]:
        if key.endswith("/build"):
            continue
        print(f"  terrain {key:14s} P {runs[1]['x3'][key]['P']}: other "
              f"{span('other', lambda r: r['x3'][key]['ms'])}  this "
              f"{span('this', lambda r: r['x3'][key]['ms'])}")
    for key in runs[0]["x3"]:
        if key.endswith("/build"):
            print(f"  terrain {key}: level loop s, build s (its level loop "
                  f"+ assembly), in run order: " + ", ".join(
                      f"{r['name']} {r['x3'][key]['loop_s']:.4f}, "
                      f"{r['x3'][key]['build_s']:.3f} "
                      f"({r['x3'][key]['level_s']:.4f} + "
                      f"{r['x3'][key]['assembly_s']:.3f})" for r in runs)
                  + f"; {runs[1]['x3'][key]['levels']} levels")


def worker(tree, out, parts):
    import torch
    cs = _smoke(tree)
    if parts == "x3":
        res, x3_outs = x3_readings(cs, torch.device("cuda", 0))
        torch.save({"x3": x3_outs}, out + ".pt")
        with open(out, "w") as f:
            json.dump({"tree": tree, "x3": res}, f)
        return
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.probes import common, probe_r2c
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    if not os.path.abspath(pt.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"{pt.__file__} is not under {tree}")
    dev = torch.device("cuda", 0)
    res = {"tree": tree, "b5": {}}
    scene = terrain_scene(100_000, cs.MESH_W, cs.MESH_H, device=dev)
    rays = cs.terrain_rays(scene, ct.ClusterTracer(scene, walk="wide"))
    res["x2"], x2_outs = x2_readings(cs, scene, rays, dev)
    res["front"], front_imgs = front_readings(cs, dev)
    slist = pt.PacketTracer(scene)
    tracers = {"slist": slist,
               "f2b": pt.PacketTracer(scene, variant="f2b", data=slist.data)}
    counts = "steps" in inspect.signature(pt.trace_packet).parameters
    outs, metas = {}, {}
    for kind, r in rays.items():
        for variant, tr in tracers.items():
            _, packed = tr.pack(*r)
            meta = tr.cull(packed)
            cull_ms = [cs.event_ms(lambda: tr.cull(packed),
                                   cs.TIMED_LAUNCHES)[1]
                       for _ in range(READINGS)]
            metas[f"{variant}/{kind}"] = meta.cpu()
            args = (tr.tri_t, meta, *packed, *tr.walk_args(kind == "shadow"))
            steps = torch.zeros(1, dtype=torch.int64, device=dev)
            got = (pt.trace_packet(*args, steps=steps) if counts
                   else pt.trace_packet(*args))
            for _ in range(2):
                pt.trace_packet(*args)
            ms = [cs.event_ms(lambda: pt.trace_packet(*args),
                              cs.TIMED_LAUNCHES)[1] for _ in range(READINGS)]
            outs[f"{variant}/{kind}"] = [x.cpu() for x in got]
            res["b5"][f"{variant}/{kind}"] = dict(
                ms=ms, steps=int(steps) if counts else None, cull_ms=cull_ms)
    a, b = probe_r2c.matmul_inputs(dev)
    prod = probe_r2c.matmul(a, b, "default")
    res["p19"] = dict(
        ms=[common.device_ms(lambda: probe_r2c.matmul(a, b, "default"),
                             cs.TIMED_LAUNCHES) for _ in range(READINGS)],
        held=float(probe_r2c.matmul_held(a, b, prod, "default")))
    res["p1"], p1_outs = p1_readings(cs, scene, dev)
    st = ir.RenderSettings(cs.MESH_W, cs.MESH_H, spp=cs.MESH_SPP,
                           max_depth=64, integrator="mis", tonemap="agx",
                           batch_size=cs.MESH_BATCH)
    render_frame(scene, ir.RenderSettings(
        cs.MESH_W, cs.MESH_H, spp=1, max_depth=64, integrator="mis",
        tonemap="agx", batch_size=cs.MESH_BATCH), tracer_force="packet")
    before = (pt.LAUNCHES, pt.LAUNCHES_CULL)
    img, secs = cs.timed(lambda: render_frame(scene, st,
                                              tracer_force="packet"))
    res["frame"] = dict(s=secs, launches=pt.LAUNCHES - before[0],
                        cull_launches=pt.LAUNCHES_CULL - before[1],
                        **_wf_stats(wavefront.LAST_STATS))
    # once more under deterministic algorithms (the film's index_add_
    # then sums in a fixed order): its film is held bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        img6 = render_frame(scene, st, tracer_force="packet").cpu()
    finally:
        torch.use_deterministic_algorithms(False)
    res["walks"], walk_outs = walk_readings(cs, scene, rays, dev)
    res["b2"], b2_outs = b2_readings(cs, dev)
    res["frame2"], img2 = frame_readings(cs, dev, 100_000, "LAUNCHES_WIDE")
    res["frame3"], img3 = frame_readings(cs, dev, 500_000, "LAUNCHES_SKIP")
    res["frame1"], main1 = main1_readings(cs, dev)
    res["frames78"], imgs78 = normal_readings(cs, dev)
    res["frame9"], img9 = envtex_readings(cs, dev)
    if hasattr(cs, "train_run"):
        res["main10"] = train_readings(cs, dev)
    res["x3"], x3_outs = x3_readings(cs, dev)
    torch.save({"x3": x3_outs, "b5": outs, "meta": metas, "p1": p1_outs, "img": img.cpu(),
                "img6_det": img6,
                "walks": walk_outs, "b2": b2_outs, "img2": img2,
                "img3": img3, "img9": img9, "main1": main1, **imgs78,
                "x2": x2_outs, **front_imgs}, out + ".pt")
    with open(out, "w") as f:
        json.dump(res, f)


def walk_readings(cs, scene100, rays100, dev):
    """B3 on terrain 100k's phase-6 rays and B4 on terrain 500k's: (t,
    slot, u, v) of one launch, three readings of 20 launches, the warp
    steps where the checkout's walk counts them."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    counts = {w: "steps" in inspect.signature(fn).parameters
              for w, fn in (("b3", ct.trace_wide), ("b4", ct.trace_skip))}
    wide = ct.ClusterTracer(scene100, walk="wide")
    scene500 = terrain_scene(500_000, cs.MESH_W, cs.MESH_H, device=dev)
    data = ct.ClusterData(scene500)
    wide500 = ct.ClusterTracer(scene500, walk="wide", data=data)
    skip = ct.ClusterTracer(scene500, walk="skip", data=data)
    rays500 = cs.terrain_rays(scene500, wide500)
    res, outs = {}, {}
    for walk, tr, rays in (("b3", wide, rays100), ("b4", skip, rays500)):
        for kind, r in rays.items():
            rs = cs.sorted_rays(tr, r)
            any_hit = kind == "shadow"
            if walk == "b3":
                fn = lambda: ct.trace_wide(*tr.node_tables, tr.tri_rows,
                                           tr.n_wide, tr.max_stack, *rs,
                                           any_hit)
            else:
                fn = lambda: ct.trace_skip(*tr.node_tables, tr.tri_rows,
                                           tr.data.n_nodes, *rs, any_hit)
            got = fn()
            steps = None
            if counts[walk]:
                st = torch.zeros(2, dtype=torch.int64, device=dev)
                if walk == "b3":
                    ct.trace_wide(*tr.node_tables, tr.tri_rows, tr.n_wide,
                                  tr.max_stack, *rs, any_hit, steps=st)
                else:
                    ct.trace_skip(*tr.node_tables, tr.tri_rows,
                                  tr.data.n_nodes, *rs, any_hit, steps=st)
                steps = [int(x) for x in st.cpu()]
            for _ in range(2):
                fn()
            ms = [cs.event_ms(fn, cs.TIMED_LAUNCHES)[1]
                  for _ in range(READINGS)]
            outs[f"{walk}/{kind}"] = [x.cpu() for x in got]
            res[f"{walk}/{kind}"] = dict(ms=ms, steps=steps)
    return res, outs


def b2_readings(cs, dev):
    """B2 at main paths 4 and 5 and B1 on the flagship at 4 spp: three
    launches each between the wrapper's CUDA events after a warm one; the
    first launch's film and counters."""
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    res, outs = {}, {}
    flag, fst = load_json_scene(cs.FLAGSHIP, device=dev)
    frames = (("main4", cs.b2_scene("terrain", 100_000, dev),
               cs.b2_settings("mis", cs.MAIN4_SPP)),
              ("main5", cs.b2_scene("bumpy", 100_000, dev),
               cs.b2_settings("material", cs.MAIN5_SPP)),
              ("b1_flagship4", flag, dataclasses.replace(fst, spp=4)))
    for key, scene, st in frames:
        kernel.render_megakernel(scene, st)
        runs = [kernel.render_megakernel(scene, st, return_stats=True)
                for _ in range(READINGS)]
        img, ks = runs[0]
        outs[key] = dict(img=img.cpu(), counts=[
            ks[k] for k in ("segments", "shadow_rays", "box_tests",
                            "tri_tests", "warp_steps") if k in ks])
        res[key] = dict(ms=[1e3 * r[1]["seconds"] for r in runs],
                        warp_tri_steps=ks.get("warp_tri_steps"),
                        tri_tests=ks.get("tri_tests"))
    return res, outs


def _wf_stats(stats):
    """The wavefront's render-loop seconds, ray counts and supersteps."""
    return dict(loop_s=stats["seconds"], segments=stats["segments"],
                shadow_rays=stats["shadow_rays"],
                supersteps=stats["supersteps"])


def main1_readings(cs, dev):
    """Main path 1: the flagship JSON at 1800x800 @ 512 spp through
    render_frame (B1), after a 1-spp warm-up frame, timed once; the film
    and B1's counters (segments, shadow rays, warp steps)."""
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    scene, st = load_json_scene(cs.FLAGSHIP, device=dev)
    render_frame(scene, dataclasses.replace(st, spp=1))
    img, secs = cs.timed(lambda: render_frame(scene, st))
    return dict(s=secs), dict(img=img.cpu(), counts=[
        int(v) for v in kernel.LAST_COUNTS.cpu()])


def normal_readings(cs, dev):
    """Main paths 7 and 8: s_normal frames at 4 spp of the flagship and
    terrain 100k through render_frame -> render(), timed once each after
    a 1-spp warm-up frame; the films."""
    from vimg_tpu_torch.render.render import render_frame
    res, imgs = {}, {}
    for n, kind in ((7, "flagship"), (8, "terrain")):
        scene, st = cs.normal_scene(kind, dev)
        render_frame(scene, dataclasses.replace(st, spp=1))
        img, secs = cs.timed(lambda: render_frame(scene, st))
        res[f"main{n}"] = dict(s=secs)
        imgs[f"img{n}"] = img.cpu()
    return res, imgs


def frame_readings(cs, dev, n_tris, counter):
    """Main path 2 or 3: terrain ``n_tris`` at 512x256 @ 64 spp MIS through
    the wavefront over B3 or B4 (``counter`` names its launch count),
    after a 1-spp warm-up frame, timed once."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(n_tris, cs.MESH_W, cs.MESH_H, device=dev)
    st = ir.RenderSettings(cs.MESH_W, cs.MESH_H, spp=cs.MESH_SPP,
                           max_depth=64, integrator="mis", tonemap="agx",
                           batch_size=cs.MESH_BATCH)
    render_frame(scene, ir.RenderSettings(
        cs.MESH_W, cs.MESH_H, spp=1, max_depth=64, integrator="mis",
        tonemap="agx", batch_size=cs.MESH_BATCH))
    before = getattr(ct, counter)
    img, secs = cs.timed(lambda: render_frame(scene, st))
    return dict(s=secs, launches=getattr(ct, counter) - before,
                **_wf_stats(wavefront.LAST_STATS)), img.cpu()


def envtex_readings(cs, dev):
    """Main path 9: the envtex frame at 512x256 @ 64 spp MIS through the
    wavefront over B3, after a 1-spp warm-up frame, timed once."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    scene = cs.envtex_scene(dev)
    st = ir.RenderSettings(cs.MESH_W, cs.MESH_H, spp=cs.MESH_SPP,
                           max_depth=64, integrator="mis", tonemap="agx",
                           batch_size=cs.MESH_BATCH)
    render_frame(scene, dataclasses.replace(st, spp=1))
    before = ct.LAUNCHES_WIDE
    img, secs = cs.timed(lambda: render_frame(scene, st))
    return dict(s=secs, launches=ct.LAUNCHES_WIDE - before,
                **_wf_stats(wavefront.LAST_STATS)), img.cpu()


def train_readings(cs, dev):
    """Main path 10 as chip_smoke.py's phase 8c runs it: per step the loss,
    forward and backward ms and B3 launches."""
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.scene import ir
    scene = cs.envtex_scene(dev)
    st = ir.RenderSettings(cs.MESH_W, cs.MESH_H, spp=1, max_depth=64,
                           integrator="mis")
    start = cs.train_start(scene)
    tracer = make_tracer(start, differentiable=True)
    rows = cs.train_run(start, st, tracer, cs.TRAIN_STEPS,
                        lambda i: cs.train_rays(scene, st, tracer, i),
                        optimizer=cs.train_optimizer(cs.TRAIN_RATES))
    return [dict(loss=r["loss"], forward_ms=r["forward_ms"],
                 backward_ms=r["backward_ms"], launches=r["launches"])
            for r in rows]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", nargs="?", help="the other checkout's root")
    p.add_argument("--out", default=None, help="JSON of the readings")
    p.add_argument("--parts", choices=("all", "x3"), default="all",
                   help="x3: only X3 and the device builds")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker), args.out, args.parts)
    import torch
    if not torch.cuda.is_available():
        sys.exit("compare_parent.py needs a GPU")
    if not args.other:
        p.error("name the other checkout")
    other = os.path.abspath(args.other)
    cs = _smoke(ROOT)
    card = cs.nvidia_smi_line()
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, tree) in enumerate(order):
            path = os.path.join(tmp, f"run{i}.json")
            t0 = time.time()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", tree, "--out", path,
                            "--parts", args.parts], check=True)
            with open(path) as f:
                res = json.load(f)
            res.update(name=name, wall_s=time.time() - t0,
                       data=torch.load(path + ".pt"))
            runs.append(res)
            print(f"run {i} ({name}) done in {res['wall_s']:.1f} s",
                  flush=True)
    def span(key, get):
        xs = [x for res in runs if res["name"] == key for x in get(res)]
        return f"{min(xs):.6f}-{max(xs):.6f}"

    bad = x3_checks(runs)
    if args.parts == "x3":
        x3_report(runs, span)
        return finish(args, card, other, runs, bad, "X3's inputs and "
                      "outputs bit-equal across the runs")
    ref = runs[1]["data"]
    for res in runs:
        bad += x2_checks(res, runs[1])
        for key, (t, code) in res["data"]["b5"].items():
            rt, rc = ref["b5"][key]
            n = int(((t.view(torch.int32) != rt.view(torch.int32))
                     | (code.view(torch.int32) != rc.view(torch.int32))).sum())
            if n:
                bad.append(f"B5 {key} run {res['name']}: {n} rays differ")
        if res["p19"]["held"] > 1.0:
            bad.append(f"P19 run {res['name']}: gate {res['p19']['held']}")
        for key, got in res["data"]["meta"].items():
            n = int((got != ref["meta"][key]).sum())
            if n:
                bad.append(f"meta {key} run {res['name']}: {n} slots differ")
        for key, got in res["data"]["p1"].items():
            n = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                    for a, b in zip(got, ref["p1"][key]))
            if n:
                bad.append(f"P1 {key} run {res['name']}: {n} values differ")
        for key, got in res["data"]["walks"].items():
            n = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                    for a, b in zip(got, ref["walks"][key]))
            if n:
                bad.append(f"{key} run {res['name']}: {n} values differ")
        for key, got in res["data"]["b2"].items():
            want = ref["b2"][key]
            if not torch.equal(got["img"].view(torch.int32),
                               want["img"].view(torch.int32)):
                bad.append(f"{key} run {res['name']}: another film")
            if got["counts"] != want["counts"]:
                bad.append(f"{key} run {res['name']}: counters "
                           f"{got['counts']} != {want['counts']}")
        for name, key, fkey in (("main path 6", "img", "frame"),
                                 ("main path 2", "img2", "frame2"),
                                 ("main path 3", "img3", "frame3"),
                                 ("main path 9", "img9", "frame9")):
            r = cs.compare(f"{name}, {res['name']} vs this", ref[key],
                           res["data"][key])
            if not (r["mean"] < cs.WF_MEAN and r["corr"] > cs.WF_CORR):
                bad.append(f"{name} run {res['name']}: another image")
            got, want = ([x[fkey][k] for k in ("segments", "shadow_rays",
                                               "supersteps")]
                         for x in (res, runs[1]))
            if got != want:
                bad.append(f"{name} run {res['name']}: segments, shadow "
                           f"rays, supersteps {got} != {want}")
        if not torch.equal(res["data"]["img6_det"].view(torch.int32),
                           ref["img6_det"].view(torch.int32)):
            bad.append(f"main path 6 run {res['name']}: another "
                       f"deterministic film")
        for k in ("launches", "cull_launches"):
            if res["frame"][k] != runs[1]["frame"][k]:
                bad.append(f"main path 6 run {res['name']}: {k} "
                           f"{res['frame'][k]} != {runs[1]['frame'][k]}")
        m1, w1 = res["data"]["main1"], ref["main1"]
        if not torch.equal(m1["img"].view(torch.int32),
                           w1["img"].view(torch.int32)):
            bad.append(f"main path 1 run {res['name']}: another film")
        if m1["counts"] != w1["counts"]:
            bad.append(f"main path 1 run {res['name']}: counters "
                       f"{m1['counts']} != {w1['counts']}")
        for n in (7, 8):
            if not torch.equal(res["data"][f"img{n}"].view(torch.int32),
                               ref[f"img{n}"].view(torch.int32)):
                bad.append(f"main path {n} run {res['name']}: another film")

    x2_report(runs, span)
    x3_report(runs, span)
    print(f"cull and B5 ms (20 calls between CUDA events, {READINGS} "
          f"readings a run; other runs 1 and 4, this runs 2 and 3):")
    for key in runs[0]["b5"]:
        steps = runs[1]["b5"][key]["steps"]
        print(f"  {key:13s} cull other "
              f"{span('other', lambda r: r['b5'][key]['cull_ms'])}  this "
              f"{span('this', lambda r: r['b5'][key]['cull_ms'])}; B5 other "
              f"{span('other', lambda r: r['b5'][key]['ms'])}"
              f"  this {span('this', lambda r: r['b5'][key]['ms'])}"
              f"  warp test steps (this) {steps}")
    print(f"P1 ms (device time, 20 launches queued behind a spin, "
          f"{READINGS} readings a run):")
    for key in runs[0]["p1"]:
        print(f"  {key:13s} other "
              f"{span('other', lambda r: r['p1'][key]['ms'])}  this "
              f"{span('this', lambda r: r['p1'][key]['ms'])}")
    print(f"P19 TF32 ms (device time): other "
          f"{span('other', lambda r: r['p19']['ms'])}  this "
          f"{span('this', lambda r: r['p19']['ms'])}")
    print(f"main path 6 frame s (render loop s), in run order: " + ", ".join(
        f"{r['name']} {r['frame']['s']:.3f} ({r['frame']['loop_s']:.3f})"
        for r in runs) + f"; launches X1 {runs[1]['frame']['cull_launches']}"
          f", B5 {runs[1]['frame']['launches']} (equal in every run)")
    print(f"B3 (terrain 100k) and B4 (terrain 500k) ms (20 launches between "
          f"CUDA events, {READINGS} readings a run):")
    for key in runs[0]["walks"]:
        print(f"  {key:10s} other "
              f"{span('other', lambda r: r['walks'][key]['ms'])}  this "
              f"{span('this', lambda r: r['walks'][key]['ms'])}  warp steps "
              f"(node, tri; this) {runs[1]['walks'][key]['steps']}")
    for key in runs[0]["b2"]:
        b2 = runs[1]["b2"][key]
        fill = (b2["tri_tests"] / (32 * b2["warp_tri_steps"])
                if b2["warp_tri_steps"] else None)
        print(f"{key} ms (CUDA events, one launch each): other "
              f"{span('other', lambda r: r['b2'][key]['ms'])}  this "
              f"{span('this', lambda r: r['b2'][key]['ms'])}  lane fill "
              f"(this) {fill}")
    for n, key in ((2, "frame2"), (3, "frame3"), (9, "frame9")):
        print(f"main path {n} frame s (render loop s), in run order: "
              + ", ".join(f"{r['name']} {r[key]['s']:.3f} "
                          f"({r[key]['loop_s']:.3f})" for r in runs))
    for n, key in ((2, "frame2"), (3, "frame3"), (6, "frame"),
                   (9, "frame9")):
        f = runs[1][key]
        print(f"main path {n}: {f['segments']} segments + "
              f"{f['shadow_rays']} shadow rays, {f['supersteps']} "
              f"supersteps (equal in every run)")
    for r in runs:
        if "main10" not in r:
            print(f"main path 10: run {r['name']} has no train step")
            continue
        rows = r["main10"]
        print(f"main path 10, run {r['name']}: losses "
              + ", ".join(f"{x['loss']:.6g}" for x in rows)
              + "; forward + backward ms "
              + ", ".join(f"{x['forward_ms']:.1f}+{x['backward_ms']:.1f}"
                          for x in rows)
              + f"; B3 launches {sum(x['launches'].get('cluster_wide', 0) for x in rows)}")
    print(f"main path 1 frame s, in run order: " + ", ".join(
        f"{r['name']} {r['frame1']['s']:.3f}" for r in runs))
    for n in (7, 8):
        print(f"main path {n} frame s, in run order: " + ", ".join(
            f"{r['name']} {r['frames78'][f'main{n}']['s']:.3f}"
            for r in runs))
    finish(args, card, other, runs, bad,
           "all meta, B3, B4, B5, X2, X3 and P1 outputs, B1 and B2 films "
           "and counters (main paths 1, 4, 5), the films of main paths 7 "
           "and 8, the heatmap and the deterministic films of main paths 11 "
           "and 13 (-b 1) bit-equal across the runs, P19 held, the "
           "wavefront frames' counts equal and their films agree")


def finish(args, card, other, runs, bad, ok):
    """Print the card, write the readings, exit non-zero on a failure."""
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, other=other, runs=[
                {k: v for k, v in r.items() if k != "data"} for r in runs],
                failures=bad), f, indent=1)
    if bad:
        sys.exit("FAIL: " + "; ".join(bad))
    print(ok)

def x2_checks(res, ref):
    """X2's outputs, the heatmap and main paths 11 and 13's deterministic
    films bit-equal to run 2's (this checkout), the frames' counts equal."""
    import torch
    bad = []
    for key, got in res["data"]["x2"].items():
        n = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                if a.dtype == torch.float32 else int((a != b).sum())
                for a, b in zip(got, ref["data"]["x2"][key]))
        if n:
            bad.append(f"X2 {key} run {res['name']}: {n} values differ")
    for key in ("main11", "main13_b1", "heatmap"):
        a, b = res["data"][key], ref["data"][key]
        n = int((a.view(torch.int32) != b.view(torch.int32)).any(-1).sum())
        if n:
            bad.append(f"{key} run {res['name']}: {n} pixels differ")
        if key == "heatmap":
            continue
        for det in (False, True):
            got, want = ([(x["front"][key]["det"] if det else
                           x["front"][key])[k]
                          for k in ("segments", "shadow_rays", "supersteps")]
                         for x in (res, ref))
            if got != want:
                bad.append(f"{key}{' (deterministic)' if det else ''} run "
                           f"{res['name']}: segments, shadow rays, "
                           f"supersteps {got} != {want}")
    return bad


def x2_report(runs, span):
    """X2's times beside the other checkout's, and the front frames."""
    print(f"X2 ms, terrain 100k (20 launches between CUDA events / queued "
          f"behind a spin (device), {READINGS} readings a run; other runs "
          f"1 and 4, this runs 2 and 3):")
    for key in runs[0]["x2"]:
        print(f"  {key:16s} events other "
              f"{span('other', lambda r: r['x2'][key]['ms'])}  this "
              f"{span('this', lambda r: r['x2'][key]['ms'])}; device other "
              f"{span('other', lambda r: r['x2'][key]['device_ms'])}  this "
              f"{span('this', lambda r: r['x2'][key]['device_ms'])}; warp "
              f"steps (node, leaf; this) {runs[1]['x2'][key]['steps']}")
    for key, name in (("main11", "main path 11"),
                      ("main13_b1", "main path 13 -b 1")):
        f = runs[1]["front"][key]
        print(f"{name} frame s (render loop s), in run order: " + ", ".join(
            f"{r['name']} {r['front'][key]['s']:.3f} "
            f"({r['front'][key]['loop_s']:.3f})" for r in runs)
              + f"; {f['segments']} segments + {f['shadow_rays']} shadow "
              f"rays, {f['supersteps']} supersteps")
        print(f"  X2 device ms in the frame ({f['x2_calls']} calls, CUDA "
              f"events around each), in run order: " + ", ".join(
                  f"{r['name']} {r['front'][key]['x2_ms']:.1f}"
                  for r in runs))
    print("heatmap s, in run order: " + ", ".join(
        f"{r['name']} {r['front']['heatmap']['s']:.3f}" for r in runs))


if __name__ == "__main__":
    main()
