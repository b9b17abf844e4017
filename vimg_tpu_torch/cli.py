"""Command-line renderer (port of vimg_tpu.cli, the reference's
src/main.cpp:59-77).

Flags:
  -f / --file        scene file (.json / .gltf / .glb / .xml)
  -j / --json        companion JSON of a glTF scene
  -m / --heatmap     render the BVH-cost heatmap scaled by FACTOR
  -t / --threads     ignored (kept for the reference's CLI)
  -c / --tonemap     0=clamp 1=agx 2=reinhard 3=aces (default agx)
  -d / --debug-pixel "x y": trace one pixel, print linear and sRGB values
  -b / --bvh         0=binned SAH (default); 1=sweep SAH (the BVH tracer)
  -o / --output      output path (default v_img_<UTC>.png)
  --spp / --depth    overrides (depth < 0 = unbounded)
  --integrator       s_normal | g_normal | material | mis
  --device           torch device (default cuda; raises without CUDA)
  --cpu              the same as --device cpu
  --trace LOGDIR     render once to warm up, then again under
                     torch.profiler; writes LOGDIR/trace.json (Chrome trace)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from datetime import datetime, timezone

TONEMAP_BY_ID = {0: "clamp", 1: "agx", 2: "reinhard", 3: "aces"}


def build_argparser():
    p = argparse.ArgumentParser("vimg_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-f", "--file", required=True, help="scene file")
    p.add_argument("-j", "--json", default=None, help="glTF companion JSON")
    p.add_argument("-m", "--heatmap", type=float, default=None,
                   help="BVH heatmap factor")
    p.add_argument("-t", "--threads", type=int, default=0, help="(ignored)")
    p.add_argument("-c", "--tonemap", type=int, default=None,
                   help="0=clamp 1=agx 2=reinhard 3=aces")
    p.add_argument("-d", "--debug-pixel", default=None, metavar='"x y"')
    p.add_argument("-b", "--bvh", type=int, default=0,
                   help="0=binned 1=sweep")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--integrator", default=None,
                   choices=["s_normal", "g_normal", "material", "mis"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no silent fallback)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of the render "
                        "into LOGDIR/trace.json")
    return p


def load_scene_any(path, companion_json=None, device="cuda"):
    """(scene, settings) of a .json, .gltf / .glb (with its companion
    JSON) or Mitsuba .xml file, on ``device``."""
    path = str(path)
    if path.endswith(".json"):
        from vimg_tpu_torch.scene.json_loader import load_json_scene
        return load_json_scene(path, device=device)
    if path.endswith((".gltf", ".glb")):
        from vimg_tpu_torch.scene.gltf_loader import load_gltf_scene
        return load_gltf_scene(path, companion_json, device=device)
    if path.endswith(".xml"):
        from vimg_tpu_torch.scene.mitsuba_loader import load_mitsuba_scene
        return load_mitsuba_scene(path, device=device)
    raise ValueError(f"unknown scene format: {path}")


def _sync(x):
    if x.is_cuda:
        import torch
        torch.cuda.synchronize(x.device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = "cpu" if args.cpu else args.device
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.render import film
    from vimg_tpu_torch.render.render import megakernel_takes, render_frame

    t0 = time.time()
    scene, settings = load_scene_any(args.file, args.json, device=device)
    print(f"Scene loaded in {time.time() - t0:.2f}s: "
          f"{scene.n_tris()} tris, {scene.n_spheres()} spheres, "
          f"{scene.n_mats()} materials, {scene.n_lights()} lights "
          f"on {scene.device}")

    over = {}
    if args.spp is not None:
        over["spp"] = args.spp
    if args.depth is not None:
        over["max_depth"] = args.depth if args.depth >= 0 else 2 ** 31 - 1
    if args.integrator is not None:
        over["integrator"] = args.integrator
    if args.tonemap is not None:
        over["tonemap"] = TONEMAP_BY_ID[args.tonemap]
    elif (args.integrator or settings.integrator) in ("s_normal", "g_normal"):
        # the reference forces clamp + 4 spp for the normal integrators
        # (main.cpp:220-236)
        over["tonemap"] = "clamp"
        over.setdefault("spp", 4)
    else:
        over["tonemap"] = "agx"
    settings = dataclasses.replace(settings, **over)

    force = "sweep" if args.bvh == 1 else None

    if args.heatmap is not None:
        from vimg_tpu_torch.render.heatmap import render_heatmap
        # the heatmap shows the BVH walk's cost: the BVH tracer (the
        # cluster tracer has no per-ray cost counter)
        tracer = make_tracer(scene, force=force or "bvh")
        img = render_heatmap(scene, settings, tracer, args.heatmap)
        out = args.output or _default_name("heatmap")
        film.write_png(out, img)
        print(f"Heatmap written to {out}")
        return 0

    if args.debug_pixel is not None:
        import torch
        from vimg_tpu_torch.render.integrators import trace_radiance
        x, y = (int(v) for v in args.debug_pixel.split())
        tracer = make_tracer(scene, force=force)
        W, H = settings.width, settings.height
        pix = torch.full((settings.spp,), x + (H - 1 - y) * W,
                         dtype=torch.int64, device=scene.device)
        samp = torch.arange(settings.spp, device=scene.device)
        col = trace_radiance(scene, settings, tracer, pix, samp).mean(dim=0)
        srgb = film.srgb_encode(col)
        print(f"pixel ({x} {y}) linear: {col.tolist()}")
        print(f"pixel ({x} {y}) sRGB:   {srgb.tolist()}")
        return 0

    if (force == "sweep" and scene.device.type == "cuda"
            and megakernel_takes(scene, settings)):
        # vimg_tpu prints this for every frame the megakernel supports,
        # also those its wavefront takes (ROADMAP C24)
        print("note: -b 1 (sweep SAH) only affects the wavefront/BVH "
              "paths; this render takes the megakernel (binned-SAH "
              "cluster tables)")
    trace_cm = contextlib.nullcontext()
    if args.trace:
        from vimg_tpu_torch.utils.profiling import device_trace
        # warm once outside the trace, so that it shows the steady state
        # (kernel library build and first-call set-up excluded)
        _sync(render_frame(scene, settings, tracer_force=force))
        trace_cm = device_trace(args.trace, device=scene.device)
    t0 = time.time()
    with trace_cm as trace_path:
        img = render_frame(scene, settings, tracer_force=force,
                           progress=True)
        _sync(img)
    dt = time.time() - t0
    n_paths = settings.width * settings.height * settings.spp
    print(f"Render took {dt:.2f}s ({n_paths / dt / 1e6:.2f} Mpaths/s)")
    if args.trace:
        print(f"Device trace captured to {trace_path}")

    out = args.output or _default_name("v_img")
    film.write_png(out, film.finalize(img, tonemap=settings.tonemap))
    print(f"Image written to {out}")
    return 0


def _default_name(prefix):
    ts = datetime.now(timezone.utc).strftime("%Y-%m-%d_%H-%M-%S")
    return f"{prefix}_{ts}.png"


if __name__ == "__main__":
    sys.exit(main())
