"""Where a wavefront superstep's time goes, stage by stage (port of
tools/ablate_superstep.py).

Runs ``n_steps`` supersteps of the wavefront (``render/wavefront.py``)
over ``lanes`` lanes with a work count that never runs out (2^31 - 1
paths: every lane stays busy), once for each variant of ``VARIANTS``: the
full superstep, then with stages replaced by ``make_superstep``'s
``ablate`` stand-ins. The difference to ``full`` is what a stage costs.

For each variant it logs, per superstep: ``ms``, the host's clock around
the run (``torch.cuda.synchronize()`` before and after), best of
``repeats`` runs after a warm run; ``mseg_s``, lanes / ms (million path
segments a second); ``event_ms``, the card's clock between CUDA events
recorded before and after each superstep (its span on the stream, which
includes the gaps while the host queues the next launch: a host-paced step
shows about the host's time); ``busy_ms``, the sum of the device times of
the kernels it launched, from one more run of PROFILE_STEPS supersteps
under ``torch.profiler`` (CUPTI; the profiler slows the host, not the
kernels). busy_ms against ms is the split of device against host that
ROADMAP R1 asks for, per stage. On the CPU (``--device cpu``, the tests)
the records carry ``ms`` and ``mseg_s`` from the host's clock and no
device times.

Scenes: ``--terrain N`` (terrain_scene, 512x256 @ 64 spp MIS, the bench's
mesh frame), ``--envtex N`` (textured_terrain_scene @ 16 spp), ``--mesh
N`` (the bumpy sphere, max depth 16), else ``--scene`` (a JSON scene, the
repository's flagship by default) with ``make_tracer``'s tracer. vimg_tpu's
``--mesh`` tracer takes tile_rows=16, a TPU knob; here it is the default
ClusterTracer.

Run: ``python -m vimg_tpu_torch.probes.ablate_superstep [--device cpu]
[--terrain 100000] [--lanes 131072] [--steps 100] [--repeats 3]
[--variants full,-film,...] [--out records.jsonl]``.
"""
from __future__ import annotations

import os
import time

import torch

from vimg_tpu_torch.probes import common
from vimg_tpu_torch.render import wavefront

VARIANTS = [
    ("full", frozenset()),
    ("-film", frozenset({"film"})),
    ("-cumsum", frozenset({"cumsum"})),
    ("-film-cumsum", frozenset({"film", "cumsum"})),
    ("-nee", frozenset({"nee"})),
    ("-shadow", frozenset({"shadow"})),
    ("-beval", frozenset({"beval"})),
    ("-bsample", frozenset({"bsample"})),
    ("-trace", frozenset({"trace", "shadow"})),
    ("-hitinfo", frozenset({"hitinfo"})),
    ("-bg", frozenset({"bg"})),
    ("skeleton", frozenset({"film", "cumsum", "nee", "beval", "bsample",
                            "trace", "hitinfo", "bg"})),
]
TOTAL = 2 ** 31 - 1     # never exhausts the work: lanes stay busy
PROFILE_STEPS = 5       # supersteps of the profiled run (busy_ms)
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes", "disney_spheres_flagship.json")


def make_fixed_run(scene, settings, tracer, total, n_steps, ablate,
                   events=None):
    """run(state, accum) -> (state, accum): ``n_steps`` supersteps with the
    stages ``ablate`` replaced. ``events``, a list, gets a (start, end)
    pair of CUDA events around each superstep."""
    step = wavefront.make_superstep(scene, settings, tracer, total,
                                    ablate=ablate)

    def run(state, accum):
        for _ in range(n_steps):
            if events is not None:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            state, accum = step(state, accum)
            if events is not None:
                ev[1].record()
                events.append(ev)
        return state, accum
    return run


def load_scene(device, terrain=0, envtex=0, mesh=0, scene=FLAGSHIP):
    """(scene, settings, tracer) of the tool's scene choice."""
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.scene import ir
    if terrain or envtex or mesh:
        from vimg_tpu_torch.scene import synthetic
        if terrain:
            sc = synthetic.terrain_scene(terrain, 512, 256, device=device)
            st = ir.RenderSettings(512, 256, spp=64, max_depth=64,
                                   integrator="mis")
        elif envtex:
            sc = synthetic.textured_terrain_scene(envtex, 512, 256,
                                                  device=device)
            st = ir.RenderSettings(512, 256, spp=16, max_depth=64,
                                   integrator="mis")
        else:
            sc = synthetic.bumpy_sphere_scene(mesh, 512, 256, device=device)
            st = ir.RenderSettings(512, 256, spp=64, max_depth=16,
                                   integrator="mis")
        return sc, st, ClusterTracer(sc)
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    sc, st = load_json_scene(scene, device=device)
    return sc, st, make_tracer(sc)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _busy_ms(run, state, accum, dev):
    """Device milliseconds of the kernels that one run launches (CUPTI
    through torch.profiler); None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, accum = run(state, accum)
        _sync(dev)
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        us += getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
    return (us / 1e3 if us > 0 else None), state, accum


def ablate(scene, settings, tracer, lanes, n_steps, repeats=3, names=None,
           log=None):
    """The probe: each variant (all, or those in ``names``) for ``n_steps``
    supersteps over ``lanes`` lanes; logs one record a variant. Returns
    {name: record}."""
    dev = scene.device
    log = log or common.Log(dev)
    cuda = dev.type == "cuda"
    res = {}
    for name, ab in VARIANTS:
        if names is not None and name not in names:
            continue
        events = [] if cuda else None
        run = make_fixed_run(scene, settings, tracer, TOTAL, n_steps, ab,
                             events)
        state = wavefront.init_state(lanes, dev, cones=scene.needs_cones)
        accum = torch.zeros((3, settings.width * settings.height),
                            device=dev)
        t0 = time.time()
        state, accum = run(state, accum)          # warm run
        _sync(dev)
        warm_s = time.time() - t0
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                events.clear()
            t0 = time.time()
            state, accum = run(state, accum)
            _sync(dev)
            dt = time.time() - t0
            if dt < best:
                best = dt
                event_ms = (sum(a.elapsed_time(b) for a, b in events)
                            / n_steps if cuda else None)
        busy = None
        if cuda:
            k = min(n_steps, PROFILE_STEPS)
            busy, state, accum = _busy_ms(
                make_fixed_run(scene, settings, tracer, TOTAL, k, ab),
                state, accum, dev)
            busy = None if busy is None else busy / k
        ms = best / n_steps * 1e3
        base = res.get("full")
        res[name] = log(
            probe="ablate_superstep", variant=name, ablate=sorted(ab),
            lanes=lanes, steps=n_steps, ms=ms, mseg_s=lanes / ms / 1e3,
            delta_ms=None if base is None or name == "full"
            else base["ms"] - ms,
            event_ms=event_ms if cuda else None, busy_ms=busy,
            warm_s=warm_s, film_finite=bool(torch.isfinite(accum).all()),
            segments=int(state["n_segments"]))
    return res


def main(argv=None):
    args = common.parse_args(__doc__, argv, (
        ("--lanes", dict(type=int, default=wavefront.MAX_LANES)),
        ("--steps", dict(type=int, default=100)),
        ("--repeats", dict(type=int, default=3)),
        ("--variants", dict(default=None,
                            help="comma-separated subset of variant names")),
        ("--terrain", dict(type=int, default=0)),
        ("--envtex", dict(type=int, default=0)),
        ("--mesh", dict(type=int, default=0)),
        ("--scene", dict(default=FLAGSHIP))))
    dev = common.resolve_device(args.device)
    scene, settings, tracer = load_scene(dev, args.terrain, args.envtex,
                                         args.mesh, args.scene)
    names = None if args.variants is None else set(args.variants.split(","))
    ablate(scene, settings, tracer, args.lanes, args.steps, args.repeats,
           names, common.Log(dev, args.out))


if __name__ == "__main__":
    main()
