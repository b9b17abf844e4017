"""The port's scale-out across cards and processes (vimg_tpu_torch.parallel,
render_megakernel_sharded, make_train_step(mesh=)), which chip_smoke.py can
only drive on one card and one rank.

Run from the repository root on a machine with several NVIDIA GPUs:

    python3 scale_study.py [--out FILE]

or, as a rehearsal on the CPU at a small size (gloo, meshes that name the
CPU once a rank):

    python3 scale_study.py --device cpu --ranks 4

1. One process, a mesh of every card (``--ranks`` entries): the
   flagship's 1800x800 frame at 4 spp through render_megakernel_sharded
   (B1) and terrain 100k at 512x256 @ 4 spp MIS through it (B2), each
   against the single launch on the first card, bit for bit; terrain
   100k at 4 spp through render_sharded over the mesh (B3) against one
   card, bit for bit. Seconds of each (host clock to the synchronised
   film).
2. One process a card under NCCL (``--ranks`` processes): render_distributed
   of that terrain frame against phase 1's one-card render_sharded (within
   1e-5; the same film on every rank), with the film all-reduce's ms; then
   main path 10's envtex train step (131,072 rays, B3) with
   mesh=global_mesh() against the unsharded step on one card: the loss
   within 1e-6 relative, every gradient within chip_smoke.py's GRAD_RTOL
   of its largest, the parameters equal on every rank; forward, backward
   and all-reduce ms of each rank.

Prints the card's name and power limit, and exits non-zero on a failure.
"""
import argparse
import dataclasses
import json
import os
import socket
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FLAGSHIP_SPP = 4
SHARD_SPP = 4


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    sync(dev)
    t0 = time.time()
    out = fn()
    sync(dev)
    return out, time.time() - t0


def bits_equal(a, b):
    import torch
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def sizes(args):
    """(W, H, terrain triangles): the bench's, or small on the CPU."""
    return (512, 256, 100_000) if args.device == "cuda" else (32, 16, 2_000)


def terrain_settings(args, spp):
    from vimg_tpu_torch.scene import ir
    W, H, _ = sizes(args)
    return ir.RenderSettings(W, H, spp=spp, max_depth=64, integrator="mis",
                             batch_size=1 << 20)


def devices(args):
    import torch
    if args.device == "cpu":
        return [torch.device("cpu")] * args.ranks
    return [torch.device("cuda", i) for i in range(args.ranks)]


def mesh_phase(args, res):
    import chip_smoke as cs
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.parallel.sharding import make_mesh, render_sharded
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    devs = devices(args)
    dev, mesh = devs[0], make_mesh(devs)
    W, H, n_tris = sizes(args)
    log(f"[1] one process, a mesh of {mesh.size} x {dev.type}")
    fscene, fst = load_json_scene(cs.FLAGSHIP, device=dev)
    if args.device == "cpu":
        fst = dataclasses.replace(fst, width=48, height=24)
        fscene = fscene.replace(camera=dataclasses.replace(
            fscene.camera, width=48, height=24))
    terrain = terrain_scene(n_tris, W, H, device=dev)
    frames = (("flagship (B1)", fscene,
               dataclasses.replace(fst, spp=FLAGSHIP_SPP)),
              ("terrain (B2)", terrain, terrain_settings(args, SHARD_SPP)))
    for label, sc, st in frames:
        kernel.render_megakernel(sc, st)                          # warm
        one, one_s = timed(lambda: kernel.render_megakernel(sc, st), dev)
        kernel.render_megakernel_sharded(sc, st, mesh=mesh)       # warm
        img, secs = timed(lambda: kernel.render_megakernel_sharded(
            sc, st, mesh=mesh), dev)
        same = bits_equal(img, one)
        log(f"    render_megakernel_sharded, {label}: {secs:.4f} s over "
            f"{mesh.size} devices, {one_s:.4f} s the single launch; "
            f"bit-equal {same}")
        res[f"mega_{label}"] = dict(sharded_s=secs, single_s=one_s)
        if not same:
            fail(f"render_megakernel_sharded, {label}: films differ")
    st = terrain_settings(args, SHARD_SPP)
    tracer = ClusterTracer(terrain)
    one_mesh = make_mesh([dev])
    render_sharded(terrain, st, tracer, mesh=mesh)                # warm
    one, one_s = timed(lambda: render_sharded(terrain, st, tracer,
                                              mesh=one_mesh), dev)
    img, secs = timed(lambda: render_sharded(terrain, st, tracer,
                                             mesh=mesh), dev)
    same = bits_equal(img, one)
    log(f"    render_sharded, terrain (B3): {secs:.4f} s over {mesh.size} "
        f"devices, {one_s:.4f} s on one; bit-equal {same}")
    res["render_sharded"] = dict(sharded_s=secs, single_s=one_s)
    if not same:
        fail("render_sharded over the mesh differs from one device")
    return one


def rank_main(rank, args, port, out_dir):
    """One rank of phase 2; writes its film, losses and gradients."""
    import datetime
    import numpy as np
    import torch
    import chip_smoke as cs
    from vimg_tpu_torch.diff import grad
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.parallel import distributed
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(f"tcp://127.0.0.1:{port}", args.ranks, rank,
                           device=args.device,
                           timeout=datetime.timedelta(seconds=120))
    dev = distributed.global_mesh().devices[0]
    W, H, n_tris = sizes(args)
    # NCCL builds its communicator at the first collective
    torch.distributed.all_reduce(torch.ones(1, device=dev))
    terrain = terrain_scene(n_tris, W, H, device=dev)
    stats = {}
    film, film_s = timed(lambda: distributed.render_distributed(
        terrain, terrain_settings(args, SHARD_SPP), stats=stats), dev)
    st1 = ir.RenderSettings(W, H, spp=1, max_depth=64, integrator="mis")
    scene = cs.envtex_scene(dev, W, H)
    start = cs.train_start(scene)
    tracer = make_tracer(start, differentiable=True)
    rays = cs.train_rays(scene, st1, tracer, 0)
    step, opt, params = grad.make_train_step(
        start, st1, tracer, bounded_depth=cs.TRAIN_DEPTH, integrator="mis",
        optimizer=cs.train_optimizer(cs.TRAIN_RATES),
        mesh=distributed.global_mesh())
    sstats = {}
    params, opt, loss = step(params, opt, *rays, stats=sstats)
    out = {"film": film.cpu().numpy(), "film_s": film_s,
           "loss": float(loss)}
    for k, v in params.items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            out[f"grad/{k}/{i}"] = t.grad.cpu().numpy()
            out[f"param/{k}/{i}"] = t.detach().cpu().numpy()
    for k, v in list(stats.items()) + [(f"step_{k}", v)
                                       for k, v in sstats.items()]:
        out[k] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phase(args, ref_film, res):
    import multiprocessing as mp
    import numpy as np
    import torch
    import chip_smoke as cs
    from vimg_tpu_torch.diff import grad
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.scene import ir
    log(f"[2] {args.ranks} processes, "
        f"{'NCCL' if args.device == 'cuda' else 'gloo'}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [ctx.Process(target=rank_main, args=(r, args, port, tmp))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            fail(f"ranks exited {[p.exitcode for p in procs]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(args.ranks)]
    ref = ref_film.cpu().numpy()
    d = float(np.abs(ranks[0]["film"] - ref).max())
    same = all(np.array_equal(r["film"], ranks[0]["film"]) for r in ranks)
    log(f"    render_distributed: {[round(float(r['film_s']), 4) for r in ranks]}"
        f" s a rank, all-reduce "
        f"{[round(float(r.get('allreduce_ms', np.nan)), 4) for r in ranks]}"
        f" ms; the same film on every rank {same}; max |d| against one "
        f"device's render_sharded {d:.3e}")
    res["render_distributed"] = dict(
        seconds=[float(r["film_s"]) for r in ranks],
        allreduce_ms=[float(r.get("allreduce_ms", np.nan)) for r in ranks],
        max_abs_err=d)
    if not same or not d <= 1e-5:
        fail("render_distributed differs")
    dev = devices(args)[0]
    W, H, _ = sizes(args)
    st1 = ir.RenderSettings(W, H, spp=1, max_depth=64, integrator="mis")
    scene = cs.envtex_scene(dev, W, H)
    start = cs.train_start(scene)
    tracer = make_tracer(start, differentiable=True)
    rays = cs.train_rays(scene, st1, tracer, 0)
    step, opt, params = grad.make_train_step(
        start, st1, tracer, bounded_depth=cs.TRAIN_DEPTH, integrator="mis",
        optimizer=cs.train_optimizer(cs.TRAIN_RATES))
    params, opt, loss = step(params, opt, *rays)
    loss = float(loss)
    worst = 0.0
    for k, v in params.items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            g = t.grad.cpu().numpy().astype(np.float64)
            bound = cs.GRAD_RTOL * np.abs(g).max() + cs.GRAD_ATOL
            for r in ranks:
                e = float(np.abs(r[f"grad/{k}/{i}"] - g).max())
                worst = max(worst, e / max(np.abs(g).max(), 1e-30))
                if e > bound:
                    fail(f"sharded step: gradient of {k}/{i} off by {e:.3e}")
                if not np.array_equal(r[f"param/{k}/{i}"],
                                      ranks[0][f"param/{k}/{i}"]):
                    fail(f"sharded step: {k}/{i} differs between ranks")
    losses = [float(r["loss"]) for r in ranks]
    log(f"    sharded step: loss {losses} against {loss:.8g} unsharded; "
        f"gradients within {worst:.3e} of each key's largest; forward "
        f"{[round(float(r.get('step_forward_ms', np.nan)), 1) for r in ranks]}"
        f" ms, backward "
        f"{[round(float(r.get('step_backward_ms', np.nan)), 1) for r in ranks]}"
        f" ms, all-reduce "
        f"{[round(float(r.get('step_allreduce_ms', np.nan)), 3) for r in ranks]}"
        f" ms")
    res["train_step"] = dict(loss=losses, loss_unsharded=loss,
                             worst_rel=worst)
    if any(abs(x - loss) > 1e-6 * abs(loss) for x in losses):
        fail("sharded step: the loss differs")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=0,
                   help="mesh entries and processes (default: every card)")
    p.add_argument("--out", default=None, help="write the readings as JSON")
    args = p.parse_args()
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false")
        import chip_smoke as cs
        card = cs.nvidia_smi_line()
        args.ranks = args.ranks or torch.cuda.device_count()
        if args.ranks > torch.cuda.device_count():
            fail(f"{args.ranks} ranks, {torch.cuda.device_count()} cards")
    else:
        card = "cpu"
        args.ranks = args.ranks or 2
    log(f"{card} x {args.ranks}")
    res = {"card": card, "ranks": args.ranks}
    ref = mesh_phase(args, res)
    dist_phase(args, ref, res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    log(card)
    log("scale_study: every check passed")


if __name__ == "__main__":
    main()
