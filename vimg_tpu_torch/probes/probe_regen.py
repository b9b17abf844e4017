"""Can a kernel keep a dynamic-index scalar stack (port of
tools/probe_regen.py's probe_smem_dynamic_write)?

Sixteen steps push two values (3i + 1, 3i + 2) at the stack pointer and
pop one, then the entries 0..sp are summed: 423 for these pushes. Output
``x + sum`` over an (8, 128) float32 block.

``stack_sum`` is kernel P4 (``csrc/probe_scalar.cu``; the stack lives in
shared memory, the counterpart of SMEM) for CUDA tensors and
``stack_sum_plain`` for CPU tensors. ``probe_smem_dynamic_write`` is the
probe: its record carries the TPU probe's keys (probe, ok, v) and the
launch time.

``depth_decomposition`` runs the port's mesh megakernel B2
(``render_megakernel``) on terrain 100k at 512x256 @ 32 spp MIS with
max_depth 1, 2, 3, 6 and 64: the second of two renders is timed, with its
segments, shadow rays and the walk's box and triangle tests and warp
steps (B2's counters; the plain version's on the CPU). The tool's
``regen_frac`` and ``rows`` are TPU knobs and are dropped; its
``sweep_regen`` sweeps only them and is not ported. Times are None on the
CPU.

Run: ``python -m vimg_tpu_torch.probes.probe_regen [--device cpu]
[--out records.jsonl]``: the kernel probe, then ``depth_decomposition``.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.probes import common

SHAPE = (8, 128)
N_PUSH = 16


def stack_sum_plain(x):
    """Plain version of kernel P4: the stack pushes and pops in a tensor,
    then x + the float32 sum of entries 0..sp in order."""
    stack = torch.zeros(64, dtype=torch.int32)
    sp = 0
    for i in range(N_PUSH):      # push two values, pop one
        stack[sp] = i * 3 + 1
        stack[sp + 1] = i * 3 + 2
        v = int(stack[sp])
        sp = sp + 1 + v % 1
    acc = torch.zeros((), dtype=torch.float32)
    for i in range(sp + 1):
        acc = acc + stack[i].to(torch.float32)
    return x + acc.to(x.device)


def stack_sum(x):
    """Kernel P4 on a CUDA tensor, stack_sum_plain on a CPU tensor.

    Replaces tools/probe_regen.py::probe_smem_dynamic_write (pallas_call
    :56). Thread 0 of one 128-thread block runs the stack in shared memory
    (volatile, so every store and load happens) and shares the sum through
    shared memory. Bounded by launch latency (a latency probe)."""
    if not common.on_card(x):
        return stack_sum_plain(x)
    common.check_tensor(x, "x", torch.float32, SHAPE, x.device)
    out = torch.empty(SHAPE, dtype=torch.float32, device=x.device)
    common.launch("probe_smem_write", "vimg_probe_stack", x.device, x, out)
    return out


def probe_smem_dynamic_write(device="cuda", log=None):
    """The probe: x = 0; logs (ok, v, us per launch; None on the CPU).
    Returns (x, out, ms per launch)."""
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    x = torch.zeros(SHAPE, dtype=torch.float32, device=dev)
    out = stack_sum(x)
    ms = (common.device_ms(lambda: stack_sum(x))
          if dev.type == "cuda" else None)
    log(probe="smem_dynamic_write", ok=bool(torch.isfinite(out).all()),
        v=float(out[0, 0]), us=None if ms is None else ms * 1e3)
    return x, out, ms


MEGA_STATS = ("segments", "shadow_rays", "box_tests", "tri_tests",
              "warp_node_steps", "warp_tri_steps")


def depth_decomposition(device="cuda", n_tris=100_000, size=(512, 256),
                        spp=32, depths=(1, 2, 3, 6, 64), log=None):
    """The tool's depth sweep over B2; logs per depth mpaths, secs (None
    on the CPU) and B2's stats. Returns {depth: (image, stats)}."""
    from vimg_tpu_torch.render.mega.kernel import render_megakernel
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    dev = common.resolve_device(device)
    log = log or common.Log(dev)
    W, H = size
    scene = terrain_scene(n_tris, W, H, device=dev)
    res = {}
    for depth in depths:
        st = ir.RenderSettings(W, H, spp=spp, max_depth=depth,
                               integrator="mis", batch_size=1 << 18)
        render_megakernel(scene, st)
        dt, (img, stats) = common.host_seconds(
            lambda: render_megakernel(scene, st, return_stats=True), dev)
        card = dev.type == "cuda"
        log(probe="depth", depth=depth,
            mpaths=W * H * spp / dt / 1e6 if card else None,
            secs=dt if card else None,
            **{k: int(stats[k]) for k in MEGA_STATS if k in stats})
        res[depth] = (img, stats)
    return res


def main(argv=None):
    args = common.parse_args(__doc__, argv)
    dev = common.resolve_device(args.device)
    log = common.Log(dev, args.out)
    probe_smem_dynamic_write(dev, log)
    depth_decomposition(dev, log=log)


if __name__ == "__main__":
    main()
