"""GPU smoke run of the PyTorch + CUDA port (vimg_tpu_torch).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py [--png-dir DIR]

Phases:
 1. environment: card name and power limit, CUDA/PyTorch/nvcc versions,
    whether Triton imports;
 2. build the CUDA kernel library from csrc/ (every .cu compiled in
    parallel, linked into one library; timed), ptxas registers and spills;
 3. kernel B1 (megakernel) against its plain PyTorch version, both on the
    card: a unit-scale scene at 64x48 @ 16 spp (MIS and material;
    per-pixel parity, warp steps equal to the plain count) and the
    flagship scene at 1800x800 @ 4 spp (statistical parity); B1's warp
    steps, SIMT fill (segments / (32 x warp steps)), registers, spills and
    resident warps per SM;
 4. main path 1: scenes/disney_spheres_flagship.json -> render_frame on
    cuda at the file's 1800x800 @ 512 spp -> finalize -> write_png, which
    must launch B1; its frame time, warp steps and SIMT fill;
 5. the cluster kernels in the library: B3 (wide walk) and B4 (skip walk);
 6. B3 and B4 against their plain walks on the card, on terrain_scene
    (100k and 500k triangles) with 131,072 camera, cosine-bounce and shadow
    rays each: zero mismatches, kernel vs plain and wide vs skip; kernel
    times with CUDA events; the bound of each; B3's and B4's warp node
    and triangle steps (one counted launch each) equal to the replay of
    their schedules (geometry/skip_schedule.py), their leaf lane fill
    (needed triangle tests / (32 x triangle steps)) side by side;
 7. main path 2: terrain 100k at 512x256 @ 64 spp, max_depth 64,
    batch 1<<17 -> render_frame -> finalize -> write_png through B3 (not
    B1), after the same frame at 1 spp through B3 and through the plain
    walk agree per pixel;
 8. main path 3: the same at terrain 500k through B4 (64-spp MIS frames
    still go to the wavefront: B2 is launched 0 times in 7 and 8);
8b. main path 9: the env-lit textured terrain (textured_terrain_scene,
    bench.py's envtex stage: 100k triangles, a 256^2 mip-mapped image
    texture, a 64x128 HDR sky with a sun disk sampled by NEE) at 512x256 @
    64 spp, max_depth 64, batch 1<<17 -> render_frame -> the wavefront with
    ray cones -> finalize (AgX) -> write_png through B3 only, after the
    same frame at 1 spp through B3 and through the plain walk agree per
    pixel with equal ray counts; its mean against the plain 1-spp mean;
    seconds a superstep beside main path 2's;
8c. main path 10, the differentiable step (diff/grad.py): the envtex
    scene at 512x256 with env_scale halved and its Principled scalars
    moved by seeded noise -> make_tracer(differentiable=True) ->
    make_train_step (MIS, bounded_depth 6, Adam at 1e-2, the camera at
    1e-4) -> 10 steps of 131,072 rays (every pixel once, sample id =
    step) toward the port's own radiance at the scene's values, through
    B3 at zero tangent: each step's loss, forward and backward ms (CUDA
    events), B3 launches and peak memory; every loss and gradient finite,
    the last loss below the first, B3 launched every step and nothing
    else; step 0's gradients through B3 against the plain walk's on the
    card and the card's against the CPU's at 64x32 (per key, GRAD_RTOL of
    the largest); then 5 steps on the flagship JSON (the same rates, its
    Principled scalars put back into [0, 1] after each step; the SoA
    tracer, tensor code; no kernel may launch), the scene of vimg_tpu's
    dryrun_multichip;
 9. kernel B2 (mesh-mode megakernel) against its plain PyTorch version,
    both on the card, at 512x256 @ 1 spp: terrain 100k MIS, the smooth-
    shaded bumpy sphere 100k under the material integrator, terrain 500k
    MIS (films bit-identical, equal ray counts; the plain renders launch
    no kernel); B2's registers, spills and resident warps per SM, its
    walk's warp steps and lane fill (kernel counters); B2 timed at 4 spp
    on terrain 100k with CUDA events, its bound from the kernel's own box
    and triangle test counters;
10. main path 4: terrain 100k at 512x256 @ 4 spp MIS (a low-spp preview)
    -> render_frame -> finalize -> write_png through B2 only, its mean
    against the B3 wavefront's 4-spp frame (another estimator order, the
    same expectation);
11. main path 5: the smooth bumpy sphere 100k at 512x256 @ 64 spp under
    the material integrator -> render_frame -> write_png through B2 only,
    its mean against the plain version's 4-spp frame; then the same launch
    alone between CUDA events, its bound and lane fill from its counters;
12. kernels X1 (packet cull) and B5 (packet walk) against their plain
    versions on the card, on phase 6's terrain-100k camera, bounce and
    shadow rays in PacketTracer's own order, variants slist and f2b: the
    cull's meta bit for bit against the plain cull's, zero (t, code)
    mismatches for B5; kernel, plain cull and whole-trace times with CUDA
    events (X1's six: slist and f2b on each ray kind); X1's registers,
    shared memory and resident warps per SM; X1's counted launch (its
    select-form, plain-form, bounds and skipped tests) against the CPU
    replay cull_schedule.cull_steps, and its skip share; the bound of
    each (X1's from the slab and bounds tests it runs); B5's warp test
    steps and lane
    fill (needed tests / (32 x steps)); closest() and occluded() against
    B3's on the same rays (prim ids may differ only where t ties exactly:
    counted and printed);
13. main path 6: terrain 100k at 512x256 @ 64 spp -> render_frame(...,
    tracer_force="packet") -> finalize -> write_png through X1 and B5 only
    (one cull launch a walk launch, printed), after the same frame at 1
    spp through the kernels and through the plain cull and packet walk
    agree per pixel; its mean against phase 7's B3 frame;
14. kernel B6 (table-row gather) on a 24x256 table and 1,048,576 ids:
    bit for bit against its plain version and the table; timed beside
    torch.index_select on the float32 table;
15. kernel P1 (the walk ablation of tools/probe_walkablate.py) through
    its probe on phase 6's terrain 100k: 131,072 bounce rays in origin-
    Morton order, five variants at groups 32 (a warp in lockstep) and 1;
    bt and visits bit for bit against the plain walk at the same group;
    the full walk's bt against B4's closest t on the same rays; a counted
    launch of the full walk at each group, whose warp node and triangle
    steps must equal the replay of its schedule
    (probe_walkablate.walk_schedule, bt and visits the plain walk's too),
    and the leaf round's lane fill (triangle tests / (32 x steps));
16. kernels P2-P4 (tools/probe_r3b.py microbench_sync, probe_r3c.py
    smem_read_cost, probe_regen.py probe_smem_dynamic_write) through their
    probes at N = 20,000, bit for bit against their plain versions;
17. kernels P5-P10 (tools/probe_r4a.py) through their probes at reps 512
    (ffs 64 with 16 and 4 live lanes), bit for bit against plain;
18. kernel P11 (tools/probe_r4c.py) through run_stage, stages 0-3 and
    stage 4 at 1, 4 and 16 packets, bit for bit against plain;
19. main paths 7 and 8: the flagship JSON at 1800x800 and terrain 100k at
    512x256, both under s_normal at 4 spp -> render_frame -> render() on
    the card (the flagship's SoA tracer is tensor code, terrain's walk is
    B3), each first compared per pixel with the same call on the CPU at a
    reduced size; then a g_normal frame and three material frames the
    megakernel refuses, card vs CPU per pixel, launching only B3 or B4;
    and main path 9's frame at 64x32 @ 4 spp, card vs CPU (mean and
    correlation: the card's transcendentals round otherwise), launching
    only B3;
20. B-1: kernels P12-P15 and P20 (tools/probe_prims.py, probe_vpu2.py,
    probe_vpu3.py, probe_r2c.py vpu_rate) through their probes at the
    probes' sizes (probe_prims at ITERS = 200,000), one block and the full
    card, separate and fused multiply-adds; each against its plain version
    (probe_prims at 2,000 steps, the most its plain version can run);
21. B-2: kernels P16-P19, P21, P22 (tools/probe_r2c.py gathers and
    mxu_precision, probe_r4j.py) through their probes, against their plain
    versions; P19 and P22 beside torch.matmul (TF32 on and off) and
    torch.index_select;
22. B-3: kernels P23-P31 (tools/probe_pallas.py, probe_constructs.py)
    through their probes (every check's verdict must hold), against their
    plain versions;
23. kernel X2 (the BVH walk, csrc/bvh_walk.cu: nodes per lane, the
    posted leaves per warp) against its plain version bvh_traverse on the
    card, on terrain 100k (phase 6's camera, bounce and shadow rays) over
    its binned-SAH and its sweep-SAH tree and on many_lights_scene
    (131,072 camera, cosine-bounce and shadow rays each), in its three
    modes (closest t, prim type, prim id, u, v; any hit; the heatmap's
    cost), bit for bit; timed with CUDA events beside its bound and the
    packed tables' bytes; a counted launch of each mode whose warp node
    and leaf steps must equal the replay of its schedule
    (geometry/bvh_schedule.py::warp_schedule, whose hits must be the plain
    walk's too), the leaf lane fill (primitive tests / (32 x leaf steps))
    and the replayed steps of the first, per-lane design beside them; its
    registers, spills and resident warps per SM in each mode; X2's
    closest hits against B3's on terrain 100k (the same prim ids but at
    ties in t, counted);
24. main path 11: a Mitsuba XML scene written here (terrain 100k as .obj,
    a 20k-triangle bumpy sphere as .serialized, 128 spheres, a rectangle
    area emitter, a 64x128 .hdr env map) -> cli.main(["-f", ..., "--spp",
    "64"]) -> load_mitsuba_scene -> render_frame at 512x256 -> the
    wavefront (the env map makes the megakernel refuse it) over the BVH
    tracer (128 spheres): only X2 may launch; first the 1-spp frame
    through X2 and through its plain walk agree per pixel with equal ray
    counts;
25. main path 12: a GLB written here (terrain 100k, three 256^2 PNG
    textures written by film.write_png, an emissive quad, a camera) and its
    companion JSON -> cli.main(["-f", ..., "-j", ...]) -> load_gltf_scene
    -> the wavefront with textures and ray cones over B3 only, after the
    same 1-spp check;
26. main path 13: a JSON scene with a "mesh" surface (the terrain .obj)
    through the CLI as it is (B3) and with -b 1 (X2 over the sweep-SAH
    tree): the pixels that differ and the two means; then -m 4.0 on main
    path 11's file (the 512x256 heatmap, 4 spp, through X2's cost
    counter) and -d "256 128" on the card against the CPU.
27. main path 14: the flagship file (1800x800 @ 512 spp) through
    render_with_checkpoints in slabs of 128 spp (one B1 launch a slab),
    stopped at 256 spp and resumed to 512: the resumed film bit for bit
    the uninterrupted slabs' film, within 1e-5 of main path 1's frame;
28. main path 15: terrain 100k at 512x256 @ 64 spp MIS through
    render_with_checkpoints in slabs of 16 spp (the wavefront, B3),
    stopped at 32 and resumed: within 1e-5 of main path 2's frame, the
    slabs' segment and shadow-ray counts summing to its counts exactly;
29. main path 16: render_megakernel_sharded over a mesh of the card (one
    range) and over three ranges launched in turn there, on the flagship
    (B1) and on main path 4's frame (B2): each bit for bit the single
    launch's film;
30. main path 17: terrain 100k at 512x256 @ 4 spp through render_sharded
    over the card against render() over the same B3 tracer (unit-scale
    bounds); render_distributed under a one-rank NCCL group equal to
    render_sharded; the NCCL all-reduce's milliseconds on a 1800x800 film;
31. main path 18: main path 10's envtex step (131,072 rays) through
    make_train_step(mesh=global_mesh()) under that group against the
    unsharded step: the loss bit for bit, the gradients within GRAD_RTOL
    (and the count of elements whose bits differ), then both steps again
    under torch.use_deterministic_algorithms with loss and gradients bit
    for bit; forward, backward and all-reduce milliseconds;
32. main path 19: the CLI with --trace on main path 13's JSON: the trace
    file names B3's kernel; walk_roofline of main path 5's B2 launch;
33. main path 20: terrain 100k at 512x256 @ 64 spp through render_frame
    with VIMG_PREPASS=1 beside the same frame without it: the pre-pass
    engages, equal supersteps, segments within 0.1%, the film within
    tests/test_cluster_trace.py's pre-pass bounds; both frame times and
    peak memories.
34. main paths 21 and 22: the device BVH build (geometry/device_build.py,
    kernel X3 for the per-axis SAH sweep) of terrain 100k and 500k through
    BVHTracer(builder="device"): P, levels, nodes, the level loop's and
    the host assembly's seconds, X3's launches (3 x levels); the tree bit
    for bit the plain build of the same inputs on the CPU; the native
    sweep (mode 1) timed beside it and, where its tree differs, both SAH
    costs; X3 bit for bit its plain version on every level's inputs of the
    100k build, timed on a middle level's and level 0's inputs of each
    terrain (on the device's clock, paced by the host, and its one kernel
    by torch.profiler, which must see no other) beside the plain version
    and its bound, with its launch's plan (grid, chunks a tile, shared
    memory, registers) and, for the 100k build, the look-back steps a tile
    of geometry/sweep_schedule.py's replay; one X2 walk over the 100k device tree (phase 6's bounce rays)
    and ClusterTracer(builder="device") through B3 (camera, bounce,
    shadow), each bit for bit its plain walk, X3 launched 3 x levels;
35. main path 23: make_tracer(force="mxu") (tensor code: no kernel may
    launch) on 2,000 random triangles and 128 spheres, 131,072 rays,
    against the SoA tracer on the card at tests/test_fast_tracers.py's
    tolerances, both timed;
36. main path 24: probes/ablate_superstep.py on terrain 100k (131,072
    lanes, 20 supersteps, all twelve variants through B3): ms a
    superstep by the host's clock, Mseg/s, the CUDA-event span and the
    device-busy ms (torch.profiler's kernel times) a superstep; main path
    25: the probe leftovers at their tools' sizes (cluster_bounce with
    trace_stats, sort_tax, wavefront_e2e, xla_gather, hit_info_cost,
    depth_decomposition over B2).
The probe kernels lie on no render path: their rows report 0 launches,
and each probe phase prints the launches its entry points made. Every
probe record carries the card's name and power limit. Each kernel is
held to its plain version bit for bit, except P19 (within 2 K 2^-24
(|A~||B~|) of its form's plain product, TF32 inputs for "default") and P27 (rtol 1e-4 of float64, the probe's gate); the count
of differing outputs is printed for each.
Each main path is driven with every launch counter set to 0 just before
and read just after. The line before the card's name is the kernels JSON.
Each of its rows names in "clock" how its "ms" and "library_ms" were
timed: "host", the host's clock around one call between two
synchronisations (B1's frame); "events", CUDA events around calls the host
queues one after another (one launch for B2 and P12, 20 calls for the
others); "device", CUDA events around 20 calls queued behind a spinning
kernel, so that the host's time to queue them does not show
(probes.common.device_ms). "plain_ms" is always one call between CUDA
events;
the last line is the JSON result {"ok": true, "device": {...}}; any
failure exits non-zero without it. A machine without CUDA fails at once.
"""
import dataclasses
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FLAGSHIP = os.path.join(ROOT, "scenes", "disney_spheres_flagship.json")
# tolerances (tests/test_megakernel.py criteria)
UNIT_MEAN, UNIT_PIX, UNIT_FRAC, UNIT_CORR = 1e-4, 1e-5, 0.01, 0.999
FLAG_MEAN, FLAG_CORR = 6e-3, 0.99
COUNT_REL = 1e-3
MAIN_MEAN_REL = 0.02
# wavefront, kernel vs plain walk at 1 spp: hits are bit-equal, only the
# order of the film's atomic index_add_ may differ
WF_MEAN, WF_CORR = 1e-5, 0.9999
# the bench's mesh frames (bench.py terrain stages)
MESH_W, MESH_H, MESH_SPP = 512, 256, 64
MESH_BATCH = 1 << 17
TERRAINS = ((100_000, "wide", "cluster_wide"), (500_000, "skip", "cluster_skip"))
N_RAYS = 1 << 17
TIMED_LAUNCHES = 20
# the card's published peaks (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations of kernel B1 per path segment and per shadow ray, counted
# from csrc/megakernel.cu for the flagship (12 triangles, 6 spheres): a
# segment is one closest trace (12 x ~52 + 6 x ~32 ops), hit shading and
# its frame (~45), a light sample (~70), two Principled eval/pdf (~300
# each), a Principled sample (~150), MIS bookkeeping (~30) and three
# counter-RNG hashes (~90 integer ops); a shadow ray is one any-hit trace
# of the same primitives. Estimates to about +-30%.
MEGA_OPS_PER_SEGMENT = 1800
MEGA_OPS_PER_SHADOW = 830
# kernel B2 per segment: B1's count without its trace of the flagship's
# 18 primitives (12 x ~52 + 6 x ~32 = ~816), i.e. shading, light sample,
# BSDF work and RNG; per shadow ray: the ray set-up of the walk (three
# guarded reciprocals, ~15). The walk itself is counted by the kernel:
# box tests x BOX_TEST_OPS + triangle tests x TRI_TEST_OPS.
MESH_OPS_PER_SEGMENT = MEGA_OPS_PER_SEGMENT - 816
MESH_OPS_PER_SHADOW = 15
# phases 9-11: B2's frames (bench.py's mesh scenes at the bench's size)
B2_FRAMES = (("terrain 100k mis", "terrain", 100_000, "mis"),
             ("bumpy 100k smooth material", "bumpy", 100_000, "material"),
             ("terrain 500k mis", "terrain", 500_000, "mis"))
B2_TIMED_SPP = 4
MAIN4_SPP, MAIN5_SPP, MAIN5_REF_SPP = 4, 64, 4
# phase 14: kernel B6's table (24 parameters x 256 rows) and lookups
GATHER_P, GATHER_ROWS, GATHER_IDS = 24, 256, 1 << 20
# phases 15-18: the probe kernels' sources
PROBE_SOURCES = dict(
    probe_walkablate="vimg_tpu_torch/csrc/probe_walk.cu",
    **dict.fromkeys(("probe_sync", "probe_smem_read", "probe_smem_write"),
                    "vimg_tpu_torch/csrc/probe_scalar.cu"),
    **dict.fromkeys(("probe_setup", "probe_dynrow", "probe_ffs",
                     "probe_epilogue", "probe_dynblock", "probe_dynrow_par"),
                    "vimg_tpu_torch/csrc/probe_packet.cu"),
    probe_packet_stages="vimg_tpu_torch/csrc/probe_packet_stages.cu",
    **dict.fromkeys(("probe_prims", "probe_fma", "probe_mix", "probe_vpu3",
                     "probe_vpu_rate"), "vimg_tpu_torch/csrc/probe_vpu.cu"),
    **dict.fromkeys(("probe_take", "probe_onehot", "probe_selchain",
                     "probe_mxu_precision", "probe_lookup",
                     "probe_lookup_check"),
                    "vimg_tpu_torch/csrc/probe_gather.cu"),
    **dict.fromkeys(("probe_grid", "probe_while", "probe_pcg",
                     "probe_scalars", "probe_transcendental",
                     "probe_throughput", "probe_k1", "probe_k2", "probe_k3"),
                    "vimg_tpu_torch/csrc/probe_lowering.cu"))
# the card's tensor-core peaks (H100 SXM data sheet, dense, at 700 W)
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12
# phase 8b: main path 9, bench.py's envtex scene
ENVTEX_TRIS = 100_000
# phase 8c: main path 10, the train step on the envtex scene and on the
# flagship (131,072 rays a step: every pixel of 512x256 once)
TRAIN_STEPS, FLAGSHIP_TRAIN_STEPS, TRAIN_DEPTH, TRAIN_SEED = 10, 5, 6, 12
# Adam's rates: 1e-2 (vimg_tpu's optax.adam(1e-2)) for the scene's
# tables, 1e-4 for the camera, whose pose entries at 1e-2 move the view by
# about 0.01 a step (with 1e-2 on every key this scene's loss rose). The
# flagship's Principled scalars are projected back into [0, 1] after each
# step: many sit at 0 or 1, and left outside, their lobe weights turn
# negative and a path's throughput blows up within a few steps (in
# vimg_tpu's eval as in the port's: tests/test_torch_diff_checks.py)
TRAIN_LR = 1e-2
TRAIN_RATES = dict.fromkeys(("cam2world", "cam_vfov", "cam_aperture",
                             "cam_focal"), 1e-4)
TRAIN_SMALL = (64, 32)
# gradients against a reference, per key: max|g - g_ref| <= GRAD_RTOL x
# max|g_ref| + GRAD_ATOL. Not bit for bit: the backward of index_add_,
# of the texture and sky fetches and of the loss's mean scatter-add with
# atomics on the card, whose order of summation varies, and float32 sums
# of up to 131,072 terms in another order differ by about sqrt(n) ulps
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# phase 19: the s_normal frames at reduced size (card vs CPU)
NORMAL_SMALL = {"flagship": (180, 80), "terrain": (64, 32)}
# phase 19: main path 9's frame at reduced size, card vs CPU
ENVTEX_SMALL, ENVTEX_SMALL_SPP = (64, 32), 4
NORMAL_SPP = 4            # the CLI's (and the reference's) normal-view spp
# phase 20: probe_prims' iterations where the plain version is held
PRIMS_PLAIN_ITERS = 2000
# phases 27-33: sample slabs and scale-out (main paths 14-20)
FLAGSHIP_SPP, FLAG_W, FLAG_H = 512, 1800, 800      # the flagship file's
CKPT_FLAGSHIP_SLAB, CKPT_TERRAIN_SLAB = 128, 16
# a slab film against the one-shot frame, max |d|: the per-pixel sums
# group differently (tests/test_checkpoint.py's bound)
CKPT_ONESHOT = 1e-5
SHARD_SPP = 4
ALLREDUCE_REPS = 20
B3_SYMBOL = "cluster_wide_kernel"
# a frame's mean is compared within MAIN_MEAN_REL, widened to 4 standard
# errors of the difference where the two frames' own pixel noise says 2%
# is less (the material integrator's light hits are rare and bright)
MEAN_SIGMAS = 4.0


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def unit_scene(device, spp, integrator, n_extra=0, floor_tris=0):
    """tests/test_megakernel.py::_simple_scene at 64x48: red Lambertian,
    glass and an emissive sphere (unit scale: no epsilon races), plus
    ``n_extra`` small spheres (257 make the megakernel refuse it) and a
    terrain floor of ``floor_tris`` triangles below them."""
    from vimg_tpu_torch.core.math import look_at
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.json_loader import SceneBuilder
    b = SceneBuilder()
    red = b.add_material(ir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(ir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={ir.MS_IOR: 1.5})
    light = b.add_material(ir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    for k in range(n_extra):
        b.add_sphere((-3.0 + 0.02 * k, -2.0, 0), 0.01, red)
    if floor_tris:
        import numpy as np
        from vimg_tpu_torch.scene.synthetic import terrain_mesh
        verts, tris = terrain_mesh(floor_tris)
        b.add_mesh(verts - np.float32([0, 2.5, 0]), tris, red)
    cam = dict(cam2world=look_at([0, 0, 6], [0.7, 0, 0], [0, 1, 0]),
               width=64, height=48, vfov_deg=45.0)
    scene = b.build(camera=cam, device=device)
    st = ir.RenderSettings(width=64, height=48, spp=spp, max_depth=64,
                           integrator=integrator)
    return scene, st


def fill(stats):
    """SIMT fill of a B1 launch: segments over 32 lanes x warp steps."""
    return stats["segments"] / max(32 * stats["warp_steps"], 1)


def b1_report(scene, st):
    """The megakernel's registers, spills and resident warps per SM for
    this frame (B1 or B2, by the scene's mode)."""
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.runtime import cuda
    occ = kernel.occupancy(scene, st)
    mode, name = (("4Mesh", "B2") if kernel.is_mesh_mode(scene)
                  else ("8Analytic", "B1"))
    part = f"mega_kernelI{mode}Lb{int(st.integrator == 'mis')}E"
    return (f"{name} ({st.integrator}) {occ['registers']} registers, "
            f"{occ['local_bytes']} B local memory a thread, "
            f"{occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} "
            f"resident warps per SM; ptxas: "
            f"{' | '.join(cuda.ptxas_lines(cuda.BUILD_INFO['log'], part))}")


def compare(name, ref, img):
    import numpy as np
    ref = ref.cpu().numpy().astype(np.float64)
    img = img.cpu().numpy().astype(np.float64)
    if not (np.isfinite(ref).all() and np.isfinite(img).all()):
        fail(f"{name}: non-finite pixels")
    d = np.abs(ref - img)
    corr = float(np.corrcoef(ref.ravel(), img.ravel())[0, 1])
    res = dict(mean=float(d.mean()), max=float(d.max()),
               frac=float((d.max(-1) > UNIT_PIX).mean()), corr=corr)
    log(f"  {name}: mean|d|={res['mean']:.3e} max|d|={res['max']:.3e} "
        f"pixels>{UNIT_PIX:g}: {100 * res['frac']:.3f}% corr={corr:.6f}")
    return res


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def event_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def zero_counts():
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.ops import mxu_gather
    from vimg_tpu_torch.probes import common
    from vimg_tpu_torch.render.mega import kernel
    kernel.LAUNCHES = 0
    kernel.LAUNCHES_MESH = 0
    ct.LAUNCHES_WIDE = 0
    ct.LAUNCHES_SKIP = 0
    pt.LAUNCHES = 0
    pt.LAUNCHES_CULL = 0
    mxu_gather.LAUNCHES = 0
    bvh.LAUNCHES = 0
    db.LAUNCHES = 0
    for k in common.LAUNCHES:
        common.LAUNCHES[k] = 0


def read_counts():
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.ops import mxu_gather
    from vimg_tpu_torch.probes import common
    from vimg_tpu_torch.render.mega import kernel
    return dict(megakernel_analytic=kernel.LAUNCHES,
                cluster_wide=ct.LAUNCHES_WIDE, cluster_skip=ct.LAUNCHES_SKIP,
                megakernel_mesh=kernel.LAUNCHES_MESH,
                packet_trace=pt.LAUNCHES, packet_cull=pt.LAUNCHES_CULL,
                gather_row=mxu_gather.LAUNCHES, bvh_walk=bvh.LAUNCHES,
                sah_sweep=db.LAUNCHES, **common.LAUNCHES)


def save_png(img, tonemap, name, png_dir):
    from vimg_tpu_torch.render import film
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(png_dir or tmp, name)
        film.write_png(path, film.finalize(img, tonemap=tonemap))
        return os.path.getsize(path)


# ---------------------------------------------------------------------------
# phase 6 helpers: ray populations and the kernel-vs-plain comparison
# ---------------------------------------------------------------------------

def terrain_rays(scene, tracer):
    """N_RAYS each of: camera rays (512x256 @ 1 spp), cosine bounce rays
    from the first hits of 2-spp camera rays, and shadow rays from the same
    hit points to a sampled light point (finite maxT)."""
    import torch
    from vimg_tpu_torch.core import rng
    from vimg_tpu_torch.core.math import onb_to_world
    from vimg_tpu_torch.core.rng import Draw
    from vimg_tpu_torch.core.warps import sample_hemisphere_cosine
    from vimg_tpu_torch.geometry import intersect
    from vimg_tpu_torch.lights import emitters
    from vimg_tpu_torch.render.integrators import (MIN_T, SHADOW_EPS,
                                                   _primary_rays)
    from vimg_tpu_torch.scene import ir
    dev = scene.device
    st = ir.RenderSettings(MESH_W, MESH_H, spp=2, integrator="mis")
    pix = torch.arange(MESH_W * MESH_H, device=dev).repeat_interleave(2)
    samp = torch.arange(2, device=dev).repeat(MESH_W * MESH_H)
    ro, rd, _, _ = _primary_rays(scene, st, pix, samp)
    n = ro.shape[0]
    mn = torch.full((n,), MIN_T, device=dev)
    inf = torch.full((n,), float("inf"), device=dev)
    hr = tracer.closest(scene, ro, rd, mn, inf)
    idx = torch.nonzero(hr.hit)[:, 0]
    if idx.numel() < N_RAYS:
        fail(f"only {idx.numel()} camera hits for {N_RAYS} bounce rays")
    idx = idx[:N_RAYS]
    sub = intersect.HitResult(*(getattr(hr, f)[idx] for f in
                                ("t", "prim_type", "prim_id", "u", "v")))
    hi = intersect.hit_info(scene, ro[idx], rd[idx], sub)
    p, s = pix[idx], samp[idx]
    r1, r2 = rng.uniform2(p, s, 1, Draw.BSDF_SAMPLE)
    wo = onb_to_world(hi.tangent, hi.bitangent, hi.n_s,
                      sample_hemisphere_cosine(r1, r2))
    pick, l1, l2, _ = rng.uniform4(p, s, 1, Draw.LIGHT_SAMPLE)
    ls = emitters.sample_lights(scene, hi.p, pick, l1, l2)
    mnN, infN = mn[:N_RAYS], inf[:N_RAYS]
    shadow_max = ls.dist - SHADOW_EPS
    if not bool(torch.isfinite(shadow_max).all()):
        fail("shadow rays need a finite maxT")
    return {"camera": (ro[::2].contiguous(), rd[::2].contiguous(), mnN, infN),
            "bounce": (hi.p.contiguous(), wo.contiguous(), mnN, infN),
            "shadow": (hi.p.contiguous(), ls.wi.contiguous(), mnN,
                       shadow_max.contiguous())}


def sorted_rays(tracer, rays):
    """The rays in the tracer's Morton order (what trace() hands the
    kernel)."""
    order = tracer.sort_order(rays[0], rays[1], rays[3])
    return tuple(x[order].contiguous() for x in rays)


def mismatches(a, b):
    """Rays whose (t, slot, u, v) differ in any bit; max |d| of t, u, v."""
    import torch
    bad = torch.zeros_like(a[1], dtype=torch.bool)
    err = 0.0
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            bad |= x.view(torch.int32) != y.view(torch.int32)
            fin = torch.isfinite(x) & torch.isfinite(y)
            if bool(fin.any()):
                err = max(err, float((x[fin] - y[fin]).abs().max()))
        else:
            bad |= x != y
    return int(bad.sum()), err


def walk_steps(walk, tracer, rays, any_hit, st):
    """B3's or B4's warp node and triangle steps (one counted launch, not
    timed), held equal to the replay of its schedule on the same rays, and
    its lane fill (the plain walk's triangle tests / (32 x triangle
    steps))."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import skip_schedule as ss
    steps = torch.zeros(2, dtype=torch.int64, device=rays[0].device)
    if walk == "wide":
        tabs = (*tracer.node_tables, tracer.tri_rows)
        ct.trace_wide(*tabs, tracer.n_wide, tracer.max_stack, *rays, any_hit,
                      steps=steps)
        _, warp = ss.wide_warp_schedule(*tabs, tracer.max_stack, *rays,
                                        any_hit)
    else:
        tabs = (*tracer.node_tables, tracer.tri_rows, tracer.data.n_nodes)
        ct.trace_skip(*tabs, *rays, any_hit, steps=steps)
        _, warp = ss.warp_schedule(*tabs, *rays, any_hit)
    node, tri = (int(x) for x in steps.cpu())
    if (warp["node_steps"], warp["tri_steps"]) != (node, tri):
        fail(f"{walk} warp steps {node}, {tri} differ from its schedule's "
             f"{warp['node_steps']}, {warp['tri_steps']}")
    return dict(node_steps=node, tri_steps=tri,
                fill=st["tri_tests"] / max(32 * tri, 1))


def kernel_vs_plain(n_tris, scene):
    """Phase 6 for one terrain: both walks, three ray kinds."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    t0 = time.time()
    data = ct.ClusterData(scene)
    wide = ct.ClusterTracer(scene, walk="wide", data=data)
    skip = ct.ClusterTracer(scene, walk="skip", data=data)
    log(f"  terrain {n_tris}: {data.n_clusters} clusters, {data.n_nodes} "
        f"binary nodes (depth {data.tree_depth}), {wide.n_wide} wide nodes "
        f"(stack {wide.max_stack}), tri table "
        f"{data.tri_rows.nbytes / 1e6:.1f} MB; host build "
        f"{time.time() - t0:.2f}s")
    rays = terrain_rays(scene, wide)
    fns = {
        "wide": (lambda r, ah: ct.trace_wide(*wide.node_tables, wide.tri_rows,
                                             wide.n_wide, wide.max_stack,
                                             *r, ah),
                 lambda r, ah, st: ct.wide_walk_plain(
                     *wide.node_tables, wide.tri_rows, wide.max_stack, *r,
                     ah, stats=st), wide),
        "skip": (lambda r, ah: ct.trace_skip(*skip.node_tables, skip.tri_rows,
                                             data.n_nodes, *r, ah),
                 lambda r, ah, st: ct.skip_walk_plain(
                     *skip.node_tables, skip.tri_rows, data.n_nodes, *r, ah,
                     stats=st), skip)}
    res = {}
    for kind, r in rays.items():
        any_hit = kind == "shadow"
        rs = sorted_rays(wide, r)
        outs = {}
        for walk, (kfn, pfn, tr) in fns.items():
            got = kfn(rs, any_hit)
            torch.cuda.synchronize()
            for _ in range(2):                              # warm-up
                kfn(rs, any_hit)
            _, ms = event_ms(lambda: kfn(rs, any_hit), TIMED_LAUNCHES)
            st = {}
            ref, plain_ms = event_ms(lambda: pfn(rs, any_hit, st), 1)
            bad, err = mismatches(got, ref)
            tables = sum(x.numel() * x.element_size()
                         for x in (*tr.node_tables, tr.tri_rows))
            nbytes = N_RAYS * (32 + 16) + tables
            ops = (st["box_tests"] * ct.BOX_TEST_OPS
                   + st["tri_tests"] * ct.TRI_TEST_OPS)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * ops / FP32_OPS_PER_S
            hits = int((got[0] == -float("inf")).sum() if any_hit
                       else (got[1] >= 0).sum())
            outs[walk] = got
            res[(walk, kind)] = dict(
                mismatches=bad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                box_tests=st["box_tests"], tri_tests=st["tri_tests"])
            w = walk_steps(walk, tr, rs, any_hit, st)
            res[(walk, kind)].update(w)
            log(f"  {walk:4s} {kind:6s}: warp steps node {w['node_steps']} "
                f"tri {w['tri_steps']} (equal to the replay of its "
                f"schedule), leaf lane fill {w['fill']:.4f}")
            log(f"  {walk:4s} {kind:6s}: {'occluded' if any_hit else 'hits'} "
                f"{hits}/{N_RAYS}, kernel vs plain mismatches {bad} "
                f"(max|d| {err:g}); kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms; {st['box_tests']} box + "
                f"{st['tri_tests']} tri tests -> bound "
                f"{res[(walk, kind)]['bound_ms']:.4f} ms "
                f"({res[(walk, kind)]['bound_by']}: bytes {t_bytes:.4f} ms, "
                f"ops {t_ops:.4f} ms)")
            if bad:
                fail(f"terrain {n_tris} {walk} {kind}: {bad} mismatches")
        ww, _ = mismatches(outs["wide"], outs["skip"])
        log(f"  wide vs skip {kind}: {ww} mismatches; leaf lane fill B3 "
            f"{res[('wide', kind)]['fill']:.4f}, B4 "
            f"{res[('skip', kind)]['fill']:.4f}")
        if ww:
            fail(f"terrain {n_tris} {kind}: wide and skip walks differ")
    # the facade (sort, prim ids, barycentric convention) agrees too
    ro, rd, mn, mx = rays["bounce"]
    hw = wide.closest(scene, ro, rd, mn, mx)
    hs = skip.closest(scene, ro, rd, mn, mx)
    hp = ct.ClusterTracer(scene, walk="wide", data=data,
                          plain=True).closest(scene, ro, rd, mn, mx)
    for f in ("t", "prim_type", "prim_id", "u", "v"):
        for name, other in (("skip", hs), ("plain", hp)):
            if not torch.equal(getattr(hw, f), getattr(other, f)):
                fail(f"terrain {n_tris}: closest().{f} wide vs {name}")
    log("  closest() (t, prim type, prim id, u, v): wide kernel == skip "
        "kernel == plain walk on the bounce rays")
    return res, rays


# ---------------------------------------------------------------------------
# phases 7/8: the mesh main path
# ---------------------------------------------------------------------------

def mesh_main_path(n_tris, walk, name, png_dir, card, dev):
    import numpy as np
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(n_tris, MESH_W, MESH_H, device=dev)
    st = ir.RenderSettings(MESH_W, MESH_H, spp=MESH_SPP, max_depth=64,
                           integrator="mis", tonemap="agx",
                           batch_size=MESH_BATCH)
    st1 = dataclasses.replace(st, spp=1)
    data = ct.ClusterData(scene)
    kt = ct.ClusterTracer(scene, data=data)
    pt = ct.ClusterTracer(scene, data=data, plain=True)
    if kt.walk != walk:
        fail(f"terrain {n_tris}: the default walk is {kt.walk}, not {walk}")
    (img_k, sk), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=kt, return_stats=True))
    (img_p, sp), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=pt, return_stats=True))
    r = compare(f"terrain {n_tris} {MESH_W}x{MESH_H}@1 kernel vs plain walk",
                img_p, img_k)
    log(f"    kernel {sk['seconds']:.2f}s, plain walk {sp['seconds']:.2f}s; "
        f"segments {sk['segments']} / {sp['segments']}, shadow rays "
        f"{sk['shadow_rays']} / {sp['shadow_rays']}, supersteps "
        f"{sk['supersteps']} / {sp['supersteps']}")
    if not (r["mean"] < WF_MEAN and r["corr"] > WF_CORR):
        fail(f"terrain {n_tris}: 1-spp kernel vs plain walk per pixel")
    if (sk["segments"], sk["shadow_rays"]) != (sp["segments"],
                                               sp["shadow_rays"]):
        fail(f"terrain {n_tris}: 1-spp ray counts differ")
    plain_mean = img_p.reshape(-1, 3).mean(0).cpu().numpy()

    zero_counts()
    img, secs = timed(lambda: render_frame(scene, st))
    counts = read_counts()
    stats = wavefront.LAST_STATS
    img_np = img.cpu().numpy()
    if img_np.shape != (MESH_H, MESH_W, 3) or not np.isfinite(img_np).all():
        fail(f"terrain {n_tris} image shape {img_np.shape} / non-finite")
    if counts[name] < 1 or any(v for k, v in counts.items() if k != name):
        fail(f"terrain {n_tris} main path launches {counts}")
    png = save_png(img, st.tonemap, f"terrain{n_tris // 1000}k.png", png_dir)
    mean = img_np.reshape(-1, 3).mean(0)
    rel = np.abs(mean - plain_mean) / np.maximum(plain_mean, 1e-12)
    log(f"    {MESH_SPP}-spp mean {mean.tolist()} vs plain@1spp "
        f"{plain_mean.tolist()} (rel {rel.tolist()}); png {png} bytes")
    if not (rel < MAIN_MEAN_REL).all():
        fail(f"terrain {n_tris} mean differs from the 1-spp plain mean")
    paths = MESH_W * MESH_H * MESH_SPP
    rays = stats["segments"] + stats["shadow_rays"]
    log(f"    {MESH_W}x{MESH_H} @ {MESH_SPP} spp: {secs:.3f} s (render "
        f"loop {stats['seconds']:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, "
        f"{rays / secs / 1e6:.2f} Mrays/s ({stats['segments']} segments + "
        f"{stats['shadow_rays']} shadow rays), {stats['supersteps']} "
        f"supersteps ({1e3 * stats['seconds'] / stats['supersteps']:.2f} ms "
        f"a superstep), launches {counts}, on {card}")
    return counts[name], r["max"], img, dict(stats)


# ---------------------------------------------------------------------------
# phase 8b: main path 9, the env-lit textured terrain
# ---------------------------------------------------------------------------

def envtex_scene(dev, width=MESH_W, height=MESH_H):
    """bench.py's envtex stage: textured_terrain_scene(100_000) with its
    256^2 texture and 64x128 sky, at ``width`` x ``height``."""
    from vimg_tpu_torch.scene.synthetic import textured_terrain_scene
    return textured_terrain_scene(ENVTEX_TRIS, width, height, device=dev)


def envtex_main_path(png_dir, card, dev):
    """Main path 9: the 1-spp frame through B3 and through the plain walk
    (per pixel, equal ray counts), then the 64-spp frame through
    render_frame with every count set to 0 just before and read just
    after: only B3 may launch; finite, its mean within MAIN_MEAN_REL of the
    plain 1-spp mean; AgX PNG; seconds, paths/s, rays/s, supersteps."""
    import numpy as np
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.mega import supports_megakernel
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    t0 = time.time()
    scene = envtex_scene(dev)
    log(f"    scene: {scene.n_tris()} triangles, atlas "
        f"{scene.atlas.shape[0]} texels in {scene.atlas_meta.shape[1]} "
        f"levels, env {tuple(scene.env_mips[0].shape[:2])} in "
        f"{len(scene.env_mips)} levels, {scene.n_lights()} light (the sky); "
        f"host build {time.time() - t0:.2f}s")
    st = ir.RenderSettings(MESH_W, MESH_H, spp=MESH_SPP, max_depth=64,
                           integrator="mis", tonemap="agx",
                           batch_size=MESH_BATCH)
    if supports_megakernel(scene, st):
        fail("envtex: the megakernel would take this frame")
    st1 = dataclasses.replace(st, spp=1)
    data = ct.ClusterData(scene)
    kt = ct.ClusterTracer(scene, data=data)
    pt = ct.ClusterTracer(scene, data=data, plain=True)
    if kt.walk != "wide":
        fail(f"envtex: the default walk is {kt.walk}, not wide")
    (img_k, sk), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=kt, return_stats=True))
    (img_p, sp), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=pt, return_stats=True))
    r = compare(f"envtex {MESH_W}x{MESH_H}@1 kernel vs plain walk", img_p,
                img_k)
    log(f"    kernel {sk['seconds']:.2f}s, plain walk {sp['seconds']:.2f}s; "
        f"segments {sk['segments']} / {sp['segments']}, shadow rays "
        f"{sk['shadow_rays']} / {sp['shadow_rays']}, supersteps "
        f"{sk['supersteps']} / {sp['supersteps']}")
    if not (r["mean"] < WF_MEAN and r["corr"] > WF_CORR):
        fail("envtex: 1-spp kernel vs plain walk per pixel")
    if (sk["segments"], sk["shadow_rays"]) != (sp["segments"],
                                               sp["shadow_rays"]):
        fail("envtex: 1-spp ray counts differ")
    plain_mean = img_p.reshape(-1, 3).mean(0).cpu().numpy()

    zero_counts()
    img, secs = timed(lambda: render_frame(scene, st))
    counts = read_counts()
    stats = wavefront.LAST_STATS
    img_np = img.cpu().numpy()
    if img_np.shape != (MESH_H, MESH_W, 3) or not np.isfinite(img_np).all():
        fail(f"envtex image shape {img_np.shape} / non-finite")
    if counts["cluster_wide"] < 1 or any(
            v for k, v in counts.items() if k != "cluster_wide"):
        fail(f"envtex main path launches {counts}")
    png = save_png(img, st.tonemap, "envtex.png", png_dir)
    mean = img_np.reshape(-1, 3).mean(0)
    rel = np.abs(mean - plain_mean) / np.maximum(plain_mean, 1e-12)
    log(f"    {MESH_SPP}-spp mean {mean.tolist()} vs plain@1spp "
        f"{plain_mean.tolist()} (rel {rel.tolist()}); png {png} bytes")
    if not (rel < MAIN_MEAN_REL).all():
        fail("envtex mean differs from the 1-spp plain mean")
    paths = MESH_W * MESH_H * MESH_SPP
    rays = stats["segments"] + stats["shadow_rays"]
    log(f"    {MESH_W}x{MESH_H} @ {MESH_SPP} spp: {secs:.3f} s (render "
        f"loop {stats['seconds']:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, "
        f"{rays / secs / 1e6:.2f} Mrays/s ({stats['segments']} segments + "
        f"{stats['shadow_rays']} shadow rays), {stats['supersteps']} "
        f"supersteps ({1e3 * stats['seconds'] / stats['supersteps']:.2f} ms "
        f"a superstep), launches {counts}, on {card}")
    return counts["cluster_wide"]


# ---------------------------------------------------------------------------
# phase 8c: main path 10, the differentiable step
# ---------------------------------------------------------------------------

def train_start(scene):
    """The scene a training run starts from: env_scale halved and the
    Principled scalars (specular, roughness, metallic) moved by seeded
    uniform noise in +-0.15, clamped to [0, 1]."""
    import numpy as np
    import torch
    from vimg_tpu_torch.scene import ir
    cols = [ir.MS_SPECULAR, ir.MS_ROUGHNESS, ir.MS_METALLIC]
    ms = scene.mat_scalars.clone()
    noise = np.random.default_rng(TRAIN_SEED).uniform(
        -0.15, 0.15, (ms.shape[0], len(cols))).astype(np.float32)
    ms[:, cols] = torch.clamp(ms[:, cols] + torch.as_tensor(
        noise, device=ms.device), 0.0, 1.0)
    return scene.replace(env_scale=scene.env_scale * 0.5, mat_scalars=ms)


def train_optimizer(rates):
    """make_train_step's optimizer: Adam over the parameter dict, each key
    at its rate in ``rates``, the others at TRAIN_LR."""
    import torch

    def make(params):
        groups = {}
        for k in sorted(params):
            v = params[k]
            groups.setdefault(rates.get(k, TRAIN_LR), []).extend(
                v if isinstance(v, tuple) else (v,))
        return torch.optim.Adam([{"params": v, "lr": lr}
                                 for lr, v in groups.items()], lr=TRAIN_LR)
    return make


def train_rays(scene, st, tracer, step):
    """A step's rays and target: every pixel once at sample id ``step``,
    the target the port's own radiance at ``scene``'s values."""
    import torch
    from vimg_tpu_torch.render.integrators import trace_radiance
    n = st.width * st.height
    pix = torch.arange(n, device=scene.device)
    samp = torch.full((n,), step, dtype=torch.int64, device=scene.device)
    with torch.no_grad():
        target = trace_radiance(scene, st, tracer, pix, samp,
                                integrator="mis", bounded_depth=TRAIN_DEPTH)
    return pix, samp, target


def grads_at_start(scene, st, tracer, rays):
    """(loss, flat {key: gradient}) at the start's parameters."""
    from vimg_tpu_torch.diff import grad
    start = train_start(scene)
    params = {k: tuple(m.clone().requires_grad_(True) for m in v)
              if isinstance(v, tuple) else v.clone().requires_grad_(True)
              for k, v in grad.get_params(start).items()}
    loss, g = grad.value_and_grad(start, st, tracer, params, *rays,
                                  bounded_depth=TRAIN_DEPTH,
                                  integrator="mis")
    flat = {}
    for k, v in g.items():
        for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
            flat[k if not isinstance(v, tuple) else f"{k}/{i}"] = \
                x.detach().cpu().double()
    return float(loss), flat


def grads_agree(name, got, ref):
    """Fails unless every key's gradient is finite and within GRAD_RTOL of
    the reference's largest; prints the worst key."""
    import torch
    worst = (0.0, None)
    for k, r in ref.items():
        g = got[k]
        if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
            fail(f"{name}: non-finite gradient of {k}")
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        if err > GRAD_RTOL * scale + GRAD_ATOL:
            fail(f"{name}: gradient of {k} off by {err:.3e} (largest "
                 f"{scale:.3e})")
        if scale > 0 and err / scale >= worst[0]:
            worst = (err / scale, k)
    log(f"    {name}: every key within {GRAD_RTOL:g} of the largest; "
        f"worst {worst[1]} at {worst[0]:.3e}")


def train_run(start, st, tracer, steps, rays_of, optimizer=None,
              project=None):
    """``steps`` make_train_step steps from ``start`` (every count set to 0
    just before a step and read just after; ``project(params)`` after
    each): per step the loss, forward and backward ms, segments and
    shadow rays, the kernels launched, and the peak device memory. Fails
    on a non-finite loss or gradient."""
    import math
    import torch
    from vimg_tpu_torch.diff import grad
    step, opt, params = grad.make_train_step(
        start, st, tracer, bounded_depth=TRAIN_DEPTH, integrator="mis",
        optimizer=optimizer)
    out = []
    for i in range(steps):
        rays = rays_of(i)
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        params, opt, loss = step(params, opt, *rays, stats=stats)
        counts = read_counts()
        if project is not None:
            project(params)
        loss = float(loss)
        leaves = [t for v in params.values()
                  for t in (v if isinstance(v, tuple) else (v,))]
        if not math.isfinite(loss) or not all(
                bool(torch.isfinite(t.grad).all()) for t in leaves):
            fail(f"train step {i}: non-finite loss or gradient")
        out.append(dict(loss=loss, forward_ms=stats["forward_ms"],
                        backward_ms=stats["backward_ms"],
                        segments=stats.get("segments", 0),
                        shadow_rays=stats.get("shadow_rays", 0),
                        launches=nonzero(counts),
                        peak_bytes=torch.cuda.max_memory_allocated()))
    return out


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def log_steps(rows):
    for i, r in enumerate(rows):
        log(f"    step {i}: loss {r['loss']:.6g}, forward "
            f"{r['forward_ms']:.1f} ms, backward {r['backward_ms']:.1f} ms, "
            f"{r['segments']} segments + {r['shadow_rays']} shadow rays, "
            f"launches {r['launches']}, peak "
            f"{r['peak_bytes'] / 2 ** 30:.2f} GiB")


def train_main_path(card, dev):
    """Main path 10 on the envtex scene through B3 (with its checks against
    the plain walk and the CPU), then on the flagship through the SoA
    tracer; returns B3's launches on the envtex run."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    st = ir.RenderSettings(MESH_W, MESH_H, spp=1, max_depth=64,
                           integrator="mis")
    scene = envtex_scene(dev)
    start = train_start(scene)
    t0 = time.time()
    tracer = make_tracer(start, differentiable=True)
    log(f"    tracer {type(tracer).__name__} (walk {tracer.walk}), host "
        f"build {time.time() - t0:.2f}s; start: env_scale "
        f"{float(start.env_scale):g} (scene {float(scene.env_scale):g}), "
        f"Principled scalars {start.mat_scalars[0].tolist()}")
    if not (isinstance(tracer, ct.ClusterTracer) and tracer.walk == "wide"):
        fail("main path 10: the tracer is not the cluster tracer's B3 walk")

    # step 0's gradients: B3 against the plain walk, on the card
    rays0 = train_rays(scene, st, tracer, 0)
    plain = ct.ClusterTracer(start, data=tracer.data, plain=True)
    lk, gk = grads_at_start(scene, st, tracer, rays0)
    lp, gp = grads_at_start(scene, st, plain, rays0)
    log(f"    step-0 loss through B3 {lk:.8g}, through the plain walk "
        f"{lp:.8g}")
    grads_agree("step-0 gradients, B3 vs the plain walk", gk, gp)

    # card against CPU at reduced size
    w, h = TRAIN_SMALL
    small_st = dataclasses.replace(st, width=w, height=h)
    small = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        sc = envtex_scene(d, w, h)
        tr = make_tracer(train_start(sc), differentiable=True)
        small[name] = grads_at_start(sc, small_st, tr,
                                     train_rays(sc, small_st, tr, 0))
    log(f"    {w}x{h} step-0 loss card {small['card'][0]:.8g}, cpu "
        f"{small['cpu'][0]:.8g}")
    grads_agree(f"{w}x{h} step-0 gradients, card vs cpu", small["card"][1],
                small["cpu"][1])

    rows = train_run(start, st, tracer, TRAIN_STEPS,
                     lambda i: train_rays(scene, st, tracer, i),
                     optimizer=train_optimizer(TRAIN_RATES))
    log(f"    main path 10 (Adam at {TRAIN_LR:g}, {TRAIN_RATES}):")
    log_steps(rows)
    for i, r in enumerate(rows):
        if set(r["launches"]) != {"cluster_wide"}:
            fail(f"main path 10 step {i}: launches {r['launches']}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        fail("main path 10: the loss did not fall")
    b3 = sum(r["launches"].get("cluster_wide", 0) for r in rows)
    ms = [r["forward_ms"] + r["backward_ms"] for r in rows]
    log(f"    {TRAIN_STEPS} steps of {MESH_W * MESH_H} rays: step "
        f"{min(ms):.1f}-{max(ms):.1f} ms (forward + backward), loss "
        f"{rows[0]['loss']:.6g} -> {rows[-1]['loss']:.6g}, B3 launches {b3}, "
        f"peak {max(r['peak_bytes'] for r in rows) / 2 ** 30:.2f} GiB, on "
        f"{card}")

    fscene, fst = load_json_scene(FLAGSHIP, device=dev)
    fst = dataclasses.replace(fst, spp=1)
    ftracer = make_tracer(fscene, differentiable=True)
    n = MESH_W * MESH_H
    fpix = torch.arange(n, device=dev) * 997 % (fst.width * fst.height)
    fsamp = torch.zeros(n, dtype=torch.int64, device=dev)
    zeros = torch.zeros((n, 3), device=dev)
    rows_p, last = fscene.mat_type == ir.MAT_PRINCIPLED, []

    def project(params):
        """The Principled rows' scalars (IOR aside) clamped into [0, 1]."""
        ms = params["mat_scalars"]
        with torch.no_grad():
            ms[rows_p, 1:] = ms[rows_p, 1:].clamp(0.0, 1.0)
        last[:] = [ms.detach()[rows_p]]
    frows = train_run(fscene, fst, ftracer, FLAGSHIP_TRAIN_STEPS,
                      lambda i: (fpix, fsamp, zeros),
                      optimizer=train_optimizer(TRAIN_RATES),
                      project=project)
    log(f"    flagship ({type(ftracer).__name__}, {n} rays a step, sample 0 "
        f"and target 0 as vimg_tpu's dryrun_multichip; Adam at "
        f"{TRAIN_LR:g}, {TRAIN_RATES}, Principled scalars projected into "
        f"[0, 1]):")
    log_steps(frows)
    moved = float((last[0] - fscene.mat_scalars[rows_p]).abs().max())
    log(f"    Principled scalars after the last step: min "
        f"{float(last[0][:, 1:].min()):.6g}, max "
        f"{float(last[0][:, 1:].max()):.6g}, moved up to {moved:.6g}")
    if any(r["launches"] for r in frows):
        fail("flagship train steps launched a kernel")
    if not frows[-1]["loss"] < frows[0]["loss"]:
        fail("flagship train steps: the loss did not fall")
    if not moved > 0.0:
        fail("flagship train steps: the Principled scalars did not move")
    return b3


# ---------------------------------------------------------------------------
# phases 9-11: kernel B2, the mesh-mode megakernel
# ---------------------------------------------------------------------------

def b2_scene(kind, n_tris, dev):
    from vimg_tpu_torch.scene.synthetic import (bumpy_sphere_scene,
                                                terrain_scene)
    if kind == "terrain":
        return terrain_scene(n_tris, MESH_W, MESH_H, device=dev)
    return bumpy_sphere_scene(n_tris, MESH_W, MESH_H, smooth_normals=True,
                              device=dev)


def b2_settings(integrator, spp):
    from vimg_tpu_torch.scene import ir
    return ir.RenderSettings(MESH_W, MESH_H, spp=spp, max_depth=64,
                             integrator=integrator, tonemap="agx")


def mean_and_se(img):
    """Per-channel image mean and its standard error over the pixels
    (pixels are independent samples of the frame's mean)."""
    import numpy as np
    px = img.reshape(-1, 3).double().cpu().numpy()
    return px.mean(0), px.std(0, ddof=1) / np.sqrt(px.shape[0])


def check_mean(name, img, ref):
    """The frame's mean within MAIN_MEAN_REL (or MEAN_SIGMAS standard
    errors of the difference, if larger) of the reference frame's."""
    import numpy as np
    m, se = mean_and_se(img)
    mr, ser = mean_and_se(ref)
    rel = np.abs(m - mr) / np.maximum(mr, 1e-12)
    se_rel = np.sqrt(se ** 2 + ser ** 2) / np.maximum(mr, 1e-12)
    tol = np.maximum(MAIN_MEAN_REL, MEAN_SIGMAS * se_rel)
    log(f"    mean {m.tolist()} vs reference {mr.tolist()}: rel "
        f"{rel.tolist()}, standard error of the difference (rel) "
        f"{se_rel.tolist()}, tolerance {tol.tolist()}")
    if not (rel < tol).all():
        fail(f"{name}: mean differs from the reference")
    return rel


def b2_vs_plain(label, kind, n_tris, integrator, dev):
    """Phase 9 for one frame: B2 and its plain version at 1 spp."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render.mega import kernel
    scene = b2_scene(kind, n_tris, dev)
    st = b2_settings(integrator, 1)
    if not (kernel.is_mesh_mode(scene)
            and kernel.supports_megakernel(scene, st)):
        fail(f"{label}: not a mesh-mode megakernel frame")
    t0 = time.time()
    data = kernel.cluster_data(scene)
    t1 = time.time()
    kernel._tri_v(scene)
    t2 = time.time()
    tabs = kernel._device_tables(scene)
    torch.cuda.synchronize(dev)
    t3 = time.time()
    nbytes = sum(tabs[k].numel() * tabs[k].element_size()
                 for k in kernel._MESH_TABLE_ORDER)
    log(f"  {label}: {data.n_clusters} clusters, {data.n_nodes} nodes; host "
        f"build: ClusterData {t1 - t0:.2f}s, tri_v (vectorised) "
        f"{t2 - t1:.3f}s, all tables packed and uploaded {t3 - t2:.2f}s "
        f"({nbytes / 1e6:.1f} MB)")
    kernel.render_megakernel(scene, st)                       # warm
    (img, ks), k_s = timed(lambda: kernel.render_megakernel(
        scene, st, return_stats=True))
    walks = (ct.LAUNCHES_WIDE, ct.LAUNCHES_SKIP, kernel.LAUNCHES,
             kernel.LAUNCHES_MESH)
    (ref, ps), p_s = timed(lambda: kernel.render_megakernel_plain(
        scene, st, return_stats=True))
    if (ct.LAUNCHES_WIDE, ct.LAUNCHES_SKIP, kernel.LAUNCHES,
            kernel.LAUNCHES_MESH) != walks:
        fail(f"{label}: the plain version launched a kernel")
    r = compare(f"{label} {MESH_W}x{MESH_H}@1 B2 vs plain", ref, img)
    differ = int((img.contiguous().view(torch.int32)
                  != ref.contiguous().view(torch.int32)).any(-1).sum())
    log(f"    B2 {1e3 * k_s:.2f} ms, plain {1e3 * p_s:.1f} ms; film: "
        f"{differ} pixels not bit-identical (max|d| {r['max']:g}); segments "
        f"{ks['segments']} / {ps['segments']}, shadow rays "
        f"{ks['shadow_rays']} / {ps['shadow_rays']}; B2 walk: "
        f"{ks['box_tests']} box + {ks['tri_tests']} triangle tests, warp "
        f"steps node {ks['warp_node_steps']} tri {ks['warp_tri_steps']}, "
        f"lane fill {b2_fill(ks):.4f}")
    log(f"    {b1_report(scene, st)}")
    if not (r["mean"] < UNIT_MEAN and r["frac"] < UNIT_FRAC
            and r["corr"] > UNIT_CORR):
        fail(f"{label}: B2 vs plain per-pixel parity")
    if differ:
        fail(f"{label}: B2's film is not its plain version's bit for bit")
    for key in ("segments", "shadow_rays"):
        if ks[key] != ps[key]:
            fail(f"{label}: {key} count")
    return scene, nbytes, r["max"], 1e3 * p_s


def b2_fill(ks):
    """Lane fill of B2's walk: needed triangle tests over 32 lanes x its
    warp triangle steps (kernel counters)."""
    return ks["tri_tests"] / max(32 * ks["warp_tri_steps"], 1)


def b2_timing(scene, nbytes, st=None):
    """B2 on the scene (MIS at B2_TIMED_SPP unless ``st`` says otherwise):
    the wrapper's CUDA events around one launch, after a warm one; the
    bound from this launch's counters."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render.mega import kernel
    st = st or b2_settings("mis", B2_TIMED_SPP)
    kernel.render_megakernel(scene, st)                       # warm
    _, ks = kernel.render_megakernel(scene, st, return_stats=True)
    ms = 1e3 * ks["seconds"]
    ops = (ks["segments"] * MESH_OPS_PER_SEGMENT
           + ks["shadow_rays"] * MESH_OPS_PER_SHADOW
           + ks["box_tests"] * ct.BOX_TEST_OPS
           + ks["tri_tests"] * ct.TRI_TEST_OPS)
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    t_bytes = 1e3 * (nbytes + MESH_W * MESH_H * 3 * 4) / HBM_BYTES_PER_S
    res = dict(ms=ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               lane_fill=b2_fill(ks), stats=ks)
    log(f"    B2 @ {st.spp} spp {st.integrator}: {ms:.3f} ms (CUDA events); "
        f"{ks['segments']} segments, {ks['shadow_rays']} shadow rays, "
        f"{ks['box_tests']} box + {ks['tri_tests']} triangle tests, warp "
        f"steps node {ks['warp_node_steps']} tri {ks['warp_tri_steps']} "
        f"(kernel counters; lane fill {res['lane_fill']:.4f}) -> bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: ops {t_ops:.4f} ms, "
        f"bytes {t_bytes:.4f} ms)")
    return res


def b2_main_path(phase, label, scene, st, ref_img, png, png_dir, card):
    """Phases 10/11: render_frame -> finalize -> write_png through B2
    only; the mean against ``ref_img``."""
    import numpy as np
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.render.render import render_frame
    zero_counts()
    img, secs = timed(lambda: render_frame(scene, st))
    counts = read_counts()
    segs, shadow = (int(v) for v in kernel.LAST_COUNTS[:2].cpu())
    img_np = img.cpu().numpy()
    if img_np.shape != (MESH_H, MESH_W, 3) or not np.isfinite(img_np).all():
        fail(f"{label}: image shape {img_np.shape} / non-finite")
    if counts["megakernel_mesh"] < 1 or any(
            v for k, v in counts.items() if k != "megakernel_mesh"):
        fail(f"{label}: main path launches {counts}")
    size = save_png(img, st.tonemap, png, png_dir)
    check_mean(label, img, ref_img)
    paths = MESH_W * MESH_H * st.spp
    log(f"    [{phase}] {MESH_W}x{MESH_H} @ {st.spp} spp {st.integrator}: "
        f"{secs:.3f} s, {paths / secs / 1e6:.3f} Mpaths/s, "
        f"{(segs + shadow) / secs / 1e6:.2f} Mrays/s ({segs} segments + "
        f"{shadow} shadow rays), png {size} bytes, launches {counts}, on "
        f"{card}")
    return counts["megakernel_mesh"]


def b2_phases(dev, png_dir, card):
    """Phases 9-11; returns B2's row of the kernels JSON (launches over
    main paths 4 and 5)."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.mega import kernel
    # ---- 9. kernel B2 vs its plain version ------------------------------
    log(f"[9] B2 (mesh-mode megakernel) vs its plain PyTorch version (both "
        f"on the card), {MESH_W}x{MESH_H} @ 1 spp")
    b2_err, b2_scenes = 0.0, {}
    for label, kind, n_tris, integ in B2_FRAMES:
        sc, nbytes, err, plain_ms = b2_vs_plain(label, kind, n_tris, integ,
                                                dev)
        b2_err = max(b2_err, err)
        b2_scenes[label] = (sc, nbytes, plain_ms)
    t100 = b2_scenes["terrain 100k mis"]
    b2 = b2_timing(t100[0], t100[1])
    b2["plain_ms"] = t100[2]

    # ---- 10. main path 4: terrain 100k low-spp MIS through B2 ----------
    log(f"[10] main path 4: terrain 100k -> render_frame ({MESH_W}x{MESH_H} "
        f"@ {MAIN4_SPP} spp MIS, max_depth 64) -> finalize -> write_png "
        f"through B2")
    sc = t100[0]
    st4 = b2_settings("mis", MAIN4_SPP)
    wf_ref, wf_s = timed(lambda: wavefront.render_wavefront(
        sc, st4, tracer=ct.ClusterTracer(sc, data=kernel.cluster_data(sc))))
    log(f"    reference: the wavefront through B3 at {MAIN4_SPP} spp, "
        f"{wf_s:.3f} s")
    b2_launches = b2_main_path(10, "terrain 100k mis", sc, st4, wf_ref,
                               "terrain100k_b2.png", png_dir, card)
    main4 = (sc, st4, b2_launches)

    # ---- 11. main path 5: smooth bumpy 100k, material, through B2 -------
    log(f"[11] main path 5: bumpy sphere 100k (vertex normals) -> "
        f"render_frame ({MESH_W}x{MESH_H} @ {MAIN5_SPP} spp material) -> "
        f"finalize -> write_png through B2")
    sc = b2_scenes["bumpy 100k smooth material"][0]
    ref5, ref5_s = timed(lambda: kernel.render_megakernel_plain(
        sc, b2_settings("material", MAIN5_REF_SPP)))
    log(f"    reference: the plain version at {MAIN5_REF_SPP} spp, "
        f"{ref5_s:.1f} s")
    st5 = b2_settings("material", MAIN5_SPP)
    main5_launches = b2_main_path(11, "bumpy 100k smooth material", sc,
                                  st5, ref5, "bumpy100k_b2.png", png_dir,
                                  card)
    log(f"    main path 5's launch alone (not counted as a main-path "
        f"launch):")
    m5 = b2_timing(sc, b2_scenes["bumpy 100k smooth material"][1], st5)

    return dict(b2, launches_4=b2_launches, launches_5=main5_launches,
                max_abs_err=b2_err, main4=main4, main5_stats=m5["stats"],
                main5_ms=m5["ms"], main5_bound_ms=m5["bound_ms"],
                main5_bound_by=m5["bound_by"], main5_lane_fill=m5["lane_fill"])


# ---------------------------------------------------------------------------
# phases 12-14: kernels X1 (packet cull) and B5 (packet walk), main path 6,
# kernel B6
# ---------------------------------------------------------------------------

def cull_vs_plain(tr, packed):
    """X1 (through PacketTracer.cull, counted) against the plain cull on
    the same packed rays: meta bit for bit, both timed, the bound from
    this run's shapes. Returns (meta, its row of numbers)."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.geometry import cull_schedule as cs
    before = pt.LAUNCHES_CULL
    meta = tr.cull(packed)
    torch.cuda.synchronize()
    if pt.LAUNCHES_CULL != before + 1:
        fail("PacketTracer.cull did not launch X1")
    pi = tr.pi if tr.variant == "f2b" else None

    def plain():
        return pt._cull_meta(*packed, tr.cl_lo, tr.cl_hi, tr.cp, pi,
                             tr.entry_scale)
    ref, plain_ms = event_ms(plain, 1)
    bad = int((meta != ref).sum())
    for _ in range(2):                                      # warm-up
        tr.cull(packed)
    _, ms = event_ms(lambda: tr.cull(packed), TIMED_LAUNCHES)
    # the counted launch: its meta as the uncounted one's, its counts
    # (select-form, plain-form, bounds tests, tests skipped) as the CPU
    # replay's
    steps = torch.zeros(4, dtype=torch.int64, device=meta.device)
    args = (*packed, tr.cl_lo, tr.cl_hi, tr.cp, pi)
    bad += int((pt.cull_meta(*args, tr.entry_scale, steps=steps)
                != meta).sum())
    got = dict(zip(cs.KEYS, (int(x) for x in steps.cpu())))
    want = cs.cull_steps(*(a.cpu() if isinstance(a, torch.Tensor) else a
                           for a in args))
    if got != want:
        fail(f"X1 {tr.variant}: counted {got}, the replay {want}")
    n_rays = packed[0].shape[0]
    # the bound: the slab and bounds tests X1 runs on these rays (a skipped
    # bucket's tests are work no ray needs), at their operations each
    live = int((packed[2] <= packed[3]).sum())
    pairs = live * tr.data.n_clusters
    skip = got["skipped_tests"] / pairs if pairs else 0.0
    nbytes = meta.numel() * 4 + n_rays * 32 + tr.data.n_clusters * 24
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * cs.operations(got) / FP32_OPS_PER_S
    return meta, dict(mismatches=bad, ms=ms, plain_ms=plain_ms,
                      bound_ms=max(t_bytes, t_ops), steps=got, pairs=pairs,
                      skip_share=skip,
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      t_bytes=t_bytes, t_ops=t_ops)


def packet_vs_plain(scene, rays):
    """Phase 12: X1 against the plain cull and B5 against its plain walk on
    the same packed rays and meta, both variants, three ray kinds; then
    closest()/occluded() against B3's."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import packet_trace as pt
    t0 = time.time()
    tracers = {"slist": pt.PacketTracer(scene)}
    tracers["f2b"] = pt.PacketTracer(scene, variant="f2b",
                                     data=tracers["slist"].data)
    data = tracers["slist"].data
    log(f"  terrain 100k: {data.n_clusters} clusters of <= {pt.PACK_K} "
        f"triangles, packed table {data.tri_rows_t.nbytes / 2 ** 20:.2f} MiB "
        f"(budget {pt.PacketTracer.VMEM_BUDGET_BYTES >> 20} MiB), cp "
        f"{tracers['slist'].cp}; host build {time.time() - t0:.2f}s")
    res, cull = {}, {}
    for kind, r in rays.items():
        any_hit = kind == "shadow"
        for variant, tr in tracers.items():
            _, packed = tr.pack(*r)
            meta, c = cull_vs_plain(tr, packed)
            cull[(variant, kind)] = c
            st = c["steps"]
            log(f"  X1 {variant:5s} {kind:6s}: meta vs the plain cull's "
                f"mismatches {c['mismatches']}; kernel {c['ms']:.4f} ms, "
                f"plain cull {c['plain_ms']:.3f} ms; of {c['pairs']} (live "
                f"ray, cluster) pairs {st['select_tests']} tested in the "
                f"select form, {st['plain_tests']} in the plain form, "
                f"{st['skipped_tests']} skipped (skip share "
                f"{c['skip_share']:.4f}), {st['bound_tests']} bounds tests "
                f"(counted launch = CPU replay) -> bound {c['bound_ms']:.4f} "
                f"ms ({c['bound_by']}: bytes {c['t_bytes']:.4f} ms, ops "
                f"{c['t_ops']:.4f} ms)")
            if c["mismatches"]:
                fail(f"X1 {variant} {kind}: {c['mismatches']} meta slots "
                     f"differ from the plain cull's or the uncounted "
                     f"launch's")
            args = (tr.tri_t, meta, *packed, *tr.walk_args(any_hit))
            steps = torch.zeros(1, dtype=torch.int64, device=meta.device)
            got = pt.trace_packet(*args, steps=steps)
            torch.cuda.synchronize()
            for _ in range(2):                              # warm-up
                pt.trace_packet(*args)
            _, ms = event_ms(lambda: pt.trace_packet(*args), TIMED_LAUNCHES)
            cull_ms = c["ms"]
            _, trace_ms = event_ms(lambda: tr._run(*r, any_hit),
                                   TIMED_LAUNCHES // 4)
            st = {}
            ref, plain_ms = event_ms(
                lambda: pt.packet_walk_plain(*args, stats=st,
                                             cl_len=data.cl_len), 1)
            bad, err = mismatches(got, ref)
            fill_ = st["tri_tests"] / (32 * int(steps))
            cands = meta.view(-1, pt.META_ROWS, tr.cp)[:, 2, 0].float()
            nbytes = (meta.numel() * 4 + tr.tri_t.numel() * 4
                      + packed[0].shape[0] * (32 + 8))
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * st["tri_tests"] * ct.TRI_TEST_OPS / FP32_OPS_PER_S
            hits = int((got[0] == -float("inf")).sum() if any_hit
                       else (got[1] >= 0).sum())
            res[(variant, kind)] = dict(
                mismatches=bad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                cull_ms=cull_ms, trace_ms=trace_ms, fill=fill_)
            log(f"  {variant:5s} {kind:6s}: {int(steps)} warp test steps, "
                f"lane fill {fill_:.4f} (needed tests / (32 x steps))")
            log(f"  {variant:5s} {kind:6s}: {'occluded' if any_hit else 'hits'}"
                f" {hits}/{r[0].shape[0]}, kernel vs plain (t, code) "
                f"mismatches {bad}; B5 {ms:.3f} ms, cull (X1) {cull_ms:.3f} ms, "
                f"whole trace {trace_ms:.3f} ms (cull share "
                f"{cull_ms / trace_ms:.1%}), plain walk {plain_ms:.1f} ms; "
                f"candidates per workgroup mean {float(cands.mean()):.1f} max "
                f"{int(cands.max())}; {st['packet_tests']} live packet tests "
                f"walked, {st['tri_tests']} triangle tests needed (valid "
                f"lanes of open rays) -> bound "
                f"{res[(variant, kind)]['bound_ms']:.4f} ms "
                f"({res[(variant, kind)]['bound_by']}: bytes {t_bytes:.4f} "
                f"ms, ops {t_ops:.4f} ms)")
            if bad:
                fail(f"B5 {variant} {kind}: {bad} mismatches")
    # the facade against B3 on the same rays: the same t; another triangle
    # only where t ties exactly (the walks break ties in other orders)
    wide = ct.ClusterTracer(scene, walk="wide")
    for kind, r in rays.items():
        for variant, tr in tracers.items():
            if kind == "shadow":
                a, b = tr.occluded(scene, *r), wide.occluded(scene, *r)
                n_bad = int((a != b).sum())
                log(f"  {variant:5s} occluded() vs B3 on {kind} rays: "
                    f"{n_bad} differ ({int(a.sum())} occluded)")
                if n_bad:
                    fail(f"B5 {variant}: occluded() differs from B3")
                continue
            hp, hb = tr.closest(scene, *r), wide.closest(scene, *r)
            t_bad = int((hp.t.view(torch.int32)
                         != hb.t.view(torch.int32)).sum())
            other = hp.prim_id != hb.prim_id
            ties = int((other & (hp.t == hb.t)).sum())
            same = hb.hit & ~other
            du = float((hp.u - hb.u)[same].abs().max()) if same.any() else 0.
            dv = float((hp.v - hb.v)[same].abs().max()) if same.any() else 0.
            log(f"  {variant:5s} closest() vs B3 on {kind} rays: t differs "
                f"on {t_bad}, prim id on {int(other.sum())} (exact ties in "
                f"t: {ties}); on the same triangle max|du| {du:g}, max|dv| "
                f"{dv:g} (u, v solved in the plane, ROADMAP C10)")
            if t_bad or int(other.sum()) != ties:
                fail(f"B5 {variant} {kind}: closest() differs from B3 "
                     f"beyond exact ties")
    return res, cull


def packet_main_path(scene, b3_img, png_dir, card, dev):
    """Phase 13: main path 6 through X1 and B5."""
    import numpy as np
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    st = ir.RenderSettings(MESH_W, MESH_H, spp=MESH_SPP, max_depth=64,
                           integrator="mis", tonemap="agx",
                           batch_size=MESH_BATCH)
    st1 = dataclasses.replace(st, spp=1)
    kt = pt.PacketTracer(scene)
    ptr = pt.PacketTracer(scene, plain=True, data=kt.data)
    (img_k, sk), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=kt, return_stats=True))
    (img_p, sp), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=ptr, return_stats=True))
    r = compare(f"terrain 100k {MESH_W}x{MESH_H}@1 B5 vs plain packet walk",
                img_p, img_k)
    log(f"    B5 {sk['seconds']:.2f}s, plain walk {sp['seconds']:.2f}s; "
        f"segments {sk['segments']} / {sp['segments']}, shadow rays "
        f"{sk['shadow_rays']} / {sp['shadow_rays']}, supersteps "
        f"{sk['supersteps']} / {sp['supersteps']}")
    if not (r["mean"] < WF_MEAN and r["corr"] > WF_CORR):
        fail("main path 6: 1-spp B5 vs plain packet walk per pixel")
    if (sk["segments"], sk["shadow_rays"]) != (sp["segments"],
                                               sp["shadow_rays"]):
        fail("main path 6: 1-spp ray counts differ")

    zero_counts()
    img, secs = timed(lambda: render_frame(scene, st, tracer_force="packet"))
    counts = read_counts()
    stats = wavefront.LAST_STATS
    img_np = img.cpu().numpy()
    if img_np.shape != (MESH_H, MESH_W, 3) or not np.isfinite(img_np).all():
        fail(f"main path 6 image shape {img_np.shape} / non-finite")
    ours = ("packet_trace", "packet_cull")
    if (counts["packet_trace"] < 1
            or counts["packet_cull"] != counts["packet_trace"]
            or any(v for k, v in counts.items() if k not in ours)):
        fail(f"main path 6 launches {counts}")
    png = save_png(img, st.tonemap, "terrain100k_packet.png", png_dir)
    mean = img_np.reshape(-1, 3).mean(0)
    ref = b3_img.reshape(-1, 3).mean(0).cpu().numpy()
    rel = np.abs(mean - ref) / np.maximum(ref, 1e-12)
    log(f"    {MESH_SPP}-spp mean {mean.tolist()} vs the B3 frame of phase 7 "
        f"{ref.tolist()} (rel {rel.tolist()}); png {png} bytes")
    if not (rel < MAIN_MEAN_REL).all():
        fail("main path 6 mean differs from the B3 frame's")
    paths = MESH_W * MESH_H * MESH_SPP
    rays = stats["segments"] + stats["shadow_rays"]
    log(f"    [13] {MESH_W}x{MESH_H} @ {MESH_SPP} spp: {secs:.3f} s (render "
        f"loop {stats['seconds']:.3f} s), {paths / secs / 1e6:.3f} Mpaths/s, "
        f"{rays / secs / 1e6:.2f} Mrays/s ({stats['segments']} segments + "
        f"{stats['shadow_rays']} shadow rays), {stats['supersteps']} "
        f"supersteps, launches {counts} (X1 {counts['packet_cull']}, B5 "
        f"{counts['packet_trace']}), on {card}")
    return counts, r["max"]


def packet_phases(scene, rays, b3_img, png_dir, card, dev):
    """Phases 12 and 13; returns B5's and X1's rows of the kernels JSON
    (the slist bounce launch, as the B3/B4 rows; launches over main path
    6)."""
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.runtime import cuda
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import cull_schedule as cs
    log(f"[12] X1 (packet cull) and B5 (packet walk) vs their plain "
        f"versions, terrain 100k, phase 6's {N_RAYS} rays per kind, "
        f"PacketTracer's order")
    occ = {}
    for f2b, variant in ((False, "slist"), (True, "f2b")):
        occ[variant] = o = pt.cull_occupancy(f2b)
        log(f"    X1 {variant}: {o['regs']} registers, {o['local_bytes']} B "
            f"local memory a thread, {o['smem_bytes']} B shared memory a "
            f"block, {o['blocks_per_sm']} blocks = {o['warps_per_sm']} "
            f"resident warps per SM; ptxas: " + " | ".join(cuda.ptxas_lines(
                cuda.BUILD_INFO["log"],
                f"packet_cull_kernelILb{int(f2b)}ELb0E")))
    log(f"    X1's slab test: {cs.SELECT_TEST_OPS} operations in the "
        f"select form (6 of them min/max), {ct.BOX_TEST_OPS} in the plain "
        f"form (12 min/max), a bounds test {cs.BOUND_TEST_OPS} (design "
        f"counts, csrc/packet_cull.cu)")
    res, cull = packet_vs_plain(scene, rays)
    log("    X1 ms (20 culls between CUDA events): " + "; ".join(
        f"{variant} " + " / ".join(f"{kind} {cull[(variant, kind)]['ms']:.4f}"
                                   for kind in rays)
        for variant in ("slist", "f2b")))
    log(f"[13] main path 6: terrain 100k -> render_frame ({MESH_W}x{MESH_H} "
        f"@ {MESH_SPP} spp, batch {MESH_BATCH}, tracer_force='packet') -> "
        f"finalize -> write_png through X1 and B5")
    counts, _ = packet_main_path(scene, b3_img, png_dir, card, dev)
    c = res[("slist", "bounce")]
    b5 = dict(launches=counts["packet_trace"],
              max_abs_err=max(v["max_abs_err"] for v in res.values()),
              ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
              bound_by=c["bound_by"], note=f"lane fill {c['fill']:.4f}")
    c = cull[("slist", "bounce")]
    x1 = dict(launches=counts["packet_cull"], max_abs_err=0.0, ms=c["ms"],
              plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
              bound_by=c["bound_by"],
              f2b_ms=cull[("f2b", "bounce")]["ms"],
              camera_ms=cull[("slist", "camera")]["ms"],
              shadow_ms=cull[("slist", "shadow")]["ms"],
              f2b_camera_ms=cull[("f2b", "camera")]["ms"],
              f2b_shadow_ms=cull[("f2b", "shadow")]["ms"],
              skip_share={f"{v}_{k}": cull[(v, k)]["skip_share"]
                          for v in ("slist", "f2b") for k in rays},
              regs=occ["slist"]["regs"],
              warps_per_sm=occ["slist"]["warps_per_sm"],
              f2b_regs=occ["f2b"]["regs"],
              f2b_warps_per_sm=occ["f2b"]["warps_per_sm"])
    return b5, x1


def gather_phase(dev, card):
    """Phase 14: B6 through gather_row (counted), bit for bit against its
    plain version and the table; timed beside torch.index_select."""
    import numpy as np
    import torch
    from vimg_tpu_torch.ops import mxu_gather as g
    log(f"[14] B6 (gather_row) on a {GATHER_P}x{GATHER_ROWS} table, "
        f"{GATHER_IDS} ids")
    rs = np.random.RandomState(7)
    table = (rs.randn(GATHER_P, GATHER_ROWS)
             * np.exp(rs.randn(GATHER_P, GATHER_ROWS) * 4)).astype(np.float32)
    hi, mid, lo = (x.to(dev) for x in g.split3(table))
    ids = torch.from_numpy(rs.randint(0, GATHER_ROWS, (1, GATHER_IDS))
                           .astype(np.int32)).to(dev)
    zero_counts()
    out = g.gather_row(hi, mid, lo, ids, GATHER_ROWS)
    torch.cuda.synchronize()
    launches = read_counts()["gather_row"]
    ref = g.gather_row_plain(hi, mid, lo, ids, GATHER_ROWS)
    bad = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    err = float((out - ref).abs().max())
    exact = np.array_equal(out.cpu().numpy(),
                           table[:, ids[0].cpu().numpy()])
    tab = torch.from_numpy(table).to(dev)
    for _ in range(2):
        g.gather_row(hi, mid, lo, ids, GATHER_ROWS)
        torch.index_select(tab, 1, ids[0])
    _, ms = event_ms(lambda: g.gather_row(hi, mid, lo, ids, GATHER_ROWS),
                     TIMED_LAUNCHES)
    _, plain_ms = event_ms(lambda: g.gather_row_plain(hi, mid, lo, ids,
                                                      GATHER_ROWS), 5)
    _, lib_ms = event_ms(lambda: torch.index_select(tab, 1, ids[0]),
                         TIMED_LAUNCHES)
    nbytes = (ids.numel() * 4 + out.numel() * 4
              + 3 * hi.numel() * hi.element_size())
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * out.numel() / FP32_OPS_PER_S
    log(f"    launches {launches}; vs plain: {bad} elements differ in bits; "
        f"equal to table[:, ids]: {exact}; B6 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.index_select on the float32 table "
        f"{lib_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms (bytes "
        f"{t_bytes:.4f} ms, ops {t_ops:.5f} ms), on {card}")
    if launches != 1 or bad or not exact:
        fail("B6 gather_row")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phases 15-18: the probe kernels P1-P11 (vimg_tpu_torch/probes), each
# through its probe's own entry point at the probe's size, then against its
# plain version on the same inputs
# ---------------------------------------------------------------------------

def bits_differ(a, b):
    """Elements whose bits differ (float32 compared as int32)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def probe_row(name, replaces, ms, plain_ms, ops, nbytes, err=0.0,
              note=None, peak=FP32_OPS_PER_S, library_ms=None,
              clock="device"):
    """A kernels-JSON row of a probe kernel: no render path launches it.
    ``peak`` is the card's rate for the operations' type (FP32 by
    default); ``clock`` how ``ms`` and ``library_ms`` were timed (the
    module's docstring)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / peak
    row = {"name": name, "route": "cuda", "source": PROBE_SOURCES[name],
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "clock": clock}
    if note:
        row["note"] = note
    lib = "" if library_ms is None else f", library {library_ms:.6f} ms"
    log(f"    {name}: kernel {ms:.6f} ms, plain {plain_ms:.3f} ms{lib}, "
        f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}: {ops:.4g} ops "
        f"at {peak / 1e12:g} T/s, {nbytes:.4g} bytes)"
        f"{'; ' + note if note else ''}")
    return row


def probe_counts():
    from vimg_tpu_torch.probes import common
    return {k: v for k, v in common.LAUNCHES.items() if v}


def walk_probe_phase(scene):
    """Phase 15: P1 through probe_walkablate.walk_ablation on terrain 100k
    (5 variants x groups 32 and 1), each bit for bit against
    walkablate_plain at the same group; the full walk's bt against B4's
    closest t on the same rays."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.probes import common
    from vimg_tpu_torch.probes import probe_walkablate as pw
    log(f"[15] P1 (walk ablation) on terrain 100k, {N_RAYS} bounce rays in "
        f"origin-Morton order, variants {', '.join(pw.VARIANTS)} at groups "
        f"{pw.KERNEL_GROUPS}; records:")
    zero_counts()
    tables, rays, res = pw.walk_ablation(scene, N_RAYS,
                                         log=common.Log(scene.verts.device))
    log(f"    probe launches {probe_counts()}")
    plain = {}
    for (variant, group), (bt, nv, ms) in res.items():
        (rbt, rnv), plain_ms = event_ms(lambda: pw.walkablate_plain(
            *tables, *rays, variant, group), 1)
        bad_bt, bad_nv = bits_differ(bt, rbt), bits_differ(nv, rnv)
        visits = int(nv.sum())
        plain[(variant, group)] = plain_ms
        log(f"    {variant:10s} group {group:2d}: kernel {ms:.4f} ms, "
            f"{visits} visits ({visits / nv.numel():.1f} per group), "
            f"{1e3 * ms / max(visits, 1):.6f} us/visit; plain "
            f"{plain_ms:.1f} ms; bt differs on {bad_bt}, visits on {bad_nv}")
        if bad_bt or bad_nv:
            fail(f"P1 {variant} group {group}: kernel differs from plain")
    aabbs, cid, skip, tri, n_nodes = tables
    bt = res[("full", 32)][0]
    t4 = ct.trace_skip(aabbs, cid, skip, tri, n_nodes, *rays, False)[0]
    _, b4_ms = event_ms(lambda: ct.trace_skip(aabbs, cid, skip, tri, n_nodes,
                                              *rays, False), TIMED_LAUNCHES)
    log(f"    B4 (trace_skip) on the same rays: {b4_ms:.4f} ms per launch")
    fin = torch.isfinite(bt) & torch.isfinite(t4)
    err = float((bt - t4)[fin].abs().max()) if bool(fin.any()) else 0.0
    log(f"    full bt vs B4's closest t on the same rays: "
        f"{bits_differ(bt, t4)} of {N_RAYS} differ in bits, max|d| {err:g}; hits "
        f"{int(torch.isfinite(bt).sum())} / {int(torch.isfinite(t4).sum())}")
    st = {}
    ct.skip_walk_plain(aabbs, cid, skip, tri, n_nodes, *rays, False, stats=st)
    ops = st["box_tests"] * ct.BOX_TEST_OPS + st["tri_tests"] * ct.TRI_TEST_OPS
    nbytes = (sum(x.numel() * x.element_size() for x in tables[:4])
              + N_RAYS * (32 + 4) + N_RAYS // 32 * 4)
    log(f"    bound of the full walk from B4's plain walk on these rays: "
        f"{st['box_tests']} box + {st['tri_tests']} triangle tests")
    # the full walk's warp steps: a counted launch against the replay of
    # its schedule (walk_schedule), and the leaf round's lane fill
    fill = {}
    for group in pw.KERNEL_GROUPS:
        steps = torch.zeros(2, dtype=torch.int64, device=bt.device)
        kbt, knv = pw.walkablate(*tables, *rays, "full", group, steps=steps)
        rbt, rnv, c = pw.walk_schedule(*tables, *rays, group)
        got = [int(x) for x in steps.cpu()]
        want = [c["node_steps"], c["tri_steps"]]
        fill[group] = c["tri_tests"] / (32 * max(got[1], 1))
        old = (f"; the per-lane leaf before: 64 x {c['leaf_visits']} leaf "
               f"visits = {64 * c['leaf_visits']} warp triangle steps"
               if group == 32 else "")
        log(f"    full group {group:2d}: warp (node, triangle) steps kernel "
            f"{got}, replay {want}; {c['tri_tests']} triangle tests, leaf "
            f"lane fill {fill[group]:.4f} (replay "
            f"{c['tri_tests'] / (32 * max(want[1], 1)):.4f}){old}")
        if (got != want or bits_differ(kbt, rbt) or bits_differ(knv, rnv)
                or bits_differ(kbt, res[("full", group)][0])):
            fail(f"P1 full group {group}: counted launch or steps differ "
                 f"from the replay")
    row = probe_row("probe_walkablate", "tools/probe_walkablate.py:204",
                    res[("full", 32)][2], plain[("full", 32)], ops, nbytes,
                    note=f"leaf lane fill {fill[32]:.4f} (group 1: "
                    f"{fill[1]:.4f})")
    row.update(leaf_fill=fill[32], group1_leaf_fill=fill[1],
               group1_ms=res[("full", 1)][2])
    return row


def scalar_probe_phase(dev):
    """Phase 16: P2-P4 through their probes at N = 20,000, each against
    its plain version at the same N."""
    from vimg_tpu_torch.probes import common, probe_r3b, probe_r3c, probe_regen
    log(f"[16] P2 (sync), P3 (smem_read), P4 (stack) at N = "
        f"{probe_r3b.N_ITER}; records:")
    plog = common.Log(dev)
    zero_counts()
    x, sync_res = probe_r3b.microbench_sync(dev, log=plog)
    x8, tab, read_res = probe_r3c.smem_read_cost(dev, log=plog)
    x0, stack_out, stack_ms = probe_regen.probe_smem_dynamic_write(dev,
                                                                  log=plog)
    log(f"    probe launches {probe_counts()}")
    plain_ms = {}
    for mode, (out, _) in sync_res.items():
        ref, plain_ms[mode] = event_ms(lambda: probe_r3b.sync_plain(x, mode),
                                       1)
        bad = bits_differ(out, ref)
        log(f"    sync {mode}: {bad} elements differ from plain")
        if bad:
            fail(f"P2 {mode}: kernel differs from plain")
    for cfg, (out, _) in read_res.items():
        ref, plain_ms[cfg] = event_ms(lambda: probe_r3c.smem_read_plain(
            x8, tab, cfg[1], cfg[0]), 1)
        bad = bits_differ(out, ref)
        log(f"    smem_read packed={cfg[0]} n_reads={cfg[1]}: {bad} elements "
            f"differ from plain")
        if bad:
            fail(f"P3 {cfg}: kernel differs from plain")
    ref, plain_stack = event_ms(lambda: probe_regen.stack_sum_plain(x0), 1)
    bad = bits_differ(stack_out, ref)
    log(f"    stack: value {float(stack_out[0, 0])}, {bad} elements differ "
        f"from plain")
    if bad or float(stack_out[0, 0]) != 423.0:
        fail("P4: kernel differs from plain or from 423")
    n = probe_r3b.N_ITER
    note = "latency probe: a serial chain, far above its bound by design"
    return [
        probe_row("probe_sync", "tools/probe_r3b.py:68", sync_res["scalar"][1],
                  plain_ms["scalar"], n * 4096 * 3, 2 * 4096 * 4, note=note),
        probe_row("probe_smem_read", "tools/probe_r3c.py:64",
                  read_res[(False, 4)][1], plain_ms[(False, 4)],
                  n * (1024 + 3 * 4), 2 * 1024 * 4 + 4096 * 4, note=note),
        probe_row("probe_smem_write", "tools/probe_regen.py:56", stack_ms,
                  plain_stack, 1024 + 64, 2 * 1024 * 4, note=note)]


def packet_probe_phase(dev):
    """Phase 17: P5-P10 through probe_r4a's probes at their sizes (reps
    512; ffs 64 with 16 and 4 live lanes), each against its plain version
    on the same inputs."""
    from vimg_tpu_torch.probes import common, probe_r4a as r
    log("[17] P5-P10 (packet primitives) at the probe's sizes; records:")
    plog = common.Log(dev)
    zero_counts()
    runs = {name: fn(device=dev, log=plog) for name, fn in r.PROBES}
    log(f"    probe launches {probe_counts()}")
    plains = {
        "setup_static": lambda a: r.setup_plain(a[0], a[2]),
        "setup_dynamic": lambda a: r.setup_plain(a[0], a[2]),
        "dynrow": lambda a: r.rows_plain(a[0], a[1], a[2], False),
        "ffs16": lambda a: r.ffs_plain(*a),
        "ffs4": lambda a: r.ffs_plain(*a),
        "epilogue": lambda a: r.epilogue_plain(*a),
        "dynblock_par": lambda a: r.rows_plain(*a),
        "dynblock_chain": lambda a: r.rows_plain(*a),
        "dynrow_par": lambda a: r.rows_plain(a[0], a[1], a[2], True)}
    plain_ms = {}
    for name, (args, out, _) in runs.items():
        ref, plain_ms[name] = event_ms(lambda: plains[name](args), 1)
        bad = bits_differ(out, ref)
        log(f"    {name}: {bad} elements differ from plain")
        if bad:
            fail(f"{name}: kernel differs from plain")
    reps = 512

    def rows_bytes(args):
        return (len(set(args[1].tolist())) * r.NROWS * 128 * 4 + 64 * 4
                + 1024 * 4)

    def ms(name):
        return runs[name][2]

    ffs_args = runs["ffs16"][0]
    n_live = int((ffs_args[0] > 0.5).sum())
    return [
        probe_row("probe_setup", "tools/probe_r4a.py:86", ms("setup_dynamic"),
                  plain_ms["setup_dynamic"], reps * 8 * 11, 2 * 1024 * 4),
        probe_row("probe_dynrow", "tools/probe_r4a.py:117", ms("dynrow"),
                  plain_ms["dynrow"], reps * 128 * 23,
                  rows_bytes(runs["dynrow"][0])),
        probe_row("probe_ffs", "tools/probe_r4a.py:160", ms("ffs16"),
                  plain_ms["ffs16"], 64 * n_live * 128,
                  128 * 4 + n_live * 128 * 4 + 1024 * 4),
        probe_row("probe_epilogue", "tools/probe_r4a.py:198", ms("epilogue"),
                  plain_ms["epilogue"], reps * 1024 * 3, 1024 * 4 + 8 * 4),
        probe_row("probe_dynblock", "tools/probe_r4a.py:257",
                  ms("dynblock_par"), plain_ms["dynblock_par"],
                  reps * 128 * 12, rows_bytes(runs["dynblock_par"][0])),
        probe_row("probe_dynrow_par", "tools/probe_r4a.py:287",
                  ms("dynrow_par"), plain_ms["dynrow_par"], reps * 128 * 12,
                  rows_bytes(runs["dynrow_par"][0]))]


def stage_probe_phase(dev):
    """Phase 18: P11 through probe_r4c.run_stage, stages 0-3 at 16 packets
    and stage 4 at 1, 4 and 16, each against its plain version."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.probes import common, probe_r4c
    log("[18] P11 (packet kernel stages) on the probe's inputs (8 "
        "workgroups, 40 chain entries); records:")
    plog = common.Log(dev)
    zero_counts()
    runs = {run: probe_r4c.run_stage(*run, dev, plog)
            for run in probe_r4c.RUNS}
    log(f"    probe launches {probe_counts()}")
    plain_ms = {}
    for (stage, n_packets), (args, out, ms) in runs.items():
        ref, plain_ms[(stage, n_packets)] = event_ms(
            lambda: probe_r4c.packet_stage_plain(*args, stage, n_packets), 1)
        bad = bits_differ(out, ref)
        log(f"    stage {stage} at {n_packets:2d} packets: {ms:.6f} ms per "
            f"launch, mean {float(out.mean()):.6g}; {bad} elements differ "
            f"from plain")
        if bad:
            fail(f"P11 stage {stage} n_packets {n_packets}: kernel differs")
    xt, meta, tri = runs[(4, 16)][0]
    m = meta.view(-1, 8, probe_r4c.CP).long()
    live = 0
    for w in range(m.shape[0]):
        pm = m[w, 1, :int(m[w, 2, 0])] & 0xFFFF
        live += sum(bin(int(v)).count("1") for v in pm)
    ops = live * 8 * 128 * ct.TRI_TEST_OPS
    clusters = len(set(m[:, 0, :40].reshape(-1).tolist()))
    nbytes = 3 * xt.numel() * 4 + clusters * 12 * 128 * 4
    log(f"    stage 4 at 16 packets: {live} live (packet, entry) pairs, "
        f"{live * 8 * 128} triangle tests")
    return probe_row("probe_packet_stages", "tools/probe_r4c.py:158",
                     runs[(4, 16)][2], plain_ms[(4, 16)], ops, nbytes)


# ---------------------------------------------------------------------------
# phase 19: the s_normal frames (render_frame -> render() on the card)
# ---------------------------------------------------------------------------

def normal_scene(kind, device, size=None):
    """The flagship JSON or terrain 100k under s_normal at the CLI's 4 spp,
    at its own size or at ``size`` (width, height)."""
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    if kind == "flagship":
        scene, st = load_json_scene(FLAGSHIP, device=device)
        w, h = size or (st.width, st.height)
        scene = scene.replace(camera=dataclasses.replace(
            scene.camera, width=w, height=h))
        st = dataclasses.replace(st, width=w, height=h)
    else:
        w, h = size or (MESH_W, MESH_H)
        scene = terrain_scene(TERRAINS[0][0], w, h, device=device)
        st = ir.RenderSettings(w, h, batch_size=MESH_BATCH)
    return scene, dataclasses.replace(st, spp=NORMAL_SPP,
                                      integrator="s_normal", tonemap="clamp")


def normal_phase(dev, card, png_dir):
    """Phase 19 (main paths 7 and 8): s_normal frames through
    render_frame on the card (ROADMAP C12: before this, they raised). Each
    is first compared with the same call on the CPU at a reduced size
    (per-pixel, at the unit-scale bound), then driven at full size with the
    counts set to 0 just before and read just after: the flagship's SoA
    tracer is tensor code (no kernel), terrain 100k's is B3."""
    import torch
    from vimg_tpu_torch.render.render import render_frame
    log("[19] main paths 7, 8: s_normal frames -> render_frame -> render() "
        "on the card")
    launches = {}
    for kind, kernel_name in (("flagship", None), ("terrain", "cluster_wide")):
        small = {}
        for d in (dev, torch.device("cpu")):
            scene, st = normal_scene(kind, d, NORMAL_SMALL[kind])
            small[d.type] = render_frame(scene, st)
        r = compare(f"{kind} {st.width}x{st.height}@{st.spp} s_normal card "
                    f"vs cpu", small["cpu"], small["cuda"])
        if not (r["mean"] < UNIT_MEAN and r["frac"] < UNIT_FRAC):
            fail(f"s_normal {kind}: card differs from the CPU")
        scene, st = normal_scene(kind, dev)
        render_frame(scene, dataclasses.replace(st, spp=1))      # warm
        zero_counts()
        img, secs = timed(lambda: render_frame(scene, st))
        counts = read_counts()
        nz = {k: v for k, v in counts.items() if v}
        ok_counts = (set(nz) == {kernel_name} if kernel_name
                     else not nz)
        arr = img.cpu().numpy()
        import numpy as np
        if (not img.is_cuda or arr.shape != (st.height, st.width, 3)
                or not np.isfinite(arr).all() or not ok_counts):
            fail(f"s_normal {kind}: image {arr.shape} on {img.device}, "
                 f"launches {nz}")
        png = save_png(img, st.tonemap, f"{kind}_s_normal.png", png_dir)
        paths = st.width * st.height * st.spp
        log(f"    {kind} {st.width}x{st.height} @ {st.spp} spp s_normal: "
            f"{secs:.3f} s, {paths / secs / 1e6:.2f} Mpaths/s, launches "
            f"{nz or 'none (tensor code)'}, mean {arr.mean():.6f}, png "
            f"{png} bytes, on {card}")
        launches[kind] = nz
    return launches


def other_frame(case, device):
    """(scene, settings, render_frame's keywords, the walk kernel it must
    launch on the card or None) of a phase-19 C12 case at small size: a
    g_normal frame of terrain 20k, and material frames the megakernel
    refuses (260 spheres): over a 2,000-triangle floor through the cluster
    tracer (its default walk, and a given skip-walk tracer), and alone
    through the SoA tracer (each names its tracer: by itself make_tracer
    gives 260 spheres the BVH tracer, X2)."""
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    if case == "terrain_g_normal":
        w, h = NORMAL_SMALL["terrain"]
        scene = terrain_scene(20_000, w, h, device=device)
        return (scene, ir.RenderSettings(w, h, spp=4, integrator="g_normal"),
                {}, "cluster_" + ClusterTracer(scene).walk)
    floor = 0 if case == "unit_material" else 2_000
    scene, st = unit_scene(device, 4, "material", n_extra=257,
                           floor_tris=floor)
    st = dataclasses.replace(st, max_depth=8)
    if not floor:
        return scene, st, {"tracer_force": "soa"}, None
    if case == "floor_material_skip":
        return scene, st, {"tracer": ClusterTracer(scene, walk="skip")}, \
            "cluster_skip"
    return (scene, st, {"tracer_force": "cluster"},
            "cluster_" + ClusterTracer(scene).walk)


OTHER_FRAMES = ("terrain_g_normal", "floor_material", "floor_material_skip",
                "unit_material")


def other_frames_phase(dev):
    """Phase 19, the other C12 frames: each renders through render_frame
    -> render() on the card and on the CPU, compared per pixel at the
    unit-scale bound; on the card, with the counts set to 0 before, only
    its walk kernel (B3 or B4; closest hits, as these integrators trace no
    shadow rays) or none may launch."""
    import torch
    from vimg_tpu_torch.render.mega import supports_megakernel
    from vimg_tpu_torch.render.render import render_frame
    log("    C12's other frames, card vs CPU through render_frame -> "
        "render():")
    for case in OTHER_FRAMES:
        imgs = {}
        for d in (torch.device("cpu"), dev):
            scene, st, kw, walk = other_frame(case, d)
            if st.integrator == "material" and supports_megakernel(scene, st):
                fail(f"{case}: the megakernel would take this frame")
            zero_counts()
            imgs[d.type], secs = timed(lambda: render_frame(scene, st, **kw))
        nz = {k: v for k, v in read_counts().items() if v}
        r = compare(f"{case} {st.width}x{st.height}@{st.spp} "
                    f"{st.integrator} card vs cpu", imgs["cpu"], imgs["cuda"])
        log(f"      card {secs:.3f} s, launches {nz or 'none'}")
        if not (imgs["cuda"].is_cuda and r["mean"] < UNIT_MEAN
                and r["frac"] < UNIT_FRAC):
            fail(f"{case}: card differs from the CPU")
        if set(nz) != ({walk} if walk else set()):
            fail(f"{case}: launches {nz}, expected only {walk}")


def envtex_small_phase(dev):
    """Phase 19, main path 9 at 64x32 @ 4 spp through render_frame on the
    card and on the CPU: the frames agree statistically (the card's log2,
    acos, atan2, sin and cos may round an ulp apart from the CPU's, and an
    ulp can move a texel, a mip level or a sampled direction, so this is
    the flagship's criterion, not the per-pixel one); on the card only B3
    may launch."""
    import torch
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    w, h = ENVTEX_SMALL
    st = ir.RenderSettings(w, h, spp=ENVTEX_SMALL_SPP, max_depth=64,
                           integrator="mis", tonemap="agx")
    imgs = {}
    for d in (torch.device("cpu"), dev):
        scene = envtex_scene(d, w, h)
        zero_counts()
        imgs[d.type], secs = timed(lambda: render_frame(scene, st))
    nz = {k: v for k, v in read_counts().items() if v}
    r = compare(f"envtex {w}x{h}@{st.spp} mis card vs cpu", imgs["cpu"],
                imgs["cuda"])
    log(f"      card {secs:.3f} s, launches {nz}")
    if not (imgs["cuda"].is_cuda and r["mean"] < FLAG_MEAN
            and r["corr"] > FLAG_CORR):
        fail("envtex: card differs from the CPU")
    if set(nz) != {"cluster_wide"}:
        fail(f"envtex small frame: launches {nz}, expected only B3")


# ---------------------------------------------------------------------------
# phases 20-22: the probe kernels P12-P31, through their probes' entry
# points at the probes' own sizes, then against their plain versions
# ---------------------------------------------------------------------------

def held(label, out, ref, close=None):
    """Log and check a kernel output against its plain version: bit for
    bit, or within ``close(out, ref)`` (a tolerance the caller names)."""
    bad = bits_differ(out, ref)
    err = float((out.double() - ref.double()).abs().max())
    ok = bad == 0 if close is None else bool(close(out, ref))
    log(f"    {label}: {bad} of {out.numel()} outputs differ in bits from "
        f"plain (max |d| {err:g})")
    if not ok:
        fail(f"{label}: kernel differs from its plain version")
    return err


def vpu_probe_phase(dev):
    """Phase 20 (B-1): P12-P15 and P20 through probe_prims, probe_vpu2,
    probe_vpu3 and probe_r2c.vpu_rate at the probes' sizes (probe_prims at
    ITERS = 200,000), one block and the full card, separate and fused;
    each against its plain version (probe_prims at 2,000 steps)."""
    import torch
    from vimg_tpu_torch.probes import (common, probe_prims, probe_r2c,
                                       probe_vpu2, probe_vpu3)
    log("[20] B-1: P12 (prims), P13 (fma), P14 (mix), P15 (vpu3), P20 "
        "(vpu_rate) at the probes' sizes, one block and the full card; "
        "records:")
    plog = common.Log(dev)
    zero_counts()
    for prim in probe_prims.PRIMS:
        probe_prims.run(prim, dev, log=plog)
    runs = {}
    for dtype in ("f32", "bf16"):
        runs[("fma", dtype)] = probe_vpu2.fma_throughput(dtype, dev, log=plog)
        runs[("mix", dtype)] = probe_vpu2.mix_throughput(dtype, dev, log=plog)
        runs[("rate", dtype)] = probe_r2c.vpu_rate(dtype, dev, log=plog)
    for form in probe_vpu3.FORMS:
        runs[("vpu3", form)] = probe_vpu3.run(form, dev, log=plog)
    log(f"    probe launches {probe_counts()}")
    tab = probe_prims.table(dev)
    init = torch.zeros(probe_prims.SHAPE, dtype=torch.float32, device=dev)
    n = PRIMS_PLAIN_ITERS
    errs, prim_ms = [], {}
    for prim in probe_prims.PRIMS:
        for n_rep in (1, 4):
            ref, pms = event_ms(lambda: probe_prims.prims_plain(
                tab, init, prim, n_rep, n), 1)
            for n_blocks in (1, 0):
                (out, blocks), ms = event_ms(lambda: probe_prims.prims(
                    tab, init, prim, n_rep, n, n_blocks), 1)
                errs.append(held(f"prims {prim} x{n_rep} at {n} steps, "
                                 f"{blocks} blocks", out, ref))
                if n_blocks:
                    prim_ms[(prim, n_rep)] = (ms, pms)
    plains = {"fma": probe_vpu2.fma_plain, "mix": probe_vpu2.mix_plain,
              "rate": probe_r2c.rate_plain, "vpu3": probe_vpu3.vpu3_plain}
    plain_ms = {}
    for (kind, arg), (x, res) in runs.items():
        for fused in (False, True):
            ref, plain_ms[(kind, arg, fused)] = event_ms(
                lambda: plains[kind](x, arg, fused), 1)
            form = "fused" if fused else "separate"
            for card in (False, True):
                out, _, blocks = res[(fused, card)]
                errs.append(held(f"{kind} {arg} {form}, {blocks} blocks",
                                 out, ref))
    ms, pms = prim_ms[("vec22", 4)]
    shape_bytes = 2 * 4096 * 4
    lat = "latency probe: a dependent chain on one block"
    return [
        probe_row("probe_prims", "tools/probe_prims.py:73", ms, pms,
                  n * 4 * 22 * 2048, (1024 + 2 * 2048) * 4, max(errs),
                  clock="events",
                  note=f"vec22 x4 at {n} steps (the plain version's size); "
                       + lat),
        probe_row("probe_fma", "tools/probe_vpu2.py:59",
                  runs[("fma", "f32")][1][(False, False)][1],
                  plain_ms[("fma", "f32", False)],
                  2 * 8 * 300 * 4096 + 15 * 4096, shape_bytes,
                  note="f32 separate, one block"),
        probe_row("probe_mix", "tools/probe_vpu2.py:91",
                  runs[("mix", "f32")][1][(False, False)][1],
                  plain_ms[("mix", "f32", False)], 10 * 200 * 4096,
                  shape_bytes, note="f32 separate, one block; " + lat),
        probe_row("probe_vpu3", "tools/probe_vpu3.py:55",
                  runs[("vpu3", probe_vpu3.FORMS[0])][1][(False, False)][1],
                  plain_ms[("vpu3", probe_vpu3.FORMS[0], False)],
                  10 * 200 * 4096, shape_bytes, peak=2 * FP32_OPS_PER_S,
                  note="f32cmp+bf16where separate, one block (bf16 pairs at "
                       "twice the FP32 rate); " + lat),
        probe_row("probe_vpu_rate", "tools/probe_r2c.py:203",
                  runs[("rate", "f32")][1][(False, False)][1],
                  plain_ms[("rate", "f32", False)], 4 * 2000 * 4096,
                  shape_bytes, note="f32 separate, one block; " + lat)]


def gather_probe_phase(dev):
    """Phase 21 (B-2): P16-P19, P21, P22 through probe_r2c and probe_r4j
    at the probes' sizes, each against its plain version; P19 and P22
    beside their library calls."""
    import torch
    from vimg_tpu_torch.probes import common, probe_r2c as r, probe_r4j as j
    log("[21] B-2: P16 (take), P17 (onehot), P18 (selchain), P19 "
        "(mxu_precision), P21/P22 (probe_r4j) at the probes' sizes; "
        "records:")
    plog = common.Log(dev)
    zero_counts()
    take = {n: r.gather_take(n, dev, plog) for n in r.TAKE_N}
    onehot = {n: r.gather_onehot(n, dev, plog) for n in r.ONEHOT_N}
    sel = {n: r.gather_selchain(n, dev, plog) for n in r.SELCHAIN_N}
    a, b, mm = r.mxu_precision(dev, plog)
    r4j = {n: j.run(n, device=dev, log=plog) for n in j.N_MATS}
    log(f"    probe launches {probe_counts()}")
    errs, pms = {}, {}
    for name, runs, plain in (("take", take, r.take_plain),
                              ("onehot", onehot, r.onehot_plain),
                              ("selchain", sel, r.selchain_plain)):
        for n, (tab, idx, out, _) in runs.items():
            ref, pms[(name, n)] = event_ms(lambda: plain(tab, idx), 1)
            errs[(name, n)] = held(f"{name} n={n}", out, ref)
    for form, (out, _) in mm.items():
        ref, pms[("mm", form)] = event_ms(
            lambda: r.matmul_plain(a, b, form), 1)
        tool, ratio = r.matmul_errors(a, b, out, form)
        gate = r.matmul_held(a, b, out, form)
        log(f"    mxu_precision {form}: |out - plain| / (2 K 2^-24 "
            f"(|A~||B~|)) max {gate:.6f} (the gate); logged only: "
            f"|out - float64| / (2 K u (|A||B|)) max {ratio:.6f}, the "
            f"tool's metric {tool:.3e}")
        errs[("mm", form)] = held(f"mxu_precision {form}", out, ref,
                                  close=lambda o, p: gate <= 1.0)
    def library_mm(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return common.device_ms(lambda: torch.matmul(a, b),
                                    TIMED_LAUNCHES)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def p19_tf32():
        return common.device_ms(lambda: r.matmul(a, b, "default"),
                                TIMED_LAUNCHES)

    # P19's TF32 kernel and torch.matmul TF32 in turns (A B B A)
    turns = [p19_tf32(), library_mm(True), library_mm(True), p19_tf32()]
    p19_ms = (turns[0] + turns[3]) / 2
    lib = {True: (turns[1] + turns[2]) / 2, False: library_mm(False)}
    log(f"    torch.matmul 256x256 (device time): TF32 {lib[True]:.6f} ms, "
        f"float32 {lib[False]:.6f} ms")
    log(f"    P19 TF32 kernel {p19_ms:.6f} ms vs torch.matmul TF32 "
        f"{lib[True]:.6f} ms ({p19_ms / lib[True]:.3f}x; device time, in "
        f"turns: {', '.join(f'{t:.6f}' for t in turns)} ms); highest "
        f"{mm['highest'][1]:.6f} ms vs torch.matmul float32 "
        f"{lib[False]:.6f} ms")
    for n, res in r4j.items():
        table, ids, hi, mid, lo = res["inputs"]
        errs[("check", n)] = held(f"lookup check n_mats={n}", res["check"][0],
                                  j.check_plain(ids, hi, mid, lo))
        if not torch.equal(res["check"][0], table[:, ids[0].long()]):
            fail(f"P22 n_mats {n}: not table[:, ids]")
        ref, pms[("mxu", n)] = event_ms(
            lambda: j.mxu_plain(ids, hi, mid, lo), 1)
        errs[("mxu", n)] = held(f"lookup mxu n_mats={n}", res["mxu"][0], ref)
        if "chain" in res:
            ref, pms[("chain", n)] = event_ms(
                lambda: j.chain_plain(ids, hi, n), 1)
            errs[("chain", n)] = held(f"lookup chain n_mats={n}",
                                      res["chain"][0], ref)
    table, ids, hi, mid, lo = r4j[512]["inputs"]
    _, check_pms = event_ms(lambda: j.check_plain(ids, hi, mid, lo), 1)
    row_ids = ids[0].long()
    # P22 and its library call, each as device time (launches queued
    # behind a spinning kernel) and as the host-paced rate of back-to-back
    # calls (CUDA events alone, the measure of earlier runs)
    def check():
        return j.lookup_check(ids, hi, mid, lo)

    def library():
        return torch.index_select(table, 1, row_ids)

    check_ms = common.device_ms(check, TIMED_LAUNCHES)
    check_lib = common.device_ms(library, TIMED_LAUNCHES)
    _, check_paced = event_ms(check, TIMED_LAUNCHES)
    _, lib_paced = event_ms(library, TIMED_LAUNCHES)
    log(f"    P22 (lookup check, n_mats 512): device {check_ms:.6f} ms, "
        f"torch.index_select on the float32 table {check_lib:.6f} ms "
        f"({check_ms / check_lib:.3f}x); host-paced {check_paced:.6f} / "
        f"{lib_paced:.6f} ms")
    tab2048, idx2048 = take[2048][0], take[2048][1]
    lanes = torch.arange(128, device=dev)
    touched = torch.unique(((idx2048.long()[None] + torch.arange(
        r.TAKE_REPS, device=dev)[:, None, None]) % 2048) * 128 + lanes)
    kpad = -(-512 // 16) * 16
    mxu_ops = j.REPS * j.ROWS * 3 * 2 * 32 * kpad * 128
    # P22 reads its 128 ids, the hi/mid/lo columns they name and writes
    # (ppad, 128) float32; it needs two adds an output
    ppad, n_cols = hi.shape[0], int(torch.unique(row_ids).numel())
    check_bytes = 128 * 4 + 3 * ppad * n_cols * 2 + ppad * 128 * 4
    lat = "latency probe at 4,096 lanes"
    return [
        probe_row("probe_take", "tools/probe_r2c.py:79", take[2048][3],
                  pms[("take", 2048)], 3 * r.TAKE_REPS * 4096,
                  2 * 4096 * 4 + touched.numel() * 4,
                  note="n = 2,048; " + lat),
        probe_row("probe_onehot", "tools/probe_r2c.py:115", onehot[2048][3],
                  pms[("onehot", 2048)], r.ONEHOT_REPS * 2 * 4096 * 2048 * 4,
                  2 * 4096 * 4 + 2048 * 4 * 4, peak=BF16_TC_OPS_PER_S,
                  note="n = 2,048; the dense one-hot product at the bf16 "
                       "tensor-core rate"),
        probe_row("probe_selchain", "tools/probe_r2c.py:142", sel[256][3],
                  pms[("selchain", 256)], r.SELCHAIN_REPS * 2 * 256 * 4096,
                  2 * 4096 * 4 + 256 * 4, note="n = 256"),
        probe_row("probe_mxu_precision", "tools/probe_r2c.py:170",
                  p19_ms, pms[("mm", "default")], 2 * 256 ** 3,
                  3 * 256 * 256 * 4,
                  err=errs[("mm", "default")], peak=TF32_TC_OPS_PER_S,
                  library_ms=lib[True],
                  note=f"default (TF32); highest (float32 FMA) "
                       f"{mm['highest'][1]:.6f} ms beside torch.matmul "
                       f"float32 {lib[False]:.6f} ms"),
        probe_row("probe_lookup", "tools/probe_r4j.py:94",
                  r4j[512]["mxu"][1], pms[("mxu", 512)], mxu_ops,
                  ids.numel() * 4 * 2 + 3 * 32 * 512 * 2,
                  peak=BF16_TC_OPS_PER_S,
                  note=f"mxu, n_mats 512, reps {j.REPS}; chain n_mats 48 "
                       f"{r4j[48]['chain'][1]:.6f} ms"),
        probe_row("probe_lookup_check", "tools/probe_r4j.py:115", check_ms,
                  check_pms, 2 * ppad * 128, check_bytes,
                  library_ms=check_lib,
                  note=f"n_mats 512, {n_cols} distinct ids; library: "
                       f"torch.index_select on the float32 table")]


def lowering_probe_phase(dev):
    """Phase 22 (B-3): P23-P31 through probe_pallas.run (its throughput
    body at the probe's 131,072 lanes and on the full card) and
    probe_constructs.run; every check's verdict must hold, and each kernel
    is held to its plain version."""
    import torch
    from vimg_tpu_torch.probes import common, probe_constructs as pc
    from vimg_tpu_torch.probes import probe_pallas as pp
    log("[22] B-3: P23-P28 (probe_pallas), P29-P31 (probe_constructs); "
        "records:")
    plog = common.Log(dev)
    zero_counts()
    res = pp.run(dev, log=plog)
    (aabbs, tris, rays), con = pc.run(dev, plog)
    log(f"    probe launches {probe_counts()}")
    if not all(rec["ok"] for rec in plog.records):
        fail("a probe_pallas / probe_constructs check failed")
    x_w = torch.full(pp.TILE, 0.5, dtype=torch.float32, device=dev)
    tbl, x_t = pp.scalars_table(dev), pp.transc_input(dev)
    exact = pp.transc_exact(x_t)
    plains = {"grid+blocked-output": lambda: pp.grid_plain(dev),
              "while_loop": lambda: pp.while_plain(x_w),
              "pcg4d": lambda: pp.pcg_plain(dev),
              "smem-scalars": lambda: pp.scalars_plain(tbl),
              "transcendentals": lambda: pp.transc_plain(x_t)}
    errs, pms = {}, {}
    for name, plain in plains.items():
        ref, pms[name] = event_ms(plain, 1)
        close = None
        if name == "transcendentals":      # the probe's gate, for both
            def close(o, p):
                return bool((((o.double() - exact).abs()
                              <= 1e-4 * exact.abs())
                             & ((p.double() - exact).abs()
                                <= 1e-4 * exact.abs())).all())
        errs[name] = held(f"{name}", res[name][0], ref, close)
    ref, pms["throughput"] = event_ms(lambda: pp.throughput_plain(dev), 1)
    for card, (out, ms, blocks) in res["throughput"].items():
        errs[("throughput", card)] = held(
            f"throughput, {blocks} blocks", out, ref)
    for which, (out, _) in con.items():
        ref, pms[which] = event_ms(lambda: pc.constructs_plain(
            aabbs, tris, rays, which), 1)
        errs[which] = held(f"constructs k{which}", out, ref)
    steps = 0
    v = x_w.clone()
    while bool(v.max() < 100.0) and steps < 1000:
        v = v * pp.F(1.1) + pp.F(0.01)
        steps += 1
    tile = 1024 * 4
    lanes = pp.TP_SHAPE[0] * 128
    lat = "launch-latency probe"

    def row(name, line, key, ops, nbytes, note=lat):
        return probe_row(name, f"tools/probe_pallas.py:{line}", res[key][1],
                         pms[key], ops, nbytes, errs[key], note=note)
    rows = [
        row("probe_grid", 54, "grid+blocked-output", 32 * 256 * 2,
            32 * 256 * 4),
        row("probe_while", 81, "while_loop", 1024 * 3 * steps, 2 * tile,
            note=f"{steps} steps; latency probe"),
        row("probe_pcg", 100, "pcg4d", 1024 * 45, tile),
        row("probe_scalars", 125, "smem-scalars", 1024 * 6, 96 + tile),
        row("probe_transcendental", 145, "transcendentals", 1024 * 13,
            2 * tile, note="rtol 1e-4 of float64 (the probe's gate); "
            "each function counted as one operation; " + lat),
        probe_row("probe_throughput", "tools/probe_pallas.py:188",
                  res["throughput"][False][1], pms["throughput"],
                  lanes * pp.TP_ITERS * 28, lanes * 4,
                  errs[("throughput", False)],
                  note=f"the probe's {lanes} lanes; full card "
                       f"{res['throughput'][True][1]:.6f} ms on "
                       f"{res['throughput'][True][2]} blocks; 28 operations "
                       f"a step (sqrt and divide one each)")]
    for which, line, ops in ((1, 39, 8 * 1024 * 2), (2, 55, 8 * 1024 * 3),
                             (3, 79, 8 * 1024 * 2 + 8 * 1024 * 2)):
        nbytes = 256 + (0 if which == 1 else 8 * 512) + 2 * tile
        rows.append(probe_row(f"probe_k{which}",
                              f"tools/probe_constructs.py:{line}",
                              con[which][1], pms[which], ops, nbytes,
                              errs[which], note=lat))
    return rows


# ---------------------------------------------------------------------------
# phases 23-26: kernel X2 and the scene-file front door (main paths 11-13)
# ---------------------------------------------------------------------------

def light_rays(scene):
    """N_RAYS each of rays for many_lights_scene, whose ground quad is a
    sliver (ROADMAP C23), so camera rays seldom hit: camera rays (512x256
    @ 1 spp), cosine-bounce rays from points of the ground plane y = 0,
    and shadow rays from the same points toward a sampled point of a
    random light sphere (finite maxT)."""
    import torch
    from vimg_tpu_torch.core import rng
    from vimg_tpu_torch.core.math import normalize
    from vimg_tpu_torch.core.rng import Draw
    from vimg_tpu_torch.core.warps import sample_hemisphere_cosine
    from vimg_tpu_torch.render.integrators import MIN_T, _primary_rays
    from vimg_tpu_torch.scene import ir
    dev = scene.device
    st = ir.RenderSettings(MESH_W, MESH_H, spp=1, integrator="mis")
    pix = torch.arange(N_RAYS, device=dev)
    samp = torch.zeros_like(pix)
    ro, rd, _, _ = _primary_rays(scene, st, pix, samp)
    u = rng.uniform4(pix, samp, 1, Draw.BSDF_SAMPLE)
    org = torch.stack([28.0 * u[0] - 14.0, torch.zeros_like(u[0]),
                       28.0 * u[1] - 14.0], -1)
    # the hemisphere about +y: local z -> world y
    w = sample_hemisphere_cosine(u[2], u[3])
    up = torch.stack([w[:, 0], w[:, 2], w[:, 1]], -1)
    k = (rng.uniform1(pix, samp, 1, Draw.LIGHT_PICK)
         * scene.n_spheres()).long().clamp_max(scene.n_spheres() - 1)
    tgt = scene.sph_center[k] + normalize(up) * scene.sph_radius[k][:, None]
    to = tgt - org
    dist = to.norm(dim=-1)
    mn = torch.full((N_RAYS,), MIN_T, device=dev)
    inf = torch.full((N_RAYS,), float("inf"), device=dev)
    return {"camera": (ro.contiguous(), rd.contiguous(), mn, inf),
            "bounce": (org.contiguous(), up.contiguous(), mn, inf),
            "shadow": (org.contiguous(), (to / dist[:, None]).contiguous(),
                       mn, (dist - 1e-4).contiguous())}


def x2_bound(st, nbytes):
    """Kernel X2's bound from the plain walk's counts ``st``: the larger
    of ``nbytes`` at the card's memory rate and the tests' float32
    operations at its peak rate."""
    from vimg_tpu_torch.geometry import bvh
    ops = (st.get("box_tests", 0) * bvh.BOX_TEST_OPS
           + st.get("tri_tests", 0) * bvh.TRI_TEST_OPS
           + st.get("sphere_tests", 0) * bvh.SPHERE_TEST_OPS)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def x2_differ(got, ref, mode):
    """Values that differ in any bit between two of X2's returns in
    ``mode`` (closest, occluded, cost), and max |d| of the finite floats."""
    import torch
    if mode == "occluded":
        return int((got != ref).sum()), 0.0
    (gh, gc), (rh, rc) = ((got, None), (ref, None)) \
        if mode == "closest" else (got, ref)
    outs = [(getattr(gh, f), getattr(rh, f)) for f in
            ("t", "prim_type", "prim_id", "u", "v")]
    if gc is not None:
        outs.append((gc, rc))
    bad, err = 0, 0.0
    for a, b in outs:
        if a.dtype == torch.float32:
            bad += int((a.view(torch.int32) != b.view(torch.int32)).sum())
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                err = max(err, float((a[fin] - b[fin]).abs().max()))
        else:
            bad += int((a != b).sum())
    return bad, err


def x2_steps(label, scene, tr, r, mode, got):
    """X2's warp node and leaf steps (one counted launch of ``mode``, not
    timed), held equal to the replay of its schedule, whose hits must be
    X2's; its leaf lane fill; the replayed steps of the per-lane first
    design beside them."""
    import torch
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import bvh_schedule as bs
    kw = dict(any_hit=mode == "occluded", count_cost=mode == "cost")
    steps = torch.zeros(2, dtype=torch.int64, device=r[0].device)
    counted = bvh.bvh_trace(scene, tr.bvh, *r, steps=steps, **kw)
    node, leaf = (int(x) for x in steps.cpu())
    nodes, rows = bvh.packed_tables(scene, tr.bvh)
    replay, warp = bs.warp_schedule(nodes, rows, *r, **kw)
    _, lane = bs.lane_schedule(nodes, rows, *r, **kw)
    bad = x2_differ(counted, got, mode)[0] + x2_differ(replay, got, mode)[0]
    if bad or (warp["node_steps"], warp["leaf_steps"]) != (node, leaf):
        fail(f"X2 {label} {mode}: counted launch steps {node}, {leaf} "
             f"against the replay's {warp['node_steps']}, "
             f"{warp['leaf_steps']}; {bad} values differ")
    fill = warp["prim_tests"] / max(32 * leaf, 1)
    lane_fill = lane["prim_tests"] / max(32 * lane["leaf_steps"], 1)
    return dict(node_steps=node, leaf_steps=leaf, fill=fill,
                lane_node_steps=lane["node_steps"],
                lane_leaf_steps=lane["leaf_steps"], lane_fill=lane_fill)


def x2_vs_plain(label, scene, rays, builder="auto"):
    """X2 against bvh_traverse on one scene and tree, each ray kind in the
    three modes (closest, any hit, cost), bit for bit; X2 timed with CUDA
    events (TIMED_LAUNCHES launches), the plain walk once; the bound of
    each; the warp steps of a counted launch against the replays
    (x2_steps)."""
    import torch
    from vimg_tpu_torch.geometry import bvh
    t0 = time.time()
    tr = bvh.BVHTracer(scene, builder=builder)
    build_s = time.time() - t0
    # the bound's bytes: the tables as the plain walk reads them (the same
    # count as the first design's row, so that old and new rows compare)
    tables = sum(x.numel() * x.element_size() for x in (
        *(getattr(tr.bvh, f) for f in ("node_min", "node_max", "node_start",
                                       "node_count", "node_skip",
                                       "prim_type", "prim_idx")),
        scene.verts, scene.tri_vidx, scene.sph_center, scene.sph_radius))
    t0 = time.time()
    packed = bvh.packed_tables(scene, tr.bvh)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    packed_bytes = sum(x.numel() * x.element_size() for x in packed)
    log(f"  {label} ({builder} tree): {scene.n_tris()} triangles, "
        f"{scene.n_spheres()} spheres, {tr.bvh.n_nodes} BVH nodes, tables "
        f"{tables / 1e6:.2f} MB, packed {packed_bytes / 1e6:.2f} MB (nodes "
        f"{packed[0].numel() * 4 / 1e6:.2f} MB, rows "
        f"{packed[1].numel() * 4 / 1e6:.2f} MB); host build {build_s:.2f}s, "
        f"pack {pack_s:.3f}s")
    res, err = {}, 0.0
    for kind, r in rays.items():
        for mode in ("closest", "occluded", "cost"):
            kw = dict(any_hit=mode == "occluded", count_cost=mode == "cost")

            def kern():
                return bvh.bvh_trace(scene, tr.bvh, *r, **kw)
            got = kern()
            torch.cuda.synchronize()
            kern()
            _, ms = event_ms(kern, TIMED_LAUNCHES)
            st = {}
            ref, plain_ms = event_ms(lambda: bvh.bvh_traverse(
                scene, tr.bvh, *r, stats=st, **kw), 1)
            bad, e = x2_differ(got, ref, mode)
            err = max(err, e)
            if mode == "occluded":
                summary = f"occluded {int(got.sum())}/{N_RAYS}"
            else:
                gh, gc = (got, None) if mode == "closest" else got
                summary = (f"hits {int(gh.hit.sum())}/{N_RAYS} (spheres "
                           f"{int((gh.prim_type == 1).sum())})")
                if gc is not None:
                    summary += f", mean cost {float(gc.mean()):.3f}"
            nbytes = N_RAYS * 48 + tables
            bound, by = x2_bound(st, nbytes)
            res[(kind, mode)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by, mismatches=bad,
                                     packed_bytes=packed_bytes, **st)
            log(f"    X2 {kind:6s} {mode:8s}: {summary}; kernel vs plain "
                f"mismatches {bad}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.1f} ms; {st.get('box_tests', 0)} box + "
                f"{st.get('tri_tests', 0)} tri + "
                f"{st.get('sphere_tests', 0)} sphere tests -> bound "
                f"{bound:.4f} ms ({by}; tables {tables / 1e6:.2f} MB, packed "
                f"{packed_bytes / 1e6:.2f} MB); {ms / bound:.1f}x the bound")
            if bad:
                fail(f"X2 {label} {kind} {mode}: {bad} mismatches")
            w = x2_steps(label, scene, tr, r, mode, got)
            res[(kind, mode)].update(w)
            log(f"      warp steps node {w['node_steps']} leaf "
                f"{w['leaf_steps']} (equal to the replay of its schedule), "
                f"leaf lane fill {w['fill']:.4f}; the per-lane first "
                f"design, replayed: node {w['lane_node_steps']} leaf "
                f"{w['lane_leaf_steps']}, fill {w['lane_fill']:.4f}")
    return res, err, tr


# X2 against B3: B3 tests the host's plane rows and X2 the watertight
# test, so t, u, v differ in their low bits (grazing rays most), and a ray
# through an edge may take either triangle (both t within EDGE_REL of
# each other) or, at the mesh's silhouette, hit in one and miss in the
# other. At most EDGE_SHARE of the rays may differ, and only so.
EDGE_REL, EDGE_SHARE = 1e-3, 1e-3


def x2_against_b3(scene, rays, tr):
    """X2's closest hits against B3's on terrain 100k: the same prim id on
    every ray but at edges (counted and printed)."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    b3 = ct.ClusterTracer(scene, walk="wide")
    for kind in ("camera", "bounce"):
        r = rays[kind]
        a, b = tr.closest(scene, *r), b3.closest(scene, *r)
        diff = a.prim_id != b.prim_id
        hit_diff = a.hit != b.hit
        fin = a.hit & b.hit
        rel = (a.t - b.t).abs() / b.t.abs().clamp_min(1e-30)
        ties = int((diff & fin & (a.t == b.t)).sum())
        near = int((diff & fin & (a.t != b.t) & (rel <= EDGE_REL)).sum())
        n_diff, n_hm = int((diff | hit_diff).sum()), int(hit_diff.sum())
        dt = float(rel[fin].max()) if bool(fin.any()) else 0.0
        log(f"    X2 vs B3 {kind}: prim ids differ on {n_diff} of {N_RAYS} "
            f"rays: {ties} exact ties in t, {near} other edge ties (t within "
            f"{EDGE_REL:g} relative), {n_hm} hit in one and missed in the "
            f"other; max relative |dt| over rays both hit {dt:.3g}")
        if n_diff != ties + near + n_hm or n_diff > EDGE_SHARE * N_RAYS:
            fail(f"X2 vs B3 {kind}: closest hits differ beyond edges")
        if not torch.equal(a.prim_type, b.prim_type):
            fail(f"X2 vs B3 {kind}: prim types differ")


def x2_phase(terrain, terrain_rays_, dev):
    """Phase 23: X2 against its plain version on terrain 100k (phase 6's
    rays; binned- and sweep-SAH trees) and on many_lights_scene; X2
    against B3 on terrain 100k; X2's registers, spills and resident warps
    in each mode."""
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.runtime import cuda
    from vimg_tpu_torch.scene.synthetic import many_lights_scene
    log("[23] X2 (the BVH walk) vs its plain version, "
        f"{N_RAYS} rays a kind, three modes")
    for m, mode in enumerate(("closest", "any hit", "cost")):
        occ = bvh.occupancy(m)
        log(f"    X2 {mode}: {occ['regs']} registers, {occ['local_bytes']} B "
            f"local memory a thread, {occ['blocks_per_sm']} blocks = "
            f"{occ['warps_per_sm']} resident warps per SM; ptxas: "
            + " | ".join(cuda.ptxas_lines(cuda.BUILD_INFO["log"],
                                          f"bvh_walk_kernelILi{m}ELb0E")))
    res_t, err_t, tr = x2_vs_plain("terrain 100k", terrain, terrain_rays_)
    x2_against_b3(terrain, terrain_rays_, tr)
    res_s, err_s, _ = x2_vs_plain("terrain 100k", terrain, terrain_rays_,
                                  builder="sweep")
    lights = many_lights_scene(256, MESH_W, MESH_H, device=dev)
    res_l, err_l, _ = x2_vs_plain("many_lights_scene", lights,
                                  light_rays(lights))
    return res_t, res_l, max(err_t, err_s, err_l)


FRONT_SPHERES = 128
FRONT_BUMPY_TRIS = 20_000
FRONT_TERRAIN_TRIS = 100_000
HEATMAP_FACTOR, HEATMAP_SPP = 4.0, 4
DEBUG_PIXEL = (256, 128)
# -d on the card against the CPU: a path of the pixel's 64 may take
# another direction where an ulp of the card's sin / cos / log moves a
# sample, so the CPU's value is held within a share of itself
DEBUG_REL, DEBUG_ABS = 0.02, 1e-4


def write_obj(path, verts, tris):
    with open(path, "w") as f:
        f.write("".join(f"v {a!r} {b!r} {c!r}\n"
                        for a, b, c in verts.tolist()))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n"
                        for a, b, c in tris.tolist()))


def sky_image(h=64, w=128):
    """textured_terrain_scene's sky: a gradient and a sun disk."""
    import numpy as np
    th = (np.arange(h) + 0.5) / h * np.pi
    ph = (np.arange(w) + 0.5) / w * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    sky = np.stack([0.3 + 0.3 * np.cos(tt), 0.45 + 0.3 * np.cos(tt),
                    0.8 + 0.15 * np.cos(tt)], -1)
    d2 = (tt - np.pi * 0.3) ** 2 + (pp - np.pi * 0.35) ** 2
    sun = np.exp(-d2 / 0.004)[..., None] * np.array([400.0, 380.0, 330.0])
    return (sky + sun).astype(np.float32)


def write_mitsuba(d, terrain):
    """Main path 11's Mitsuba scene in directory d: terrain 100k as .obj, a
    20k-triangle bumpy sphere (smooth normals) as .serialized, 128 spheres
    over eight Lambertian and Principled materials, a rectangle area
    emitter and a 64x128 .hdr env map; 512x256 @ 64 spp, path, depth 64."""
    import numpy as np
    from vimg_tpu_torch.scene.images import write_hdr
    from vimg_tpu_torch.scene.serialized import write_serialized
    from vimg_tpu_torch.scene.synthetic import bumpy_sphere_mesh
    write_obj(os.path.join(d, "terrain.obj"), *terrain)
    v, t = bumpy_sphere_mesh(FRONT_BUMPY_TRIS, 1)
    p = v[t]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, t[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    write_serialized(os.path.join(d, "bumpy.serialized"), v, t, normals=n)
    write_hdr(os.path.join(d, "sky.hdr"), sky_image())
    rs = np.random.RandomState(13)
    shapes = []
    for k in range(FRONT_SPHERES):
        m = k % 8
        if k < 8 and m < 4:
            bsdf = (f'<bsdf type="diffuse" id="m{m}"><rgb name="reflectance"'
                    f' value="{0.2 + 0.2 * m}, 0.5, {0.8 - 0.15 * m}"/></bsdf>')
        elif k < 8:
            bsdf = (f'<bsdf type="principled" id="m{m}"><rgb name='
                    f'"base_color" value="0.9, {0.2 * (m - 3)}, 0.3"/>'
                    f'<float name="roughness" value="{0.1 + 0.2 * (m - 4)}"/>'
                    f'<float name="metallic" value="{0.3 * (m - 4)}"/></bsdf>')
        else:
            bsdf = f'<ref id="m{m}"/>'
        x, z = rs.uniform(-3.5, 3.5, 2)
        shapes.append(f'<shape type="sphere"><point name="center" x="{x}" '
                      f'y="{1.0 + 0.8 * rs.rand()}" z="{z}"/><float '
                      f'name="radius" value="{0.05 + 0.1 * rs.rand()}"/>'
                      f'{bsdf}</shape>')
    xml = f"""<scene version="2.0.0">
  <integrator type="path"><integer name="max_depth" value="64"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/><string name="fov_axis" value="y"/>
    <transform name="to_world">
      <lookat origin="0, 2.2, 4.6" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="{MESH_SPP}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="{MESH_W}"/><integer name="height" value="{MESH_H}"/></film>
  </sensor>
  <emitter type="envmap"><string name="filename" value="sky.hdr"/></emitter>
  <shape type="obj"><string name="filename" value="terrain.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.55, 0.5, 0.42"/></bsdf>
  </shape>
  <shape type="serialized"><string name="filename" value="bumpy.serialized"/>
    <transform name="to_world"><scale value="0.6"/><translate y="1.2"/></transform>
    <bsdf type="principled"><rgb name="base_color" value="0.7, 0.6, 0.5"/>
      <float name="roughness" value="0.4"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><scale value="1.2"/><rotate x="1" angle="90"/><translate y="4"/></transform>
    <emitter type="area"><rgb name="radiance" value="14, 13.5, 12"/></emitter>
  </shape>
  {chr(10).join(shapes)}
</scene>
"""
    path = os.path.join(d, "front.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


def write_mesh_json(d):
    """Main path 13's JSON scene: terrain.obj (written by write_mitsuba) as
    a "mesh" surface under a quad light; 512x256 @ 64 spp, MIS, depth 64."""
    cfg = {
        "camera": {"transform": {"from": [0, 2.2, 4.6], "at": [0, 0, 0],
                                 "up": [0, 1, 0]},
                   "resolution": [MESH_W, MESH_H], "vfov": 45},
        "sampler": {"samples": MESH_SPP, "depth": 64},
        "integrator": {"type": "mis"},
        "materials": [{"name": "ground", "type": "lambertian",
                       "albedo": [0.55, 0.5, 0.42]},
                      {"name": "light", "type": "diffuse_light",
                       "albedo": [14, 13.5, 12]}],
        "surfaces": [
            {"type": "mesh", "mat_name": "ground", "filename": "terrain.obj"},
            {"type": "quad", "mat_name": "light",
             "transform": [{"scale": 1.2},
                           {"rotate": [0.7071068, 0, 0, 0.7071068]},
                           {"translate": [0, 4, 0]}]}]}
    path = os.path.join(d, "mesh.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def write_glb(d, terrain):
    """Main path 12's glTF: terrain 100k with planar UVs and three 256^2
    PNG textures (base colour, normal, metal-rough; film.write_png), an
    emissive quad, a perspective camera (aspect 2), and its companion JSON
    (spp 64, yres 256, MIS, depth 64, a constant sky)."""
    import numpy as np
    from vimg_tpu_torch.render import film
    v, t = terrain
    rs = np.random.RandomState(17)
    yy, xx = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    checker = ((xx // 16 + yy // 16) % 2).astype(np.float32)
    noise = rs.rand(256, 256).astype(np.float32)
    base = np.stack([0.2 + 0.5 * checker + 0.1 * noise,
                     0.35 + 0.25 * (1 - checker), 0.25 + 0.15 * noise], -1)
    bump = np.stack([0.5 + 0.2 * np.sin(xx / 9.0), 0.5 + 0.2 * np.cos(
        yy / 7.0), np.ones_like(noise)], -1)
    mr = np.stack([np.zeros_like(noise), 0.2 + 0.6 * noise, 0.8 * checker],
                  -1)
    pngs = []
    for k, img in enumerate((base, bump, mr)):
        path = os.path.join(d, f"tex{k}.png")
        film.write_png(path, img)
        with open(path, "rb") as f:
            pngs.append(f.read())
    ext = v[:, [0, 2]]
    uv = ((ext - ext.min(0)) / np.maximum(np.ptp(ext, 0), 1e-6) * 6.0).astype(
        np.float32)
    quad = np.array([[-1.2, 4, -1.2], [1.2, 4, -1.2], [1.2, 4, 1.2],
                     [-1.2, 4, 1.2]], np.float32)
    blob, views = bytearray(), []

    def view(data):
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=len(data)))
        blob.extend(data)
        return len(views) - 1
    acc = [dict(bufferView=view(v.tobytes()), componentType=5126,
                count=len(v), type="VEC3"),
           dict(bufferView=view(uv.tobytes()), componentType=5126,
                count=len(v), type="VEC2"),
           dict(bufferView=view(t.astype(np.uint32).tobytes()),
                componentType=5125, count=t.size, type="SCALAR"),
           dict(bufferView=view(quad.tobytes()), componentType=5126, count=4,
                type="VEC3"),
           dict(bufferView=view(np.array([0, 1, 2, 0, 2, 3], np.uint32)
                                .tobytes()),
                componentType=5125, count=6, type="SCALAR")]
    images_ = [dict(bufferView=view(b), mimeType="image/png") for b in pngs]
    blob.extend(b"\0" * (-len(blob) % 4))
    half = -0.5 * np.arctan2(2.2, 4.6)        # pitch down at the origin
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0},
                  {"camera": 0, "translation": [0, 2.2, 4.6],
                   "rotation": [float(np.sin(half)), 0, 0,
                                float(np.cos(half))]}],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": float(np.radians(45.0)), "aspectRatio": MESH_W / MESH_H,
            "znear": 0.01}}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2,
             "material": 0},
            {"attributes": {"POSITION": 3}, "indices": 4, "material": 1}]}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 2}},
             "normalTexture": {"index": 1, "scale": 1.0}},
            {"emissiveFactor": [1.0, 0.96, 0.86], "extensions": {
                "KHR_materials_emissive_strength":
                    {"emissiveStrength": 14.0}}}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": images_, "accessors": acc, "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    glb = os.path.join(d, "terrain.glb")
    with open(glb, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    comp = os.path.join(d, "terrain_glb.json")
    with open(comp, "w") as f:
        json.dump({"spp": MESH_SPP, "yres": MESH_H, "integrator": "mis",
                   "depth": 64, "background": [0.25, 0.3, 0.38]}, f)
    return glb, comp


class Captured:
    """Records what ``module.name`` returns while the context is open (the
    CLI imports the render functions at each call, so it calls this)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            import torch
            torch.cuda.synchronize()
            t0 = time.time()
            out = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((out, time.time() - t0))
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def cli_run(argv):
    """cli.main(argv) with its standard output kept: (rc, text)."""
    import contextlib
    import io
    from vimg_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def cli_frame(label, argv, png, allowed):
    """Drive a CLI render with every count set to 0 just before and read
    just after: the linear frame render_frame returned, its seconds, the
    launches; only kernels in ``allowed`` may launch (each at least
    once); the PNG written is read back."""
    import numpy as np
    from vimg_tpu_torch.render import render, wavefront
    from vimg_tpu_torch.scene.images import decode_png
    zero_counts()
    with Captured(render, "render_frame") as cap:
        rc, out = cli_run(argv + ["-o", png])
    counts = read_counts()
    nz = {k: v for k, v in counts.items() if v}
    if rc != 0 or len(cap.calls) != 1:
        fail(f"{label}: the CLI returned {rc} after {len(cap.calls)} frames")
    img, secs = cap.calls[0]
    if set(nz) != set(allowed):
        fail(f"{label}: launches {nz}, expected {sorted(allowed)}")
    with open(png, "rb") as f:
        px = decode_png(f.read())
    img_np = img.cpu().numpy()
    if (img_np.shape != (MESH_H, MESH_W, 3) or not np.isfinite(img_np).all()
            or px.shape != (MESH_H, MESH_W, 3) or px.max() == 0):
        fail(f"{label}: image {img_np.shape} / PNG {px.shape} / non-finite")
    stats = wavefront.LAST_STATS
    paths = MESH_W * MESH_H * MESH_SPP
    log(f"    {label}: {MESH_W}x{MESH_H} @ {MESH_SPP} spp, {secs:.3f} s "
        f"(render loop {stats['seconds']:.3f} s), {paths / secs / 1e6:.3f} "
        f"Mpaths/s, {(stats['segments'] + stats['shadow_rays']) / secs / 1e6:.2f}"
        f" Mrays/s ({stats['segments']} segments + {stats['shadow_rays']} "
        f"shadow rays), {stats['supersteps']} supersteps "
        f"({1e3 * stats['seconds'] / stats['supersteps']:.2f} ms a "
        f"superstep), launches {nz}; PNG mean {px.mean():.2f}")
    for line in out.splitlines():
        if line.startswith(("Scene loaded", "note:")):
            log(f"      cli: {line}")
    return img, secs, nz


def one_spp_check(label, scene, st, kt, pt):
    """The frame at 1 spp through the kernel's tracer ``kt`` and through
    its plain twin ``pt`` (the wavefront): per pixel, equal ray counts.
    Returns the plain frame."""
    from vimg_tpu_torch.render import wavefront
    st1 = dataclasses.replace(st, spp=1)
    (img_k, sk), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=kt, return_stats=True))
    (img_p, sp), _ = timed(lambda: wavefront.render_wavefront(
        scene, st1, tracer=pt, return_stats=True))
    r = compare(f"{label} {st.width}x{st.height}@1 kernel vs plain walk",
                img_p, img_k)
    log(f"    kernel {sk['seconds']:.2f}s, plain walk {sp['seconds']:.2f}s; "
        f"segments {sk['segments']} / {sp['segments']}, shadow rays "
        f"{sk['shadow_rays']} / {sp['shadow_rays']}, supersteps "
        f"{sk['supersteps']} / {sp['supersteps']}")
    if not (r["mean"] < WF_MEAN and r["corr"] > WF_CORR):
        fail(f"{label}: 1-spp kernel vs plain walk per pixel")
    if (sk["segments"], sk["shadow_rays"]) != (sp["segments"],
                                               sp["shadow_rays"]):
        fail(f"{label}: 1-spp ray counts differ")
    return img_p


def mitsuba_main_path(files, png_dir, dev):
    """Phase 24, main path 11: the Mitsuba scene through the CLI: the
    wavefront (the env map makes the megakernel refuse it) over the BVH
    tracer (128 spheres), X2 only; first the 1-spp frame through X2 and
    through its plain walk."""
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.render.mega import supports_megakernel
    from vimg_tpu_torch.scene.mitsuba_loader import load_mitsuba_scene
    t0 = time.time()
    scene, st = load_mitsuba_scene(files["xml"], device=dev)
    log(f"    scene: {scene.n_tris()} triangles, {scene.n_spheres()} "
        f"spheres, {scene.n_mats()} materials, {scene.n_lights()} lights, "
        f"env {tuple(scene.env_mips[0].shape[:2])}; {st}; load "
        f"{time.time() - t0:.2f}s")
    if supports_megakernel(scene, st):
        fail("main path 11: the megakernel would take this frame")
    kt = make_tracer(scene)
    if not isinstance(kt, bvh.BVHTracer):
        fail(f"main path 11: make_tracer gave {type(kt).__name__}")
    plain = one_spp_check("main path 11", scene, st, kt,
                               bvh.BVHTracer(scene, plain=True))
    png = os.path.join(png_dir, "front_mitsuba.png")
    img, secs, nz = cli_frame("main path 11", ["-f", files["xml"], "--spp",
                                               str(MESH_SPP)], png,
                              {"bvh_walk"})
    check_mean(f"main path 11 {MESH_SPP} spp vs plain 1 spp", img, plain)
    return nz["bvh_walk"]


def gltf_main_path(files, png_dir, dev):
    """Phase 25, main path 12: the GLB and its companion JSON through the
    CLI: the wavefront with textures and ray cones over B3 only; first the
    1-spp frame through B3 and through its plain walk."""
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.scene.gltf_loader import load_gltf_scene
    t0 = time.time()
    scene, st = load_gltf_scene(files["glb"], files["glb_json"], device=dev)
    log(f"    scene: {scene.n_tris()} triangles, {scene.n_mats()} materials, "
        f"{scene.n_lights()} lights, atlas {scene.atlas.shape[0]} texels, "
        f"normal maps {scene.has_normal_maps}, cones {scene.needs_cones}; "
        f"{st}; load {time.time() - t0:.2f}s")
    if (st.width, st.height, st.spp) != (MESH_W, MESH_H, MESH_SPP):
        fail(f"main path 12: settings {st}")
    data = ct.ClusterData(scene)
    kt = ct.ClusterTracer(scene, data=data)
    if kt.walk != "wide":
        fail(f"main path 12: the default walk is {kt.walk}, not wide")
    plain = one_spp_check("main path 12", scene, st, kt,
                               ct.ClusterTracer(scene, data=data, plain=True))
    png = os.path.join(png_dir, "front_gltf.png")
    img, secs, nz = cli_frame("main path 12", ["-f", files["glb"], "-j",
                                               files["glb_json"]], png,
                              {"cluster_wide"})
    check_mean(f"main path 12 {MESH_SPP} spp vs plain 1 spp", img, plain)
    return nz["cluster_wide"]


def debug_pixel(argv):
    import numpy as np
    rc, out = cli_run(argv)
    vals = {}
    for line in out.splitlines():
        for key in ("linear", "sRGB"):
            if f") {key}:" in line:
                vals[key] = np.array(json.loads(line.split(":", 1)[1]))
    if rc != 0 or len(vals) != 2:
        fail(f"-d {argv}: rc {rc}, output {out[-500:]}")
    return vals


def bvh_flag_main_path(files, png_dir, dev):
    """Phase 26, main path 13: the JSON "mesh" scene through the CLI as it
    is (B3) and with -b 1 (X2 over the sweep-SAH tree): the differing
    pixels and the two means; then -m 4.0 on main path 11's file (the
    heatmap through X2's cost counter) and -d on the card against the
    CPU."""
    import numpy as np
    import torch
    from vimg_tpu_torch.render import heatmap
    from vimg_tpu_torch.scene.images import decode_png
    a, _, nz_a = cli_frame("main path 13 (binned, B3)", ["-f", files["json"]],
                           os.path.join(png_dir, "front_json.png"),
                           {"cluster_wide"})
    b, _, nz_b = cli_frame("main path 13 (-b 1, X2)", ["-f", files["json"],
                                                       "-b", "1"],
                           os.path.join(png_dir, "front_json_sweep.png"),
                           {"bvh_walk"})
    an, bn = a.cpu().numpy(), b.cpu().numpy()
    ma, mb = an.reshape(-1, 3).mean(0), bn.reshape(-1, 3).mean(0)
    differ = int((an != bn).any(-1).sum())
    rel = np.abs(ma - mb) / np.maximum(ma, 1e-12)
    log(f"    -b 0 vs -b 1: {differ} of {MESH_W * MESH_H} pixels differ "
        f"(max |d| {float(np.abs(an - bn).max()):.3g}; B3 tests the host's "
        f"plane rows, X2 the watertight test, so t, u, v differ in their "
        f"last bits); means {ma.tolist()} / {mb.tolist()} (rel "
        f"{rel.tolist()})")
    if not (rel < MAIN_MEAN_REL).all():
        fail("main path 13: the -b 1 frame's mean differs")
    png = os.path.join(png_dir, "front_heatmap.png")
    zero_counts()
    with Captured(heatmap, "render_heatmap") as cap:
        rc, _ = cli_run(["-f", files["xml"], "-m", str(HEATMAP_FACTOR),
                         "-o", png])
    nz_h = {k: v for k, v in read_counts().items() if v}
    img, secs = cap.calls[0]
    with open(png, "rb") as f:
        px = decode_png(f.read())
    log(f"    -m {HEATMAP_FACTOR}: {tuple(img.shape)} heatmap in {secs:.3f} s, "
        f"launches {nz_h}; colours {len(np.unique(px.reshape(-1, 3), axis=0))}"
        f" (turbo(floor(cost / spp) / factor) saturates at 1), PNG mean "
        f"{px.mean():.2f}")
    if (rc != 0 or nz_h != {"bvh_walk": HEATMAP_SPP}
            or tuple(img.shape) != (MESH_H, MESH_W, 3)
            or not bool(torch.isfinite(img).all())):
        fail(f"-m: rc {rc}, launches {nz_h}, shape {tuple(img.shape)}")
    x, y = DEBUG_PIXEL
    zero_counts()
    card = debug_pixel(["-f", files["xml"], "-d", f"{x} {y}"])
    nz_d = {k: v for k, v in read_counts().items() if v}
    cpu = debug_pixel(["-f", files["xml"], "--cpu", "-d", f"{x} {y}"])
    d = np.abs(card["linear"] - cpu["linear"])
    log(f"    -d {x} {y}: card {card['linear'].tolist()} (sRGB "
        f"{card['sRGB'].tolist()}), CPU {cpu['linear'].tolist()}; max |d| "
        f"{float(d.max()):.3g}; card launches {nz_d}")
    if (set(nz_d) != {"bvh_walk"} or not np.isfinite(card["linear"]).all()
            or (d > DEBUG_REL * np.abs(cpu["linear"]) + DEBUG_ABS).any()):
        fail("-d: the card's pixel differs from the CPU's")
    return (nz_a["cluster_wide"], nz_b["bvh_walk"] + nz_h["bvh_walk"]
            + nz_d["bvh_walk"])


def front_door_phases(terrain, terrain_rays_, png_dir, dev):
    """Phases 23-26; returns X2's kernels-JSON row and the launches of B3
    on main paths 12 and 13."""
    from vimg_tpu_torch.scene.synthetic import terrain_mesh
    res_t, res_l, err = x2_phase(terrain, terrain_rays_, dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        mesh = terrain_mesh(FRONT_TERRAIN_TRIS)
        files = {"xml": write_mitsuba(tmp, mesh), "json": write_mesh_json(tmp)}
        files["glb"], files["glb_json"] = write_glb(tmp, mesh)
        log(f"    scene files written in {time.time() - t0:.2f}s: " + ", ".join(
            f"{os.path.basename(p)} {os.path.getsize(p) / 1e6:.1f} MB"
            for p in (*files.values(), os.path.join(tmp, "terrain.obj"),
                      os.path.join(tmp, "bumpy.serialized"))))
        out = png_dir or tmp
        log("[24] main path 11: cli -f front.xml --spp 64 -> "
            "load_mitsuba_scene -> render_frame -> wavefront over X2")
        x2_11 = mitsuba_main_path(files, out, dev)
        log("[25] main path 12: cli -f terrain.glb -j terrain_glb.json -> "
            "load_gltf_scene -> render_frame -> wavefront (textures, cones) "
            "over B3")
        b3_12 = gltf_main_path(files, out, dev)
        log("[26] main path 13: cli -f mesh.json [-b 1 | -m 4.0 | -d]")
        b3_13, x2_13 = bvh_flag_main_path(files, out, dev)
    c = res_t[("bounce", "closest")]
    row = {
        "name": "bvh_walk",
        "route": "cuda",
        "source": "vimg_tpu_torch/csrc/bvh_walk.cu",
        # X2 replaces an XLA loop of vimg_tpu, not a Pallas kernel
        "replaces": "vimg_tpu/geometry/bvh.py:341",
        "launches": x2_11 + x2_13,
        "launches_by_main_path": {"11": x2_11, "13": x2_13},
        "max_abs_err": err,
        "ms": c["ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None,
        "clock": "events",
        **{f"{k}_{m}_ms": res_t[(k, m)]["ms"] for k in ("camera", "shadow")
           for m in ("closest", "occluded")},
        "many_lights_bounce_ms": res_l[("bounce", "closest")]["ms"],
        "many_lights_bound_ms": res_l[("bounce", "closest")]["bound_ms"],
        "packed_bytes": c["packed_bytes"],
        "lane_fill": c["fill"],
        "warp_steps": [c["node_steps"], c["leaf_steps"]]}
    return row, b3_12, b3_13


# ---------------------------------------------------------------------------
# phases 27-33: sample slabs and scale-out (main paths 14-20)
# ---------------------------------------------------------------------------

def ckpt_run(label, scene, st, slab, tracer=None):
    """Main paths 14/15: ``st`` through render_with_checkpoints in slabs of
    ``slab`` spp, stopped at half the samples and resumed (every count set
    to 0 just before the first run and read just after the second), then
    the same slabs uninterrupted into another file. Returns the resumed
    film, the uninterrupted one, the stopped and resumed runs' summed
    slab counts, the launches and the seconds of each run."""
    from vimg_tpu_torch.render.checkpoint import render_with_checkpoints
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.ckpt")
        stats = {}
        zero_counts()
        _, stop_s = timed(lambda: render_with_checkpoints(
            scene, dataclasses.replace(st, spp=st.spp // 2), path,
            slab_spp=slab, tracer=tracer, stats=stats))
        resumed, resume_s = timed(lambda: render_with_checkpoints(
            scene, st, path, slab_spp=slab, tracer=tracer, stats=stats))
        counts = nonzero(read_counts())
        whole, whole_s = timed(lambda: render_with_checkpoints(
            scene, st, os.path.join(tmp, "b.ckpt"), slab_spp=slab,
            tracer=tracer))
    log(f"    {label}: stop at {st.spp // 2} spp {stop_s:.3f} s, resume to "
        f"{st.spp} spp {resume_s:.3f} s ({stats['slabs']} slabs of {slab} "
        f"spp, launches {counts}); uninterrupted slabs {whole_s:.3f} s")
    return resumed, whole, stats, counts, (stop_s, resume_s, whole_s)


def checkpoint_phases(flag_img, terrain, terrain_stats, terrain_img, card):
    """Phases 27/28, main paths 14 and 15; returns the launches of B1 and
    of B3."""
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    dev = terrain.device
    log(f"[27] main path 14: the flagship ({FLAGSHIP_SPP} spp) -> "
        f"render_with_checkpoints in slabs of {CKPT_FLAGSHIP_SLAB} spp "
        f"through B1, stopped at {FLAGSHIP_SPP // 2} and resumed")
    scene, st = load_json_scene(FLAGSHIP, device=dev)
    if st.spp != FLAGSHIP_SPP:
        fail(f"the flagship file asks {st.spp} spp, not {FLAGSHIP_SPP}")
    resumed, whole, stats, counts, secs = ckpt_run(
        "flagship", scene, st, CKPT_FLAGSHIP_SLAB)
    slabs = FLAGSHIP_SPP // CKPT_FLAGSHIP_SLAB
    if counts != {"megakernel_analytic": slabs}:
        fail(f"main path 14: launches {counts}, expected one B1 a slab")
    if not torch.equal(resumed.view(torch.int32), whole.view(torch.int32)):
        fail("main path 14: the resumed film is not the uninterrupted "
             "slabs' film bit for bit")
    d = float((resumed - flag_img).abs().max())
    log(f"    resumed film bit-equal to the uninterrupted slabs'; max |d| "
        f"against main path 1's one-shot frame {d:.3e} (bound "
        f"{CKPT_ONESHOT:g}); on {card}")
    if not d <= CKPT_ONESHOT:
        fail("main path 14: the slab film differs from the one-shot frame")
    b1 = counts.get("megakernel_analytic", 0)

    log(f"[28] main path 15: terrain 100k ({MESH_W}x{MESH_H} @ {MESH_SPP} "
        f"spp MIS) -> render_with_checkpoints in slabs of "
        f"{CKPT_TERRAIN_SLAB} spp through the wavefront and B3, stopped at "
        f"{MESH_SPP // 2} and resumed")
    st = ir.RenderSettings(MESH_W, MESH_H, spp=MESH_SPP, max_depth=64,
                           integrator="mis", tonemap="agx",
                           batch_size=MESH_BATCH)
    tracer = ct.ClusterTracer(terrain)
    resumed, whole, stats, counts, secs = ckpt_run(
        "terrain 100k", terrain, st, CKPT_TERRAIN_SLAB, tracer)
    if set(counts) != {"cluster_wide"}:
        fail(f"main path 15: launches {counts}")
    d = float((resumed - terrain_img).abs().max())
    dw = float((resumed - whole).abs().max())
    log(f"    slab counts {stats['segments']} segments + "
        f"{stats['shadow_rays']} shadow rays; one-shot (main path 2) "
        f"{terrain_stats['segments']} + {terrain_stats['shadow_rays']}; "
        f"max |d| against the one-shot frame {d:.3e} (bound "
        f"{CKPT_ONESHOT:g}), against the uninterrupted slabs {dw:.3e}; on "
        f"{card}")
    if (stats["segments"], stats["shadow_rays"]) != (
            terrain_stats["segments"], terrain_stats["shadow_rays"]):
        fail("main path 15: the slabs' ray counts differ from the one-shot "
             "frame's")
    if not d <= CKPT_ONESHOT:
        fail("main path 15: the slab film differs from the one-shot frame")
    return b1, counts.get("cluster_wide", 0)


def sharded_mega_phase(flag_img, main4, card):
    """Phase 29, main path 16: render_megakernel_sharded over a mesh of
    the one card and over three ranges in turn there, on the flagship (B1)
    and on main path 4's frame (B2), each bit for bit the single launch's;
    returns the launches of B1 and of B2."""
    import torch
    from vimg_tpu_torch.parallel.sharding import make_mesh
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    sc4, st4, _ = main4
    dev = sc4.device
    log("[29] main path 16: render_megakernel_sharded over the card (one "
        "range, then three in turn) on the flagship (B1) and main path 4's "
        "frame (B2)")
    fscene, fst = load_json_scene(FLAGSHIP, device=dev)
    one4 = kernel.render_megakernel(sc4, st4)          # outside the count
    frames = (("flagship", fscene, fst, flag_img), ("main path 4", sc4, st4,
                                                     one4))
    out = {}
    zero_counts()
    for label, sc, st, _ in frames:
        for n in (1, 3):
            out[(label, n)] = timed(lambda: kernel.render_megakernel_sharded(
                sc, st, mesh=make_mesh([dev] * n)))
    counts = nonzero(read_counts())
    for label, sc, st, ref in frames:
        for n in (1, 3):
            img, secs = out[(label, n)]
            same = torch.equal(img.view(torch.int32), ref.view(torch.int32))
            log(f"    {label}, {n} range(s): {secs:.3f} s, bit-equal to the "
                f"single launch: {same}")
            if not same:
                fail(f"main path 16: {label} over {n} range(s) differs")
    log(f"    launches {counts}, on {card}")
    if counts != {"megakernel_analytic": 4, "megakernel_mesh": 4}:
        fail(f"main path 16: launches {counts}")
    return 4, 4


def nccl_group():
    """A one-rank NCCL group on this card (a free localhost port)."""
    import datetime
    import socket
    from vimg_tpu_torch.parallel import distributed
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import torch
    import torch.distributed as dist
    t0 = time.time()
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device="cuda",
                           timeout=datetime.timedelta(seconds=120))
    t1 = time.time()
    # NCCL builds its communicator at the first collective
    dist.all_reduce(torch.ones(1, device="cuda"))
    torch.cuda.synchronize()
    log(f"    process group: {dist.get_backend()}, world "
        f"{dist.get_world_size()}, rank {dist.get_rank()}; joined in "
        f"{t1 - t0:.3f} s, first all-reduce (communicator set-up) "
        f"{time.time() - t1:.3f} s")


def scale_out_phases(terrain, card):
    """Phases 30/31, main paths 17 and 18; returns B3's launches on each."""
    import numpy as np
    import torch
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.parallel import distributed, sharding
    from vimg_tpu_torch.render.render import render
    from vimg_tpu_torch.scene import ir
    dev = terrain.device
    log(f"[30] main path 17: terrain 100k ({MESH_W}x{MESH_H} @ "
        f"{SHARD_SPP} spp MIS) -> render_sharded over the card, against "
        f"render() over the same B3 tracer; render_distributed under a "
        f"one-rank NCCL group")
    st = ir.RenderSettings(MESH_W, MESH_H, spp=SHARD_SPP, max_depth=64,
                           integrator="mis", batch_size=1 << 20)
    tracer = ct.ClusterTracer(terrain)
    mesh = sharding.make_mesh([dev])
    ref, ref_s = timed(lambda: render(terrain, st, tracer=tracer))
    zero_counts()
    img, secs = timed(lambda: sharding.render_sharded(terrain, st, tracer,
                                                      mesh=mesh))
    counts = nonzero(read_counts())
    r = compare("render_sharded vs render()", ref, img)
    log(f"    render_sharded {secs:.3f} s, render() {ref_s:.3f} s; bit-equal "
        f"{torch.equal(img, ref)}; launches {counts}")
    if not (r["mean"] < UNIT_MEAN and r["frac"] < UNIT_FRAC
            and r["corr"] > UNIT_CORR):
        fail("main path 17: render_sharded vs render()")
    if set(counts) != {"cluster_wide"}:
        fail(f"main path 17: launches {counts}")
    b3_17 = counts.get("cluster_wide", 0)
    nccl_group()
    zero_counts()
    stats = {}
    dimg, dsecs = timed(lambda: distributed.render_distributed(
        terrain, st, tracer, stats=stats))
    counts = nonzero(read_counts())
    same = torch.equal(dimg, img)
    log(f"    render_distributed {dsecs:.3f} s (all-reduce "
        f"{stats.get('allreduce_ms', float('nan')):.3f} ms), equal to "
        f"render_sharded: {same}; "
        f"launches {counts}")
    if not same or set(counts) != {"cluster_wide"}:
        fail("main path 17: render_distributed differs from render_sharded")
    b3_17 += counts.get("cluster_wide", 0)
    film = torch.ones((FLAG_H, FLAG_W, 3), device=dev)
    ms = []
    for _ in range(ALLREDUCE_REPS):
        s = {}
        distributed.reduce_films(film.clone(), 1, s)
        ms.append(s.get("allreduce_ms", float("nan")))
    log(f"    all-reduce (NCCL SUM, one rank) of the {FLAG_W}x{FLAG_H} "
        f"film ({film.numel() * 4 / 2 ** 20:.2f} MiB): "
        f"{min(ms):.4f}-{max(ms):.4f} ms over {ALLREDUCE_REPS} calls (CUDA "
        f"events), on {card}")

    log(f"[31] main path 18: main path 10's envtex step ({MESH_W * MESH_H} "
        f"rays, B3) through make_train_step(mesh=global_mesh()) under the "
        f"one-rank NCCL group, against the unsharded step")
    from vimg_tpu_torch.diff import grad
    from vimg_tpu_torch.geometry.trace import make_tracer
    st1 = ir.RenderSettings(MESH_W, MESH_H, spp=1, max_depth=64,
                            integrator="mis")
    scene = envtex_scene(dev)
    start = train_start(scene)
    tracer = make_tracer(start, differentiable=True)
    rays = train_rays(scene, st1, tracer, 0)

    def steps(quiet=False):
        res = {}
        for name, mesh in (("unsharded", None),
                           ("sharded", distributed.global_mesh())):
            step, opt, params = grad.make_train_step(
                start, st1, tracer, bounded_depth=TRAIN_DEPTH,
                integrator="mis", optimizer=train_optimizer(TRAIN_RATES),
                mesh=mesh)
            stats = {}
            zero_counts()
            params, opt, loss = step(params, opt, *rays, stats=stats)
            counts = nonzero(read_counts())
            g = {f"{k}/{i}": t.grad.detach().clone()
                 for k, v in params.items()
                 for i, t in enumerate(v if isinstance(v, tuple) else (v,))}
            res[name] = (loss.detach().clone(), g, counts)
            nan = float("nan")
            if not quiet:
                log(f"    {name}: loss {float(loss):.8g}, forward "
                    f"{stats.get('forward_ms', nan):.1f} ms, backward "
                    f"{stats.get('backward_ms', nan):.1f} ms"
                    + (f", all-reduce {stats['allreduce_ms']:.3f} ms"
                       if "allreduce_ms" in stats else "")
                    + f", launches {counts}")
            if set(counts) != {"cluster_wide"}:
                fail(f"main path 18 ({name}): launches {counts}")
        (l0, g0, _), (l1, g1, c1) = res["unsharded"], res["sharded"]
        differ = sum(int((g0[k].view(torch.int32) != g1[k].view(torch.int32))
                         .sum()) for k in g0)
        same_loss = torch.equal(l0.view(torch.int32), l1.view(torch.int32))
        return same_loss, differ, sum(g.numel() for g in g0.values()), \
            g0, g1, c1

    same_loss, differ, total, g0, g1, c1 = steps()
    if not same_loss:
        fail("main path 18: the sharded loss differs from the unsharded")
    log(f"    loss bit-equal; gradients: {differ} of {total} elements differ "
        f"in their bits (the backward's atomic adds order freely)")
    grads_agree("sharded vs unsharded step gradients",
                {k: v.cpu().double() for k, v in g1.items()},
                {k: v.cpu().double() for k, v in g0.items()})
    # both steps again under deterministic algorithms (the backward's
    # scatter-adds then sum in a fixed order): loss and gradients bit for
    # bit; the ops without a deterministic form are named
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            same_loss, differ, total, _, _, _ = steps(quiet=True)
        finally:
            torch.use_deterministic_algorithms(False)
    notes = sorted({str(w.message).splitlines()[0][:160] for w in caught
                    if "deterministic" in str(w.message)})
    log(f"    deterministic algorithms: loss bit-equal {same_loss}; "
        f"gradients: {differ} of {total} elements differ in their bits; "
        f"{len(notes)} ops without a deterministic form"
        + "".join(f"\n      {n}" for n in notes))
    if not same_loss or differ:
        fail("main path 18: under deterministic algorithms the sharded "
             "step's loss or gradients differ from the unsharded in bits")
    import torch.distributed as dist
    dist.destroy_process_group()
    return b3_17, c1.get("cluster_wide", 0)


def trace_phase(main5_stats, card, dev):
    """Phase 32, main path 19: the CLI on main path 13's JSON with
    --trace; the trace must name B3's kernel. Then walk_roofline on main
    path 5's B2 counts. Returns B3's launches."""
    from vimg_tpu_torch.scene.synthetic import terrain_mesh
    from vimg_tpu_torch.utils.profiling import FP32_FLOPS_PER_S, walk_roofline
    log("[32] main path 19: cli -f mesh.json --trace DIR (a warm render, "
        "then the traced one) through B3")
    with tempfile.TemporaryDirectory() as tmp:
        write_obj(os.path.join(tmp, "terrain.obj"),
                  *terrain_mesh(FRONT_TERRAIN_TRIS))
        path = write_mesh_json(tmp)
        zero_counts()
        (rc, out), secs = timed(lambda: cli_run(
            ["-f", path, "--trace", os.path.join(tmp, "tr"),
             "-o", os.path.join(tmp, "t.png")]))
        counts = nonzero(read_counts())
        trace = os.path.join(tmp, "tr", "trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        named = False
        if size:
            with open(trace) as f:
                named = B3_SYMBOL in f.read()
    for line in out.splitlines():
        if line.startswith(("Render took", "Device trace")):
            log(f"      cli: {line}")
    log(f"    rc {rc}, {secs:.2f} s (both renders and the export), trace "
        f"{size / 2 ** 20:.1f} MiB, names {B3_SYMBOL}: {named}; launches "
        f"{counts}")
    if rc != 0 or not named or set(counts) != {"cluster_wide"}:
        fail("main path 19: no trace naming B3's kernel")
    roof = walk_roofline(main5_stats, main5_stats["seconds"])
    log(f"    walk_roofline of main path 5's B2 launch "
        f"({main5_stats['seconds'] * 1e3:.3f} ms): "
        + ", ".join(f"{k} {v:.6g}" for k, v in roof.items())
        + f" (peak {FP32_FLOPS_PER_S:.3g} flop/s float32, the H100 SXM "
        f"data sheet's at 700 W; this card: {card})")
    return counts.get("cluster_wide", 0)


def prepass_phase(terrain, card):
    """Phase 33, main path 20: terrain 100k at 512x256 @ 64 spp through
    render_frame with VIMG_PREPASS=1, beside the same frame without it;
    returns B3's launches on the pre-pass frame."""
    import numpy as np
    import torch
    from vimg_tpu_torch.render import wavefront
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene import ir
    log(f"[33] main path 20: terrain 100k -> render_frame ({MESH_W}x"
        f"{MESH_H} @ {MESH_SPP} spp) with VIMG_PREPASS=1 (the primary "
        f"pre-pass) beside the same frame without it")
    st = ir.RenderSettings(MESH_W, MESH_H, spp=MESH_SPP, max_depth=64,
                           integrator="mis", tonemap="agx",
                           batch_size=MESH_BATCH)
    total = MESH_W * MESH_H * MESH_SPP
    res = {}
    for on in (False, True):
        if on:
            os.environ["VIMG_PREPASS"] = "1"
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            img, secs = timed(lambda: render_frame(terrain, st))
            counts = nonzero(read_counts())
            peak = torch.cuda.max_memory_allocated()
        finally:
            os.environ.pop("VIMG_PREPASS", None)
        stats = dict(wavefront.LAST_STATS)
        res[on] = (img, stats, counts)
        log(f"    pre-pass {'on ' if on else 'off'}: {secs:.3f} s (render "
            f"{stats['seconds']:.3f} s, pre-pass "
            f"{stats['prepass_seconds']:.3f} s), {stats['supersteps']} "
            f"supersteps, {stats['segments']} segments + "
            f"{stats['shadow_rays']} shadow rays, peak memory "
            f"{peak / 2 ** 20:.1f} MiB, launches {counts}")
        if set(counts) != {"cluster_wide"}:
            fail(f"main path 20: launches {counts}")
    (a, sa, _), (b, sb, cb) = res[False], res[True]
    log(f"    the table: {total} paths x 64 B = "
        f"{total * 64 / 2 ** 20:.1f} MiB (PREPASS_MAX_TOTAL "
        f"{wavefront.PREPASS_MAX_TOTAL}); on {card}")
    if not sb["prepass_seconds"] > 0 or sa["prepass_seconds"] != 0:
        fail("main path 20: the pre-pass did not engage")
    if sb["supersteps"] != sa["supersteps"] or abs(
            sb["segments"] - sa["segments"]) > 1e-3 * sa["segments"]:
        fail("main path 20: supersteps or segments differ")
    on, off = b.cpu().numpy(), a.cpu().numpy()
    d = np.abs(on - off)
    frac = float((d.max(-1) > 1e-5).mean())
    corr = float(np.corrcoef(on.ravel(), off.ravel())[0, 1])
    log(f"    pre-pass vs plain frame: mean |d| {d.mean():.3e}, pixels above "
        f"1e-5 {100 * frac:.3f}%, corr {corr:.6f}, max |d| {d.max():.3e}")
    if not (np.isfinite(on).all() and d.mean() < 1e-4 and frac < 0.01
            and corr > 0.999):
        fail("main path 20: the pre-pass frame misses the parity bounds")
    return cb.get("cluster_wide", 0)


# ---------------------------------------------------------------------------
# phases 34-36: the device BVH build (X3), the mxu tracer, the diagnosis
# hooks (main paths 21-25)
# ---------------------------------------------------------------------------

X3_TERRAINS = (100_000, 500_000)
MXU_TRIS, MXU_SPHERES = 2_000, 128
ABLATE_LANES, ABLATE_STEPS, ABLATE_REPEATS = 1 << 17, 20, 3
# X3's bytes a position: seg_s and the six box floats read, seg_cost and
# seg_j written (each once)
X3_BYTES_PER_POS = 4 + 24 + 8


def sweep_differ(got, ref):
    """Slots where two (seg_cost, seg_j) of X3 differ: seg_cost's bits
    (any NaN as NaN) or seg_j."""
    import torch
    a, b = got[0], ref[0]
    nan = torch.isnan(a) & torch.isnan(b)
    bad = (torch.where(nan, 0.0, a).view(torch.int32)
           != torch.where(nan, 0.0, b).view(torch.int32)) | (got[1] != ref[1])
    return int(bad.sum())


X3_KERNELS = ("sah_sweep_coop",)


def profiled_us(fn, reps, names, sessions=3):
    """Each named kernel's device microseconds a call of ``fn``, mean over
    ``reps`` calls, from torch.profiler's CUDA activity (the kernels' own
    durations, whatever the host's pace); None for a kernel the profiler
    did not see. Also the names of the other kernels it saw. A session
    that saw none of the named kernels (CUPTI then returned no activity at
    all) is profiled again, up to ``sessions`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(names, 0.0)
        others = []
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            mine = [name for name in names if name in e.key]
            for name in mine:
                us[name] += t
            if t > 0 and not mine:
                others.append(e.key)
        if others or any(v > 0 for v in us.values()):
            break
    return {k: (v / reps if v > 0 else None) for k, v in us.items()}, others


def x3_timing(label, inputs):
    """X3 on one level's inputs: ms a call on the device's clock
    (probes.common.device_ms: TIMED_LAUNCHES calls queued behind a spinning
    kernel), ms a call paced by the host (CUDA events around calls queued
    one after another), its kernel's own device us (torch.profiler, which
    must see no other kernel), and its plain version (one call, events),
    with the bound (bytes) and the launch's plan. Returns (device ms, plain
    ms, bound ms, host-paced ms, {kernel: us}, plan)."""
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.probes import common
    P = inputs[0].shape[0]
    got, host_ms = event_ms(lambda: db.sah_sweep(*inputs), TIMED_LAUNCHES)
    ms = common.device_ms(lambda: db.sah_sweep(*inputs), TIMED_LAUNCHES)
    kus, others = profiled_us(lambda: db.sah_sweep(*inputs), TIMED_LAUNCHES,
                              X3_KERNELS)
    ref, plain_ms = event_ms(lambda: db.sah_sweep_plain(*inputs), 1)
    bad = sweep_differ(got, ref)
    if bad:
        fail(f"X3 {label}: {bad} slots differ from the plain version")
    if others or None in kus.values():
        fail(f"X3 {label}: the profiler saw {others} beside {kus}")
    plan = db.sweep_plan(P, inputs[0].device)
    bound = 1e3 * X3_BYTES_PER_POS * P / HBM_BYTES_PER_S
    segs = int((inputs[0][1:] != inputs[0][:-1]).sum()) + 1
    log(f"    X3 {label} (P = {P}, {segs} segments): {ms:.4f} ms a call on "
        f"the device's clock, {host_ms:.4f} ms paced by the host; kernel "
        + ", ".join(f"{k} {v:.2f} us" for k, v in kus.items())
        + f" (profiler, no other kernel); plain {plain_ms:.3f} ms, bound "
        f"{bound:.5f} ms (bytes: {X3_BYTES_PER_POS} B a position at 3.35 "
        f"TB/s); plan: grid {plan['grid']}, {plan['tile_chunks']} chunk(s) "
        f"a tile, {plan['smem_bytes']} B shared (0: not staged), "
        f"{plan['per_sm']} blocks / SM, {plan['regs']} registers")
    return ms, plain_ms, bound, host_ms, kus, plan


def x3_look_back(plan, levels):
    """The look-back steps a tile of X3's launch, in each direction, on
    the given levels' inputs: geometry/sweep_schedule.py's replay at the
    launch's tile (its plan), checked bit for bit against the plain
    version on the CPU. Returns {level: {"pre": [max, mean], "suf": ...}}."""
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.geometry import sweep_schedule as ss
    out = {}
    for level, inputs in levels.items():
        seg, lo, hi = (x.cpu() for x in inputs)
        cost, j, st = ss.replay(seg, lo, hi, plan["tile_chunks"] * ss.CHUNK)
        if sweep_differ((cost, j), db.sah_sweep_plain(seg, lo, hi)):
            fail(f"X3's replay differs from the plain version at level "
                 f"{level}")
        out[level] = {d: [int(st[f"steps_{d}"].max()),
                          float(st[f"steps_{d}"].float().mean())]
                      for d in ("pre", "suf")}
        log(f"    X3's look-back (replay, {st['n_tiles']} tiles of "
            f"{plan['tile_chunks']} chunk(s), {ss.WIDTH} tiles a step), "
            f"level {level}: steps a tile from the left max "
            f"{out[level]['pre'][0]} mean {out[level]['pre'][1]:.3f}, from "
            f"the right max {out[level]['suf'][0]} mean "
            f"{out[level]['suf'][1]:.3f}; {st['atomics']} key atomics")
    return out


def device_build_phase(phase6, card):
    """Phase 34, main paths 21 and 22: BVHTracer(builder="device") on
    terrain 100k and 500k (X3 and tensor code on the card) with its level
    loop and host assembly timed apart, the tree against the plain build of
    the same inputs on the CPU (bit for bit) and against the native sweep
    (a finding: SAH costs when they differ), X3 against its plain version
    on every level's inputs of the 100k build and timed; then one X2 walk
    over the 100k device tree and ClusterTracer(builder="device") through
    B3, each against its plain walk. Returns X3's kernels-JSON row and the
    X2 and B3 launches of the two main paths."""
    import numpy as np
    import torch
    from vimg_tpu_torch.geometry import bvh
    from vimg_tpu_torch.geometry import cluster_trace as ct
    from vimg_tpu_torch.geometry import device_build as db
    from vimg_tpu_torch.runtime import cuda
    from vimg_tpu_torch.runtime.native import build_bvh_native
    log("[34] main paths 21, 22: BVHTracer(builder='device') on terrain "
        f"{' and '.join(str(n) for n in X3_TERRAINS)} (X3), X2 and B3 over "
        "the device trees")
    row, x3_21, x3_22 = {}, 0, 0
    for n in X3_TERRAINS:
        scene = phase6[n][0]
        bmin, bmax, cen, _, _ = bvh.scene_prim_bounds(scene)
        zero_counts()
        (tr, build_s) = timed(lambda: bvh.BVHTracer(scene, builder="device"))
        st = dict(db.LAST_STATS)
        counts = read_counts()
        x3_21 += counts["sah_sweep"]
        if counts["sah_sweep"] != 3 * st["levels"] or any(
                v for k, v in counts.items() if k != "sah_sweep"):
            fail(f"main path 21 (terrain {n}) launches {nonzero(counts)}, "
                 f"{st['levels']} levels")
        log(f"    terrain {n}: P = {st['P']}, {st['levels']} levels of "
            f"{st['max_levels']}, {st['nodes']} nodes; BVHTracer "
            f"{build_s:.3f} s (level loop on the card "
            f"{st['level_seconds']:.3f} s, host assembly "
            f"{st['assembly_seconds']:.3f} s); X3 launches "
            f"{counts['sah_sweep']} (3 x levels)")
        # the level loop again, keeping each sweep's inputs; the same loop
        # on the CPU (plain): the tree is assembled from (order, levels),
        # so equal tables mean equal trees
        mid = []

        def capture(seg, lo, hi):
            mid.append((seg, lo, hi))
            return db.sah_sweep(seg, lo, hi)
        t = [torch.as_tensor(x, device=scene.device)
             for x in (bmin, bmax, cen)]
        max_levels = db.max_levels_for(st["P"])
        (order, hist, _), loop_s = timed(
            lambda: db.build_levels(*t, max_levels, sweep=capture))
        (p_order, p_hist, _), cpu_s = timed(lambda: db.build_levels(
            *(x.cpu() for x in t), max_levels, sweep=db.sah_sweep_plain))
        if not (torch.equal(order.cpu(), p_order)
                and torch.equal(hist.cpu(), p_hist)
                and torch.equal(tr.bvh.prim_idx.long(), order)):
            fail(f"terrain {n}: the card's device build differs from the "
                 f"CPU's plain build or from BVHTracer's tree")
        got = {k: getattr(tr.bvh, k).cpu().numpy() for k in (
            "node_min", "node_max", "node_start", "node_count", "node_skip")}
        nat, nat_s = timed(lambda: build_bvh_native(bmin, bmax, cen, mode=1))
        same = (np.array_equal(order.cpu().numpy(), nat["order"]) and all(
            np.array_equal(got[k], nat[k]) for k in
            ("node_count", "node_start", "node_skip")))
        log(f"    terrain {n}: the level loop alone {loop_s:.3f} s on the "
            f"card, bit for bit the plain loop on the CPU ({cpu_s:.3f} s) "
            f"and BVHTracer's order; native sweep (mode 1) {nat_s:.3f} s, "
            + ("the same tree" if same else
               f"another tree: SAH cost device {db.sah_cost(got):.6f}, "
               f"native {db.sah_cost(nat):.6f} ({nat['node_count'].shape[0]}"
               f" nodes)"))
        if hist.shape[0] != st["levels"]:
            fail("the level loop ran another number of levels")
        inputs = mid[3 * (len(mid) // 6)]       # the middle level, axis 0
        ms, plain_ms, bound, host_ms, kus, plan = x3_timing(
            f"terrain {n} level {len(mid) // 6}", inputs)
        ms0, _, _, _, kus0, _ = x3_timing(f"terrain {n} level 0", mid[0])
        if n == X3_TERRAINS[0]:
            steps = x3_look_back(plan, {0: mid[0],
                                        len(mid) // 6: inputs})
            checked = []

            def both(seg, lo, hi):
                out = db.sah_sweep(seg, lo, hi)
                checked.append(sweep_differ(out,
                                            db.sah_sweep_plain(seg, lo, hi)))
                return out
            db.build_levels(*t, db.max_levels_for(st["P"]), sweep=both)
            if any(checked) or len(checked) != 3 * st["levels"]:
                fail(f"X3 differs from its plain version on "
                     f"{sum(1 for c in checked if c)} of {len(checked)} "
                     f"level inputs")
            log(f"    X3 bit for bit its plain version on all "
                f"{len(checked)} level inputs (3 axes x {st['levels']} "
                f"levels) of the 100k build")
            row = {"name": "sah_sweep", "route": "cuda",
                   "source": "vimg_tpu_torch/csrc/sah_sweep.cu",
                   # X3 replaces XLA scans of vimg_tpu, not a Pallas kernel
                   "replaces": "vimg_tpu/geometry/device_build.py:92",
                   "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": "bytes",
                   "library_ms": None, "clock": "device",
                   "host_paced_ms": host_ms, "kernel_us": kus,
                   "ms_level0": ms0, "kernel_us_level0": kus0,
                   "plan": plan, "look_back_steps": steps,
                   "ptxas": cuda.ptxas_lines(cuda.BUILD_INFO["log"],
                                             "sah_sweep"),
                   "launches_per_build": {}, "build_s": {}}
            walk_tr, rays = tr, phase6[n][1]
        else:
            row.update(ms_500k=ms, plain_ms_500k=plain_ms,
                       bound_ms_500k=bound, host_paced_ms_500k=host_ms,
                       kernel_us_500k=kus, ms_level0_500k=ms0,
                       kernel_us_level0_500k=kus0, plan_500k=plan)
        row["launches_per_build"][str(n)] = 3 * st["levels"]
        row["build_s"][str(n)] = dict(
            level_loop=st["level_seconds"], assembly=st["assembly_seconds"],
            native=nat_s, cpu_plain_loop=cpu_s, levels=st["levels"],
            nodes=st["nodes"])
    # main path 21's walk: X2 over the 100k device tree
    scene = phase6[X3_TERRAINS[0]][0]
    zero_counts()
    got = walk_tr.closest(scene, *rays["bounce"])
    x2_21 = read_counts()["bvh_walk"]
    bad, _ = x2_differ(got, bvh.bvh_traverse(scene, walk_tr.bvh,
                                             *rays["bounce"]), "closest")
    if bad or x2_21 != 1:
        fail(f"X2 over the device tree: {bad} values differ from the plain "
             f"walk, {x2_21} launches")
    log(f"    main path 21: X2 over the 100k device tree, {N_RAYS} bounce "
        f"rays, bit for bit its plain walk (hits "
        f"{float(got.hit.float().mean()):.4f})")
    # main path 22: ClusterTracer(builder="device") through B3
    zero_counts()
    ctr = ct.ClusterTracer(scene, builder="device")
    levels_22 = db.LAST_STATS["levels"]
    for kind in ("camera", "bounce", "shadow"):
        r = sorted_rays(ctr, rays[kind])
        got = ctr.trace(*r, kind == "shadow", sort=False)
        counts = read_counts()
        ref = ct.ClusterTracer(scene, plain=True, data=ctr.data).trace(
            *r, kind == "shadow", sort=False)
        bad, _ = mismatches(got, ref)
        if bad:
            fail(f"B3 over the device tree, {kind}: {bad} rays differ")
    x3_22 = counts["sah_sweep"]
    b3_22 = counts["cluster_wide"]
    if x3_22 != 3 * levels_22 or b3_22 != 3 or ctr.walk != "wide" or any(
            v for k, v in counts.items()
            if k not in ("sah_sweep", "cluster_wide")):
        fail(f"main path 22 launches {nonzero(counts)} (walk {ctr.walk}, "
             f"{levels_22} levels)")
    log(f"    main path 22: ClusterTracer(builder='device') on terrain 100k "
        f"({ctr.data.n_clusters} clusters, {ctr.walk} walk): B3 bit for bit"
        f" its plain walk on camera, bounce and shadow rays; launches "
        f"{nonzero(counts)} (X3: 3 x {levels_22} levels)")
    row.update(launches=x3_21 + x3_22,
               launches_by_main_path={"21": x3_21, "22": x3_22})
    return row, x2_21, b3_22


def mxu_scene(dev):
    """A soup of MXU_TRIS random triangles and MXU_SPHERES spheres."""
    import numpy as np
    from vimg_tpu_torch.scene import ir
    from vimg_tpu_torch.scene.json_loader import SceneBuilder
    b = SceneBuilder()
    m = b.add_material(ir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    r = np.random.default_rng(0)
    c = r.uniform(-10, 10, (MXU_TRIS, 3)).astype(np.float32)
    v = (c[:, None] + r.uniform(-0.8, 0.8, (MXU_TRIS, 3, 3))).astype(
        np.float32)
    b.add_mesh(v.reshape(-1, 3), np.arange(3 * MXU_TRIS).reshape(-1, 3), m)
    for _ in range(MXU_SPHERES):
        b.add_sphere(r.uniform(-10, 10, 3), r.uniform(0.2, 1.5), m)
    return b.build(camera=dict(cam2world=np.eye(4, dtype=np.float32),
                               width=8, height=8, vfov_deg=45.0), device=dev)


def mxu_phase(dev):
    """Phase 35, main path 23: make_tracer(force="mxu") (tensor code, no
    kernel) on MXU_TRIS triangles and MXU_SPHERES spheres, N_RAYS rays,
    against the SoA tracer on the card at tests/test_fast_tracers.py's
    tolerances; both timed."""
    import warnings
    import numpy as np
    import torch
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    from vimg_tpu_torch.geometry.trace import make_tracer
    log(f"[35] main path 23: make_tracer(force='mxu') on {MXU_TRIS} "
        f"triangles and {MXU_SPHERES} spheres, {N_RAYS} rays, against the "
        "SoA tracer")
    scene = mxu_scene(dev)
    r = np.random.default_rng(1)
    tgt = np.concatenate([scene.verts.cpu().numpy()[
        scene.tri_vidx.cpu().numpy()].mean(1),
        scene.sph_center.cpu().numpy()])
    ro = r.uniform(-15, 15, (N_RAYS, 3)).astype(np.float32)
    rd = tgt[r.integers(0, tgt.shape[0], N_RAYS)] + r.normal(
        0, 0.5, (N_RAYS, 3)) - ro
    rd[::4] = r.normal(size=(N_RAYS // 4, 3))        # a quarter at random
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    ro, rd = (torch.as_tensor(x, device=dev) for x in (ro, rd))
    mn = torch.full((N_RAYS,), 1e-4, device=dev)
    mx = torch.full((N_RAYS,), float("inf"), device=dev)
    ten = torch.full((N_RAYS,), 10.0, device=dev)
    zero_counts()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = make_tracer(scene, force="mxu")
    got, mxu_s = timed(lambda: tr.closest(scene, ro, rd, mn, mx))
    occ = tr.occluded(scene, ro, rd, mn, ten)
    counts = read_counts()
    if any(counts.values()):
        fail(f"main path 23 launched {nonzero(counts)}")
    soa = SoATracer(scene)
    ref, soa_s = timed(lambda: soa.closest(scene, ro, rd, mn, mx))
    t1, t2 = ref.t.cpu().numpy(), got.t.cpu().numpy()
    both = np.isfinite(t1) & np.isfinite(t2)
    tri = both & (ref.prim_type.cpu().numpy() == 0)
    hit_agree = float((np.isfinite(t1) == np.isfinite(t2)).mean())
    id_agree = float((ref.prim_id.cpu().numpy()[both]
                      == got.prim_id.cpu().numpy()[both]).mean())
    occ_agree = float((soa.occluded(scene, ro, rd, mn, ten).cpu().numpy()
                       == occ.cpu().numpy()).mean())
    t_err = float(np.abs(t1[both] - t2[both]).max())
    u_err = float(np.abs(ref.u.cpu().numpy()[tri]
                         - got.u.cpu().numpy()[tri]).max())
    log(f"    warning: {[str(x.message) for x in w]}")
    log(f"    hits {both.mean():.4f}, hit agreement {hit_agree:.6f}, prim id "
        f"{id_agree:.6f}, occlusion {occ_agree:.6f}, max|dt| {t_err:.3e}, "
        f"max|du| {u_err:.3e}; mxu {mxu_s * 1e3:.1f} ms, SoA "
        f"{soa_s * 1e3:.1f} ms (host clock, one call each); launches 0")
    if not (len(w) == 1 and hit_agree > 0.999 and id_agree > 0.999
            and occ_agree > 0.999 and both.mean() > 0.2
            and np.allclose(t1[both], t2[both], rtol=1e-3, atol=1e-3)
            and u_err <= 2e-3):
        fail("the mxu tracer is outside tests/test_fast_tracers.py's "
             "tolerances of the SoA tracer")


def ablate_phase(t100, card):
    """Phase 36, main paths 24 and 25: probes/ablate_superstep.py on
    terrain 100k (ABLATE_LANES lanes, ABLATE_STEPS supersteps, all twelve
    variants, B3), then the probe leftovers at their tools' sizes. Returns
    the B3, B4 and B2 launches of each."""
    import torch
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.probes import ablate_superstep as ab
    from vimg_tpu_torch.probes import common, probe_r3b, probe_r3c, \
        probe_regen
    from vimg_tpu_torch.scene import ir
    dev = t100.device
    log(f"[36] main path 24: ablate_superstep on terrain 100k, "
        f"{ABLATE_LANES} lanes, {ABLATE_STEPS} supersteps, "
        f"{len(ab.VARIANTS)} variants")
    st = ir.RenderSettings(MESH_W, MESH_H, spp=MESH_SPP, max_depth=64,
                           integrator="mis")
    tr = ClusterTracer(t100)
    plog = common.Log(dev)
    zero_counts()
    res = ab.ablate(t100, st, tr, ABLATE_LANES, ABLATE_STEPS,
                    ABLATE_REPEATS, log=plog)
    c24 = read_counts()
    if len(res) != len(ab.VARIANTS) or c24["cluster_wide"] < 1 or any(
            v for k, v in c24.items() if k != "cluster_wide") or not all(
            r["film_finite"] for r in res.values()):
        fail(f"main path 24: {len(res)} variants, launches {nonzero(c24)}")
    log("    variant        ms/step  Mseg/s  event ms  busy ms  delta ms "
        f"(on {card})")
    for name, r in res.items():
        log(f"    {name:13s} {r['ms']:8.3f} {r['mseg_s']:7.2f} "
            f"{r['event_ms']:9.3f} "
            + (f"{r['busy_ms']:8.3f}" if r["busy_ms"] is not None
               else "     n/a")
            + ("" if r["delta_ms"] is None else f" {r['delta_ms']:+9.3f}"))
    log("[36] main path 25: the probe leftovers (probe_r3b cluster_bounce, "
        "sort_tax, wavefront_e2e; probe_r3c xla_gather, hit_info_cost; "
        "probe_regen depth_decomposition) at the tools' sizes")
    zero_counts()
    t0 = time.time()
    probe_r3b.cluster_bounce(dev, log=plog)
    probe_r3b.sort_tax(dev, log=plog)
    probe_r3b.wavefront_e2e(dev, log=plog)
    probe_r3c.xla_gather(dev, log=plog)
    probe_r3c.hit_info_cost(dev, log=plog)
    probe_regen.depth_decomposition(dev, log=plog)
    torch.cuda.synchronize()
    c25 = read_counts()
    log(f"    leftovers in {time.time() - t0:.1f} s; launches {nonzero(c25)}")
    kinds = {r["probe"] for r in plog.records}
    if kinds != {"ablate_superstep", "bounce_trace", "sort_tax",
                 "wavefront_e2e", "xla_gather", "hit_info", "depth"} or \
            c25["megakernel_mesh"] != 10 or c25["cluster_wide"] < 1:
        fail(f"main path 25: records {sorted(kinds)}, launches "
             f"{nonzero(c25)}")
    return c24["cluster_wide"], c25


def phase_seconds(label, since):
    """Log the seconds since ``since`` under ``label``; returns now."""
    now = time.time()
    log(f"    ({label}: {now - since:.1f} s)")
    return now


def main():
    t_start = t_phase = time.time()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    png_dir = None
    if "--png-dir" in sys.argv:
        png_dir = sys.argv[sys.argv.index("--png-dir") + 1]
        os.makedirs(png_dir, exist_ok=True)
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.runtime import cuda
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    from vimg_tpu_torch.scene.synthetic import terrain_scene

    # ---- 1. environment -------------------------------------------------
    card = nvidia_smi_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    log(f"    nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    try:
        import triton
        log(f"    triton {triton.__version__} imports")
    except ImportError as e:
        log(f"    triton does not import ({e})")
    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    lib = cuda.load_library()
    log(f"[2] built {os.path.relpath(cuda.BUILD_INFO['path'], ROOT)} in "
        f"{time.time() - t0:.2f}s (nvcc {cuda.BUILD_INFO['seconds']:.2f}s, "
        f"all sources in parallel)")
    for line in cuda.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"    ptxas: {line.strip()}")

    t_phase = phase_seconds("phases 1-2", t_phase)
    # ---- 3. kernel B1 vs plain version ---------------------------------
    log("[3] B1 vs its plain PyTorch version (both on the card)")
    unit_err = 0.0
    for integ in ("mis", "material"):
        scene, st = unit_scene(dev, 16, integ)
        img, ks = kernel.render_megakernel(scene, st, return_stats=True)
        ref, ps = kernel.render_megakernel_plain(scene, st, return_stats=True)
        r = compare(f"unit 64x48@16 {integ}", ref, img)
        unit_err = max(unit_err, r["max"])
        if not (r["mean"] < UNIT_MEAN and r["frac"] < UNIT_FRAC
                and r["corr"] > UNIT_CORR):
            fail(f"unit-scale {integ} parity")
        for key in ("segments", "shadow_rays", "warp_steps"):
            a, b = ks[key], ps[key]
            log(f"    {key}: kernel {a} plain {b}")
            if abs(a - b) > COUNT_REL * max(b, 1):
                fail(f"unit-scale {integ} {key} count")
        if ks["warp_steps"] != ps["warp_steps"]:
            fail(f"unit-scale {integ}: warp steps differ from the plain count")
        log(f"    SIMT fill {fill(ks):.4f}; {b1_report(scene, st)}")

    fscene, fst = load_json_scene(FLAGSHIP, device=dev)
    fst4 = dataclasses.replace(fst, spp=4)
    kernel.render_megakernel(fscene, dataclasses.replace(fst4, spp=1))  # warm
    (img, ks), k_s = timed(lambda: kernel.render_megakernel(
        fscene, fst4, return_stats=True))
    (ref, ps), p_s = timed(lambda: kernel.render_megakernel_plain(
        fscene, fst4, return_stats=True))
    r = compare("flagship 1800x800@4 mis", ref, img)
    log(f"    kernel {1e3 * k_s:.1f} ms, plain {1e3 * p_s:.1f} ms; "
        f"segments kernel {ks['segments']} plain {ps['segments']}, "
        f"shadow kernel {ks['shadow_rays']} plain {ps['shadow_rays']}, "
        f"warp steps kernel {ks['warp_steps']} plain {ps['warp_steps']}")
    log(f"    SIMT fill {fill(ks):.4f} (plain count {fill(ps):.4f}); "
        f"{b1_report(fscene, fst4)}")
    if not (r["mean"] < FLAG_MEAN and r["corr"] > FLAG_CORR):
        fail("flagship statistical parity")
    plain_mean = ref.reshape(-1, 3).mean(0).cpu().numpy()
    mega_ops = (ks["segments"] * MEGA_OPS_PER_SEGMENT
                + ks["shadow_rays"] * MEGA_OPS_PER_SHADOW)
    mega_bytes = fst4.width * fst4.height * 3 * 4
    mega_bound = 1e3 * max(mega_ops / FP32_OPS_PER_S,
                           mega_bytes / HBM_BYTES_PER_S)
    log(f"    bound at 4 spp: {mega_bound:.2f} ms (operations: "
        f"{mega_ops:.4g} ops at 67 TFLOP/s)")

    t_phase = phase_seconds("phase 3", t_phase)
    # ---- 4. main path 1: flagship through B1 ----------------------------
    log("[4] main path 1: load_json_scene -> render_frame -> finalize -> "
        "write_png")
    import numpy as np
    scene, st = load_json_scene(FLAGSHIP, device=dev)
    st = dataclasses.replace(st, tonemap="agx")
    zero_counts()
    img, secs = timed(lambda: render_frame(scene, st))
    counts = read_counts()
    mega_launches = counts["megakernel_analytic"]
    segs, shadow, steps = (int(v) for v in kernel.LAST_COUNTS.cpu())
    png_bytes = save_png(img, st.tonemap, "flagship.png", png_dir)
    img_np = img.cpu().numpy()
    if img_np.shape != (st.height, st.width, 3) or not np.isfinite(img_np).all():
        fail(f"main path image shape {img_np.shape} / non-finite values")
    if mega_launches < 1 or any(
            v for k, v in counts.items() if k != "megakernel_analytic"):
        fail(f"main path 1 launches {counts}")
    mean = img_np.reshape(-1, 3).mean(0)
    rel = np.abs(mean - plain_mean) / np.maximum(plain_mean, 1e-12)
    log(f"    image mean {mean.tolist()} vs plain@4spp {plain_mean.tolist()} "
        f"(rel {rel.tolist()}); png {png_bytes} bytes")
    if not (rel < MAIN_MEAN_REL).all():
        fail("main path mean differs from the plain version's by > 2%")
    paths = st.width * st.height * st.spp
    frame_bound = (segs * MEGA_OPS_PER_SEGMENT
                   + shadow * MEGA_OPS_PER_SHADOW) / FP32_OPS_PER_S
    log(f"    B1 bound of this frame: {frame_bound:.4f} s (operations)")
    log(f"    {st.width}x{st.height} @ {st.spp} spp: {secs:.3f} s, "
        f"{paths / secs / 1e6:.2f} Mpaths/s, {(segs + shadow) / secs / 1e6:.2f}"
        f" Mrays/s ({segs} segments + {shadow} shadow rays), launches "
        f"{counts}, on {card}")
    log(f"    warp steps {steps}: SIMT fill "
        f"{fill(dict(segments=segs, warp_steps=steps)):.4f}; "
        f"{b1_report(scene, st)}")

    t_phase = phase_seconds("phase 4", t_phase)
    # ---- 5. the cluster kernels -----------------------------------------
    log("[5] B3 (cluster_wide_kernel) and B4 (cluster_skip_kernel), both on "
        "the warp's leaf round, are in the library built in [2]")
    for fn in ("vimg_cluster_wide", "vimg_cluster_skip"):
        getattr(lib, fn)
    for line in cuda.BUILD_INFO["log"].splitlines():
        if "cluster" in line:
            log(f"    {line.strip()}")

    t_phase = phase_seconds("phase 5", t_phase)
    # ---- 6. B3 / B4 vs their plain walks --------------------------------
    log(f"[6] B3 and B4 vs their plain walks, {N_RAYS} rays per kind")
    cmp, phase6 = {}, {}
    for n_tris, _, _ in TERRAINS:
        scene = terrain_scene(n_tris, MESH_W, MESH_H, device=dev)
        res, rays = kernel_vs_plain(n_tris, scene)
        for key, v in res.items():
            cmp[(n_tris,) + key] = v
        phase6[n_tris] = (scene, rays)

    t_phase = phase_seconds("phase 6", t_phase)
    # ---- 7/8. main paths 2 and 3: the mesh wavefront ---------------------
    launches, wf_err, wf_img, wf_stats = {}, {}, {}, {}
    for phase, (n_tris, walk, name) in zip((7, 8), TERRAINS):
        log(f"[{phase}] main path {phase - 5}: terrain {n_tris} -> "
            f"render_frame ({MESH_W}x{MESH_H} @ {MESH_SPP} spp, batch "
            f"{MESH_BATCH}) -> finalize -> write_png through {name}")
        (launches[name], wf_err[name], wf_img[name],
         wf_stats[name]) = mesh_main_path(n_tris, walk, name, png_dir, card,
                                          dev)

    t_phase = phase_seconds("phases 7-8", t_phase)
    # ---- 8b. main path 9: the env-lit textured terrain through B3 -------
    log(f"[8b] main path 9: textured_terrain_scene({ENVTEX_TRIS}) -> "
        f"render_frame ({MESH_W}x{MESH_H} @ {MESH_SPP} spp, batch "
        f"{MESH_BATCH}) -> wavefront with ray cones -> finalize -> write_png "
        f"through cluster_wide")
    envtex_launches = envtex_main_path(png_dir, card, dev)

    t_phase = phase_seconds("phase 8b", t_phase)
    # ---- 8c. main path 10: the train step through B3 -------------------
    log(f"[8c] main path 10: textured_terrain_scene({ENVTEX_TRIS}) -> "
        f"make_tracer(differentiable=True) -> make_train_step -> "
        f"{TRAIN_STEPS} Adam steps of {MESH_W * MESH_H} rays through "
        f"cluster_wide at zero tangent; then the flagship")
    train_launches = train_main_path(card, dev)

    t_phase = phase_seconds("phase 8c", t_phase)
    # ---- 9-11. kernel B2 and main paths 4, 5 --------------------------
    b2 = b2_phases(dev, png_dir, card)

    t_phase = phase_seconds("phases 9-11", t_phase)
    # ---- 12-14. kernels B5, B6 and main path 6 -------------------------
    b5, x1 = packet_phases(*phase6[TERRAINS[0][0]], wf_img["cluster_wide"],
                       png_dir, card, dev)
    b6 = gather_phase(dev, card)

    t_phase = phase_seconds("phases 12-14", t_phase)
    # ---- 15-18. the probe kernels P1-P11 -------------------------------
    probes = [walk_probe_phase(phase6[TERRAINS[0][0]][0])]
    probes += scalar_probe_phase(dev)
    probes += packet_probe_phase(dev)
    probes.append(stage_probe_phase(dev))

    t_phase = phase_seconds("phases 15-18", t_phase)
    # ---- 19. main paths 7 and 8: s_normal frames through render() -------
    normal_phase(dev, card, png_dir)
    other_frames_phase(dev)
    envtex_small_phase(dev)

    t_phase = phase_seconds("phase 19", t_phase)
    # ---- 20-22. the probe kernels P12-P31 -------------------------------
    probes += vpu_probe_phase(dev)
    probes += gather_probe_phase(dev)
    probes += lowering_probe_phase(dev)

    t_phase = phase_seconds("phases 20-22", t_phase)
    # ---- 23-26. X2 and the scene-file front door (main paths 11-13) ----
    x2, b3_12, b3_13 = front_door_phases(*phase6[TERRAINS[0][0]], png_dir,
                                         dev)

    t_phase = phase_seconds("phases 23-26", t_phase)
    # ---- 27-33. sample slabs and scale-out (main paths 14-20) ----------
    t100 = phase6[TERRAINS[0][0]][0]
    b1_14, b3_15 = checkpoint_phases(img, t100, wf_stats["cluster_wide"],
                                     wf_img["cluster_wide"], card)
    b1_16, b2_16 = sharded_mega_phase(img, b2["main4"], card)
    b3_17, b3_18 = scale_out_phases(t100, card)
    b3_19 = trace_phase(b2["main5_stats"], card, dev)
    b3_20 = prepass_phase(t100, card)

    t_phase = phase_seconds("phases 27-33", t_phase)
    # ---- 34-36. device build (X3), mxu tracer, ablate (main paths 21-25)
    x3, x2_21, b3_22 = device_build_phase(phase6, card)
    t_phase = phase_seconds("phase 34", t_phase)
    mxu_phase(dev)
    t_phase = phase_seconds("phase 35", t_phase)
    b3_24, c25 = ablate_phase(t100, card)
    t_phase = phase_seconds("phase 36", t_phase)

    rows = [{
        "name": "megakernel_analytic",
        "route": "cuda",
        "source": "vimg_tpu_torch/csrc/megakernel.cu",
        "replaces": "vimg_tpu/render/mega/kernel.py:404",
        "launches": mega_launches + b1_14 + b1_16,
        "launches_by_main_path": {"1": mega_launches, "14": b1_14,
                                  "16": b1_16},
        "max_abs_err": unit_err,
        "ms": 1e3 * k_s,
        "plain_ms": 1e3 * p_s,
        "bound_ms": mega_bound,
        "bound_by": "operations",
        "library_ms": None,
        "clock": "host"}]
    for (n_tris, walk, name), line in zip(
            TERRAINS, ("vimg_tpu/geometry/cluster_trace.py:455",
                       "vimg_tpu/geometry/cluster_trace.py:800")):
        c = cmp[(n_tris, walk, "bounce")]
        # B3 carries main paths 2, 9, 10, 12 and 13 (its -b 0 frame)
        by_path = ({"2": launches[name], "9": envtex_launches,
                    "10": train_launches, "12": b3_12, "13": b3_13,
                    "15": b3_15, "17": b3_17, "18": b3_18, "19": b3_19,
                    "20": b3_20, "22": b3_22, "24": b3_24,
                    "25": c25["cluster_wide"]}
                   if walk == "wide" else {"3": launches[name],
                                           "25": c25["cluster_skip"]})
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "vimg_tpu_torch/csrc/cluster_trace.cu",
            "replaces": line,
            "launches": sum(by_path.values()),
            "launches_by_main_path": by_path,
            "max_abs_err": max(v["max_abs_err"] for k, v in cmp.items()
                               if k[1] == walk),
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": None,
            "clock": "events",
            "lane_fill": c["fill"],
            "camera_ms": cmp[(n_tris, walk, "camera")]["ms"],
            "shadow_ms": cmp[(n_tris, walk, "shadow")]["ms"]})
    rows.append({
        "name": "megakernel_mesh",
        "route": "cuda",
        # the walk it runs is in vimg_tpu_torch/csrc/cluster_walk.cuh
        "source": "vimg_tpu_torch/csrc/megakernel.cu",
        "replaces": "vimg_tpu/render/mega/kernel.py:404 (mesh mode)",
        "launches": (b2["launches_4"] + b2["launches_5"] + b2_16
                     + c25["megakernel_mesh"]),
        "launches_by_main_path": {"4": b2["launches_4"],
                                  "5": b2["launches_5"], "16": b2_16,
                                  "25": c25["megakernel_mesh"]},
        "max_abs_err": b2["max_abs_err"],
        "ms": b2["ms"],
        "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"],
        "library_ms": None,
        "clock": "events",
        **{k: b2[k] for k in ("lane_fill", "main5_ms", "main5_bound_ms",
                              "main5_bound_by", "main5_lane_fill")}})
    rows.append(dict(b5, name="packet_trace", route="cuda",
                     source="vimg_tpu_torch/csrc/packet_trace.cu",
                     replaces="vimg_tpu/geometry/packet_trace.py:267",
                     library_ms=None, clock="events"))
    # X1 replaces an XLA function of vimg_tpu, not a Pallas kernel
    rows.append(dict(x1, name="packet_cull", route="cuda",
                     source="vimg_tpu_torch/csrc/packet_cull.cu",
                     replaces="vimg_tpu/geometry/packet_trace.py:145",
                     library_ms=None, clock="events"))
    # the launcher of the device helper vimg_tpu_torch/csrc/gather_row.cuh
    rows.append(dict(b6, name="gather_row", route="cuda",
                     source="vimg_tpu_torch/csrc/gather_row.cu",
                     replaces="vimg_tpu/ops/mxu_gather.py:57",
                     clock="events"))
    x2["launches"] += x2_21
    x2["launches_by_main_path"]["21"] = x2_21
    rows.append(x2)
    rows.append(x3)
    rows += probes
    log(f"[end] all phases in {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
