"""Profiling and observability (port of vimg_tpu.utils.profiling).

- ``PhaseTimer``: named phase timings, printed as vimg_tpu prints them;
- ``device_trace``: a ``torch.profiler`` capture (CUDA activity on the
  card) written as a Chrome trace into a directory;
- ``block_and_time``: warm up, then time calls to the end of their device
  work;
- ``walk_roofline``: vimg_tpu's flop accounting of a mesh megakernel (B2)
  render from its counted box and triangle tests, against the card's
  float32 peak.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from vimg_tpu_torch.scene.ir import check_device

# NVIDIA H100 SXM, float32 outside the tensor cores, at its 700 W power
# limit (data sheet): the peak the bounds of the port's kernels use
FP32_FLOPS_PER_S = 67e12
# vimg_tpu's charges: flops a (ray, triangle) test and a (ray, box) test,
# and the work a ray needs (a CPU BVH walk's: 30 triangle and 60 box tests)
TRI_TEST_FLOPS = 25.0
BOX_TEST_FLOPS = 30.0
USEFUL_TRI_TESTS = 30
USEFUL_BOX_TESTS = 60
TRACE_FILE = "trace.json"


class PhaseTimer:
    """Named phase timings; each phase prints ``[name] <time>``."""

    def __init__(self, quiet=False):
        self.quiet = quiet
        self.records = []

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.records.append((name, dt))
            if not self.quiet:
                print(f"[{name}] {_fmt(dt)}")


def _fmt(seconds):
    if seconds >= 60:
        return f"{int(seconds // 60)}min {seconds % 60:.1f}s"
    if seconds >= 1:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds * 1e6:.0f}us"


@contextlib.contextmanager
def device_trace(log_dir, device="cuda"):
    """Profile the block with ``torch.profiler`` (the host's activity, and
    on a CUDA ``device`` the card's kernels) and write the Chrome trace
    ``log_dir/trace.json`` (view in Perfetto or chrome://tracing). A CUDA
    ``device`` without CUDA raises. Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile
    device = check_device(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=acts) as prof:
        yield path
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


def _sync(out):
    """Wait for the card's work behind every CUDA tensor in ``out``."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for x in items:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
        elif isinstance(x, (tuple, list)):
            _sync(x)


def block_and_time(fn, *args, warmup=1, iters=3, **kw):
    """Call ``fn`` ``warmup`` times, then time ``iters`` calls, each to the
    end of its device work. Returns (the last result, seconds a call)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kw)
        _sync(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args, **kw)
        _sync(out)
    return out, (time.time() - t0) / iters


def walk_roofline(stats, seconds, peak=FP32_FLOPS_PER_S):
    """Roofline accounting of a mesh megakernel (B2) render:
    ``stats`` is ``render_megakernel(return_stats=True)``'s dict (its
    counted ``tri_tests`` and ``box_tests``, ``segments`` and
    ``shadow_rays``), ``seconds`` the render's time. The walk's flops are
    25 a triangle test and 30 a box test; the work a ray needs is 30
    triangle and 60 box tests. Returns the rays a second, the walk's
    flops, their share of ``peak`` (default: the card's float32 rate), the
    flops over the needed work's (amplification) and triangle tests a
    ray."""
    tri = float(stats.get("tri_tests", 0))
    box = float(stats.get("box_tests", 0))
    rays = float(stats.get("segments", 0)) + float(
        stats.get("shadow_rays", 0))
    total = tri * TRI_TEST_FLOPS + box * BOX_TEST_FLOPS
    useful = rays * (USEFUL_TRI_TESTS * TRI_TEST_FLOPS
                     + USEFUL_BOX_TESTS * BOX_TEST_FLOPS)
    return dict(
        rays_per_s=rays / max(seconds, 1e-9),
        vector_flops=total,
        fp32_utilization=total / max(seconds, 1e-9) / peak,
        work_amplification=total / max(useful, 1.0),
        tri_tests_per_ray=tri / max(rays, 1.0),
    )
