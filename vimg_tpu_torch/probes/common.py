"""Shared pieces of the probes: device choice, kernel launch and launch
counts, the device timer and the JSON-line record logger."""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from vimg_tpu_torch.geometry.cluster_trace import _check as check_tensor
from vimg_tpu_torch.runtime.cuda import check, load_library

# launches of each probe kernel (P1-P31), counted by its wrapper
LAUNCHES = dict.fromkeys((
    "probe_walkablate", "probe_sync", "probe_smem_read", "probe_smem_write",
    "probe_setup", "probe_dynrow", "probe_ffs", "probe_epilogue",
    "probe_dynblock", "probe_dynrow_par", "probe_packet_stages",
    "probe_prims", "probe_fma", "probe_mix", "probe_vpu3", "probe_take",
    "probe_onehot", "probe_selchain", "probe_mxu_precision",
    "probe_vpu_rate", "probe_lookup", "probe_lookup_check", "probe_grid",
    "probe_while", "probe_pcg", "probe_scalars", "probe_transcendental",
    "probe_throughput", "probe_k1", "probe_k2", "probe_k3"), 0)

# about 5 ms of spinning at the H100's 1.98 GHz boost clock: longer than
# the host takes to queue a timed run, so the card runs it back to back
SPIN_CYCLES = 10_000_000


def resolve_device(device="cuda"):
    """The probes' device: the card by default; raises without CUDA (pass
    device="cpu" for the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the probes run on an NVIDIA GPU; "
                               "torch.cuda.is_available() is false (pass "
                               "device='cpu' for the plain versions)")
        return torch.device("cuda", dev.index or 0)
    if dev.type != "cpu":
        raise NotImplementedError(f"no probe kernels for device {dev}")
    return dev


def on_card(x):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise NotImplementedError(f"no probe kernel for device {x.device}")
    return False


def launch(name, fn_name, device, *args):
    """Call the C launcher ``fn_name`` with ``args`` (tensors pass their
    data pointers, a ``ctypes.c_int`` its address) and the current stream;
    raise on a CUDA error; count the launch under ``name``."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor)
              else ctypes.addressof(a) if isinstance(a, ctypes.c_int) else a
              for a in args), stream)
    check(rc, fn_name)
    LAUNCHES[name] += 1


def device_ms(fn, reps=20):
    """Milliseconds per call of ``fn`` on the card, after two warm-up
    calls: CUDA events around ``reps`` calls queued behind a spinning
    kernel, so that the host's time to queue them does not show as idle
    time between launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sync(device):
    """Wait for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_seconds(fn, device):
    """(seconds, result) of one call of ``fn`` by the host's clock,
    synchronised before and after."""
    sync(device)
    t0 = time.time()
    out = fn()
    sync(device)
    return time.time() - t0, out


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (plain versions; no device times)"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class Log:
    """JSON-line records, each with the card's name and power limit, to
    stdout or appended to ``out``."""

    def __init__(self, device, out=None):
        self.device = device
        self.card = card_line(device)
        self.out = out
        self.records = []

    def __call__(self, **kw):
        rec = dict(kw, card=self.card)
        self.records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out:
            with open(self.out, "a") as f:
                f.write(line + "\n")
        return rec


def parse_args(doc, argv=None, extra=()):
    """--device (default cuda) and --out of a probe's command line, plus
    the probe's own (name, kwargs) arguments."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="append the JSON records to this file")
    for name, kw in extra:
        ap.add_argument(name, **kw)
    return ap.parse_args(argv)


def f32(v):
    """A Python float rounded to float32, as XLA rounds a weak-typed
    constant (exact as a float32 scalar afterwards)."""
    return float(torch.tensor(v, dtype=torch.float64).to(torch.float32))


def bf16(v):
    """A Python float rounded to bfloat16, as a Python float (jnp.asarray(v,
    jnp.bfloat16) rounds the same)."""
    return float(torch.tensor(v, dtype=torch.float64).to(torch.bfloat16))


def fused(a, c, d):
    """a * c + d rounded once to a's type (float32 or bfloat16): the plain
    version of __fmaf_rn / __hfma2. The product is exact in float64; the
    float64 sum is made round-to-odd (TwoSum gives its error; an inexact sum
    with an even last bit steps one ulp toward the error), which rounds
    correctly to any type of at most 51 bits."""
    p = a.double() * c.double()
    d = d.double()
    s = p + d
    bp = s - d
    err = (p - bp) + (d - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    if a.dtype == torch.float32:
        return s.float()
    # round-to-nearest-even from float64 to bfloat16 (7 stored bits)
    bits = s.view(torch.int64)
    bits = bits + ((1 << 44) - 1) + ((bits >> 45) & 1)
    return (bits & ~((1 << 45) - 1)).view(torch.float64).float().to(a.dtype)


def madd(a, c, d, fused_=False):
    """a * c + d in a's type: two roundings, or one (``fused_``)."""
    return fused(a, c, d) if fused_ else a * c + d


_CONSTS = {}


def device_consts(values, device):
    """The float32 constants ``values`` as a tensor on ``device``, made
    once: a kernel's launch then copies nothing from the host (a copy from
    pageable memory would make the host wait for the queued launches, and
    a timed loop would measure the host)."""
    key = (tuple(values), str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=torch.float32,
                                    device=device)
    return _CONSTS[key]


def card_grid():
    """A ``ctypes.c_int`` that a launcher fills with the grid it used."""
    return ctypes.c_int(0)


def rate_probe(kernel, ops_per_block, log, **keys):
    """Time ``kernel(fused, n_blocks) -> (out, blocks)`` at one block (the
    probe's size) and, on the card, on the full card, in both forms (False
    separate, True fused multiply-add); log each with its rate in Gop/s
    (``ops_per_block`` x blocks / time; None on the CPU).
    Returns {(fused, card): (out, ms, blocks)}."""
    res = {}
    dev = log.device
    for fused_ in (False, True):
        for card in ((False, True) if dev.type == "cuda" else (False,)):
            n_blocks = 0 if card else 1
            out, blocks = kernel(fused_, n_blocks)
            ms = (device_ms(lambda: kernel(fused_, n_blocks))
                  if dev.type == "cuda" else None)
            log(**keys, form="fused" if fused_ else "separate",
                grid="card" if card else "block", blocks=blocks,
                us=None if ms is None else ms * 1e3,
                gops=None if ms is None else
                ops_per_block * blocks / (ms * 1e-3) / 1e9)
            res[(fused_, card)] = (out, ms, blocks)
    return res
