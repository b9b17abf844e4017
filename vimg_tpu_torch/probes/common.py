"""Shared pieces of the probes: device choice, kernel launch and launch
counts, the device timer and the JSON-line record logger."""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from vimg_tpu_torch.geometry.cluster_trace import _check as check_tensor
from vimg_tpu_torch.runtime.cuda import check, load_library

# launches of each probe kernel (P1-P11), counted by its wrapper
LAUNCHES = dict.fromkeys((
    "probe_walkablate", "probe_sync", "probe_smem_read", "probe_smem_write",
    "probe_setup", "probe_dynrow", "probe_ffs", "probe_epilogue",
    "probe_dynblock", "probe_dynrow_par", "probe_packet_stages"), 0)

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
    data pointers) and the current stream; raise on a CUDA error; count
    the launch under ``name``."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
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
