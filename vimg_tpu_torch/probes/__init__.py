"""Hopper counterparts of vimg_tpu's ``tools/`` probes.

Each module mirrors the ``tools/`` file of the same name and answers the
same question on the card:

- what one step of a tree walk or a packet walk costs
  (``probe_walkablate``, ``probe_r3b``, ``probe_r3c``, ``probe_regen``,
  ``probe_r4a``, ``probe_r4c``; kernels P1-P11);
- what the vector unit's primitives and multiply-adds cost, separate and
  fused, at one block and on the full card (``probe_prims``,
  ``probe_vpu2``, ``probe_vpu3``; P12-P15, and P20 in ``probe_r2c``);
- which gather forms the card has and what they cost, and the exact
  one-hot lookup on the tensor cores (``probe_r2c``, ``probe_r4j``;
  P16-P19, P21, P22);
- whether the constructs the megakernel needs build and run
  (``probe_pallas``, ``probe_constructs``; P23-P31).

Every probe kernel is hand-written CUDA in ``csrc/probe_*.cu`` with a plain
PyTorch version beside its wrapper; a wrapper takes the plain version for
CPU tensors only and counts its launches in ``common.LAUNCHES``. The entry
points default to the card and raise without CUDA unless ``device="cpu"``
is passed; on the CPU they run the plain versions and report no times.
Run one with ``python -m vimg_tpu_torch.probes.probe_walkablate [--device
cpu] [--out records.jsonl]``. This package imports no JAX and nothing of
``vimg_tpu`` or ``tools``.
"""
