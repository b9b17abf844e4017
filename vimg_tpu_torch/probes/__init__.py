"""Hopper counterparts of vimg_tpu's ``tools/`` probes.

Each module mirrors the ``tools/`` file of the same name and answers the
same question on the card: what one step of a tree walk or a packet walk
costs (``probe_walkablate``, ``probe_r3b``, ``probe_r3c``, ``probe_regen``,
``probe_r4a``, ``probe_r4c``). Every probe kernel (P1-P11) is hand-written
CUDA in ``csrc/probe_*.cu`` with a plain PyTorch version beside its
wrapper; a wrapper takes the plain version for CPU tensors only and counts
its launches in ``common.LAUNCHES``. The entry points default to the card
and raise without CUDA unless ``device="cpu"`` is passed; on the CPU they
run the plain versions and report no times. Run one with
``python -m vimg_tpu_torch.probes.probe_walkablate [--device cpu]
[--out records.jsonl]``. This package imports no JAX and nothing of
``vimg_tpu`` or ``tools``.
"""
