"""Persistent-path megakernel renderer (CUDA, Hopper).

Public API: render_megakernel / render_megakernel_plain /
supports_megakernel (see kernel.py); kernel.LAUNCHES counts analytic-mode
launches (B1), kernel.LAUNCHES_MESH mesh-mode launches (B2).
"""
from vimg_tpu_torch.render.mega.kernel import (render_megakernel,
                                               render_megakernel_plain,
                                               supports_megakernel)

__all__ = ["render_megakernel", "render_megakernel_plain",
           "supports_megakernel"]
