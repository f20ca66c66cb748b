"""PyTorch/CUDA port of the NetMCP routing system.

Mirrors the layout of the JAX package ``repro`` (the reference), so
``repro_torch.core.batch_routing`` is the twin of
``repro.core.batch_routing``.  The port imports ``torch`` and ``numpy``
only.  Its entry points run on the CUDA card unless the caller passes
``device="cpu"``, which runs the plain PyTorch version of every kernel.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one it raises rather than
    quietly running on the CPU.  ``"cpu"`` must be asked for."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels"
        )
    return device
