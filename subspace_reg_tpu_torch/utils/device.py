"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
``cuda`` request on a machine without a card raises; nothing continues on
the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` and return it as a ``torch.device``.

    On CUDA this also turns TF32 off for both matmuls and cuDNN
    convolutions: cuDNN's default (``allow_tf32=True``) rounds f32 conv
    inputs to 10 mantissa bits, which moves the cached 640-d features ~1e-3
    away from the f32 reference and breaks the epoch-count parity of the
    fine-tune loop's stop rule."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
