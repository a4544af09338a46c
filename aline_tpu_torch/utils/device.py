"""Device selection for the entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it asks for CUDA and
    there is none, so a run never falls back to the CPU quietly.

    On CUDA it also turns TF32 off for matmuls and cuDNN: the port
    computes in float32, and TF32 keeps only about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
