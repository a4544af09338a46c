"""Device selection for the entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it asks for CUDA and
    there is none, so a run never falls back to the CPU quietly.

    On CUDA it also turns TF32 off for matmuls and cuDNN: the port
    computes in float32, and TF32 keeps only about three decimal digits.
    And it keeps bfloat16 GEMMs from reducing in reduced precision: a
    bfloat16 product sums in float32 and rounds once, as XLA's does.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev


def split_device(argv):
    """(device, the other arguments) of a trainer's ``key=value``
    arguments: ``device=...`` picks the device, the GPU by default."""
    device, rest = "cuda", []
    for arg in argv:
        if arg.startswith("device="):
            device = arg.partition("=")[2]
        else:
            rest.append(arg)
    return device, rest
