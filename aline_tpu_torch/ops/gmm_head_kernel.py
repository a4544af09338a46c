"""Fused GMM-posterior-head forward (``aline_tpu/ops/gmm_head_kernel.py``).

The GMM target head runs ``C`` independent 2-layer MLPs over every token.
``gmm_head_fwd`` launches the hand-written CUDA kernel
(``csrc/gmm_head_fwd.cu``) on CUDA tensors; it keeps the ``[B, T, C, F]``
hidden activations out of device memory.  On CPU tensors it runs
``gmm_head_fwd_plain``, the two-einsum version of the same function.
Forward only: the backward kernel comes with training.
"""
from __future__ import annotations

import torch

from aline_tpu_torch.ops import _build

# Kernel launches since the last reset; chip runs read it to show that a
# path went through the kernel.
LAUNCHES = 0


def gmm_head_fwd_plain(z, w1, b1, w2, b2):
    """relu(z·W1_c + b1_c)·W2_c + b2_c per component → [B, T, C, 3]."""
    h = torch.relu(torch.einsum("btd,cdf->btcf", z, w1) + b1)
    return torch.einsum("btcf,cfo->btco", h, w2) + b2


def _check(z, w1, b1, w2, b2):
    B, T, D = z.shape
    C, D1, F = w1.shape
    shapes = {"w1": (w1, (C, D, F)), "b1": (b1, (C, F)),
              "w2": (w2, (C, F, 3)), "b2": (b2, (C, 3))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    for name, t in {"z": z, **{n: s[0] for n, s in shapes.items()}}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the GMM head takes "
                            f"float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")


@torch.no_grad()
def gmm_head_fwd(z, w1, b1, w2, b2):
    """Fused per-component MLP head.

    Args:
        z:  [B, T, D] float32 tokens.
        w1: [C, D, F]; b1: [C, F]; w2: [C, F, 3]; b2: [C, 3].
    Returns:
        [B, T, C, 3] float32 raw (mean, std, weight) per component.
    """
    global LAUNCHES
    _check(z, w1, b1, w2, b2)
    if z.device.type == "cpu":
        return gmm_head_fwd_plain(z, w1, b1, w2, b2)
    if z.device.type != "cuda":
        raise ValueError(f"no GMM-head kernel for device {z.device}")
    B, T, D = z.shape
    C, _, F = w1.shape
    if D not in (16, 32, 64):
        raise ValueError(f"the GMM-head kernel takes D in (16, 32, 64), "
                         f"got {D}")
    out = torch.empty(B, T, C, 3, dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out                      # nothing to compute, no launch
    for name, t in (("z", z), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    lib = _build.load("gmm_head_fwd")
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.gmm_head_fwd(z.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                               B * T, D, C, F, stream)
    if err != 0:
        raise RuntimeError(f"gmm_head_fwd kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
