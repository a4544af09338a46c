"""Fused GMM-posterior-head forward and backward
(``aline_tpu/ops/gmm_head_kernel.py``).

The GMM target head runs ``C`` independent 2-layer MLPs over every token.

* ``gmm_head_fwd`` launches ``csrc/gmm_head_fwd.cu`` on CUDA tensors and
  runs ``gmm_head_fwd_plain`` (two einsums) on CPU tensors.
* ``gmm_head_bwd`` launches ``csrc/gmm_head_bwd.cu`` on CUDA tensors and
  runs ``gmm_head_bwd_plain`` (the einsum formulas of the backward) on CPU
  tensors.
* ``gmm_head`` is the differentiable entry: a ``torch.autograd.Function``
  whose forward is ``gmm_head_fwd`` and whose backward is ``gmm_head_bwd``.

Both kernels keep the ``[B, T, C, F]`` hidden activations out of device
memory.  On a CUDA tensor a wrapper launches its kernel or raises; there
is no other path.
"""
from __future__ import annotations

import torch

from aline_tpu_torch.ops import _build

# Kernel launches since the last reset, by kernel; chip runs read them to
# show that a path went through the kernels.
LAUNCHES = {"gmm_head_fwd": 0, "gmm_head_bwd": 0}

D_SUPPORTED = (16, 32, 64)


def gmm_head_fwd_plain(z, w1, b1, w2, b2):
    """relu(z·W1_c + b1_c)·W2_c + b2_c per component → [B, T, C, 3]."""
    h = torch.relu(torch.einsum("btd,cdf->btcf", z, w1) + b1)
    return torch.einsum("btcf,cfo->btco", h, w2) + b2


def gmm_head_bwd_plain(z, w1, b1, w2, g):
    """The backward of ``gmm_head_fwd_plain`` for ``g = dL/dout``
    [B, T, C, 3] → (dz, dW1, db1, dW2, db2)."""
    pre = torch.einsum("btd,cdf->btcf", z, w1) + b1
    dw2 = torch.einsum("btcf,btco->cfo", torch.relu(pre), g)
    dh = torch.einsum("btco,cfo->btcf", g, w2) * (pre > 0).to(g.dtype)
    return (torch.einsum("btcf,cdf->btd", dh, w1),
            torch.einsum("btd,btcf->cdf", z, dh),
            dh.sum(dim=(0, 1)), dw2, g.sum(dim=(0, 1)))


def _check(z, named):
    """``named``: {name: (tensor, expected shape)}; checks dtype,
    contiguity, device and shape of every tensor."""
    for name, (t, want) in named.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    for name, t in {"z": z, **{n: s[0] for n, s in named.items()}}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the GMM head takes "
                            f"float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")


def _weight_shapes(z, w1, b1, w2):
    B, T, D = z.shape
    C, _, F = w1.shape
    return {"w1": (w1, (C, D, F)), "b1": (b1, (C, F)),
            "w2": (w2, (C, F, 3))}


def _kernel_device(z, D):
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if z.device.type == "cpu":
        return False
    if z.device.type != "cuda":
        raise ValueError(f"no GMM-head kernel for device {z.device}")
    if D not in D_SUPPORTED:
        raise ValueError(f"the GMM-head kernels take D in {D_SUPPORTED}, "
                         f"got {D}")
    return True


def _aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


@torch.no_grad()
def gmm_head_fwd(z, w1, b1, w2, b2):
    """Fused per-component MLP head.

    Args:
        z:  [B, T, D] float32 tokens.
        w1: [C, D, F]; b1: [C, F]; w2: [C, F, 3]; b2: [C, 3].
    Returns:
        [B, T, C, 3] float32 raw (mean, std, weight) per component.
    """
    C = w1.shape[0]
    _check(z, {**_weight_shapes(z, w1, b1, w2), "b2": (b2, (C, 3))})
    B, T, D = z.shape
    if not _kernel_device(z, D):
        return gmm_head_fwd_plain(z, w1, b1, w2, b2)
    F = w1.shape[2]
    out = torch.empty(B, T, C, 3, dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out                      # nothing to compute, no launch
    _aligned(z=z, out=out)
    lib = _build.load("gmm_head_fwd")
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.gmm_head_fwd(z.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                               B * T, D, C, F, stream)
    if err != 0:
        raise RuntimeError(f"gmm_head_fwd kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["gmm_head_fwd"] += 1
    return out


@torch.no_grad()
def gmm_head_bwd(z, w1, b1, w2, g):
    """Gradients of the fused head for ``g = dL/dout`` [B, T, C, 3].

    Returns (dz [B, T, D], dW1 [C, D, F], db1 [C, F], dW2 [C, F, 3],
    db2 [C, 3]).  On the card the weight gradients are summed over
    per-CTA partials in a fixed order: the same inputs give bitwise the
    same gradients on every call.
    """
    B, T, D = z.shape
    C, _, F = w1.shape
    _check(z, {**_weight_shapes(z, w1, b1, w2), "g": (g, (B, T, C, 3))})
    if not _kernel_device(z, D):
        return gmm_head_bwd_plain(z, w1, b1, w2, g)
    dev = z.device
    dz = torch.empty(B, T, D, dtype=torch.float32, device=dev)
    sizes = (C * D * F, C * F, C * F * 3, C * 3)
    rows = B * T
    # no rows: the weight gradients are zero and nothing is launched
    grads = (torch.empty if rows else torch.zeros)(
        sum(sizes), dtype=torch.float32, device=dev)
    if rows > 0:
        _aligned(z=z, dz=dz)
        lib = _build.load("gmm_head_bwd")
        per_cta = lib.gmm_head_bwd_rows_per_cta()
        n_ctas = -(-rows // per_cta)
        part = torch.empty(n_ctas * sum(sizes), dtype=torch.float32,
                           device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.gmm_head_bwd(z.data_ptr(), w1.data_ptr(),
                                   b1.data_ptr(), w2.data_ptr(),
                                   g.data_ptr(), dz.data_ptr(),
                                   part.data_ptr(), grads.data_ptr(),
                                   rows, D, C, F, stream)
        if err != 0:
            raise RuntimeError(f"gmm_head_bwd kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES["gmm_head_bwd"] += 1
    dw1, db1, dw2, db2 = grads.split(sizes)
    return (dz, dw1.view(C, D, F), db1.view(C, F), dw2.view(C, F, 3),
            db2.view(C, 3))


class _GMMHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w1, b1, w2, b2):
        # b2 does not enter the backward
        ctx.save_for_backward(z, w1, b1, w2)
        return gmm_head_fwd(z, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        z, w1, b1, w2 = ctx.saved_tensors
        return gmm_head_bwd(z, w1, b1, w2, g.contiguous())


def gmm_head(z, w1, b1, w2, b2):
    """Differentiable fused head: ``gmm_head_fwd`` forward,
    ``gmm_head_bwd`` backward.  Without a gradient to record (under
    ``torch.no_grad()``, or nothing requires one) it calls the forward
    alone and saves nothing."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, w1, b1, w2, b2)):
        return _GMMHead.apply(z, w1, b1, w2, b2)
    return gmm_head_fwd(z, w1, b1, w2, b2)
