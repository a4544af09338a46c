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

Widths.  The kernels take every D ≥ 1 and F ≥ 1, as the Pallas kernels
do (``kernel_takes``).  Each source holds two forms: the narrow kernel
(D in ``NARROW_D``, F a multiple of 8 up to ``NARROW_F_MAX``: the
flagship's 32 and 128), which stages all of W1[c] in shared memory, and
the tiled one (D and F multiples of ``TILED_STEP``), for wide heads such
as D=1024, F=4096.  ``kernel_widths`` picks the form and the widths it
runs at; ``pad_head`` zero-pads z, W1, b1 and W2 up to them, which is
exact: a zero column of z meets a zero row of W1, and a zero hidden unit
has relu(0 + 0) = 0 and a zero row of W2.  The backward drops the padded
parts of the gradients (``unpad_grads``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf

from aline_tpu_torch.ops import _build
from aline_tpu_torch.utils.debug import check_kernel_outputs

NARROW_D = (16, 32, 64)   # the narrow kernel's D
NARROW_F_MAX = 256        # and its widest F (a multiple of 8, the mma width)
TILED_STEP = 128          # the tiled kernel's D and F are multiples of this


def kernel_takes(D: int, F: int) -> bool:
    """Whether the kernels take a head of widths D, F (through
    ``kernel_widths``): every positive width, as the Pallas kernels."""
    return D >= 1 and F >= 1


def kernel_widths(D: int, F: int):
    """(Dp, Fp): the widths a head of widths D, F runs at on the card.
    Narrow heads (D ≤ 64, F ≤ 256) take the narrow kernel at the next D of
    ``NARROW_D`` and F rounded up to 8; wider ones the tiled kernel at D
    and F rounded up to ``TILED_STEP``."""
    if not kernel_takes(D, F):
        raise ValueError(f"no GMM-head kernel for D={D}, F={F}")
    F8 = -(-F // 8) * 8
    if D <= NARROW_D[-1] and F8 <= NARROW_F_MAX:
        return next(d for d in NARROW_D if d >= D), F8
    return (-(-D // TILED_STEP) * TILED_STEP,
            -(-F // TILED_STEP) * TILED_STEP)


def pad_head(z, w1, b1, w2, Dp: int, Fp: int):
    """z [..., D], W1 [C, D, F], b1 [C, F], W2 [C, F, 3] zero-padded to
    widths Dp ≥ D and Fp ≥ F (contiguous).  Exact: the padded head
    computes the same outputs."""
    D, F = w1.shape[1], w1.shape[2]
    if (Dp, Fp) == (D, F):
        return z, w1, b1, w2
    return (nnf.pad(z, (0, Dp - D)).contiguous(),
            nnf.pad(w1, (0, Fp - F, 0, Dp - D)).contiguous(),
            nnf.pad(b1, (0, Fp - F)).contiguous(),
            nnf.pad(w2, (0, 0, 0, Fp - F)).contiguous())


def unpad_grads(grads, D: int, F: int):
    """The gradients (dz, dW1, db1, dW2, db2) of a head padded by
    ``pad_head``, cut back to widths D and F."""
    dz, dw1, db1, dw2, db2 = grads
    if (dw1.shape[1], dw1.shape[2]) == (D, F):
        return grads
    return (dz[..., :D].contiguous(), dw1[:, :D, :F].contiguous(),
            db1[:, :F].contiguous(), dw2[:, :F].contiguous(), db2)


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


def _kernel_device(z):
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if z.device.type == "cpu":
        return False
    if z.device.type != "cuda":
        raise ValueError(f"no GMM-head kernel for device {z.device}")
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
    if not _kernel_device(z):
        return gmm_head_fwd_plain(z, w1, b1, w2, b2)
    out = torch.empty(B, T, C, 3, dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out                      # nothing to compute, no launch
    D, F = kernel_widths(D, w1.shape[2])
    z, w1, b1, w2 = pad_head(z, w1, b1, w2, D, F)
    _aligned(z=z, w1=w1, b1=b1, w2=w2)
    _build.launch("gmm_head_fwd", (z, w1, b1, w2, b2, out), B * T, D, C, F)
    check_kernel_outputs("gmm_head_fwd", out)
    return out


@torch.no_grad()
def gmm_head_bwd(z, w1, b1, w2, g):
    """Gradients of the fused head for ``g = dL/dout`` [B, T, C, 3].

    Returns (dz [B, T, D], dW1 [C, D, F], db1 [C, F], dW2 [C, F, 3],
    db2 [C, 3]).  On the card the weight gradients are summed over
    per-CTA partials in a fixed order: the same inputs give bitwise the
    same gradients on every call.
    """
    B, T, D0 = z.shape
    C, _, F0 = w1.shape
    _check(z, {**_weight_shapes(z, w1, b1, w2), "g": (g, (B, T, C, 3))})
    if not _kernel_device(z):
        return gmm_head_bwd_plain(z, w1, b1, w2, g)
    D, F = kernel_widths(D0, F0)
    z, w1, b1, w2 = pad_head(z, w1, b1, w2, D, F)
    dev = z.device
    dz = torch.empty(B, T, D, dtype=torch.float32, device=dev)
    sizes = (C * D * F, C * F, C * F * 3, C * 3)
    rows = B * T
    # no rows: the weight gradients are zero and nothing is launched
    grads = (torch.empty if rows else torch.zeros)(
        sum(sizes), dtype=torch.float32, device=dev)
    if rows > 0:
        _aligned(z=z, w1=w1, b1=b1, w2=w2)
        # the narrow kernel's per-CTA partial copies of the gradients
        # (their count depends on the rows and the card), or the tiled
        # form's dh of one component and its row-tile partials
        with _build.on_device(dev):
            n_part = _build.load("gmm_head_bwd").gmm_head_bwd_scratch(
                rows, D, C, F)
        if n_part < 0:
            raise RuntimeError(f"gmm_head_bwd cannot size its scratch: "
                               f"cudaError {-n_part}")
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
        _build.launch("gmm_head_bwd", (z, w1, b1, w2, g, dz, part, grads),
                      rows, D, C, F)
        check_kernel_outputs("gmm_head_bwd", dz, grads)
    dw1, db1, dw2, db2 = grads.split(sizes)
    return unpad_grads((dz, dw1.view(C, D, F), db1.view(C, F),
                        dw2.view(C, F, 3), db2.view(C, 3)), D0, F0)


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
