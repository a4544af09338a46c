"""Role-masked flash attention, forward and backward
(``aline_tpu/ops/flash_attention.py``).

The ALINE mask is a function of two int32 vectors per batch row
(:func:`aline_tpu_torch.ops.roles.roles_to_codes`), so the kernels compute
it on the fly instead of reading an [N, N] bias:

    kcode[b, j] in {0: invisible, 1: context (visible to every row),
                    2: visible to query rows (selected target / time token)}
    qrow[b, i]  in {0, 1}: row i is a query row

    allowed(i, j) = kcode[j] == 1  or  (qrow[i] == 1 and kcode[j] == 2)

* ``flash_attn_fwd`` launches ``csrc/flash_attn_fwd.cu`` on CUDA tensors
  and runs ``flash_attn_fwd_plain`` on CPU tensors → (O, lse).
* ``flash_attn_bwd`` launches ``csrc/flash_attn_bwd.cu`` on CUDA tensors
  and runs ``flash_attn_bwd_plain`` on CPU tensors → (dQ, dK, dV).
* ``flash_role_attention`` is the differentiable entry: a
  ``torch.autograd.Function`` whose forward is ``flash_attn_fwd`` and
  whose backward is ``flash_attn_bwd``.

The semantics are the TPU kernel's, not the dense path's.  The key axis
is padded to ``Np = ceil(N / bq) * bq`` with ``bq = block_q(N)``; a padded
column is invisible and has v = 0, and a masked score is *replaced* by
-1e9, not offset.  A row that sees no key at all therefore averages v over
Np columns (``sum(v) / Np``), where a dense softmax averages over N.  The
backward recomputes ``P = exp(s - lse)`` from the saved lse on every
column, masked ones included, as the TPU kernel does.

On a CUDA tensor a wrapper launches its kernel or raises; there is no
other path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aline_tpu_torch.ops import _build

# Kernel launches since the last reset, by kernel; chip runs read them to
# show that a path went through the kernels.
LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd": 0}

DH_SUPPORTED = (8, 16, 32, 64)
NEG = -1e9


def block_q(N: int) -> int:
    """The TPU kernel's query block (``_block_q``): the next power of two
    of N, within [8, 128]."""
    return min(128, max(8, 1 << (N - 1).bit_length()))


def padded_len(N: int) -> int:
    """Np: N rounded up to a multiple of ``block_q(N)``."""
    bq = block_q(N)
    return -(-N // bq) * bq


def _masked_scores(q, k, kcode, qrow):
    """[B, H, N, Nk] scores ``q·kᵀ/√dh``, replaced by -1e9 where masked."""
    kc = kcode[:, None, None, :]
    allowed = (kc == 1) | ((qrow[:, None, :, None] == 1) & (kc == 2))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return torch.where(allowed, s, NEG)


def flash_attn_fwd_plain(q, k, v, kcode, qrow):
    """The TPU kernel's forward, written literally over the Np padded
    columns → (O [B, H, N, dh], lse [B, H, N])."""
    pad = padded_len(q.shape[2]) - q.shape[2]
    s = _masked_scores(q, F.pad(k, (0, 0, 0, pad)), F.pad(kcode, (0, pad)),
                       qrow)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, F.pad(v, (0, 0, 0, pad))) / l
    return o, (m + torch.log(l))[..., 0]


def flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do):
    """The TPU kernel's backward, written literally → (dQ, dK, dV).  The
    padded columns are left out: their k and v are 0, so they add nothing
    to dQ, and their dK and dV are discarded."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_masked_scores(q, k, kcode, qrow) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    delta = torch.sum(do * o, dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv


def _check(q, kcode, qrow, **floats):
    """Shapes, dtypes, contiguity and device of every argument; ``floats``
    are the [B, H, N, dh] or [B, H, N] float32 tensors beside q."""
    if q.dim() != 4:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected "
                         f"[B, H, N, dh]")
    B, H, N, dh = q.shape
    named = {"q": (q, (B, H, N, dh), torch.float32),
             "kcode": (kcode, (B, N), torch.int32),
             "qrow": (qrow, (B, N), torch.int32)}
    for name, t in floats.items():
        shape = (B, H, N) if name == "lse" else (B, H, N, dh)
        named[name] = (t, shape, torch.float32)
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the flash attention "
                            f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _kernel_device(q) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    dh = q.shape[-1]
    if dh not in DH_SUPPORTED:
        raise ValueError(f"the flash-attention kernels take dh in "
                         f"{DH_SUPPORTED}, got {dh}")
    return True


def _launch(name, q, *args):
    """Launch kernel ``name`` on ``(q, *args)``: tensors pass as device
    pointers (each 16-byte aligned), numbers as they are."""
    if any(a.data_ptr() % 16 for a in (q, *args)
           if isinstance(a, torch.Tensor)):
        raise ValueError(f"a tensor argument of {name} is not 16-byte "
                         f"aligned")
    lib = _build.load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in (q, *args)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


@torch.no_grad()
def flash_attn_fwd(q, k, v, kcode, qrow):
    """Role-masked attention forward.

    Args:
        q/k/v: [B, H, N, dh] float32.
        kcode, qrow: [B, N] int32 codes (module docstring).
    Returns:
        (O [B, H, N, dh], lse [B, H, N]) float32; lse is the row
        logsumexp over the Np padded columns, for the backward.
    """
    _check(q, kcode, qrow, k=k, v=v)
    if not _kernel_device(q):
        return flash_attn_fwd_plain(q, k, v, kcode, qrow)
    B, H, N, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse                   # nothing to compute, no launch
    _launch("flash_attn_fwd", q, k, v, kcode, qrow, o, lse, B, H, N,
            padded_len(N) - N, dh, 1.0 / math.sqrt(dh))
    return o, lse


@torch.no_grad()
def flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do):
    """Gradients of the role-masked attention for ``do = dL/dO``
    → (dQ, dK, dV), each [B, H, N, dh].  On the card every gradient
    element is summed by one thread in a fixed order (no atomics): the
    same inputs give bitwise the same gradients on every call."""
    _check(q, kcode, qrow, k=k, v=v, o=o, lse=lse, do=do)
    if not _kernel_device(q):
        return flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do)
    B, H, N, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    _launch("flash_attn_bwd", q, k, v, kcode, qrow, o, lse, do, dq, dk, dv,
            delta, B, H, N, dh, 1.0 / math.sqrt(dh))
    return dq, dk, dv


class _FlashRoleAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kcode, qrow):
        o, lse = flash_attn_fwd(q, k, v, kcode, qrow)
        ctx.save_for_backward(q, k, v, kcode, qrow, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kcode, qrow, o, lse = ctx.saved_tensors
        return (*flash_attn_bwd(q, k, v, kcode, qrow, o, lse,
                                g.contiguous()), None, None)


def flash_role_attention(q, k, v, kcode, qrow):
    """Differentiable role-masked attention: [B, H, N, dh] float32 q/k/v,
    [B, N] int32 kcode/qrow → O [B, H, N, dh].  Without a gradient to
    record it calls the forward alone and saves nothing."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashRoleAttention.apply(q, k, v, kcode, qrow)
    return flash_attn_fwd(q, k, v, kcode, qrow)[0]
