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
* ``flash_plan`` lists the pairs the mask allows (``FlashPlan``): it
  launches ``csrc/flash_plan.cu`` on CUDA tensors and runs
  ``flash_plan_plain`` on CPU tensors.  The kernels walk the plan and score
  only the allowed pairs; the encoder builds it once per forward, and a
  wrapper called without one builds its own.  The CPU versions of the
  attention do not read it.

The semantics are the TPU kernel's, not the dense path's.  The key axis
is padded to ``Np = ceil(N / bq) * bq`` with ``bq = block_q(N)``; a padded
column is invisible and has v = 0, and a masked score is *replaced* by
-1e9, not offset.  A row that sees no key at all therefore averages v over
Np columns (``sum(v) / Np``), where a dense softmax averages over N.  The
backward recomputes ``P = exp(s - lse)`` from the saved lse on every
column, masked ones included, as the TPU kernel does.

q, k, v, O and dO are all float32 or all bfloat16; lse and the backward's
row sums Δ are float32 in both.  In bfloat16 the TPU kernel scores in
float32 from the bfloat16 operands, accumulates P·V in float32 and rounds
O and dQ once; it sums dK and dV into bfloat16 outputs, one rounding per
block of ``block_q(N)`` rows.  The plain versions do the same.  The CUDA
kernels (separate ``*_bf16`` entry points, counted apart in
``_build.LAUNCHES``)
run on the bf16 tensor cores (``csrc/flash_attn_mma.cuh``): q·kᵀ and
dO·vᵀ are float32 sums of exact bfloat16 products, P and dS are cut into
three bfloat16 pieces whose products sum to the float32 product (P·V, dS·K,
Pᵀ·dO, dSᵀ·Q), the softmax runs in float32 in log2 units, and dK and dV
are summed in float32 over all rows and rounded once: they differ from the
plain backward by its per-block roundings and elsewhere only by the order
of float32 sums.

Widths.  The kernels take every dh up to ``DH_MAX`` (``kernel_takes``);
each source has an instance for each dh of ``DH_KERNEL``, and the wrappers
zero-pad q, k, v (and O, dO) of any other dh to the next of these
(``kernel_dh``, ``pad_dh``).  That is exact: a zero dim adds 0 to every
dot product, a zero column of v gives a zero column of O, which is cut
off, and the scale stays 1/√dh of the true dh.

On a CUDA tensor a wrapper launches its kernel or raises; there is no
other path.

Counters.  With the program's tracing on (``utils/metrics.py``),
``flash_plan``, ``flash_attn_fwd`` and ``flash_attn_bwd`` each count one
``flash.plan``, ``flash.fwd`` or ``flash.bwd`` a launch (a plain call on
the CPU) in the span open around the call: ``model.forward`` under a
training step's ``rollout.step``, the same under ``train.backward`` for
the forwards that the rollout's checkpoint recomputes.  Autograd runs a
CUDA backward on its own device thread, where no span is open when
``flash_attn_bwd`` runs; ``count`` then adds to the span entered last
that is still open on another thread, ``train.backward``.  Off, a count
is one flag check.  The spans are not timed per call: two CUDA events
would outweigh a 0.03 ms kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aline_tpu_torch.ops import _build
from aline_tpu_torch.utils.debug import check_kernel_outputs
from aline_tpu_torch.utils.metrics import count

DTYPES = (torch.float32, torch.bfloat16)

DH_KERNEL = (8, 16, 32, 64, 128)   # the head widths of the instances
DH_MAX = DH_KERNEL[-1]             # no configuration has a wider head
NEG = -1e9


def kernel_takes(dh: int) -> bool:
    """Whether the kernels take heads of width dh (through ``kernel_dh``)."""
    return 1 <= dh <= DH_MAX


def kernel_dh(dh: int) -> int:
    """The instance a head of width dh runs at: the next of ``DH_KERNEL``."""
    if not kernel_takes(dh):
        raise ValueError(f"the flash-attention kernels take dh up to "
                         f"{DH_MAX}, got {dh}")
    return next(d for d in DH_KERNEL if d >= dh)


def pad_dh(x, dh_to: int):
    """[..., dh] zero-padded to [..., dh_to] (contiguous)."""
    pad = dh_to - x.shape[-1]
    return x if pad == 0 else F.pad(x, (0, pad)).contiguous()


def block_q(N: int) -> int:
    """The TPU kernel's query block (``_block_q``): the next power of two
    of N, within [8, 128]."""
    return min(128, max(8, 1 << (N - 1).bit_length()))


def padded_len(N: int) -> int:
    """Np: N rounded up to a multiple of ``block_q(N)``."""
    bq = block_q(N)
    return -(-N // bq) * bq


class FlashPlan(NamedTuple):
    """The pairs the role mask allows, per batch row, as int32 tensors on
    the codes' device.  A key's code and a row's kind follow from their
    position: key_perm[b, p] has code 1 for p < n_ctx, 2 for
    n_ctx <= p < n_vis, else 0; row_perm[b, r] is a query row for
    r < n_query."""
    key_perm: torch.Tensor   # [B, N] codes 1, then 2, then 0, in index order
    row_perm: torch.Tensor   # [B, N] query rows, then the rest, in order
    n_ctx: torch.Tensor      # [B] keys of code 1
    n_vis: torch.Tensor      # [B] keys of code 1 or 2
    n_query: torch.Tensor    # [B] query rows
    dense: torch.Tensor      # [B] 1 where some row sees no key: the kernels
    #                          then walk all N keys and rows of that batch row


def flash_plan_plain(kcode, qrow) -> FlashPlan:
    """The plan by stable argsorts of each key's and row's group."""
    N = kcode.shape[1]
    key_group = torch.where(kcode == 1, 0, torch.where(kcode == 2, 1, 2))
    row_group = (qrow != 1).to(torch.int32)

    def order(group):
        return torch.argsort(group, dim=1, stable=True).to(torch.int32)

    n_ctx = (kcode == 1).sum(dim=1, dtype=torch.int32)
    n_vis = n_ctx + (kcode == 2).sum(dim=1, dtype=torch.int32)
    n_query = (qrow == 1).sum(dim=1, dtype=torch.int32)
    dense = ((n_ctx == 0) & (n_query < N)) | ((n_vis == 0) & (n_query > 0))
    return FlashPlan(order(key_group), order(row_group), n_ctx, n_vis,
                     n_query, dense.to(torch.int32))


def flash_plan(kcode, qrow) -> FlashPlan:
    """The plan of the mask of ``kcode, qrow`` ([B, N] int32): launches
    ``csrc/flash_plan.cu`` on CUDA tensors (one CTA per batch row, no
    host synchronisation), ``flash_plan_plain`` on CPU tensors.  The
    codes are checked here, once per plan: the kernel wrappers that walk
    it check only its shape and device."""
    _check_codes(kcode, qrow)
    count("flash.plan", 1)
    dev = kcode.device
    if dev.type == "cpu" or kcode.numel() == 0:
        return flash_plan_plain(kcode, qrow)
    if dev.type != "cuda":
        raise ValueError(f"no flash-plan kernel for device {dev}")
    B, N = kcode.shape
    plan = FlashPlan(*(torch.empty(B, N, dtype=torch.int32, device=dev)
                       for _ in range(2)),
                     *(torch.empty(B, dtype=torch.int32, device=dev)
                       for _ in range(4)))
    _build.launch("flash_plan", (kcode, qrow, *plan), B, N, aligned=True)
    return plan


def _masked_scores(q, k, kcode, qrow, scale=None):
    """[B, H, N, Nk] float32 scores ``q·kᵀ·scale`` (of bfloat16 q and k
    widened, not rounded; scale 1/√dh by default), replaced by -1e9 where
    masked."""
    kc = kcode[:, None, None, :]
    allowed = (kc == 1) | ((qrow[:, None, :, None] == 1) & (kc == 2))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.where(allowed, s, NEG)


def flash_attn_fwd_plain(q, k, v, kcode, qrow, scale=None):
    """The TPU kernel's forward, written literally over the Np padded
    columns → (O [B, H, N, dh] in q's dtype, lse [B, H, N] float32).
    ``scale`` multiplies the scores (1/√dh by default)."""
    pad = padded_len(q.shape[2]) - q.shape[2]
    s = _masked_scores(q, F.pad(k, (0, 0, 0, pad)), F.pad(kcode, (0, pad)),
                       qrow, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p,
                     F.pad(v, (0, 0, 0, pad)).float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do,
                         per_block=True, scale=None):
    """The TPU kernel's backward, written literally → (dQ, dK, dV) in q's
    dtype.  The padded columns are left out: their k and v are 0, so they
    add nothing to dQ, and their dK and dV are discarded.  In bfloat16 the
    products are float32 from the widened operands, Δ = sum(dO·O) is
    rounded to bfloat16, and dK and dV are summed block by block of
    ``block_q(N)`` rows into bfloat16, as the TPU kernel's revisited
    output blocks sum them; with ``per_block`` False they are summed over
    all rows in float32 and rounded once, as the CUDA kernel sums them.
    ``scale`` as for ``flash_attn_fwd_plain``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    p = torch.exp(_masked_scores(q, k, kcode, qrow, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    # as XLA fuses the TPU kernel's bfloat16 sum(do * o): float32 products
    # and sum, rounded once
    delta = torch.sum(do.float() * o.float(), dim=-1,
                      keepdim=True).to(dt).float()
    ds = p * (dp - delta)
    dq = (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(dt)
    if dt == torch.float32 or not per_block:
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float()).to(dt)
        dk = (torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale).to(dt)
        return dq, dk, dv
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    bq = block_q(q.shape[2])
    for i in range(0, q.shape[2], bq):
        rows = slice(i, i + bq)
        dv += torch.einsum("bhqk,bhqd->bhkd", p[:, :, rows],
                           do[:, :, rows].float()).to(dt)
        dk += (torch.einsum("bhqk,bhqd->bhkd", ds[:, :, rows],
                            q[:, :, rows].float()) * scale).to(dt)
    return dq, dk, dv


def _check_codes(kcode, qrow, q=None):
    """kcode and qrow: contiguous int32 [B, N] tensors on one device, those
    of q ([B, H, N, dh]) where it is given."""
    shape = kcode.shape if q is None else (q.shape[0], q.shape[2])
    device = kcode.device if q is None else q.device
    for name, t in (("kcode", kcode), ("qrow", qrow)):
        if t.dim() != 2 or t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"[B, N] = {tuple(shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} is {t.dtype}; the codes are int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check(q, **floats):
    """Shape, dtype, contiguity and device of q and of ``floats``, the
    [B, H, N, dh] tensors beside it, all float32 or all bfloat16, and the
    [B, H, N] float32 lse."""
    if q.dim() != 4:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected "
                         f"[B, H, N, dh]")
    if q.dtype not in DTYPES:
        raise TypeError(f"q is {q.dtype}; the flash attention takes "
                        f"float32 or bfloat16")
    for name, t in (("q", q), *floats.items()):
        shape = q.shape[:3] if name == "lse" else q.shape
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        want = torch.float32 if name == "lse" else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; expected {want} with q "
                            f"{q.dtype}")
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
    kernel_dh(q.shape[-1])              # raises past DH_MAX
    return True


def _entry(name, q):
    """The entry point of kernel ``name`` for q's dtype."""
    return name if q.dtype == torch.float32 else f"{name}_bf16"


def _kernel_plan(q, kcode, qrow, plan):
    """The plan to launch with.  A given plan is taken as ``flash_plan``
    built and checked it: only its shape and device are held to q's.  The
    kernels read the codes through the plan alone."""
    if plan is None:
        _check_codes(kcode, qrow, q)
        return flash_plan(kcode, qrow)
    if (plan.key_perm.shape != (q.shape[0], q.shape[2])
            or plan.key_perm.device != q.device):
        raise ValueError(f"plan.key_perm is {tuple(plan.key_perm.shape)} on "
                         f"{plan.key_perm.device}; expected [B, N] on "
                         f"{q.device} like q {tuple(q.shape)}")
    return plan


def flash_attn_fwd(q, k, v, kcode, qrow, plan: Optional[FlashPlan] = None):
    """Role-masked attention forward.

    Args:
        q/k/v: [B, H, N, dh], all float32 or all bfloat16.
        kcode, qrow: [B, N] int32 codes (module docstring).
        plan: ``flash_plan(kcode, qrow)``, built here if not given.  The
            kernel reads the mask through the plan alone, so a given plan
            must be the one of these codes.
    Returns:
        (O [B, H, N, dh] in q's dtype, lse [B, H, N] float32); lse is
        the row logsumexp over the Np padded columns, for the backward.
    """
    _check(q, k=k, v=v)
    if not _kernel_device(q):
        _check_codes(kcode, qrow, q)
        count("flash.fwd", 1)
        with torch.no_grad():
            return flash_attn_fwd_plain(q, k, v, kcode, qrow)
    B, H, N, dh = q.shape
    lse = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return torch.empty_like(q), lse  # nothing to compute, no launch
    plan = _kernel_plan(q, kcode, qrow, plan)
    width = kernel_dh(dh)
    q, k, v = (pad_dh(t, width) for t in (q, k, v))
    o = torch.empty_like(q)
    _build.launch("flash_attn_fwd", (q, k, v, *plan, o, lse), B, H, N,
                  padded_len(N) - N, width, 1.0 / math.sqrt(dh),
                  entry=_entry("flash_attn_fwd", q), aligned=True)
    count("flash.fwd", 1)
    check_kernel_outputs(_entry("flash_attn_fwd", q), o, lse)
    return (o if width == dh else o[..., :dh].contiguous()), lse


def flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do,
                   plan: Optional[FlashPlan] = None):
    """Gradients of the role-masked attention for ``do = dL/dO``
    → (dQ, dK, dV), each [B, H, N, dh] in q's dtype.  ``plan`` as for
    ``flash_attn_fwd``.  On the card every gradient element is summed by
    one thread group in a fixed order (no atomics): the same inputs give
    bitwise the same gradients on every call."""
    _check(q, k=k, v=v, o=o, lse=lse, do=do)
    if not _kernel_device(q):
        _check_codes(kcode, qrow, q)
        count("flash.bwd", 1)
        with torch.no_grad():
            return flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do)
    B, H, N, dh = q.shape
    if q.numel() == 0:
        return tuple(torch.empty_like(q) for _ in range(3))
    plan = _kernel_plan(q, kcode, qrow, plan)
    width = kernel_dh(dh)
    q, k, v, o, do = (pad_dh(t, width) for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    _build.launch("flash_attn_bwd", (q, k, v, *plan, o, lse, do, dq, dk,
                                     dv, delta), B, H, N, width,
                  1.0 / math.sqrt(dh), entry=_entry("flash_attn_bwd", q),
                  aligned=True)
    count("flash.bwd", 1)
    check_kernel_outputs(_entry("flash_attn_bwd", q), dq, dk, dv)
    if width == dh:
        return dq, dk, dv
    return tuple(t[..., :dh].contiguous() for t in (dq, dk, dv))


class _FlashRoleAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kcode, qrow, plan):
        if plan is None:
            plan = flash_plan(kcode, qrow)      # one plan for both kernels
        o, lse = flash_attn_fwd(q, k, v, kcode, qrow, plan)
        ctx.save_for_backward(q, k, v, kcode, qrow, o, lse, *plan)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kcode, qrow, o, lse, *plan = ctx.saved_tensors
        return (*flash_attn_bwd(q, k, v, kcode, qrow, o, lse,
                                g.contiguous(), FlashPlan(*plan)),
                None, None, None)


def flash_role_attention(q, k, v, kcode, qrow,
                         plan: Optional[FlashPlan] = None):
    """Differentiable role-masked attention: [B, H, N, dh] q/k/v (float32
    or bfloat16),
    [B, N] int32 kcode/qrow (and their ``flash_plan``, built here if not
    given) → O [B, H, N, dh].  Without a gradient to
    record it calls the forward alone and saves nothing."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashRoleAttention.apply(q, k, v, kcode, qrow, plan)
    return flash_attn_fwd(q, k, v, kcode, qrow, plan)[0]
