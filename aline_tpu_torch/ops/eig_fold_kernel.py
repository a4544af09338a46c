"""The EIG fold kernels (no Pallas counterpart: ``aline_tpu/eval/eig.py``
``_accumulate_chunks`` is fused by XLA).

A fold folds one chunk of contrastive draws into the running logsumexp of
the sPCE/sNMC bounds (``eval/eig.py``): for every draw l, row b and step t
the cumulative log-likelihood S[l, b, t] of the first t + 1 outcomes under
the draw, reduced over l into the (max, sumexp) state of each (b, t).  A
task whose likelihood has a kernel calls ``eig_fold`` with the kernel's
name from its ``fold_eig_chunk`` (``tasks/base.py``); every other task
folds generically there, through ``cum_loglik`` and ``lse_update``.

* On CUDA tensors ``eig_fold`` launches ``csrc/<kernel>.cu``:
  ``loc_eig_fold`` (location finding) and ``ces_eig_fold`` (CES with
  log_ndtr tails) compute every term in registers and write only
  [B, Th]-sized results (their streaming logsumexp is one,
  ``csrc/eig_fold_reduce.cuh``).
* On CPU tensors it runs ``eig_fold_plain``: the task's likelihood,
  ``torch.cumsum`` over the steps and ``lse_update``, the generic fold's
  operations without its spans.

On a CUDA tensor ``eig_fold`` launches its kernel or raises; there is no
other path.  The kernels sum in another order than the plain fold (per
thread, then over a block's threads, then over blocks; the source notes
say how), always the same one: repeated calls agree bitwise.
"""
from __future__ import annotations

import math

import torch

from aline_tpu_torch.ops import _build
from aline_tpu_torch.parallel.collectives import LogSumExpState, lse_update
from aline_tpu_torch.utils.debug import check_kernel_outputs


def cum_loglik(loglik, x, y, thetas, n_valid: int) -> torch.Tensor:
    """S [Lc, B, Th] with S[l, b, t] = sum_{s<=t} log p(y_s | x_s, th_l)
    under ``loglik`` (a task's ``log_likelihood``), for designs x
    [B, Th, D] (real space), outcomes y [B, Th] and thetas [Lc, B, ...];
    its rows from ``n_valid`` on set to -inf (the padding past L adds
    nothing)."""
    ll = loglik(y[None, ..., None], x[None], thetas.unsqueeze(2))
    S = torch.cumsum(ll[..., 0], dim=-1)
    if n_valid < S.shape[0]:
        S[max(n_valid, 0):] = -torch.inf
    return S


def eig_fold_plain(state: LogSumExpState, x, y, thetas, n_valid: int,
                   loglik) -> LogSumExpState:
    """The fold in plain PyTorch: ``cum_loglik`` folded over its first
    axis."""
    return lse_update(state, cum_loglik(loglik, x, y, thetas, n_valid),
                      axis=0)


def _check(state, x, y, thetas, draw, width):
    """dtype, device and shapes of the fold's inputs (``draw``: the
    trailing shape of one draw, ``width``: the designs'); True when they
    are CUDA tensors (launch the kernel), False for CPU ones."""
    named = {"x": x, "y": y, "thetas": thetas, "state.max": state.max,
             "state.sumexp": state.sumexp}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the EIG fold takes "
                            f"float32 only")
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no EIG fold kernel for device {x.device}")
    if x.dim() != 3 or thetas.dim() != 2 + len(draw):
        raise ValueError(f"x must be [B, Th, D] and thetas [Lc, B, "
                         f"{', '.join(map(str, draw))}], not "
                         f"{tuple(x.shape)} and {tuple(thetas.shape)}")
    B, Th, _ = x.shape
    want = {"y": (y, (B, Th)), "state.max": (state.max, (B, Th)),
            "state.sumexp": (state.sumexp, (B, Th)),
            "thetas": (thetas, (thetas.shape[0], B) + tuple(draw)),
            "x": (x, (B, Th, width))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if x.device.type == "cpu":
        return False
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return True


@torch.no_grad()
def eig_fold(kernel: str, state: LogSumExpState, x, y, thetas, n_valid: int,
             *, loglik, draw, width: int, numbers) -> LogSumExpState:
    """Fold one chunk of draws into ``state`` with fold kernel ``kernel``.

    Args:
        kernel: the kernel's library (``_build.SIGNATURES``); its entry
            takes x, y, thetas, the state in and out, the scratch of
            ``<kernel>_scratch(n_valid, B, Th)`` floats, n_valid, B, Th,
            then ``numbers``.
        state: the running (max, sumexp), each [B, Th].
        x: [B, Th, width] designs in real space; y: [B, Th] outcomes.
        thetas: [Lc, B, *draw] the chunk's draws, of which the first
            ``n_valid`` count (the rest, padding past L, add nothing).
        loglik: the task's ``log_likelihood``, which the plain fold
            (CPU tensors) computes.
        numbers: the task's constants the kernel takes.
    Returns:
        the new state, new tensors (``state`` is left as it was).
    """
    if not _check(state, x, y, thetas, draw, width):
        return eig_fold_plain(state, x, y, thetas, n_valid, loglik)
    B, Th, _ = x.shape
    n = min(max(int(n_valid), 0), thetas.shape[0])
    new_max = torch.empty_like(state.max)
    new_sumexp = torch.empty_like(state.sumexp)
    if new_max.numel() == 0:
        return LogSumExpState(new_max, new_sumexp)   # no launch
    scratch = getattr(_build.load(kernel), f"{kernel}_scratch")(n, B, Th)
    part = torch.empty(scratch, dtype=torch.float32, device=x.device)
    _build.launch(kernel, (x, y, thetas, state.max, state.sumexp, new_max,
                           new_sumexp, part), n, B, Th, *numbers)
    check_kernel_outputs(kernel, new_max, new_sumexp)
    return LogSumExpState(new_max, new_sumexp)


_F32_ULP = 2.0 ** -24
_LOG_2PI = math.log(2 * math.pi)


@torch.no_grad()
def ces_fold_tolerance(state: LogSumExpState, task, x, y, thetas,
                       n_valid: int) -> torch.Tensor:
    """[B, Th] how far the logsumexp (max + log sumexp) of two float32
    folds of the same chunk of CES (``task``) may lie apart (the kernel
    ``ces_eig_fold`` and ``eig_fold_plain``, or an emulation of either),
    in float64 from
    the inputs (on their device, 4096 draws at a time).

    Whatever two float32 implementations of the formula round
    differently (the kernel: log_ndtr and the running sum's order; on
    the CPU also the powers and the order of the utilities' sums), each
    draw's S moves by up to what float32 rounding of its terms may move
    it by, both sides:

    * a utility U = w^(1/rho) by (12 / rho + 4 |log U| + 16) ulps of it:
      the outer power multiplies the few ulps of the weighted sum w by
      1 / rho, up to 100;
    * z = (logit y - mu) / sigma by what U's and 4 ulps of |logit y| and
      |mu| move it by, over sigma, plus 8 ulps of |z|;
    * a term by its slope in z times z's error (|z| inside, phi(v) /
      Phi(v) at a limit, v = -z at the upper one, z at the lower) plus 8
      ulps of the sizes it is summed from (|ll| and 1; inside z^2 / 2,
      |log sigma|, |log y|, |log(1 - y)|; at a limit v^2 / 2 where
      v < -1, the erfcx form's);
    * S_t by the sum of its terms' and (t + 1) ulps of the sum of their
      sizes (the running sum's order).

    The logsumexp moves by those weighted by each draw's share of it
    (the state's mass has none), plus 1e-5 and (Th + 8) ulps of its size
    for the sum of exponentials' order, as for location finding.
    """
    f64, e = torch.float64, _F32_ULP
    lo, hi = (torch.tensor(v, dtype=torch.float32).item()
              for v in (task.epsilon, 1.0 - task.epsilon))
    xc = x.to(f64).clamp(0.01, 100.0)
    b1, b2 = xc[..., :3], xc[..., 3:]
    s0 = (1.0 + torch.linalg.vector_norm(b1 - b2, dim=-1)) * task.noise_scale
    yd = y.to(f64)
    log_y, log_1y = torch.log(yd), torch.log1p(-yd)
    logit = log_y - log_1y
    inside = (yd > lo) & (yd < hi)
    at_hi, at_lo = yd == hi, yd == lo
    Th = x.shape[1]
    steps = torch.arange(1, Th + 1, dtype=f64, device=x.device)
    m = torch.full(y.shape, -torch.inf, dtype=f64, device=x.device)
    mass = torch.zeros(y.shape, dtype=f64, device=x.device)
    moved = torch.zeros(y.shape, dtype=f64, device=x.device)
    n = min(max(int(n_valid), 0), thetas.shape[0])
    for l0 in range(0, n, 4096):
        th = thetas[l0:min(l0 + 4096, n)].to(f64)[:, :, None]
        rho, alpha, log_u = th[..., 0], th[..., 1:4], th[..., 4]
        U = [torch.sum(alpha * b[None] ** rho[..., None], -1) ** (1 / rho)
             for b in (b1, b2)]
        u = torch.exp(log_u)
        mu, sigma = (U[0] - U[1]) * u, s0 * u
        z = (logit - mu) / sigma
        e_U = sum(Uk * e * (12 / rho + 4 * torch.log(Uk).abs() + 16)
                  for Uk in U)
        e_z = ((u * e_U + 4 * e * (logit.abs() + mu.abs())) / sigma
               + 8 * e * z.abs())
        log_sigma = torch.log(sigma)
        # at a limit the term is log_ndtr(v), v = -z at the upper one
        v = torch.where(at_hi, -z, z)
        tail = torch.special.log_ndtr(v)
        ll = torch.where(at_hi | at_lo, tail, torch.where(
            inside, -0.5 * (z * z + _LOG_2PI) - log_sigma - log_y - log_1y,
            -torch.inf))
        finite = torch.isfinite(ll)
        size = torch.where(finite, ll.abs(), 0.0)
        # the slope of the term in z, and the sizes it is summed from
        # (phi / Phi(v) = sqrt(2 / pi) / erfcx(-v / sqrt 2): no exp of
        # -v^2 / 2 less log Phi(v), which cancel to nothing in the tail)
        slope = torch.where(inside, z.abs(), math.sqrt(2 / math.pi)
                            / torch.special.erfcx(-v / math.sqrt(2)))
        parts = torch.where(inside, 0.5 * z * z + log_sigma.abs()
                            + log_y.abs() + log_1y.abs(),
                            torch.where(v < -1, 0.5 * v * v, 0.0))
        e_ll = torch.where(finite, slope * e_z + 8 * e * (size + parts + 1),
                           0.0)
        S = torch.cumsum(ll, -1)
        e_S = torch.cumsum(e_ll, -1) + e * steps * torch.cumsum(size, -1)
        # streaming (max, sum of exp(S - max), sum of exp(S - max) e_S)
        new_m = torch.maximum(m, S.amax(0))
        safe = torch.where(torch.isfinite(new_m), new_m, 0.0)
        scale = torch.exp(torch.where(torch.isfinite(m), m - safe,
                                      -torch.inf))
        w = torch.exp(S - safe)
        mass = mass * scale + w.sum(0)
        moved = moved * scale + (w * e_S).sum(0)
        m = new_m
    lse = state.max.to(f64) + torch.log(state.sumexp.to(f64))
    safe = torch.where(torch.isfinite(m), m, 0.0)
    total = mass + torch.exp(torch.where(torch.isfinite(lse), lse - safe,
                                         -torch.inf))
    weighted = torch.where(total > 0, moved / total, 0.0)
    lse = torch.logaddexp(lse, torch.where(mass > 0, m + torch.log(mass),
                                           -torch.inf))
    size = torch.where(torch.isfinite(lse), lse.abs(), 0.0)
    return 1e-5 + (Th + 8) * e * size + weighted
