"""The EIG fold of location finding as one kernel (no Pallas counterpart:
``aline_tpu/eval/eig.py`` ``_accumulate_chunks`` is fused by XLA).

``loc_eig_fold`` folds one chunk of contrastive draws into the running
logsumexp of the sPCE/sNMC bounds (``eval/eig.py``): for every draw l,
row b and step t the cumulative log-likelihood S[l, b, t] of the first
t + 1 outcomes under the draw's sources, reduced over l into the
(max, sumexp) state of each (b, t).

* On CUDA tensors it launches ``csrc/loc_eig_fold.cu``, which computes
  every term in registers and writes only [B, Th]-sized results.
* On CPU tensors it runs ``loc_eig_fold_plain``: the likelihood of
  ``tasks/location_finding.py``, ``torch.cumsum`` over the steps and
  ``lse_update``, as the generic fold of ``eval/eig.py`` runs them.

On a CUDA tensor the wrapper launches the kernel or raises; there is no
other path.  The kernel sums in another order than the plain version
(per thread, then over a block's threads, then over blocks; the source
note says how), always the same one: repeated calls agree bitwise.
"""
from __future__ import annotations

import torch

from aline_tpu_torch.ops import _build
from aline_tpu_torch.parallel.collectives import LogSumExpState, lse_update
from aline_tpu_torch.tasks.location_finding import log_likelihood
from aline_tpu_torch.utils.debug import check_kernel_outputs

# Kernel launches since the last reset; chip runs read it to show that the
# bounds went through the kernel (one launch a chunk).
LAUNCHES = {"loc_eig_fold": 0}


def loc_eig_fold_plain(state: LogSumExpState, x, y, thetas, n_valid: int,
                       base_signal: float, max_signal: float,
                       noise_scale: float) -> LogSumExpState:
    """The fold in plain PyTorch: S [Lc, B, Th], its rows from ``n_valid``
    on set to -inf, folded over its first axis."""
    ll = log_likelihood(y[None, ..., None], x[None], thetas.unsqueeze(2),
                        base_signal, max_signal, noise_scale)
    S = torch.cumsum(ll[..., 0], dim=-1)
    if n_valid < S.shape[0]:
        S[max(n_valid, 0):] = -torch.inf
    return lse_update(state, S, axis=0)


def _check(state, x, y, thetas):
    """dtype, device and shapes of the fold's inputs; True when they are
    CUDA tensors (launch the kernel), False for CPU ones."""
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
    if x.dim() != 3 or thetas.dim() != 4:
        raise ValueError(f"x must be [B, Th, D] and thetas [Lc, B, K, D], "
                         f"not {tuple(x.shape)} and {tuple(thetas.shape)}")
    B, Th, D = x.shape
    want = {"y": (y, (B, Th)), "state.max": (state.max, (B, Th)),
            "state.sumexp": (state.sumexp, (B, Th)),
            "thetas": (thetas, (thetas.shape[0], B, thetas.shape[2], D))}
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
def loc_eig_fold(state: LogSumExpState, x, y, thetas, n_valid: int,
                 base_signal: float, max_signal: float,
                 noise_scale: float) -> LogSumExpState:
    """Fold one chunk of location-finding draws into ``state``.

    Args:
        state: the running (max, sumexp), each [B, Th].
        x: [B, Th, D] designs in real space; y: [B, Th] outcomes.
        thetas: [Lc, B, K, D] the chunk's draws, of which the first
            ``n_valid`` count (the rest, padding past L, add nothing).
        base_signal, max_signal, noise_scale: the task's constants.
    Returns:
        the new state, new tensors (``state`` is left as it was).
    """
    if not _check(state, x, y, thetas):
        return loc_eig_fold_plain(state, x, y, thetas, n_valid, base_signal,
                                  max_signal, noise_scale)
    B, Th, D = x.shape
    n = min(max(int(n_valid), 0), thetas.shape[0])
    new_max = torch.empty_like(state.max)
    new_sumexp = torch.empty_like(state.sumexp)
    if new_max.numel() == 0:
        return LogSumExpState(new_max, new_sumexp)   # no launch
    lib = _build.load("loc_eig_fold")
    with torch.cuda.device(x.device):
        part = torch.empty(lib.loc_eig_fold_scratch(n, B, Th),
                           dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.loc_eig_fold(
            x.data_ptr(), y.data_ptr(), thetas.data_ptr(),
            state.max.data_ptr(), state.sumexp.data_ptr(),
            new_max.data_ptr(), new_sumexp.data_ptr(), part.data_ptr(), n,
            B, Th, thetas.shape[2], D, base_signal, max_signal, noise_scale,
            stream)
    if err != 0:
        raise RuntimeError(f"loc_eig_fold kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["loc_eig_fold"] += 1
    check_kernel_outputs("loc_eig_fold", new_max, new_sumexp)
    return LogSumExpState(new_max, new_sumexp)
