"""Classical Gaussian-process active-learning baselines
(``aline_tpu/eval/gp_al_baselines.py``).

An exact GP regressor (RBF kernel with per-dimension lengthscales) fitted
by ML-II: ``fit_steps`` Adam steps on the masked marginal likelihood, from
the same start every step.  Then one acquisition score per pool point:
uncertainty sampling, GP-UCB, variance reduction, EPIG, BALD or random.

Every tensor carries a leading problem axis: the B problems of a batch,
and in ``compare_acquisition_methods`` the B problems once per method,
stacked, so that all methods fit in the same batched factorisations (the
problems are independent; the arithmetic of each is the JAX package's).
A fit is a Python loop of Adam steps, each a batched Cholesky and its
backward pass by autograd; JAX runs the same loop as a ``lax.scan``.

Nothing waits for the host: ``torch.linalg.cholesky_ex`` reports a failed
factorisation in ``info``, which turns that factor into NaN (as
``jnp.linalg.cholesky`` returns it) by arithmetic, and the argmax, the
mask update and the Adam step stay on the device.  The factor of the
fitted parameters is computed once per step and shared by the metrics and
every acquisition (JAX factors again in each call; the numbers are the
same).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aline_tpu_torch.distributions.gmm import normal_log_prob

ACQUISITION_FUNCTIONS = ("uncertainty", "ucb", "variance_reduction",
                         "epig", "bald", "random")
UCB_BETA = 2.0
JITTER = 1e-6
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class GPParams(NamedTuple):
    log_ls: torch.Tensor      # [N, D]
    log_amp: torch.Tensor     # [N]
    log_noise: torch.Tensor   # [N]


def init_params(n: int, dim: int, device) -> GPParams:
    """The fit's start: unit lengthscales and amplitude, noise 0.1."""
    return GPParams(torch.zeros(n, dim, device=device),
                    torch.zeros(n, device=device),
                    torch.full((n,), 0.1, device=device).log())


def _rbf(x1, x2, params: GPParams):
    """[N, A, D], [N, B, D] → [N, A, B]."""
    ls = params.log_ls.exp()[:, None, None, :]
    d = (x1[:, :, None, :] - x2[:, None, :, :]) / ls
    return (params.log_amp.exp()[:, None, None]
            * torch.exp(-0.5 * torch.sum(d * d, dim=-1)))


def _noise(params: GPParams):
    return params.log_noise.exp() + 1e-6


def _cholesky(K):
    """Lower Cholesky factor of K [N, n, n]; a factor that fails is NaN
    (added, so that a gradient through it is NaN too, as in JAX)."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = torch.where(info > 0, math.nan, 0.0).to(K.dtype)
    return L + bad[:, None, None]


def _masked_cov(params: GPParams, X, mask):
    """K(X, X) with masked-out rows turned into iid unit-variance
    pseudo-observations, the noise on the diagonal, plus the jitter."""
    m = mask.to(X.dtype)
    K = _rbf(X, X, params) * m[:, :, None] * m[:, None, :]
    diag = torch.where(mask, _noise(params)[:, None],
                       torch.ones_like(m))
    K = K + torch.diag_embed(diag)
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return K + JITTER * eye


def _cho_solve(L, b):
    """K⁻¹ b for K = L Lᵀ, b [N, n] (two triangular solves, as
    ``jax.scipy.linalg.cho_solve``)."""
    z = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def _neg_mll(params: GPParams, X, y, mask):
    """[N] negative log marginal likelihood of y [N, n] at X [N, n, D]
    over the rows where ``mask`` [N, n] is True."""
    m = mask.to(X.dtype)
    L = _cholesky(_masked_cov(params, X, mask))
    yv = torch.where(mask, y, torch.zeros_like(y))
    alpha = _cho_solve(L, yv)
    return (0.5 * torch.sum(yv * alpha, dim=-1)
            + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)) * m,
                        dim=-1)
            + 0.5 * torch.sum(m, dim=-1) * math.log(2 * math.pi))


def fit_gp(X, y, mask, n_steps: int = 80, lr: float = 0.1) -> GPParams:
    """ML-II fit by Adam on the exact marginal likelihood, every problem
    from ``init_params``.  Adam as the JAX package writes it: bias
    corrections with t = i + 1 in float32, ε outside the square root."""
    p = init_params(X.shape[0], X.shape[-1], X.device)
    m1 = [torch.zeros_like(t) for t in p]
    m2 = [torch.zeros_like(t) for t in p]
    for i in range(n_steps):
        leaves = [t.detach().requires_grad_() for t in p]
        with torch.enable_grad():
            loss = _neg_mll(GPParams(*leaves), X, y, mask).sum()
            grads = torch.autograd.grad(loss, leaves)
        t = np.float32(i + 1.0)
        bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
        with torch.no_grad():
            new = []
            for j, (pp, g) in enumerate(zip(p, grads)):
                m1[j] = ADAM_B1 * m1[j] + (1 - ADAM_B1) * g
                m2[j] = ADAM_B2 * m2[j] + (1 - ADAM_B2) * g * g
                mh = m1[j] / bc1
                vh = m2[j] / bc2
                new.append(pp - lr * mh / (torch.sqrt(vh) + ADAM_EPS))
        p = GPParams(*new)
    return p


class GPFactor(NamedTuple):
    """A fitted GP conditioned on its masked data, factored once."""
    params: GPParams
    X: torch.Tensor       # [N, n, D]
    m: torch.Tensor       # [N, n] float mask
    L: torch.Tensor       # [N, n, n]
    alpha: torch.Tensor   # [N, n]
    noise: torch.Tensor   # [N]


def gp_factor(params: GPParams, X, y, mask) -> GPFactor:
    L = _cholesky(_masked_cov(params, X, mask))
    alpha = _cho_solve(L, torch.where(mask, y, torch.zeros_like(y)))
    return GPFactor(params, X, mask.to(X.dtype), L, alpha, _noise(params))


def _project(f: GPFactor, Xs):
    """(K(Xs, X) masked [N, M, n], L⁻¹ K(X, Xs) [N, n, M])."""
    Ks = _rbf(Xs, f.X, f.params) * f.m[:, None, :]
    return Ks, torch.linalg.solve_triangular(f.L, Ks.mT, upper=False)


def _mean_var(f: GPFactor, Ks, v):
    mean = (Ks @ f.alpha[..., None])[..., 0]
    var = f.params.log_amp.exp()[:, None] - torch.sum(v * v, dim=1)
    return mean, torch.clamp(var, min=1e-10)


def gp_posterior(params: GPParams, X, y, mask, Xs):
    """(mean [N, M], variance [N, M], noise variance [N]) at Xs."""
    f = gp_factor(params, X, y, mask)
    return (*_mean_var(f, *_project(f, Xs)), f.noise)


def _cross_cov(f: GPFactor, A, vA, B, vB):
    """cov(f(A), f(B) | data) [N, |A|, |B|] from their projections."""
    return _rbf(A, B, f.params) - vA.mT @ vB


def _posterior_cov(params: GPParams, X, mask, A, B):
    """Posterior cross-covariance cov(f(A), f(B) | X)."""
    f = gp_factor(params, X, torch.zeros(mask.shape, device=X.device),
                  mask)
    return _cross_cov(f, A, _project(f, A)[1], B, _project(f, B)[1])


# ---------------------------------------------------------------------------
# Acquisition scores (higher = better) over the candidates Xq
# ---------------------------------------------------------------------------

class _Views(NamedTuple):
    """What the scores read: the posterior at the candidates and at the
    targets, and their projections."""
    f: GPFactor
    Xq: torch.Tensor
    mean_q: torch.Tensor
    var_q: torch.Tensor
    v_q: torch.Tensor
    Xt: torch.Tensor
    mean_t: torch.Tensor
    var_t: torch.Tensor
    v_t: torch.Tensor


def _views(f: GPFactor, Xq, Xt) -> _Views:
    Kq, v_q = _project(f, Xq)
    Kt, v_t = _project(f, Xt)
    return _Views(f, Xq, *_mean_var(f, Kq, v_q), v_q, Xt,
                  *_mean_var(f, Kt, v_t), v_t)


def acq_uncertainty(s: _Views):
    """Maximum posterior variance."""
    return s.var_q


def acq_ucb(s: _Views, beta: float = UCB_BETA):
    """GP-UCB."""
    return s.mean_q + beta * torch.sqrt(s.var_q)


def _cov_tq(s: _Views):
    return _cross_cov(s.f, s.Xt, s.v_t, s.Xq, s.v_q)        # [N, Nt, Nq]


def acq_variance_reduction(s: _Views):
    """Expected total variance reduction at the targets:
    cov(f_t, f_c)² / (var(f_c) + noise), summed over t."""
    noise = s.f.noise[:, None]
    return torch.sum(_cov_tq(s) ** 2, dim=1) / (s.var_q + noise)


def acq_epig(s: _Views):
    """Expected predictive information gain at the targets:
    -½ Σ_t log(1 - ρ²)."""
    noise = s.f.noise[:, None]
    rho2 = _cov_tq(s) ** 2 / ((s.var_q + noise)[:, None, :]
                             * s.var_t[:, :, None])
    rho2 = torch.clamp(rho2, 0.0, 1.0 - 1e-6)
    return -0.5 * torch.sum(torch.log1p(-rho2), dim=1)


def acq_bald(s: _Views):
    """BALD for GP regression: ½ log(1 + var_f / noise)."""
    return 0.5 * torch.log1p(s.var_q / s.f.noise[:, None])


_ACQ = {"uncertainty": acq_uncertainty, "ucb": acq_ucb,
        "variance_reduction": acq_variance_reduction, "epig": acq_epig,
        "bald": acq_bald}


def acquisition_scores(method: str, params: GPParams, X, y, mask, Xq, Xt,
                       uniform: Optional[torch.Tensor] = None):
    """[N, |Xq|] scores of one method (``random``: the given ``uniform``
    draws)."""
    if method == "random":
        return uniform
    f = gp_factor(params, X, y, mask)
    return _ACQ[method](_views(f, Xq, Xt))


# ---------------------------------------------------------------------------
# Active-learning driver
# ---------------------------------------------------------------------------

def compare_acquisition_methods(
        x, y, target_x, target_y, n_ctx_init: int, T: int,
        generator: Optional[torch.Generator] = None,
        methods: Sequence[str] = ACQUISITION_FUNCTIONS,
        fit_steps: int = 80, uniform: Optional[torch.Tensor] = None,
        return_scores: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """T AL steps of each method on the same B problems.

    Args:
        x/y: [B, P, D] / [B, P, 1] candidate pool (the first
            ``n_ctx_init`` are the initial context).
        target_x/target_y: [B, Nt, D] / [B, Nt, 1] held-out points.
        generator: draws ``random``'s scores when ``uniform`` is None.
        uniform: optional [T, B, P] uniform scores for ``random`` (e.g.
            the JAX package's draws).

    Returns ``{method: {"rmse": [B, T+1], "log_prob": [B, T+1], "idx":
    [B, T]}}``: the predictive Gaussian at the targets before each
    acquisition, and once after the last, and the chosen points; with
    ``return_scores`` also ``"scores"`` [B, T, P], each step's scores
    (-inf on the context).
    """
    for name in methods:
        if name != "random" and name not in _ACQ:
            raise ValueError(f"unknown acquisition {name!r}")
    n_m = len(methods)
    B, P, _ = x.shape
    dev = x.device
    if "random" in methods and uniform is None:
        uniform = torch.rand(T, B, P, generator=generator, device=dev)
    X, Xt = x.repeat(n_m, 1, 1), target_x.repeat(n_m, 1, 1)
    Y, Yt = y[..., 0].repeat(n_m, 1), target_y[..., 0].repeat(n_m, 1)
    mask = (torch.arange(P, device=dev) < n_ctx_init)[None].repeat(
        n_m * B, 1)
    rmses, lps, idxs, all_scores = [], [], [], []
    for t in range(T + 1):
        params = fit_gp(X, Y, mask, fit_steps)
        with torch.no_grad():
            f = gp_factor(params, X, Y, mask)
            s = _views(f, X, Xt)
            rmses.append(torch.sqrt(torch.mean((s.mean_t - Yt) ** 2,
                                               dim=-1)))
            lps.append(torch.mean(normal_log_prob(
                Yt, s.mean_t, torch.sqrt(s.var_t + f.noise[:, None])),
                dim=-1))
            if t == T:
                break
            scores = []
            for i, name in enumerate(methods):
                sl = slice(i * B, (i + 1) * B)
                if name == "random":
                    scores.append(uniform[t])
                    continue
                part = _Views(GPFactor(GPParams(*(q[sl] for q in f.params)),
                                       f.X[sl], f.m[sl], f.L[sl],
                                       f.alpha[sl], f.noise[sl]),
                              *(q[sl] for q in s[1:]))
                scores.append(_ACQ[name](part))
            scores = torch.cat(scores, dim=0)
            scores = torch.where(mask, torch.full_like(scores, -math.inf),
                                 scores)
            idx = torch.argmax(scores, dim=-1)
            mask = mask.scatter(1, idx[:, None], True)
            idxs.append(idx)
            if return_scores:
                all_scores.append(scores)

    def per_method(steps, *shape):
        return torch.stack(steps, dim=1).reshape(n_m, B, *shape)

    out = {"rmse": per_method(rmses, T + 1),
           "log_prob": per_method(lps, T + 1),
           "idx": (per_method(idxs, T) if T else
                   torch.zeros(n_m, B, 0, dtype=torch.int64, device=dev))}
    if return_scores and T:
        out["scores"] = per_method(all_scores, T, P)
    return {name: {k: v[i] for k, v in out.items()}
            for i, name in enumerate(methods)}


def active_learning_with_gp(x, y, target_x, target_y, n_ctx_init: int,
                            T: int,
                            generator: Optional[torch.Generator] = None,
                            acquisition: str = "uncertainty",
                            fit_steps: int = 80,
                            uniform: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
    """T AL steps of one method: ``{"rmse", "log_prob"}``, each [B, T+1]
    (see ``compare_acquisition_methods``)."""
    return compare_acquisition_methods(
        x, y, target_x, target_y, n_ctx_init, T, generator, (acquisition,),
        fit_steps, uniform)[acquisition]
