"""sPCE / sNMC bounds of the CES preference experiment (constant
elasticity of substitution; ALINE, arXiv 2506.07259), written from the
model's equations:

    theta = (rho, alpha_1..3, log u)
    xi    = (b1, b2), two baskets of 3 goods, each clamped to [0.01, 100]
    U(b)  = (sum_i alpha_i b_i^rho)^(1/rho)
    mu    = (U(b1) - U(b2)) u,   sigma = (1 + |b1 - b2|) noise u,   u = e^log u
    y     = clamp(sigmoid(mu + sigma eps), e, 1 - e),   eps ~ N(0, 1)

so that the log-density of an outcome y is

    log N(logit y; mu, sigma) - log y - log(1 - y)   for e < y < 1 - e
    log Phi((logit e - mu) / sigma)                  at y = e
    log Phi(-(logit(1 - e) - mu) / sigma)            at y = 1 - e
    -inf                                             outside [e, 1 - e]

with log Phi = ``torch.special.log_ndtr``, exact in the deep tail.  The
bounds are, as for location finding (``reference/eig.py``),

    sPCE = log(L+1) - [logsumexp_{l=0..L} S_l - S_0]
    sNMC = log(L)   - [logsumexp_{l=1..L} S_l - S_0]

with S_l[b, t] the log-likelihood of the first t+1 outcomes of row b
under theta_l, theta_0 the latent that generated them.

The L contrastive draws are the program's, by its stated rule: chunk i
of Lc draws comes from a ``torch.Generator`` on the device seeded with
``derive_seed(seed, i)``, with Lc from ``chunk_size`` (``reference/eig.py``),
and from it, in this order, for the whole batch [Lc, B]: rho = 0.01 +
0.99 U (``torch.rand``), three Exp(1) draws over their sum for alpha
(``Tensor.exponential_``), log u = 1 + 3 N (``torch.randn``).  The
reference draws them again from that rule; it takes nothing the program
computed.

Departures from the paper's description: rho ~ Beta(1, 1) is kept off
zero as 0.01 + 0.99 U, so that the outer power 1/rho stays finite;
alpha ~ Dirichlet(1, 1, 1) is drawn as normalised Exp(1) draws (exact at
concentration 1); the limits' mass is ``log_ndtr`` of their z-scores,
where the original code had a hand-rolled asymptote; the bounds are in
float32 and the draws are PyTorch's, not the original's.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.eig import chunk_size, derive_seed
from portbench.reference.model import LOG_2PI, Rounder

DESIGN_MIN, DESIGN_MAX = 0.01, 100.0


def prior(gen: torch.Generator, shape) -> torch.Tensor:
    """[*shape, 5] draws (rho, alpha_1..3, log u) from ``gen``, in the
    rule's order."""
    shape = tuple(shape)
    rho = 0.01 + 0.99 * torch.rand(shape, generator=gen, device=gen.device)
    e = torch.empty(shape + (3,), device=gen.device)
    e.exponential_(1.0, generator=gen)
    alpha = e / e.sum(-1, keepdim=True)
    log_u = 1.0 + 3.0 * torch.randn(shape, generator=gen, device=gen.device)
    return torch.cat([rho[..., None], alpha, log_u[..., None]], dim=-1)


def response(xi, theta, noise: float, r: Rounder):
    """(mu, sigma) [...] of the latent response to designs xi [..., 6]
    under theta [..., 5] (broadcast); ``r`` rounds every result."""
    rho, alpha = theta[..., 0:1], theta[..., 1:4]
    u = r(torch.exp(theta[..., 4]))
    xi = xi.clamp(DESIGN_MIN, DESIGN_MAX)
    b1, b2 = xi[..., :3], xi[..., 3:]

    def U(b):
        s = r((alpha * r(b ** rho)).sum(-1, keepdim=True))
        return r(s ** r(1.0 / rho))[..., 0]

    mu = r(r(U(b1) - U(b2)) * u)
    d = b1 - b2
    dist = r(torch.sqrt(r((d * d).sum(-1))))
    return mu, r(r(r(1.0 + dist) * noise) * u)


def loglik(y, xi, theta, task: dict, r: Rounder):
    """log p(y | xi, theta): y [..., 1], xi [..., 6], theta [..., 5]
    broadcast → [...]; ``r`` rounds every result."""
    v = y[..., 0]
    lo = torch.full((), task["epsilon"], device=v.device)
    hi = torch.full((), 1.0 - task["epsilon"], device=v.device)
    mu, sigma = response(xi, theta, task["noise_scale"], r)

    def logit(p):
        return r(r(torch.log(p)) - r(torch.log1p(-p)))

    z = r(r(logit(v) - mu) / sigma)
    inside = r(r(r(-0.5 * r(z * z + LOG_2PI)) - r(torch.log(sigma)))
               - r(r(torch.log(v)) + r(torch.log1p(-v))))
    at_lo = r(torch.special.log_ndtr(r(r(logit(lo) - mu) / sigma)))
    at_hi = r(torch.special.log_ndtr(-r(r(logit(hi) - mu) / sigma)))
    out = torch.where(v == hi, at_hi, torch.where(v == lo, at_lo, inside))
    return torch.where((v < lo) | (v > hi), -torch.inf, out)


@torch.no_grad()
def ces_bounds(theta0, x, y, L: int, seed: int, L_chunk: int, task: dict,
               r: Rounder, B_draw: int = None, rows=None):
    """(pce, nmc) [b, Th] of designs x [b, Th, 6], outcomes y [b, Th, 1]
    and latents theta0 [b, 5]: rows ``rows`` of a batch of ``B_draw``
    rows (default: the whole batch), whose draws are made for the whole
    batch."""
    # no TF32 anywhere in the process, as the program's device sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, Th = x.shape[:2]
    B = B_draw or b
    S0 = r(torch.cumsum(loglik(y, x, theta0[:, None], task, r), -1))
    Lc = chunk_size(L, B, Th, L_chunk)
    gen = torch.Generator(device=x.device)
    acc = torch.full((b, Th), -torch.inf, device=x.device)
    for i in range(math.ceil(L / Lc)):
        gen.manual_seed(derive_seed(seed, i))
        th = prior(gen, (Lc, B))[:max(0, min(Lc, L - i * Lc))]
        if rows is not None:
            th = th[:, rows]
        S = r(torch.cumsum(loglik(y[None], x[None], th[:, :, None], task, r),
                           -1))
        acc = torch.logaddexp(acc, r(torch.logsumexp(S, dim=0)))
    pce = math.log(L + 1) - (torch.logaddexp(acc, S0) - S0)
    nmc = math.log(L) - (acc - S0)
    return pce, nmc
