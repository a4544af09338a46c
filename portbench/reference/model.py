"""Plain PyTorch forward pass of ALINE, written from the model's
equations, for judging what the port computed.

It reads the weights from the committed npz of flax parameters (a raw
file that the port reads too) and imports nothing of the port.  The
model is: a point embedder (x MLP, plus a y MLP on context points),
learned theta tokens, ``num_layers`` post-norm encoder layers under the
ALINE role mask (every row sees the context; query rows also see the
selected targets), an acquisition MLP over the pool, and C per-component
MLPs giving a Gaussian mixture for every target (and pool) token.

Precision follows flax's ``dtype``: a ``Rounder`` rounds the operands
and results of each dense product to the compute dtype, sums in float32,
normalises LayerNorm in float32 and rounds once.  ``Rounder("float32")``
is the identity.  The reference computes in the precision that the
configuration states, and one step below it for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

NEG = -1e9
LN_EPS = 1e-6
FP8_MAX = 448.0


class Rounder:
    """Rounds a float32 tensor to ``dtype`` and back (float8 saturates at
    its largest finite value, as a scaled fp8 product would clip)."""

    def __init__(self, dtype: str):
        self.name = dtype
        self.dtype = {"float32": None, "bfloat16": torch.bfloat16,
                      "float8_e4m3fn": torch.float8_e4m3fn}[dtype]

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return t
        if self.dtype == torch.float8_e4m3fn:
            t = t.clamp(-FP8_MAX, FP8_MAX)
        return t.to(self.dtype).float()


def load_params(npz_path, device) -> Dict[str, torch.Tensor]:
    """The flax parameters, float32, keyed by their flax paths without
    the leading ``params/``."""
    with np.load(npz_path) as z:
        return {k[len("params/"):]: torch.tensor(np.asarray(z[k], np.float32),
                                                 device=device)
                for k in z.files}


@dataclass
class Inputs:
    """One batch: the candidate points (context first), the targets."""
    x: torch.Tensor            # [B, Np, dx]
    y: torch.Tensor            # [B, Np, 1]
    target_x: torch.Tensor     # [B, Td, dx]
    n_theta: int
    target_mask: torch.Tensor  # [Td + n_theta] bool


def dense(P, name, x, r: Rounder):
    w, b = P[name + "/kernel"], P[name + "/bias"]
    return r(r(r(x) @ r(w)) + r(b))


def mlp(P, name, x, r):
    return dense(P, name + "/fc2", torch.relu(dense(P, name + "/fc1", x, r)),
                 r)


def layer_norm(P, name, x, r):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return r((x - mu) / torch.sqrt(var + LN_EPS) * P[name + "/scale"]
             + P[name + "/bias"])


def embed(P, inp: Inputs, ctx: torch.Tensor, r: Rounder) -> torch.Tensor:
    pts = mlp(P, "embedder/x_embedder", inp.x, r)
    yv = mlp(P, "embedder/y_embedder", inp.y, r)
    pts = r(pts + yv * ctx[..., None].float())
    segs = [pts]
    if inp.target_x.shape[1]:
        segs.append(mlp(P, "embedder/x_embedder", inp.target_x, r))
    if inp.n_theta:
        th = r(P["embedder/theta_tokens"])
        segs.append(th[None].expand(inp.x.shape[0], -1, -1))
    return torch.cat(segs, dim=1)


def allowed_mask(ctx: torch.Tensor, n_target: int,
                 target_mask: torch.Tensor) -> torch.Tensor:
    """[B, N, N] bool: row i may read column j."""
    B = ctx.shape[0]
    k_ctx = torch.cat([ctx, ctx.new_zeros(B, n_target)], dim=1)
    q_query = torch.cat([~ctx, ctx.new_zeros(B, n_target)], dim=1)
    k_sel = torch.cat([ctx.new_zeros(ctx.shape),
                       target_mask[None].expand(B, -1)], dim=1)
    return k_ctx[:, None, :] | (q_query[:, :, None] & k_sel[:, None, :])


def encoder(P, h, allowed, n_layers, n_head, r):
    B, N, D = h.shape
    dh = D // n_head
    bias = torch.where(allowed, 0.0, NEG)[:, None]          # [B, 1, N, N]
    for i in range(n_layers):
        pre = f"encoder/layer_{i}"
        qkv = dense(P, pre + "/self_attn/qkv_proj", h, r)
        q, k, v = (t.reshape(B, N, n_head, dh).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        s = r(q @ k.transpose(-1, -2)) / math.sqrt(dh)
        p = torch.softmax(s + bias, dim=-1)
        o = r(r(p) @ v).transpose(1, 2).reshape(B, N, D)
        a = dense(P, pre + "/self_attn/out_proj", o, r)
        h = layer_norm(P, pre + "/norm1", r(h + a), r)
        f = dense(P, pre + "/linear2",
                  torch.relu(dense(P, pre + "/linear1", h, r)), r)
        h = layer_norm(P, pre + "/norm2", r(h + f), r)
    return h


def gmm_head(P, z, r: Rounder, std_min: float):
    """(means, stds, weights) [B, n, C] of the C component MLPs."""
    w1, b1 = P["head/target_head/heads_w1"], P["head/target_head/heads_b1"]
    w2, b2 = P["head/target_head/heads_w2"], P["head/target_head/heads_b2"]
    h = torch.relu(r(r(torch.einsum("btd,cdf->btcf", r(z), r(w1)))
                     + r(b1)))
    out = r(torch.einsum("btcf,cfo->btco", h, r(w2))) + b2
    mean, raw_std, raw_w = out.unbind(-1)
    return (mean, torch.nn.functional.softplus(raw_std) + std_min,
            torch.softmax(raw_w, dim=-1))


@dataclass
class Precision:
    """Rounders of each part: the model, the GMM head on token sets of
    ``head_min_tokens`` or more (``pool_head``), and the bounds."""
    model: Rounder
    pool_head: Rounder
    head_min_tokens: int = 1024


def forward(P, inp: Inputs, ctx: torch.Tensor, prec: Precision, arch: dict,
            pool_posterior: bool = False):
    """The model at one step: ``logits`` [B, Np] of the design head over
    the pool (-1e9 elsewhere), ``log_probs`` of it, ``target`` (means,
    stds, weights) and, with ``pool_posterior``, ``pool`` alike."""
    r = prec.model
    Np = inp.x.shape[1]
    n_target = inp.target_mask.shape[0]
    h = embed(P, inp, ctx, r)
    h = encoder(P, h, allowed_mask(ctx, n_target, inp.target_mask),
                arch["num_layers"], arch["n_head"], r)
    z_pts, z_tgt = h[:, :Np], h[:, Np:]
    a = torch.relu(dense(P, "head/acquisition_head/predictor_fc1", z_pts, r))
    scores = dense(P, "head/acquisition_head/predictor_fc2", a, r)[..., 0]
    logits = torch.where(~ctx, scores, torch.full_like(scores, NEG))

    def head(z):
        rr = prec.pool_head if z.shape[1] >= prec.head_min_tokens else r
        return gmm_head(P, z, rr, arch["std_min"])

    out = dict(logits=logits, log_probs=torch.log_softmax(logits, dim=-1),
               target=head(z_tgt))
    if pool_posterior:
        out["pool"] = head(z_pts)
    return out


# -- mixture arithmetic -------------------------------------------------------
LOG_2PI = math.log(2.0 * math.pi)


def normal_log_prob(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * (z * z + LOG_2PI) - torch.log(scale)


def gmm_log_prob(v, means, stds, weights):
    return torch.logsumexp(normal_log_prob(v[..., None], means, stds)
                           + torch.log(weights), dim=-1)


def gmm_mean(means, weights):
    return (weights * means).sum(-1)


def gmm_variance(means, stds, weights):
    m = gmm_mean(means, weights)
    return (weights * (means ** 2 + stds ** 2)).sum(-1) - m ** 2


def posterior_curves(post, targets, w):
    """(weighted target log-prob [B], weighted RMSE of the mixture mean
    [B]) of targets [B, n_target] under weights ``w`` [n_target]."""
    ll = gmm_log_prob(targets, *post)
    lp = (ll * w[None]).sum(-1)
    pred = gmm_mean(post[0], post[2])
    wn = w / w.sum().clamp(min=1e-12)
    rmse = torch.sqrt((((targets - pred) ** 2) * wn[None]).sum(-1))
    return lp, rmse


def precision(spec: dict, step_down: bool = False) -> Precision:
    """The configuration's precision of each part, or with ``step_down``
    the next precision below each (the control)."""
    below = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}
    pick = (lambda n: below[n]) if step_down else (lambda n: n)
    return Precision(model=Rounder(pick(spec["model"])),
                     pool_head=Rounder(pick(spec["gmm_head_pool"])),
                     head_min_tokens=int(spec["gmm_head_pool_min_tokens"]))
