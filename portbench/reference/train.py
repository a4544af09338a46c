"""Training steps of ALINE, written from the method: a T-step rollout
whose designs are drawn by Gumbel-max from the design head, a REINFORCE
loss on the per-step gain of the masked targets' log-likelihood plus the
all-targets NLL, the gradient's infinity-norm clip at 1, and AdamW
(decoupled decay) with the predictor parameters at lr and the others at
lr / 5 on a cosine schedule.

The rollout follows the designs that the program drew (``idx``): the
reference reads how far each lies from the Gumbel-max of its own logits
(``design_gap``), and computes the loss and the gradients of those
designs, so that a near-tie decided otherwise in the last bit does not
send the two rollouts apart.  Rows are independent given the reward's
normalisation, which is computed first over the whole batch; the
gradient is then summed over blocks of rows to bound the memory.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.model import Inputs, forward, gmm_log_prob

BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 0.01


def _rollout(P, inp: Inputs, ctx0, targets, w_q, w_p, noise, idx, prec,
             arch):
    ctx = ctx0.clone()
    rows = torch.arange(ctx.shape[0], device=ctx.device)
    lps, nq, npred, gaps, chosen = [], [], [], [], []
    for t in range(noise.shape[0]):
        out = forward(P, inp, ctx, prec, arch)
        pert = (out["logits"] + noise[t]).detach()
        i = pert.argmax(-1) if idx is None else idx[t]
        lps.append(out["log_probs"][rows, i])
        gaps.append(pert.max(-1).values - pert[rows, i])
        ll = gmm_log_prob(targets, *out["target"])
        nq.append(-(ll * w_q).sum(-1))
        npred.append(-(ll * w_p).sum(-1))
        ctx = ctx.clone()
        ctx[rows, i] = True
        chosen.append(i)
    return (torch.stack(lps), torch.stack(nq), torch.stack(npred),
            torch.stack(gaps), torch.stack(chosen))


def cosine_factor(step: int, decay_steps: int) -> float:
    n = max(decay_steps, 1)
    return 0.5 * (1 + math.cos(math.pi * min(step, n) / n))


def train_steps(P0: Dict[str, torch.Tensor], steps: List[dict], arch: dict,
                hp: dict, prec, block: int = 50):
    """Run ``steps`` (each: ``inp``, ``ctx0``, ``targets``, ``w_q``,
    ``w_p``, ``noise`` [T, B, Np], ``idx`` [T, B] or None) from the
    parameters ``P0``; where ``idx`` is None the designs are the
    Gumbel-max of the reference's own logits.  Returns per step ``loss``,
    its all-targets NLL part ``predict``, ``design_gap`` (the widest
    Gumbel-max gap of the designs followed), ``first_design_gap`` (that
    gap of the step's first designs, averaged over the rows) and ``idx``,
    the first step's clipped gradient ``grad1`` and the parameters after
    the last step ``P``."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, predicts, design_gaps, first_gaps = [], [], [], []
    idxs, grad1 = [], None
    for s, st in enumerate(steps):
        T, B = st["noise"].shape[:2]

        def part(rows, grad):
            inp = st["inp"]
            sub = Inputs(inp.x[rows], inp.y[rows], inp.target_x[rows],
                         inp.n_theta, inp.target_mask)
            Pg = {k: t.requires_grad_(grad) for k, t in P.items()}
            idx = None if st["idx"] is None else st["idx"][:, rows]
            return _rollout(Pg, sub, st["ctx0"][rows], st["targets"][rows],
                            st["w_q"], st["w_p"], st["noise"][:, rows], idx,
                            prec, arch)

        blocks = [slice(a, min(a + block, B)) for a in range(0, B, block)]
        with torch.no_grad():
            nq = torch.cat([part(b, False)[1] for b in blocks], dim=1)
        gain = torch.clamp(nq[:-1] - nq[1:], min=0.0)
        disc = hp["gamma"] ** torch.arange(1, T, dtype=torch.float32,
                                           device=nq.device)
        R = gain * disc[:, None]
        R = (R - R.mean(1, keepdim=True)) / (R.std(1, correction=1,
                                                   keepdim=True) + 1e-9)
        grads = {k: torch.zeros_like(t) for k, t in P.items()}
        loss, pred_loss, gap, gap_sum, idx = 0.0, 0.0, 0.0, 0.0, []
        for b in blocks:
            lp, _, npred, g, i = part(b, True)
            idx.append(i)
            design = -(lp[:-1] * R[:, b]).sum() / ((T - 1) * B)
            pred = npred.sum() / (T * B)
            lb = hp["alpha"] * design + pred
            gr = torch.autograd.grad(lb, list(P.values()))
            for k, t in zip(P, gr):
                grads[k] += t
            loss += float(lb.detach())
            pred_loss += float(pred.detach())
            gap = max(gap, float(g.max()))
            gap_sum += float(g[0].sum())
        with torch.no_grad():
            inf = max(float(g.abs().max()) for g in grads.values())
            coef = min(1.0, 1.0 / (inf + 1e-6))
            factor = cosine_factor(s, hp["decay_steps"])
            for k in P:
                g = grads[k] * coef
                if s == 0:
                    grad1 = grad1 or {}
                    grad1[k] = g.clone()
                lr = hp["lr"] * factor * (1.0 if "predictor" in k else 0.2)
                P[k] = P[k].detach() * (1 - lr * WEIGHT_DECAY)
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g * g
                mh = m[k] / (1 - BETAS[0] ** (s + 1))
                vh = v2[k] / (1 - BETAS[1] ** (s + 1))
                P[k] = P[k] - lr * mh / (torch.sqrt(vh) + EPS)
        losses.append(loss)
        predicts.append(pred_loss)
        design_gaps.append(gap)
        first_gaps.append(gap_sum / B)
        idxs.append(torch.cat(idx, dim=1))
    return dict(loss=losses, predict=predicts, design_gap=design_gaps,
                first_design_gap=first_gaps, idx=idxs, grad1=grad1, P=P)
