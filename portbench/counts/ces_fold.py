"""The EIG fold of the CES task, counted from its formula: for each
(contrastive draw l, row b, step t) term, the two baskets' utilities
(sum_i alpha_i x_i^rho)^(1/rho) under theta_l, the censored
sigmoid-normal log-density of y_t, the running sum over t, and the
term's share of the log-sum-exp over l; for each draw, the prior's
uniform, three exponentials and normal.  Everything that does not
depend on l is hoisted: log2 x_i, logit y_t, the baskets' distance, and
which branch of the density y_t takes (it lies at a limit or inside, so
no term needs both).

Per term, on the special-function units: per basket three exp2 of
rho log2 x_i and, for the outer power, a log2 and an exp2 (10), and the
fold's exp (1): 11 results, at the rate under ``assumed`` in
``peaks.json``.  On the float32 FMA pipes: 40 instructions (the powers'
products, the weighted sums, the difference, the scale by u, the z-score
and the Gaussian, the running sum, the fold's max, shift and sum), each
one FMA slot, 2 FLOPs of the 67 TFLOP/s peak.  The limits' log_ndtr
is not counted.  Per draw: 5 variates of a counter-based generator at
``DRAW_OPS`` instructions each, and 12 for their transforms (rho's scale
and offset, the three exponentials' logs, alpha's sum and three
divisions, log u's scale and offset, the normal's pair), at the FMA rate
(assumed).  Bytes: the designs, outcomes and latents read once, the two
[B, Th] bounds written once.
"""
from __future__ import annotations

from portbench.counts.eig_fold import DRAW_OPS

TERM_SFU = 11
TERM_F32 = 40
DRAW_F32 = 5 * DRAW_OPS + 12
DX = 6
N_THETA = 5


def counts(L: int, B: int, Th: int) -> dict:
    terms = L * B * Th
    return dict(fma_flops=2 * (terms * TERM_F32 + L * B * DRAW_F32),
                sfu_ops=terms * TERM_SFU,
                bytes=4 * (B * Th * (DX + 1) + B * N_THETA + 2 * B * Th))


def least_s(L: int, B: int, Th: int, peaks: dict) -> float:
    c = counts(L, B, Th)
    return max(c["fma_flops"] / peaks["fp32_flops"],
               c["sfu_ops"] / peaks["assumed"]["sfu_ops_per_s"],
               c["bytes"] / peaks["hbm_bytes_per_s"])
