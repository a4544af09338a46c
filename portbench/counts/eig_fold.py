"""The EIG fold of location finding, counted from its formula: for each
(contrastive draw l, row b, step t) term, the signal
log(base + sum_k 1 / (max_signal + |xi_t - theta_lk|^2)), the Gaussian
log-density of y_t under it, the running sum over t, and the term's
share of the log-sum-exp over l (shift, exp, sum); for each draw, the
K·D uniforms of the contrastive latents.

Per term, in FLOPs on the float32 FMA pipes (peak 67 TFLOP/s, data
sheet): K·D differences, K·D squares summed (2 a multiply-add), K
offsets, K - 1 sums, the base offset, the centring, scaling and square
of the Gaussian (3), its -0.5 (z² + log 2π) (2), the log-scale (1), the
running sum (1), and the fold's shift and sum (2): 3KD + 2K + 9.  On the
special-function units: K reciprocals, a log and an exp: K + 2, at the
rate under ``assumed`` in ``peaks.json`` (no data-sheet figure).  Per
uniform draw: 16 integer and float operations of a counter-based
generator, at the FMA rate (assumed).  Bytes: the designs, outcomes and
latents read once, the two [B, Th] bounds written once.
"""
from __future__ import annotations

DRAW_OPS = 16


def loc_counts(L: int, B: int, Th: int, K: int, D: int) -> dict:
    terms = L * B * Th
    return dict(fma_flops=terms * (3 * K * D + 2 * K + 9)
                + L * B * K * D * DRAW_OPS,
                sfu_ops=terms * (K + 2),
                bytes=4 * (B * Th * (D + 1) + B * K * D + 2 * B * Th))


def loc_least_s(L: int, B: int, Th: int, K: int, D: int,
                peaks: dict) -> float:
    c = loc_counts(L, B, Th, K, D)
    return max(c["fma_flops"] / peaks["fp32_flops"],
               c["sfu_ops"] / peaks["assumed"]["sfu_ops_per_s"],
               c["bytes"] / peaks["hbm_bytes_per_s"])
