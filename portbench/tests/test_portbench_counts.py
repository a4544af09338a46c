"""Each count of operations and bytes against a hand count at small
shapes."""
from __future__ import annotations

import portbench_tiny  # noqa: F401
from portbench.counts import aline_flops, eig_fold, gmm_head
from portbench.harness import load_peaks

PEAKS = load_peaks()


def test_gmm_head_counts_each_product_once():
    # B=1, T=2 tokens, D=2, F=3, C=1: per token 2·(2·3) + 2·(3·3) FLOPs
    assert gmm_head.fwd_flops(1, 2, 2, 3, 1) == 2 * (2 * (6 + 9))
    # z 1·2·2, weights 6 + 3 + 9 + 3, outputs 1·2·1·3 floats
    assert gmm_head.fwd_bytes(1, 2, 2, 3, 1) == 4 * (4 + 21 + 6)
    t = gmm_head.fwd_least_s(100, 2001, 32, 128, 10, PEAKS)
    assert t == max(gmm_head.fwd_flops(100, 2001, 32, 128, 10) / 495e12,
                    gmm_head.fwd_bytes(100, 2001, 32, 128, 10) / 3.35e12)


def test_eig_fold_counts_per_term():
    # L=2 draws, B=1 row, Th=3 steps, K=1, D=2: 6 terms of 3·2+2+9 FLOPs,
    # 2·1·2 draws of 16 operations; 3 special-function results a term
    c = eig_fold.loc_counts(2, 1, 3, 1, 2)
    assert c["fma_flops"] == 6 * 17 + 4 * 16
    assert c["sfu_ops"] == 6 * 3
    assert c["bytes"] == 4 * (3 * 3 + 2 + 6)
    t = eig_fold.loc_least_s(10**6, 200, 35, 1, 2, PEAKS)
    assert abs(t - 7e9 * 3 / 4.18e12) < 1e-12


def test_model_flops_by_hand():
    s = dict(D=2, F=4, C=1, dim_x=1, num_layers=1)
    # 3 points (1 context, 2 pool), 1 data target, 1 theta token, both
    # targets visible to the pool rows: N = 5 tokens
    emb = 2 * 4 * (1 * 4 + 4 * 2) + 2 * 1 * (4 + 8)
    dense = 2 * 5 * (2 * 6 + 2 * 2 + 2 * 2 * 4)
    pairs = 5 * 1 + 2 * 2
    heads = 2 * 2 * (2 * 4 + 4) + 2 * (2 * 1 * (2 * 4 + 12))
    want = emb + dense + 4 * 2 * pairs + heads
    assert aline_flops.forward(s, 3, 1, 1, 1, 2) == want
    pool = 2 * 2 * 1 * (2 * 4 + 12)
    assert aline_flops.forward(s, 3, 1, 1, 1, 2, True) == want + pool
    # a rollout grows the context a step; ``final`` adds the last forward
    two = aline_flops.rollout(s, 3, 4, 1, 1, 1, 2, 2, final=False)
    assert two == 3 * (aline_flops.forward(s, 4, 1, 1, 1, 2)
                       + aline_flops.forward(s, 4, 2, 1, 1, 2))
    assert aline_flops.rollout(s, 1, 4, 1, 1, 1, 2, 2, final=True) == \
        sum(aline_flops.forward(s, 4, c, 1, 1, 2) for c in (1, 2, 3))
