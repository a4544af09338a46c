"""Model FLOPs of ALINE forwards, from the shapes of the work the
result needs: the dense products (2 FLOPs a multiply-add) of the
embedders, the encoder and the heads, and the attention products over
the pairs the role mask allows.  Elementwise work (LayerNorm, softmax,
activations) is not counted, as model FLOPs are usually counted.

A forward over ``n_points`` candidates of which ``n_ctx`` are context,
``n_target_data`` data targets and ``n_theta`` theta tokens, with
``n_sel`` targets visible to the pool rows:

* embedders: the x MLP on every point and data target, the y MLP on the
  context points (a pool point's y is never read);
* each encoder layer: q, k, v and the output projection, the
  feed-forward pair, and per allowed (row, key) pair 2·D FLOPs for
  q·k and 2·D for p·v (every row reads the n_ctx context keys; the pool
  rows also read the n_sel selected targets);
* the design head on the pool rows; the GMM head (C MLPs of D → F → 3)
  on every target token, and on the pool rows where the pool's
  posterior is read (``pool_posterior``).
"""
from __future__ import annotations


def forward(sizes: dict, n_points: int, n_ctx: int, n_target_data: int,
            n_theta: int, n_sel: int, pool_posterior: bool = False) -> int:
    """FLOPs of one forward of one batch row."""
    D, F, C = sizes["D"], sizes["F"], sizes["C"]
    dx, layers = sizes["dim_x"], sizes["num_layers"]
    N = n_points + n_target_data + n_theta
    n_pool = n_points - n_ctx
    emb = 2 * (n_points + n_target_data) * (dx * F + F * D) \
        + 2 * n_ctx * (1 * F + F * D)
    dense = 2 * N * (D * 3 * D + D * D + 2 * D * F)
    pairs = N * n_ctx + n_pool * n_sel
    enc = layers * (dense + 4 * D * pairs)
    gmm = 2 * C * (D * F + 3 * F)
    heads = 2 * n_pool * (D * F + F) + (n_target_data + n_theta) * gmm
    if pool_posterior:
        heads += n_pool * gmm
    return emb + enc + heads


def rollout(sizes: dict, B: int, n_points: int, n_ctx0: int,
            n_target_data: int, n_theta: int, n_sel: int, T: int,
            final: bool, pool_posterior: bool = False) -> int:
    """FLOPs of a T-step rollout of B rows: one forward a step (and one
    after the last step where ``final``), the context growing by one a
    step."""
    steps = T + int(final)
    return B * sum(forward(sizes, n_points, n_ctx0 + t, n_target_data,
                           n_theta, n_sel, pool_posterior)
                   for t in range(steps))


def sizes_of(run: dict) -> dict:
    """The widths of a configuration's ``run`` section."""
    return dict(D=run["encoder"]["dim_embedding"],
                F=run["encoder"]["dim_feedforward"],
                C=run["head"]["num_components"],
                dim_x=run["task"]["dim_x"],
                num_layers=run["encoder"]["num_layers"])
