"""The PSI grid-Bayes baseline (``aline_tpu_torch/eval/psi.py``) against
the JAX package's (``aline_tpu/eval/psi.py``), with the subjects as one
batch dimension in the port and ``vmap`` in JAX.

* ``make_theta_grid``: the shape, ranges, widths (float32) and the C-order
  layout of theta are equal; the axes within 2 float32 ulps of their
  largest end point of JAX's (XLA fuses ``jnp.linspace``'s start (1 - s)
  + stop s and rounds some points up to 2 such ulps away from the
  expression's float32, and from its float64, value).
* ``info_gain`` on random posteriors for the full subset and two
  2-parameter subsets, and the metrics, on the same grid: 1e-5 relative,
  1e-6 absolute (float32 sums over the grid in two orders).
* ``psi_rollout_curves`` on a JAX-drawn batch with a small grid (9, 5, 3,
  3), B=4, T=5, each target mask: the chosen indices equal, except where
  JAX's own gains of the two candidates lie within 1e-5 of each other (a
  tie at float32 sums), and the curves within 1e-4 on the rows that stay.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.eval import psi as jpsi
from aline_tpu.tasks.psychometric import PsychometricTask as JaxPsych
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval import psi
from aline_tpu_torch.tasks import batch_from_numpy, build_task

torch.set_num_threads(1)
SMALL = (9, 5, 3, 3)
MASKS = {"threshold_slope": [True, True, False, False],
         "guess_lapse": [False, False, True, True],
         "all": [True, True, True, True]}


def _tasks():
    return (JaxPsych(jcfg.parse_overrides(["task=psychometric"]).task),
            build_task(tcfg.parse_overrides(["task=psychometric"]).task))


@pytest.mark.parametrize("n_axis", [(33, 17, 9, 7), SMALL, (1, 2, 4, 100)],
                         ids=str)
def test_theta_grid_equals_jax(n_axis):
    jt, tt = _tasks()
    want = jpsi.make_theta_grid(jt, n_axis)
    got = psi.make_theta_grid(tt, n_axis)
    assert got["shape"] == want["shape"] == tuple(n_axis)
    assert got["ranges"] == want["ranges"]
    np.testing.assert_array_equal(got["widths"].numpy(),
                                  np.asarray(want["widths"]))
    for a, b in zip(got["axes"], want["axes"]):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * np.spacing(np.abs(b).max()))
    mesh = np.meshgrid(*[a.numpy() for a in got["axes"]], indexing="ij")
    np.testing.assert_array_equal(
        got["theta"].numpy(), np.stack([m.reshape(-1) for m in mesh], -1))
    np.testing.assert_allclose(got["theta"].numpy(),
                               np.asarray(want["theta"]), rtol=0,
                               atol=2 * np.spacing(np.float32(3.0)))


def _posteriors_and_P(seed, B, N):
    """Random posteriors [B, G] and the likelihoods [B, G, N] on the JAX
    grid, and both grids."""
    jt, tt = _tasks()
    jgrid = jpsi.make_theta_grid(jt, SMALL)
    tgrid = psi.make_theta_grid(tt, SMALL)
    tgrid["axes"] = [torch.from_numpy(np.asarray(a)) for a in jgrid["axes"]]
    tgrid["theta"] = torch.from_numpy(np.asarray(jgrid["theta"]))
    rng = np.random.default_rng(seed)
    G = int(np.prod(SMALL))
    post = rng.dirichlet(np.full(G, 0.3), size=B).astype(np.float32)
    x = rng.uniform(-5, 5, size=(B, N, 1)).astype(np.float32)
    P = np.asarray(jax.vmap(lambda xb: jt.psychometric_function(
        xb[None], jgrid["theta"][:, None, :])[..., 0])(jnp.asarray(x)))
    return jgrid, tgrid, post, P


@pytest.mark.parametrize("subset", [(0, 1, 2, 3), (0, 1), (2, 3)], ids=str)
def test_info_gain_matches_jax(subset):
    jgrid, tgrid, post, P = _posteriors_and_P(0, 3, 17)
    HbP = np.asarray(jpsi._binary_entropy(jnp.asarray(P)))
    want = np.stack([np.asarray(jpsi.info_gain(
        jnp.asarray(post[b]), jnp.asarray(P[b]), jnp.asarray(HbP[b]),
        jgrid, subset)) for b in range(3)])
    tP = torch.from_numpy(P)
    got = psi.info_gain(torch.from_numpy(post), tP,
                        psi._binary_entropy(tP), tgrid, subset)
    assert got.shape == (3, 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if len(subset) < 4:        # the hoisted view gives the same numbers
        hoisted = psi.info_gain(torch.from_numpy(post), tP, None, tgrid,
                                subset, P_sub=psi.subset_view(tP, tgrid,
                                                              subset))
        assert torch.equal(hoisted, got)


def test_metrics_match_jax():
    jgrid, tgrid, post, _ = _posteriors_and_P(1, 4, 3)
    log_post = np.log(post) * 3.0
    theta_true = np.random.default_rng(2).uniform(
        [-3, 0.1, 0.1, 0.0], [3, 2, 0.9, 0.5], size=(4, 4)).astype(
            np.float32)
    for mask in MASKS.values():
        w = np.asarray(mask, np.float32) / sum(mask)
        want = [jpsi._metrics(jnp.asarray(log_post[b]), jgrid,
                              jnp.asarray(theta_true[b]), jnp.asarray(w))
                for b in range(4)]
        ll, rmse = psi._metrics(torch.from_numpy(log_post), tgrid,
                                torch.from_numpy(theta_true),
                                torch.from_numpy(w))
        np.testing.assert_allclose(ll.numpy(), [float(a) for a, _ in want],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rmse.numpy(),
                                   [float(b) for _, b in want],
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_batch():
    jt, _ = _tasks()
    return jt.sample_batch(jax.random.key(3), 4, n_query=24)


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_psi_rollout_matches_jax(jax_batch, mask_name):
    jt, tt = _tasks()
    T = 5
    mask = np.asarray(MASKS[mask_name])
    jgrid = jpsi.make_theta_grid(jt, SMALL)
    want = jpsi.psi_rollout_curves(jt, jax_batch, T, jax.random.key(0),
                                   mask=mask, grid=jgrid)
    got = psi.psi_rollout_curves(tt, batch_from_numpy(jax_batch), T, None,
                                 mask=mask,
                                 grid=psi.make_theta_grid(tt, SMALL))
    gidx, widx = got["idx"].numpy(), want["idx"]
    assert gidx.shape == widx.shape == (4, T)
    stays = (gidx == widx).all(axis=1)
    for r in np.flatnonzero(~stays):
        t = int(np.argmax(gidx[r] != widx[r]))
        gain = _jax_gain(jt, jax_batch, jgrid, mask, widx, r, t)
        assert abs(gain[gidx[r, t]] - gain[widx[r, t]]) <= 1e-5, (
            f"row {r} leaves JAX's trajectory at step {t} off a tie")
    assert stays.sum() >= 3
    for key in ("log_prob", "rmse"):
        g = got[key].numpy()
        assert g.shape == (4, T + 1) and np.isfinite(g).all()
        np.testing.assert_allclose(g[stays], want[key][stays], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def _jax_gain(jt, jb, grid, mask, widx, r, t):
    """JAX's info gain of row r at step t of its own trajectory."""
    subset = tuple(int(i) for i in np.flatnonzero(mask))
    x, y = jb.x[r], jb.y[r, :, 0]
    p = jt.psychometric_function(x[None], grid["theta"][:, None, :])[..., 0]
    ctx = np.asarray(jb.ctx_mask[r]).astype(np.float32)
    log_post = (jnp.log(p + 1e-10) * y
                + jnp.log1p(-p + 1e-10) * (1.0 - y)) @ ctx
    for s in range(t):
        col = p[:, widx[r, s]]
        log_post = log_post + jnp.where(y[widx[r, s]] > 0.5,
                                        jnp.log(col + 1e-10),
                                        jnp.log1p(-col + 1e-10))
    return np.asarray(jpsi.info_gain(jax.nn.softmax(log_post), p,
                                     jpsi._binary_entropy(p), grid, subset))


def test_random_strategy_picks_unconsumed_points(jax_batch):
    _, tt = _tasks()
    batch = batch_from_numpy(jax_batch)
    out = psi.psi_rollout_curves(tt, batch, 6,
                                 torch.Generator().manual_seed(0),
                                 mask=MASKS["all"], strategy="random",
                                 grid=psi.make_theta_grid(tt, SMALL))
    idx = out["idx"]
    assert idx.shape == (4, 6)
    for r in range(4):
        picked = idx[r].tolist()
        assert len(set(picked)) == 6
        assert not batch.ctx_mask[r, picked].any()
    assert torch.isfinite(out["log_prob"]).all()
    with pytest.raises(ValueError, match="strategy"):
        psi.psi_rollout_curves(tt, batch, 1, None, mask=MASKS["all"],
                               strategy="greedy")
