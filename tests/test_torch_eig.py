"""The port's sPCE/sNMC bounds (``aline_tpu_torch.eval.eig``), streaming
logsumexp (``parallel/collectives.py``) and bound losses
(``eval/eig_losses.py``) against the JAX package's.

The two packages cannot draw the same contrastive thetas, so the bounds
are held to JAX's on the same pre-drawn thetas (``thetas=``), within
1e-4 abs and rel (float32 on both sides; the chunk sizes, and so the
fold's summation order, differ).  The port's own draws are held to
their invariants: chunk i's thetas depend on (seed, i) alone, so
grouping the chunks differently gives bitwise equal bounds, and
``L_checkpoints`` equals separate calls bitwise; and to the analytic EIG
of a conjugate Gaussian.  The losses agree with JAX's to 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.eval import eig_losses as jlosses
from aline_tpu.eval.eig import compute_eig_from_history as jax_eig
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval import eig
from aline_tpu_torch.eval import eig_losses as tlosses
from aline_tpu_torch.eval.eig import (
    chunk_size,
    compute_eig_from_history,
    derive_seed,
    eval_eig_from_history,
)
from aline_tpu_torch.parallel.collectives import (
    lse_init,
    lse_update,
    lse_value,
    streaming_logsumexp_combine,
)
from aline_tpu_torch.tasks.base import Task
from aline_tpu_torch.tasks.location_finding import HiddenLocation

torch.set_num_threads(1)
TOL = 1e-4


def _tasks(*extra):
    args = ["task=location_finding", *extra]
    return (JaxLocation(jcfg.parse_overrides(args).task),
            HiddenLocation(tcfg.parse_overrides(args).task))


def _histories(seed, B, Th, L, K=1):
    """theta_0 [B, K, 2], designs x [B, Th, 2], outcomes y [B, Th, 1] and
    contrastive thetas [L, B, K, 2], drawn with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    theta_0 = rng.uniform(size=(B, K, 2)).astype(f32)
    x = rng.uniform(size=(B, Th, 2)).astype(f32)
    _, tt = _tasks(f"task.K={K}", f"task.n_target_theta={2 * K}")
    signal = tt.total_density(torch.from_numpy(x),
                              torch.from_numpy(theta_0)[:, None]).numpy()
    y = (signal + 0.5 * rng.normal(size=signal.shape)).astype(f32)
    thetas = rng.uniform(size=(L, B, K, 2)).astype(f32)
    return theta_0, x, y, thetas


def _port_inputs(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# -- streaming logsumexp ------------------------------------------------------

def _dense_lse(x):
    x = x.astype(np.float64)
    m = x.max(0)
    return np.log(np.exp(x - m).sum(0)) + m


def test_streaming_lse_matches_dense():
    x = np.random.default_rng(0).normal(size=(100, 4, 3)).astype(
        np.float32) * 10
    state = lse_init((4, 3))
    for chunk in np.split(x, 10, axis=0):
        state = lse_update(state, torch.from_numpy(chunk), axis=0)
    np.testing.assert_allclose(lse_value(state).numpy(), _dense_lse(x),
                               rtol=1e-5)


def test_streaming_lse_combine_is_associative():
    x = np.random.default_rng(1).normal(size=(64, 5)).astype(np.float32)
    s1 = lse_update(lse_init((5,)), torch.from_numpy(x[:32]))
    s2 = lse_update(lse_init((5,)), torch.from_numpy(x[32:]))
    full = lse_update(lse_init((5,)), torch.from_numpy(x))
    np.testing.assert_allclose(
        lse_value(streaming_logsumexp_combine(s1, s2)).numpy(),
        lse_value(full).numpy(), rtol=1e-5)
    # an empty accumulator is the identity of the combine
    same = streaming_logsumexp_combine(lse_init((5,)), full)
    assert torch.equal(lse_value(same), lse_value(full))


def test_streaming_lse_padding_adds_nothing():
    x = torch.tensor([[1.0], [-torch.inf], [2.0]])
    state = lse_update(lse_init((1,)), x)
    np.testing.assert_allclose(lse_value(state).item(),
                               np.log(np.exp(1.0) + np.exp(2.0)), rtol=1e-6)
    # a chunk that is all padding, first into an empty state (no NaN from
    # exp(-inf - -inf)), then into a full one
    pad = torch.full((4, 1), -torch.inf)
    empty = lse_update(lse_init((1,)), pad)
    assert torch.isneginf(empty.max).all() and (empty.sumexp == 0).all()
    assert torch.isneginf(lse_value(empty)).all()
    after = lse_update(lse_update(empty, x), pad)
    assert torch.equal(lse_value(after), lse_value(state))


# -- the bounds against JAX on the same thetas --------------------------------

@pytest.mark.parametrize("stepwise", [False, True])
@pytest.mark.parametrize("K", [1, 2])
def test_bounds_on_given_thetas_match_jax(stepwise, K):
    B, Th, L, L_chunk = 3, 6, 1000, 64                 # 1000 = 15 * 64 + 40
    jt, tt = _tasks(f"task.K={K}", f"task.n_target_theta={2 * K}")
    theta_0, x, y, thetas = _histories(K, B, Th, L, K)
    want = jax_eig(jt, jnp.asarray(theta_0), jnp.asarray(x), jnp.asarray(y),
                   L, jax.random.key(0), L_chunk=L_chunk, stepwise=stepwise,
                   thetas=jnp.asarray(thetas))
    got = compute_eig_from_history(tt, *_port_inputs(theta_0, x, y), L,
                                   seed=0, L_chunk=L_chunk,
                                   stepwise=stepwise,
                                   thetas=torch.from_numpy(thetas))
    for g, w, name in zip(got, want, ("pce", "nmc")):
        assert g.shape == ((B, Th) if stepwise else (B,))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
    pce, nmc = got
    assert (nmc - pce >= math.log(L / (L + 1)) - 1e-5).all()


def test_dense_recomputation_of_the_bounds():
    """The streaming fold against the dense [L+1, B] formula on the same
    thetas, in float64."""
    B, Th, L = 2, 4, 300
    _, tt = _tasks()
    theta_0, x, y, thetas = _histories(3, B, Th, L)
    pce, nmc = compute_eig_from_history(
        tt, *_port_inputs(theta_0, x, y), L, seed=0, L_chunk=7,
        stepwise=True, thetas=torch.from_numpy(thetas))
    all_th = np.concatenate([theta_0[None], thetas])
    ll = tt.log_likelihood(torch.from_numpy(y)[None].double(),
                           torch.from_numpy(x)[None].double(),
                           torch.from_numpy(all_th)[:, :, None].double())
    S = np.cumsum(ll[..., 0].numpy(), axis=-1)                # [L+1, B, Th]
    want_pce = np.log(L + 1) - (_dense_lse(S) - S[0])
    want_nmc = np.log(L) - (_dense_lse(S[1:]) - S[0])
    np.testing.assert_allclose(pce.numpy(), want_pce, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(nmc.numpy(), want_nmc, rtol=TOL, atol=TOL)


# -- the port's own draws -----------------------------------------------------

def _small_history(B=2, Th=3):
    _, tt = _tasks()
    theta_0, x, y, _ = _histories(5, B, Th, 1)
    return tt, _port_inputs(theta_0, x, y)


def test_chunk_groupings_are_bitwise_equal():
    tt, (theta_0, x, y) = _small_history()
    L, Lc, seed = 100, 16, 7                           # 7 chunks, 4 padded
    one = eig.accumulate_chunks(tt, x, y, seed, L, Lc, 0, 7,
                                lse_init((2, 3)))
    for groups in ([3, 4], [1, 1, 5], [2, 2, 2, 1]):
        state, done = lse_init((2, 3)), 0
        for g in groups:
            state = eig.accumulate_chunks(tt, x, y, seed, L, Lc, done, g,
                                          state)
            done += g
        assert torch.equal(state.max, one.max), groups
        assert torch.equal(state.sumexp, one.sumexp), groups
    # and the whole call draws the same chunks
    pce, nmc = compute_eig_from_history(tt, theta_0, x, y, L, seed,
                                        L_chunk=Lc)
    again = compute_eig_from_history(tt, theta_0, x, y, L, seed, L_chunk=Lc)
    assert torch.equal(pce, again[0]) and torch.equal(nmc, again[1])
    other = compute_eig_from_history(tt, theta_0, x, y, L, seed + 1,
                                     L_chunk=Lc)
    assert not torch.equal(pce, other[0])


def test_L_checkpoints_equal_separate_calls():
    tt, (theta_0, x, y) = _small_history()
    curve = compute_eig_from_history(tt, theta_0, x, y, 96, 3, L_chunk=16,
                                     stepwise=True,
                                     L_checkpoints=[30, 64, 90])
    assert sorted(curve) == [32, 64, 96]     # 30 and 90 snap up
    for L_eff, (pce_c, nmc_c) in curve.items():
        pce_p, nmc_p = compute_eig_from_history(tt, theta_0, x, y, L_eff, 3,
                                                L_chunk=16, stepwise=True)
        assert torch.equal(pce_c, pce_p) and torch.equal(nmc_c, nmc_p), L_eff


def test_bounds_bracket_and_last_chunk_padding():
    """pce <= nmc + log((L+1)/L) for the same draws, with an L that is not
    a multiple of the chunk; padding rows add nothing (L=40 in chunks of
    32 equals L=40 in one chunk of 40 on the same thetas)."""
    tt, (theta_0, x, y) = _small_history(B=8, Th=5)
    pce, nmc = compute_eig_from_history(tt, theta_0, x, y, 5000, 11,
                                        L_chunk=999, stepwise=True)
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()
    assert (nmc - pce >= math.log(5000 / 5001) - 1e-5).all()
    gen = torch.Generator().manual_seed(derive_seed(1, 0))
    th = tt.sample_theta(gen, (64, 8))
    padded = eig._fold(lse_init((8, 5)), tt, x, y, th, 40)
    exact = eig._fold(lse_init((8, 5)), tt, x, y, th[:40], 40)
    np.testing.assert_allclose(lse_value(padded).numpy(),
                               lse_value(exact).numpy(), rtol=1e-6)


def test_chunk_size_rule():
    assert chunk_size(1_000_000, 200, 35, 32_768) == \
        eig.CHUNK_BLOCK_BYTES // (4 * 200 * 35)
    assert chunk_size(1_000_000, 2, 3, 32_768) == 32_768     # L_chunk caps
    assert chunk_size(100, 2, 3, 32_768) == 100              # L caps
    assert chunk_size(10, 10**9, 1, 64) == 1
    Lc = chunk_size(50_000, 1000, 30, 32_768)
    assert 4 * Lc * 1000 * 30 <= eig.CHUNK_BLOCK_BYTES


def test_derive_seed_streams():
    seeds = {derive_seed(0, i) for i in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2**63 for s in seeds)
    assert derive_seed(0, 1, 2) != derive_seed(0, 2, 1)
    assert derive_seed(5) == derive_seed(5) != derive_seed(6)


def test_refuses_other_dtypes():
    tt, (theta_0, x, y) = _small_history()
    with pytest.raises(TypeError, match="float32"):
        compute_eig_from_history(tt, theta_0, x.bfloat16(), y, 10, 0)


class GaussTask(Task):
    """y = theta + noise, theta ~ N(0, 1), noise ~ N(0, s^2); the base
    task's generic EIG fold."""
    noise = 0.7

    def __init__(self):
        pass

    def sample_theta(self, gen, shape):
        return torch.randn(tuple(shape) + (1, 1), generator=gen,
                           device=gen.device)

    def log_likelihood(self, y, xi, theta):
        z = (y - theta[..., 0, :]) / self.noise
        return (-0.5 * z ** 2 - math.log(self.noise)
                - 0.5 * math.log(2 * math.pi))


def test_conjugate_gaussian_analytic_eig():
    """EIG after one observation is 0.5 log(1 + 1/s^2); sPCE approaches
    it from below within Monte-Carlo error, sNMC from above."""
    task = GaussTask()
    B = 4096
    gen = torch.Generator().manual_seed(0)
    theta_0 = task.sample_theta(gen, (B,))
    x = torch.zeros(B, 1, 1)
    y = theta_0[:, 0:1, :] + task.noise * torch.randn(B, 1, 1, generator=gen)
    pce, nmc = compute_eig_from_history(task, theta_0, x, y, 20_000, 1)
    analytic = 0.5 * math.log(1 + 1 / task.noise ** 2)
    se = pce.std().item() / math.sqrt(B)
    assert abs(pce.mean().item() - analytic) < 4 * se + 0.01, \
        f"pce {pce.mean().item():.4f} vs analytic {analytic:.4f}"
    nmc_se = nmc.std().item() / math.sqrt(B)
    assert nmc.mean().item() >= analytic - 4 * nmc_se - 0.01


def test_eval_eig_from_history_errors():
    task = GaussTask()
    gen = torch.Generator().manual_seed(2)
    theta_0 = task.sample_theta(gen, (40,))
    x = torch.zeros(40, 2, 1)
    y = theta_0[:, :, 0].unsqueeze(-1).expand(40, 2, 1) \
        + task.noise * torch.randn(40, 2, 1, generator=gen)
    out = {e: eval_eig_from_history(task, theta_0, x, y, 500, 3,
                                    batch_size=16, stepwise=True,
                                    err_type=e)
           for e in ("se", "ci", "std")}
    for k in ("pce", "nmc"):
        assert out["se"][f"{k}_mean"].shape == (2,)
        np.testing.assert_array_equal(out["se"][f"{k}_mean"],
                                      out["std"][f"{k}_mean"])
        np.testing.assert_allclose(out["se"][f"{k}_err"] * math.sqrt(40),
                                   out["std"][f"{k}_err"], rtol=1e-6)
        np.testing.assert_allclose(out["ci"][f"{k}_err"],
                                   1.96 * out["se"][f"{k}_err"], rtol=1e-6)
    with pytest.raises(ValueError, match="err_type"):
        eval_eig_from_history(task, theta_0, x, y, 10, 0, err_type="iqr")


# -- the bound losses ---------------------------------------------------------

@pytest.mark.parametrize("loss", ["pce_loss", "nmc_loss",
                                  "pce_loss_score_gradient"])
def test_eig_losses_match_jax(loss):
    jt, tt = _tasks()
    theta_0, x, y, thetas = _histories(9, 4, 5, 31)
    all_th = np.concatenate([theta_0[None], thetas])
    jfn, tfn = getattr(jlosses, loss), getattr(tlosses, loss)
    for reduction in ("mean", "none"):
        want = jfn(jt, jnp.asarray(y), jnp.asarray(x), jnp.asarray(all_th),
                   reduction=reduction)
        got = tfn(tt, torch.from_numpy(y), torch.from_numpy(x),
                  torch.from_numpy(all_th), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=reduction)
    # gradients through the designs, as a continuous-design policy takes
    want_g = jax.grad(lambda xi: jfn(jt, jnp.asarray(y), xi,
                                     jnp.asarray(all_th)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tfn(tt, torch.from_numpy(y), xt, torch.from_numpy(all_th)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)
    lp = tlosses.compute_seq_logprobs(tt, torch.from_numpy(y),
                                      torch.from_numpy(x),
                                      torch.from_numpy(all_th))
    assert lp.shape == (32, 4)
