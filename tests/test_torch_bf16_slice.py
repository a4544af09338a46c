"""The slice end to end in bfloat16: the flagship (checkpoints/al1d_200k,
whose config says ``"dtype": "bfloat16"``), and the 5k-epoch demo run of
the same recipe (checkpoints/al1d_5k_demo), through the port's
``al_rollout_curves`` against the JAX package's, on JAX-drawn GP batches
(B=4, n_query=40, T=5), strategies ``aline`` and ``uncertainty``, with the
default and the ``theta`` target masks.

* Chosen indices are equal at every step, or a row leaves the JAX
  trajectory at an exact tie of JAX's own bfloat16 scores (two candidates
  whose design probabilities, or GMM variances, are equal as floats): the
  check replays JAX's model at that step and compares the two candidates.
* The curves agree to atol = rtol = 2e-2 on the rows that stay on the
  trajectory: the forwards are bitwise equal or 1 bfloat16 ulp apart in a
  few elements (tests/test_torch_bf16.py), and one ulp of a posterior
  mean mu (2^-8 |mu|) moves a target's log-prob by |y - mu| 2^-8 |mu| /
  sigma^2, about 1e-2 for a theta target whose posterior has sigma near
  0.1 (most elements agree to 1e-4).

The JAX side runs without jit (``jax.disable_jit``): op by op, every
bfloat16 rounding the flax modules declare happens.  Under jit, XLA's CPU
compiler keeps excess precision where a bfloat16 result feeds a float32
operation inside one fusion (it skips the rounding of the attention
scores, and of the residual sum before each LayerNorm), so the jitted
JAX model computes neither the declared bfloat16 nor float32.
* Yardstick: on the same batch, the port's bfloat16 curves differ from
  JAX's bfloat16 curves by at most 1/10 of what JAX's bfloat16 curves
  differ from JAX's float32 ones (mean absolute log-prob difference), so
  the port answers as the bfloat16 reference does and not as a float32
  model would.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from aline_tpu.distributions.gmm import gmm_variance
from aline_tpu.eval.al_curves import al_rollout_curves as jax_rollout
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.base import select_design as jax_select_design
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.utils.serialization import BANKED_RUNS, load_model
from test_torch_al_curves import ROOT, _masked

torch.set_num_threads(1)
TOL = 2e-2
T = 5


@pytest.fixture(scope="module", params=["al1d_200k", "al1d_5k_demo"])
def flagship(request):
    run_dir = os.path.join(ROOT, "checkpoints", request.param)
    npz = BANKED_RUNS[request.param][1]
    cfg = jax_load_config(run_dir)
    assert cfg.dtype == "bfloat16"
    cfg32 = copy.deepcopy(cfg)        # build_model sets cfg.encoder.dtype
    cfg32.dtype = "float32"
    jmodel, jmodel32 = jax_build_model(cfg), jax_build_model(cfg32)
    assert jmodel32.encoder.cfg.dtype == "float32"
    with np.load(npz) as f:
        params = unflatten_dict({k: jnp.asarray(f[k]) for k in f.files},
                                sep="/")
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(5), 4,
                                              n_query=40)
    _, model = load_model(run_dir, npz, "cpu")
    return jmodel, jmodel32, params, model, jbatch


def _sel(jbatch):
    sel = tuple(int(i) for i in np.flatnonzero(np.asarray(
        jbatch.target_mask)))
    return None if len(sel) == jbatch.n_target else sel


def _jax_scores(jmodel, params, jbatch, idx, t, strategy):
    """JAX's own scores at step t of the trajectory ``idx`` [B, T]."""
    b = jax_init_ctx_idx(jbatch, min(int(jbatch.ctx_mask[0].sum()) + T,
                                     jbatch.n_points))
    for s in range(t):
        b = jax_select_design(b, jnp.asarray(idx[:, s]))[0]
    with jax.disable_jit():
        out = jmodel.apply(params, b, training=False, sel_targets=_sel(b))
    if strategy == "aline":
        return np.asarray(out.design_out.zt)
    pq = out.posterior_out_query
    return np.asarray(gmm_variance(pq.mixture_means, pq.mixture_stds,
                                   pq.mixture_weights))


@pytest.mark.parametrize("strategy", ["aline", "uncertainty"])
@pytest.mark.parametrize("mask", ["default", "theta"])
def test_flagship_bf16_rollout_matches_jax_bf16(flagship, strategy, mask):
    jmodel, jmodel32, params, model, jbatch = flagship
    jbatch = _masked(jbatch, mask)
    with jax.disable_jit():
        want = jax_rollout(jmodel, params, jbatch, T, jax.random.key(1),
                           strategy=strategy)
    want32 = jax_rollout(jmodel32, params, jbatch, T, jax.random.key(1),
                         strategy=strategy)
    got = al_rollout_curves(model, batch_from_numpy(jbatch), T,
                            strategy=strategy)
    gidx, widx = got["idx"].numpy(), np.asarray(want["idx"])
    differs = (gidx != widx).any(axis=1)
    for r in np.flatnonzero(differs):
        t = int(np.argmax(gidx[r] != widx[r]))
        scores = _jax_scores(jmodel, params, jbatch, widx, t, strategy)
        assert scores[r, gidx[r, t]] == scores[r, widx[r, t]], (
            f"row {r} leaves JAX's trajectory at step {t} off a tie: "
            f"{scores[r, gidx[r, t]]} vs {scores[r, widx[r, t]]}")
    same = ~differs
    assert same.sum() >= 3, f"{differs.sum()} of 4 rows left at ties"
    for key in ("log_prob", "rmse"):
        np.testing.assert_allclose(got[key].numpy()[same],
                                   np.asarray(want[key])[same], rtol=TOL,
                                   atol=TOL, err_msg=key)
    lp, lp_w = got["log_prob"].numpy(), np.asarray(want["log_prob"])
    gap_port = np.abs(lp - lp_w).mean()
    gap_dtype = np.abs(np.asarray(want32["log_prob"]) - lp_w).mean()
    assert gap_dtype > 0
    assert gap_port <= gap_dtype / 10, (gap_port, gap_dtype)
