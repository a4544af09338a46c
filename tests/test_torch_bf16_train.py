"""One bfloat16 training step in the port against the JAX package's, at the
small size of tests/test_torch_train.py (2 layers, d=16, H=2, F=32, C=4,
B=4, n_query=8, T=4) with ``dtype=bfloat16``: the same perturbed seeded
params, the same JAX-drawn batch with a fixed split mask, and the same
design noise (the Gumbel draws that ``jax.random.categorical`` adds to the
logits at each step, passed to the port's rollout), through compact
attention and through flash attention with the time token and the time
feature.  JAX runs without jit, so that every bfloat16 rounding its flax
modules declare happens (tests/test_torch_bf16_slice.py says why); its
flash kernel runs in interpret mode.

* The sampled designs are equal at every step.
* The losses agree to a relative 1e-3.
* Each parameter's gradient (float32, from the bfloat16 compute) agrees
  with JAX's to a relative L2 error of 3e-2, and to at most 1/4 of the
  relative L2 gap between JAX's bfloat16 and JAX's float32 gradient of the
  same step.  A Dense bias is the one exception, held to 1/3 of that gap:
  its gradient sums the bfloat16 output gradient over every row of the
  batch and sequence, which PyTorch does in float32, rounding once, and
  XLA in bfloat16 (over 100 rows of unit normals XLA's eager sum lands 4
  bfloat16 ulps from the exact sum, PyTorch's on the rounded exact sum),
  so there the port is nearer the exact gradient than JAX is.  Entries
  that shift every logit of a softmax alike (the score head's output
  bias, the key third of each qkv bias) have rounding noise for a
  gradient in every framework and are left out, as in
  tests/test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.train import loss as jloss
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train import loss as tloss
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.serialization import convert_flax_params
from test_torch_train import _cfgs, _shift_invariant

torch.set_num_threads(1)
T = 4
LOSS_RTOL = 1e-3
GRAD_RTOL = 3e-2

VARIANTS = {
    "compact": [],
    "flash time": ["encoder.attention_impl=flash",
                   "encoder.with_time_token=true", "time_token=true"],
}


def _jax_noise(key, B, P):
    """The Gumbel draws that JAX's rollout adds to the logits at each step
    (``categorical(k_design, logits)`` is ``argmax(gumbel(k_design) +
    logits)``), with the rollout's key splits."""
    out = []
    for _ in range(T):
        key, k_design = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(k_design, (B, P),
                                                jnp.float32)))
    return np.stack(out)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_train_step_matches_jax(variant):
    extra = VARIANTS[variant] + ["max_epoch=20", "burning_epoch=5"]
    time_token = variant != "compact"
    jc, tc = _cfgs(None, "dtype=bfloat16", *extra)
    jc32, _ = _cfgs(None, *extra)
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(5), 4,
                                             n_query=8)
    mask = np.zeros(jbatch.n_target, bool)
    mask[:4] = True                                   # the data targets
    jbatch = jax_init_ctx_idx(jbatch.replace(target_mask=jnp.asarray(mask)),
                              1 + T)
    w_q, w_p = jmask.target_weight_vectors(mask, "mix", "split", 4, 2)
    sel = None if time_token else tuple(range(4))
    params = jax_build_model(jc).init(jax.random.key(0), jbatch,
                                      training=False)
    rng = np.random.default_rng(8)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                            sep="/")
    key = jax.random.key(3)

    def jax_step(cfg):
        jmodel = jax_build_model(cfg)

        def loss_fn(p):
            ro = jax_rollout(jmodel, p, jbatch, T, jnp.asarray(w_q),
                             jnp.asarray(w_p), key, training=True,
                             time_token=time_token, sel_targets=sel)
            loss, m = jloss.total_loss(ro, cfg.gamma,
                                       jnp.float32(cfg.alpha))
            return loss, (m, ro.idx)

        with jax.disable_jit():
            (_, (m, idx)), g = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(params)
        return m, np.asarray(idx), flatten_dict(g, sep="/")

    jm, jidx, jgrads = jax_step(jc)
    _, _, jgrads32 = jax_step(jc32)

    model = build_model(tc, "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    model.train()
    assert model.encoder.layer_0.linear1.compute_dtype == torch.bfloat16
    noise = torch.from_numpy(_jax_noise(key, jbatch.batch_size,
                                        jbatch.n_points))
    ro = rollout(model, batch_from_numpy(jbatch), T, torch.from_numpy(w_q),
                 torch.from_numpy(w_p), noise, time_token=time_token,
                 sel_targets=sel)
    np.testing.assert_array_equal(ro.idx.numpy(), jidx)
    loss, m = tloss.total_loss(ro, tc.gamma, tc.alpha)
    loss.backward()
    for k in ("loss", "design_loss", "predict_loss"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)

    want = convert_flax_params(jgrads, model)
    want32 = convert_flax_params(jgrads32, model)
    invariant = _shift_invariant(model)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        keep = ~invariant.get(name, torch.zeros(p.shape, dtype=torch.bool))
        got, ref, ref32 = (t[keep].numpy() for t in
                           (p.grad, want[name], want32[name]))
        err, gap = _rel(got, ref), _rel(ref32, ref)
        share = 3 if name.endswith(".bias") else 4
        assert err <= GRAD_RTOL, f"{name}: relative error {err:.3e}"
        assert err <= gap / share, (f"{name}: relative error {err:.3e}, "
                                    f"JAX bf16 vs f32 {gap:.3e}")
