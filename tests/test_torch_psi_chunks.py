"""PSI's subject chunking (``aline_tpu_torch/eval/psi.py``
``psi_rollout_curves(b_chunk=)``), as the JAX package folds subjects in
chunks of ``b_chunk`` (``aline_tpu/eval/psi.py``).

* Chunked equals unchunked bit for bit: ``b_chunk`` in {1, 3, B} against
  one chunk of all B subjects, for ``psi`` (each subject's trials read
  only its own rows) and ``random`` (the [T, B, N] uniforms are drawn
  once, before the chunks).
* On a JAX-drawn batch of 6 subjects (chunks of 4 and 2 on both sides),
  the ``psi`` curves match JAX's at its ``b_chunk=4`` under the rule of
  ``tests/test_torch_psi.py``: equal indices except at a tie of JAX's own
  gains (1e-5), curves within 1e-4 on the rows that stay.
* ``eval_psi --b-chunk`` reaches the rollout.
"""
import jax
import numpy as np
import pytest
import torch

from aline_tpu.eval import psi as jpsi
from aline_tpu_torch import eval_psi
from aline_tpu_torch.eval import psi
from aline_tpu_torch.tasks import batch_from_numpy
from tests.test_torch_psi import MASKS, SMALL, _jax_gain, _tasks

torch.set_num_threads(1)
B, T = 6, 5


@pytest.fixture(scope="module")
def jax_batch():
    jt, _ = _tasks()
    return jt.sample_batch(jax.random.key(11), B, n_query=24)


def _run(batch, strategy, mask, b_chunk):
    _, tt = _tasks()
    gen = torch.Generator().manual_seed(5)
    return psi.psi_rollout_curves(tt, batch, T, gen, mask=mask,
                                  strategy=strategy,
                                  grid=psi.make_theta_grid(tt, SMALL),
                                  b_chunk=b_chunk)


@pytest.mark.parametrize("b_chunk", [1, 3, B])
@pytest.mark.parametrize("strategy", ["psi", "random"])
@pytest.mark.parametrize("mask_name", ["threshold_slope", "all"])
def test_chunked_equals_unchunked(jax_batch, b_chunk, strategy, mask_name):
    batch = batch_from_numpy(jax_batch)
    mask = MASKS[mask_name]
    whole = _run(batch, strategy, mask, b_chunk=B)
    got = _run(batch, strategy, mask, b_chunk=b_chunk)
    for key in ("log_prob", "rmse", "idx"):
        assert got[key].shape == whole[key].shape
        assert torch.equal(got[key], whole[key]), (key, b_chunk)
    assert torch.isfinite(got["log_prob"]).all()


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_chunked_psi_matches_jax(jax_batch, mask_name):
    jt, tt = _tasks()
    mask = np.asarray(MASKS[mask_name])
    jgrid = jpsi.make_theta_grid(jt, SMALL)
    want = jpsi.psi_rollout_curves(jt, jax_batch, T, jax.random.key(0),
                                   mask=mask, grid=jgrid, b_chunk=4)
    got = psi.psi_rollout_curves(tt, batch_from_numpy(jax_batch), T, None,
                                 mask=mask,
                                 grid=psi.make_theta_grid(tt, SMALL),
                                 b_chunk=4)
    gidx, widx = got["idx"].numpy(), want["idx"]
    assert gidx.shape == widx.shape == (B, T)
    stays = (gidx == widx).all(axis=1)
    for r in np.flatnonzero(~stays):
        t = int(np.argmax(gidx[r] != widx[r]))
        gain = _jax_gain(jt, jax_batch, jgrid, mask, widx, r, t)
        assert abs(gain[gidx[r, t]] - gain[widx[r, t]]) <= 1e-5, (
            f"row {r} leaves JAX's trajectory at step {t} off a tie")
    assert stays.sum() >= B // 2       # the curves are held on these rows
    for key in ("log_prob", "rmse"):
        g = got[key].numpy()
        assert g.shape == (B, T + 1) and np.isfinite(g).all()
        np.testing.assert_allclose(g[stays], want[key][stays], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_b_chunk_must_be_positive(jax_batch):
    with pytest.raises(ValueError, match="b_chunk"):
        _run(batch_from_numpy(jax_batch), "psi", MASKS["all"], b_chunk=0)


def test_eval_psi_takes_b_chunk(tmp_path, monkeypatch):
    seen = []
    real = eval_psi.psi_rollout_curves

    def spy(*args, **kwargs):
        seen.append(kwargs["b_chunk"])
        return real(*args, **kwargs)

    monkeypatch.setattr(eval_psi, "psi_rollout_curves", spy)
    assert eval_psi.parse_args([]).b_chunk == 4
    out = tmp_path / "psi.npz"
    res = eval_psi.main(["checkpoints/psych_100k", "--device", "cpu",
                         "--T", "2", "--batch-size", "3", "--n-query", "12",
                         "--seeds", "0", "--grid", "5,3,3,3",
                         "--b-chunk", "2", "--out", str(out)])
    assert seen and set(seen) == {2}
    assert out.exists()
    assert res["all_psi_log_prob"].shape == (3, 3)
