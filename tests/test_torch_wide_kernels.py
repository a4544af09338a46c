"""The port's kernels at every width the Pallas kernels take.

The Pallas kernels take full-extent blocks on every width axis: the GMM
head any D and F (``aline_tpu/ops/gmm_head_kernel.py``), the flash
attention any dh (``aline_tpu/ops/flash_attention.py``).  The port's
wrappers run each width through an instance of their CUDA sources, zero-
padded where needed (``kernel_widths``/``pad_head``, ``kernel_dh``/
``pad_dh``).  On the CPU, without a card, this holds:

* the width rules: every width is taken, and the widths a wrapper
  launches at are ones its sources' entry points take;
* the padding is exact: pad, run the plain version, cut back equals the
  plain version at the true width, forward and every gradient, with the
  flash scale of the true dh;
* the port's plain versions (what the wrappers run on CPU tensors)
  against JAX's ``fused_gmm_head`` and ``flash_role_attention`` in
  interpret mode at wide widths, forward and gradients.

Tolerances, relative to each output's largest element: the padding 1e-6
(the same sums with zero terms added; float32 BLAS may block a longer
sum otherwise); against JAX 1e-5 (float32 on both sides, the sums over
D=128, F=512 and over the rows in another order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.ops import flash_attention as jfa
from aline_tpu.ops import roles as jroles
from aline_tpu.ops.gmm_head_kernel import fused_gmm_head
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import flash_attention as tfa
from aline_tpu_torch.ops import gmm_head_kernel as ghk
from aline_tpu_torch.ops import roles as troles

torch.set_num_threads(1)
PAD_TOL = 1e-6
JAX_TOL = 1e-5
GMM_D = (8, 24, 32, 48, 96, 128, 256, 1024)
GMM_F = (8, 100, 128, 200, 512, 4096)
FLASH_DH = (4, 8, 12, 16, 24, 32, 64, 96, 128)
NAMES = ("dz", "dw1", "db1", "dw2", "db2")


def _near(got, want, tol, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{msg}: max abs {err:.3e}, largest {scale:.3e}"


# -- the width rules ----------------------------------------------------------

@pytest.mark.parametrize("F", GMM_F)
@pytest.mark.parametrize("D", GMM_D)
def test_gmm_kernels_take_every_width(D, F):
    assert ghk.kernel_takes(D, F)
    Dp, Fp = ghk.kernel_widths(D, F)
    assert Dp >= D and Fp >= F
    # what the sources' entry points take (gmm_head_common.cuh
    # narrow_takes, gmm_tiled.cuh takes)
    narrow = Dp in ghk.NARROW_D and Fp % 8 == 0 and Fp <= ghk.NARROW_F_MAX
    tiled = Dp % ghk.TILED_STEP == 0 and Fp % ghk.TILED_STEP == 0
    assert narrow or tiled


def test_gmm_narrow_widths_keep_the_narrow_kernel():
    # the flagship's head and the widths PR 5 measured run unpadded
    for D in ghk.NARROW_D:
        for F in (8, 64, 128, 256):
            assert ghk.kernel_widths(D, F) == (D, F)
    assert ghk.kernel_widths(1024, 4096) == (1024, 4096)
    assert not ghk.kernel_takes(0, 8) and not ghk.kernel_takes(8, 0)
    with pytest.raises(ValueError):
        ghk.kernel_widths(0, 8)


def _instances(source):
    """The dh values of a flash source's launch switch."""
    text = (_build.CSRC_DIR / source).read_text()
    return {int(d) for d in re.findall(r"case (\d+): return launch<", text)}


@pytest.mark.parametrize("dh", FLASH_DH)
def test_flash_kernels_take_every_width(dh):
    assert tfa.kernel_takes(dh)
    width = tfa.kernel_dh(dh)
    assert width >= dh and width in tfa.DH_KERNEL
    for source in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        assert width in _instances(source), source


def test_flash_widths_past_the_widest_instance_raise():
    assert set(tfa.DH_KERNEL) == _instances("flash_attn_fwd.cu") \
        == _instances("flash_attn_bwd.cu")
    assert not tfa.kernel_takes(tfa.DH_MAX + 1)
    with pytest.raises(ValueError):
        tfa.kernel_dh(tfa.DH_MAX + 1)


# -- the padding is exact -----------------------------------------------------

def _gmm_inputs(seed, B, T, D, F, C):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.normal(size=(B, T, D)).astype(f32),
             (rng.normal(size=(C, D, F)) * D ** -0.5).astype(f32),
             (rng.normal(size=(C, F)) * 0.1).astype(f32),
             (rng.normal(size=(C, F, 3)) * F ** -0.5).astype(f32),
             (rng.normal(size=(C, 3)) * 0.1).astype(f32)),
            rng.normal(size=(B, T, C, 3)).astype(f32))


@pytest.mark.parametrize("D,F", [(24, 100), (96, 200), (8, 300)])
def test_gmm_padding_is_exact(D, F):
    arrays, g = _gmm_inputs(D + F, 2, 9, D, F, 4)
    z, w1, b1, w2, b2 = map(torch.from_numpy, arrays)
    g = torch.from_numpy(g)
    Dp, Fp = ghk.kernel_widths(D, F)
    assert (Dp, Fp) != (D, F)
    zp, w1p, b1p, w2p = ghk.pad_head(z, w1, b1, w2, Dp, Fp)
    assert zp.shape[-1] == w1p.shape[1] == Dp and w1p.shape[2] == Fp
    _near(ghk.gmm_head_fwd_plain(zp, w1p, b1p, w2p, b2),
          ghk.gmm_head_fwd_plain(z, w1, b1, w2, b2), PAD_TOL, "forward")
    got = ghk.unpad_grads(ghk.gmm_head_bwd_plain(zp, w1p, b1p, w2p, g), D, F)
    want = ghk.gmm_head_bwd_plain(z, w1, b1, w2, g)
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        _near(a, w, PAD_TOL, name)


def _flash_inputs(seed, B, H, P, nt, dh, with_time):
    rng = np.random.default_rng(seed)
    ctx = rng.random((B, P)) < 0.4
    ctx[:, 0] = True
    tmask = rng.random(nt) < 0.5
    tmask[0] = True
    N = int(with_time) + P + nt
    q, k, v, w = (rng.normal(size=(B, H, N, dh)).astype(np.float32)
                  for _ in range(4))
    return ctx, tmask, with_time, q, k, v, w


def _codes(ctx, tmask, with_time):
    """(JAX codes, port codes) from the same flags."""
    jr = jroles.build_roles(jnp.asarray(ctx), tmask.size, jnp.asarray(tmask),
                            with_time)
    tr = troles.build_roles(torch.from_numpy(ctx), tmask.size,
                            torch.from_numpy(tmask), with_time)
    return jfa.roles_to_codes(jr), troles.roles_to_codes(tr)


@pytest.mark.parametrize("dh", [4, 12, 24, 96])
def test_flash_padding_is_exact(dh):
    ctx, tmask, with_time, q, k, v, w = _flash_inputs(dh, 2, 2, 20, 7, dh,
                                                      True)
    _, (kcode, qrow) = _codes(ctx, tmask, with_time)
    q, k, v, do = map(torch.from_numpy, (q, k, v, w))
    width = tfa.kernel_dh(dh)
    assert width > dh
    pq, pk, pv, pdo = (tfa.pad_dh(t, width) for t in (q, k, v, do))
    assert pq.shape[-1] == width and pq.is_contiguous()
    scale = 1.0 / dh ** 0.5                # the true dh's, not the padded
    o, lse = tfa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    po, plse = tfa.flash_attn_fwd_plain(pq, pk, pv, kcode, qrow, scale)
    _near(po[..., :dh], o, PAD_TOL, "O")
    assert (po[..., dh:] == 0).all()
    _near(plse, lse, PAD_TOL, "lse")
    want = tfa.flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do)
    got = tfa.flash_attn_bwd_plain(pq, pk, pv, kcode, qrow, po, plse, pdo,
                                   scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _near(a[..., :dh], b, PAD_TOL, name)
        assert (a[..., dh:] == 0).all(), name
    # without the true scale the padded run is another function
    wrong, _ = tfa.flash_attn_fwd_plain(pq, pk, pv, kcode, qrow)
    assert not torch.allclose(wrong[..., :dh], o, atol=1e-3)


# -- against the JAX kernels at wide widths -----------------------------------

def test_gmm_head_matches_jax_at_a_wide_head():
    arrays, g = _gmm_inputs(5, 2, 40, 128, 512, 10)
    want_out = fused_gmm_head(*map(jnp.asarray, arrays), True)

    def loss(*args):
        return jnp.sum(fused_gmm_head(*args, True) * jnp.asarray(g))
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = dict(_build.LAUNCHES)
    out = ghk.gmm_head(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    assert _build.LAUNCHES == before          # CPU tensors launch no kernel
    _near(out.detach(), want_out, JAX_TOL, "forward")
    for name, a, w in zip(NAMES, leaves, want):
        _near(a.grad, w, JAX_TOL, name)


@pytest.mark.parametrize("dh", [128, 24])
def test_flash_attention_matches_jax_at_wide_heads(dh):
    ctx, tmask, with_time, q, k, v, w = _flash_inputs(7 + dh, 2, 2, 40, 7,
                                                      dh, True)
    (jk, jq), (tk, tq) = _codes(ctx, tmask, with_time)
    assert q.shape[2] == 48
    jq_, jk_, jv_ = map(jnp.asarray, (q, k, v))
    want_o, res = jfa._flash_fwd(jq_, jk_, jv_, jk, jq, True)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_role_attention(q, k, v, jk, jq, True)
                       * jnp.asarray(w))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq_, jk_, jv_)
    o, lse = tfa.flash_attn_fwd(*map(torch.from_numpy, (q, k, v)), tk, tq)
    _near(o, want_o, JAX_TOL, "O")
    _near(lse, res[-1], JAX_TOL, "lse")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_role_attention(*leaves, tk, tq)
     * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), leaves, want):
        _near(a.grad, b, JAX_TOL, name)
