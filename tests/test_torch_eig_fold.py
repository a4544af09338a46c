"""The fused EIG fold of location finding (``ops/eig_fold_kernel.py``,
``csrc/loc_eig_fold.cu``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
to its plain version there).  Here ``emulated_fold`` repeats in PyTorch
the order in which it reduces the chunk: each thread's logsumexp over
its draws at each step, the block's fixed-order combine over its
threads (four slots a lane, then a shuffle-down tree), the blocks in
order, then the merge into the state; its layout (threads a block,
draws a thread) is read from the kernel's source.  The emulation is
held to the plain fold and, through ``compute_eig_from_history``, to the
JAX package's bounds, as ``tests/test_torch_eig.py`` holds the plain
fold.

Tolerances.  The emulation takes the plain version's S, so the two
states have the same max bit for bit and differ only in the order of the
sum of exponentials: within 1e-5 relative.  The bounds against JAX's,
1e-4 abs and rel, as ``test_bounds_on_given_thetas_match_jax``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.eval.eig import compute_eig_from_history as jax_eig
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval import eig
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import eig_fold_kernel as efk
from aline_tpu_torch.parallel.collectives import (
    LogSumExpState,
    lse_init,
    lse_update,
)
from aline_tpu_torch.tasks.ces import CESTask
from aline_tpu_torch.tasks.location_finding import (
    HiddenLocation,
    log_likelihood,
)

torch.set_num_threads(1)
TOL = 1e-4


def _layout():
    """(threads a block, draws a thread) as the kernel's source defines
    them.  The steps' tiling does not enter the order: each step is
    reduced on its own."""
    src = (_build.CSRC_DIR / "loc_eig_fold.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kThreads", "kDraws"))


THREADS, DRAWS = _layout()


def _combine(a, b):
    """The kernel's combine of two (max, sumexp) pairs."""
    m = torch.maximum(a[0], b[0])
    safe = torch.where(m == -torch.inf, 0.0, m)
    return m, a[1] * torch.exp(a[0] - safe) + b[1] * torch.exp(b[0] - safe)


def emulated_fold(state, x, y, thetas, n_valid, base_signal, max_signal,
                  noise_scale):
    """``loc_eig_fold`` with the kernel's order of reduction, on the plain
    version's S."""
    Lc, B = thetas.shape[:2]
    Th = x.shape[1]
    n = min(max(n_valid, 0), Lc)
    per_block = THREADS * DRAWS
    G = -(-n // per_block)
    ll = log_likelihood(y[None, ..., None], x[None],
                        thetas[:n].unsqueeze(2), base_signal, max_signal,
                        noise_scale)
    S = torch.cumsum(ll[..., 0], dim=-1)                     # [n, B, Th]
    S = torch.cat([S, S.new_full((G * per_block - n, B, Th), -torch.inf)])
    # draw l = g * per_block + j * THREADS + tid
    S = S.view(G, DRAWS, THREADS, B, Th)
    # each thread: its max, then its exponentials summed in j order
    m = S.amax(dim=1)                                        # [G, THREADS, ...]
    safe = torch.where(m == -torch.inf, 0.0, m)
    s = torch.zeros_like(m)
    for j in range(DRAWS):
        s = s + torch.exp(S[:, j] - safe)
    # the block, a warp a step: lane i takes slots i, i + 32, i + 64, ...
    m, s = m.view(G, THREADS // 32, 32, B, Th), s.view(G, THREADS // 32, 32,
                                                         B, Th)
    v = (m[:, 0], s[:, 0])
    for q in range(1, THREADS // 32):
        v = _combine(v, (m[:, q], s[:, q]))
    # then the shuffle-down tree: lane i < off takes lane i + off
    off = 16
    while off:
        v = _combine((v[0][:, :off], v[1][:, :off]),
                     (v[0][:, off:2 * off], v[1][:, off:2 * off]))
        off //= 2
    part_m, part_s = v[0][:, 0], v[1][:, 0]                  # [G, B, Th]
    # the blocks in order, then the state
    c = (torch.full((B, Th), -torch.inf), torch.zeros(B, Th))
    for g in range(G):
        c = _combine(c, (part_m[g], part_s[g]))
    return LogSumExpState(*_combine((state.max, state.sumexp), c))


def _task(K=1, extra=()):
    return HiddenLocation(tcfg.parse_overrides(
        ["task=location_finding", f"task.K={K}",
         f"task.n_target_theta={2 * K}", *extra]).task)


def _inputs(seed, B, Th, Lc, K=1, prior="uniform"):
    """theta_0, designs x [B, Th, 2], outcomes y [B, Th] drawn from the
    task under theta_0, and draws [Lc, B, K, 2] from ``prior``."""
    task = _task(K, [f"task.theta_dist={prior}"])
    gen = torch.Generator().manual_seed(seed)
    theta_0 = task.sample_theta(gen, (B,))
    x = task.unnormalise_design(task.sample_data(gen, B, Th))
    y = task.simulate(gen, x, theta_0[:, None])[..., 0]
    return task, theta_0, x, y, task.sample_theta(gen, (Lc, B))


def _state(B, Th, seed=None):
    """The empty state, or a state left by a fold of other draws."""
    if seed is None:
        return lse_init((B, Th))
    g = torch.Generator().manual_seed(seed)
    return lse_update(lse_init((B, Th)),
                      -30.0 * torch.rand(7, B, Th, generator=g), axis=0)


def _fold_args(task):
    return task.base_signal, task.max_signal, task.noise_scale


@pytest.mark.parametrize("K,Th,prior", [(1, 35, "uniform"), (2, 6, "uniform"),
                                        (1, 1, "uniform"), (1, 65, "normal")])
@pytest.mark.parametrize("n_valid", ["all", 0, 1, 700])
@pytest.mark.parametrize("filled", [False, True])
def test_emulated_order_matches_the_plain_fold(K, Th, prior, n_valid,
                                               filled):
    Lc, B = 1300, 3                        # three blocks of 512 draws
    task, _, x, y, thetas = _inputs(Th + K, B, Th, Lc, K, prior)
    n = Lc if n_valid == "all" else n_valid
    state = _state(B, Th, seed=5 if filled else None)
    args = (x, y, thetas, n) + _fold_args(task)
    got = emulated_fold(state, *args)
    want = efk.loc_eig_fold_plain(state, *args)
    assert torch.equal(got.max, want.max)
    np.testing.assert_allclose(got.sumexp.numpy(), want.sumexp.numpy(),
                               rtol=1e-5)
    if n == 0:
        # no valid draw: the state bit for bit
        assert torch.equal(got.max, state.max)
        assert torch.equal(got.sumexp, state.sumexp)


@pytest.mark.parametrize("stepwise", [False, True])
@pytest.mark.parametrize("K", [1, 2])
def test_emulated_bounds_match_jax(monkeypatch, stepwise, K):
    """The bounds on given thetas with the emulated fold in the plain
    one's place, against the JAX package's: chunks of 1100 draws (three
    blocks), the last 800 long."""
    B, Th, L, L_chunk = 3, 6, 3000, 1100
    args = ["task=location_finding", f"task.K={K}",
            f"task.n_target_theta={2 * K}"]
    jt = JaxLocation(jcfg.parse_overrides(args).task)
    task = _task(K)
    rng = np.random.default_rng(K)
    f32 = np.float32
    theta_0 = rng.uniform(size=(B, K, 2)).astype(f32)
    x = rng.uniform(size=(B, Th, 2)).astype(f32)
    signal = task.total_density(torch.from_numpy(x),
                                torch.from_numpy(theta_0)[:, None]).numpy()
    y = (signal + 0.5 * rng.normal(size=signal.shape)).astype(f32)
    thetas = rng.uniform(size=(L, B, K, 2)).astype(f32)
    want = jax_eig(jt, jnp.asarray(theta_0), jnp.asarray(x), jnp.asarray(y),
                   L, jax.random.key(0), L_chunk=L_chunk, stepwise=stepwise,
                   thetas=jnp.asarray(thetas))
    calls = []

    def recorded(*a):
        calls.append(a[4])
        return emulated_fold(*a)

    monkeypatch.setattr(eig, "loc_eig_fold", recorded)
    got = eig.compute_eig_from_history(
        task, *(torch.from_numpy(a) for a in (theta_0, x, y)), L, seed=0,
        L_chunk=L_chunk, stepwise=stepwise, thetas=torch.from_numpy(thetas))
    assert calls == [1100, 1100, 1100]     # the given thetas' chunks, whole
    for g, w, name in zip(got, want, ("pce", "nmc")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_emulated_chunk_padding_adds_nothing():
    """The last chunk of the port's own draws, padded past L: its
    padding rows add nothing in the kernel's order either."""
    task, _, x, y, thetas = _inputs(3, 2, 4, 1100)
    state = _state(2, 4, seed=1)
    args = _fold_args(task)
    padded = emulated_fold(state, x, y, thetas, 600, *args)
    exact = emulated_fold(state, x, y, thetas[:600], 600, *args)
    assert torch.equal(padded.max, exact.max)
    assert torch.equal(padded.sumexp, exact.sumexp)


def test_the_plain_fold_is_the_generic_fold():
    """``loc_eig_fold_plain`` computes what the generic fold of
    ``eval/eig.py`` computes for location finding, bit for bit."""
    task, _, x, y, thetas = _inputs(4, 3, 7, 50, K=2)
    state = _state(3, 7, seed=2)
    for n in (50, 20):
        got = efk.loc_eig_fold_plain(state, x, y, thetas, n,
                                     *_fold_args(task))
        S = eig._seq_cum_loglik(task, x, y[..., None], thetas)
        S[n:] = -torch.inf
        want = lse_update(state, S, axis=0)
        assert torch.equal(got.max, want.max)
        assert torch.equal(got.sumexp, want.sumexp)


def test_fold_dispatches_location_finding_to_its_kernel(monkeypatch):
    """``_fold`` sends HiddenLocation to ``loc_eig_fold`` (y as [B, Th],
    the task's constants) and every other task to the generic fold."""
    task, _, x, y, thetas = _inputs(6, 2, 3, 10)
    seen = []

    def fused(state, x_, y_, th, n, base, max_signal, noise):
        seen.append(("fused", y_.shape, n, base, max_signal, noise))
        return state

    def generic(task_, *a):
        seen.append(("generic", type(task_).__name__))
        return torch.zeros(10, 2, 3)

    monkeypatch.setattr(eig, "loc_eig_fold", fused)
    monkeypatch.setattr(eig, "_seq_cum_loglik", generic)
    state = lse_init((2, 3))
    eig._fold(state, task, x, y[..., None], thetas, 10)
    ces = CESTask(tcfg.parse_overrides(["task=ces"]).task)
    eig._fold(state, ces, x, y[..., None], thetas, 10)
    assert seen == [("fused", (2, 3), 10, task.base_signal, task.max_signal,
                     task.noise_scale), ("generic", "CESTask")]


def test_cpu_bounds_launch_no_kernel():
    task, theta_0, x, y, _ = _inputs(7, 2, 3, 1)
    efk.LAUNCHES["loc_eig_fold"] = 0
    pce, nmc = eig.compute_eig_from_history(task, theta_0, x, y[..., None],
                                            500, 3, L_chunk=128)
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()
    assert efk.LAUNCHES == {"loc_eig_fold": 0}


@pytest.mark.parametrize("case", ["float64", "bfloat16", "y_shape",
                                  "theta_rows", "theta_width", "state_shape",
                                  "x_rank", "device"])
def test_wrapper_refuses_what_it_does_not_take(case):
    task, _, x, y, thetas = _inputs(8, 2, 3, 10)
    state = _state(2, 3)
    args = dict(state=state, x=x, y=y, thetas=thetas)
    if case in ("float64", "bfloat16"):
        args["thetas"] = thetas.to(getattr(torch, case))
        err = TypeError
    else:
        err = ValueError
        if case == "y_shape":
            args["y"] = y[..., None]
        elif case == "theta_rows":
            args["thetas"] = thetas[:, :1]
        elif case == "theta_width":
            args["thetas"] = thetas[..., :1]
        elif case == "state_shape":
            args["state"] = lse_init((2, 4))
        elif case == "x_rank":
            args["x"] = x[0]
        elif case == "device":
            args = {k: (LogSumExpState(*(t.to("meta") for t in v))
                        if k == "state" else v.to("meta"))
                    for k, v in args.items()}
    with pytest.raises(err):
        efk.loc_eig_fold(args["state"], args["x"], args["y"], args["thetas"],
                         10, *_fold_args(task))


def test_kernel_layout_is_what_the_emulation_assumes():
    """Whole warps of 32 lanes, each lane taking THREADS / 32 slots."""
    assert THREADS % 32 == 0 and THREADS >= 32 and DRAWS >= 1
