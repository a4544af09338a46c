"""The fused EIG folds of location finding and CES
(``ops/eig_fold_kernel.py``, ``csrc/loc_eig_fold.cu``,
``csrc/ces_eig_fold.cu``) on the CPU, and the route from each task's
``fold_eig_chunk`` to its fold.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
to the plain fold there); here a fake library stands in for one to hold
the launch's arguments.  Here ``emulated_reduce`` repeats in
PyTorch the order in which they reduce a chunk (``csrc/eig_fold_reduce.cuh``):
each thread's logsumexp over its draws at each step, the block's
fixed-order combine over its threads (four slots a lane, then a
shuffle-down tree), the blocks in order, then the merge into the state;
the layout (threads a block, draws a thread) is read from each kernel's
source.  ``emulated_fold`` takes location finding's plain S;
``emulated_ces_fold`` computes CES's terms with the kernel's arithmetic
and runs its float32 running sum.  The emulations are held to the plain
fold and, through ``compute_eig_from_history``, to the JAX package's
bounds, as ``tests/test_torch_eig.py`` holds the plain fold.

Tolerances.  Location finding's emulation takes the plain version's S, so
the two states have the same max bit for bit and differ only in the
order of the sum of exponentials: within 1e-5 relative.  CES's rounds
its terms and running sum otherwise: within ``ces_fold_tolerance`` (what
float32 rounding of each draw's terms may move the logsumexp by).  The
bounds against JAX's, 1e-4 abs and rel, as
``test_bounds_on_given_thetas_match_jax``.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.eval.eig import compute_eig_from_history as jax_eig
from aline_tpu.tasks.ces import CESTask as JaxCES
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
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.ces import CESTask
from aline_tpu_torch.tasks.location_finding import (
    HiddenLocation,
    log_likelihood,
)

torch.set_num_threads(1)
TOL = 1e-4


def _layout(name="loc_eig_fold", keys=("kThreads", "kDraws")):
    """(threads a block, draws a thread) as a kernel's source defines
    them.  The steps' tiling does not enter the order: each step is
    reduced on its own."""
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {key} = (\d+);",
                               src).group(1))
                 for key in keys)


THREADS, DRAWS = _layout()


def _combine(a, b):
    """The kernel's combine of two (max, sumexp) pairs."""
    m = torch.maximum(a[0], b[0])
    safe = torch.where(m == -torch.inf, 0.0, m)
    return m, a[1] * torch.exp(a[0] - safe) + b[1] * torch.exp(b[0] - safe)


def emulated_reduce(state, S, threads=THREADS, draws=DRAWS):
    """The kernels' streaming logsumexp (``csrc/eig_fold_reduce.cuh``)
    of the valid draws' running sums S [n, B, Th] into ``state``, in
    their order: blocks of ``threads`` threads of ``draws`` draws each."""
    n, B, Th = S.shape
    per_block = threads * draws
    G = -(-n // per_block)
    S = torch.cat([S, S.new_full((G * per_block - n, B, Th), -torch.inf)])
    # draw l = g * per_block + j * threads + tid
    S = S.view(G, draws, threads, B, Th)
    # each thread: its max, then its exponentials summed in j order
    m = S.amax(dim=1)                                        # [G, threads, ...]
    safe = torch.where(m == -torch.inf, 0.0, m)
    s = torch.zeros_like(m)
    for j in range(draws):
        s = s + torch.exp(S[:, j] - safe)
    # the block, a warp a step: lane i takes slots i, i + 32, i + 64, ...
    m, s = (v.view(G, threads // 32, 32, B, Th) for v in (m, s))
    v = (m[:, 0], s[:, 0])
    for q in range(1, threads // 32):
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


def emulated_fold(state, x, y, thetas, n_valid, base_signal, max_signal,
                  noise_scale):
    """``loc_eig_fold`` with the kernel's order of reduction, on the plain
    version's S."""
    n = min(max(n_valid, 0), thetas.shape[0])
    ll = log_likelihood(y[None, ..., None], x[None],
                        thetas[:n].unsqueeze(2), base_signal, max_signal,
                        noise_scale)
    S = torch.cumsum(ll[..., 0], dim=-1)                     # [n, B, Th]
    return emulated_reduce(state, S)


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
    got = emulated_fold(state, x, y, thetas, n, *_fold_args(task))
    want = efk.eig_fold_plain(state, x, y, thetas, n, task.log_likelihood)
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

    def recorded(kernel, state, x_, y_, th, n, **kw):
        calls.append((kernel, n))
        return emulated_fold(state, x_, y_, th, n, *_fold_args(task))

    monkeypatch.setattr(efk, "eig_fold", recorded)
    got = eig.compute_eig_from_history(
        task, *(torch.from_numpy(a) for a in (theta_0, x, y)), L, seed=0,
        L_chunk=L_chunk, stepwise=stepwise, thetas=torch.from_numpy(thetas))
    # the given thetas' chunks, whole
    assert calls == [("loc_eig_fold", 1100)] * 3
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


def _drawn(task, B, Th, Lc, seed):
    """Designs x [B, Th, D] (real space), outcomes y [B, Th] simulated
    under each row's own theta, and Lc draws [Lc, B, ...] of the prior."""
    g = torch.Generator().manual_seed(seed)
    theta_0 = task.sample_theta(g, (B,))
    x = task.unnormalise_design(task.sample_data(g, B, Th))
    y = task.simulate(g, x, theta_0[:, None])[..., 0].contiguous()
    return x, y, task.sample_theta(g, (Lc, B))


def _route_task(name):
    if name.startswith("location_finding"):
        return _task(K=2 if name.endswith("K=2") else 1)
    if name.startswith("ces"):
        return _ces_task(name.split()[-1])
    return build_task(tcfg.parse_overrides(["task=psychometric"]).task)


# every task with a likelihood → the fold kernel its chunks reach (None:
# the generic fold), with the kernel's draw shape, design width and numbers
ROUTES = {
    "location_finding": lambda t: ("loc_eig_fold", (1, 2), 2, (
        1, 2, t.base_signal, t.max_signal, t.noise_scale)),
    "location_finding K=2": lambda t: ("loc_eig_fold", (2, 2), 2, (
        2, 2, t.base_signal, t.max_signal, t.noise_scale)),
    "ces log_ndtr": lambda t: ("ces_eig_fold", (5,), 6, (
        t.noise_scale, t.epsilon, 1.0 - t.epsilon)),
    "ces reference": lambda t: None,
    "psychometric": lambda t: None,
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_each_task_routes_its_chunks_to_its_fold(monkeypatch, name):
    """``_fold`` hands each chunk to the task's ``fold_eig_chunk``:
    location finding and CES with log_ndtr tails reach the fold launcher
    with their kernel and constants (y as [B, Th]); CES with the
    reference's tails and psychometric take the generic fold.  Unpatched
    on the CPU, every task's fold is the plain fold, bit for bit."""
    task = _route_task(name)
    x, y, thetas = _drawn(task, 2, 3, 10, seed=6)
    state = _state(2, 3, seed=4)
    want = efk.eig_fold_plain(state, x, y, thetas, 7, task.log_likelihood)
    got = eig._fold(state, task, x, y[..., None], thetas, 7)
    assert torch.equal(got.max, want.max)
    assert torch.equal(got.sumexp, want.sumexp)
    seen = []

    def recorded(kernel, state_, x_, y_, th, n, *, loglik, draw, width,
                 numbers):
        seen.append((kernel, tuple(draw), width, tuple(numbers)))
        assert (y_.shape, th.shape, n) == ((2, 3), thetas.shape, 7)
        assert loglik == task.log_likelihood
        return state_

    monkeypatch.setattr(efk, "eig_fold", recorded)
    eig._fold(state, task, x, y[..., None], thetas, 7)
    route = ROUTES[name](task)
    assert seen == ([] if route is None else [route])


def test_cpu_bounds_launch_no_kernel():
    task, theta_0, x, y, _ = _inputs(7, 2, 3, 1)
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    pce, nmc = eig.compute_eig_from_history(task, theta_0, x, y[..., None],
                                            500, 3, L_chunk=128)
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()
    ces, x, y, _ = _ces_case(2, 4, 1)
    theta_0 = ces.sample_theta(torch.Generator().manual_seed(1), (2,))
    pce, nmc = eig.compute_eig_from_history(ces, theta_0, x, y[..., None],
                                            500, 3, L_chunk=128)
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()
    assert set(_build.LAUNCHES.values()) == {0}


def test_kernel_layout_is_what_the_emulation_assumes():
    """Whole warps of 32 lanes, each lane taking THREADS / 32 slots."""
    assert THREADS % 32 == 0 and THREADS >= 32 and DRAWS >= 1


# -- the EIG fold of CES --------------------------------------------------------

CES_THREADS, CES_DRAWS, CES_TILE_MAX = _layout(
    "ces_eig_fold", ("kThreads", "kDraws", "kTileMax"))


def _ces_task(tail_mode="log_ndtr"):
    return CESTask(tcfg.parse_overrides(
        ["task=ces", f"task.tail_mode={tail_mode}"]).task)


def emulated_ces_terms(task, x, y, thetas):
    """[Lc, B, Th] the log-likelihood terms as ``csrc/ces_eig_fold.cu``
    computes them, in float32, one rounded operation at a time: per (b, t)
    the clamped goods, s0 = (1 + |b1 - b2|) noise and logit y; per draw
    1 / rho and u; per term the powers, the products alpha_i x_i^rho
    summed in the kernel's order, the outer power, mu = (U1 - U2) u, sigma = s0 u,
    z = (logit y - mu) / sigma and the branch y takes."""
    f32 = torch.float32
    lo, hi = (torch.tensor(v, dtype=f32) for v in
              (task.epsilon, 1.0 - task.epsilon))
    xc = x.clamp(0.01, 100.0)                                  # [B, Th, 6]
    d = xc[..., :3] - xc[..., 3:]
    sq = d * d
    dist = torch.sqrt((sq[..., 0] + sq[..., 2]) + sq[..., 1])
    s0 = (1.0 + dist) * torch.tensor(task.noise_scale, dtype=f32)
    log_y, log_1y = torch.log(y), torch.log1p(-y)
    logit = log_y - log_1y
    rho, alpha = thetas[..., 0, None, None], thetas[..., None, 1:4]
    inv_rho, u = 1.0 / rho[..., 0], torch.exp(thetas[..., 4, None])
    p = xc ** rho                                          # [Lc, B, Th, 6]
    U = []
    for k in (0, 3):
        w = ((alpha[..., 0] * p[..., k] + alpha[..., 2] * p[..., k + 2])
             + alpha[..., 1] * p[..., k + 1])
        U.append(w ** inv_rho)
    sigma = s0 * u
    z = (logit - (U[0] - U[1]) * u) / sigma
    inside = ((-0.5 * (z * z + torch.tensor(math.log(2 * math.pi),
                                            dtype=f32))
               - torch.log(sigma)) - log_y) - log_1y
    return torch.where(
        y == hi, torch.special.log_ndtr(-z), torch.where(
            y == lo, torch.special.log_ndtr(z), torch.where(
                (y > hi) | (y < lo), -torch.inf, inside)))


def emulated_ces_fold(state, task, x, y, thetas, n_valid):
    """``ces_eig_fold`` with the kernel's arithmetic: its terms, its
    running sum over the steps in float32, its order of reduction."""
    n = min(max(n_valid, 0), thetas.shape[0])
    ll = emulated_ces_terms(task, x, y, thetas[:n])
    S = torch.empty_like(ll)
    run = torch.zeros(ll.shape[:2])
    for t in range(ll.shape[2]):
        run = run + ll[..., t]
        S[..., t] = run
    return emulated_reduce(state, S, CES_THREADS, CES_DRAWS)


def _ces_case(B, Th, Lc, seed=0, ys="sim", rho=None, log_u=None):
    """The CES task, designs x [B, Th, 6], outcomes y [B, Th] and Lc
    draws [Lc, B, 5] of the prior.  ``ys``: "sim" (simulated under each
    row's own theta: mostly at a limit), "inside" (uniform in (0.01,
    0.99)), "limits" (each limit in turn) or "outside" (beyond a limit
    at some steps).  ``rho``, ``log_u``: a value that every draw takes, or
    "tails" for log u at the prior's +- 5.5 standard deviations."""
    task = _ces_task()
    g = torch.Generator().manual_seed(seed)
    theta_0 = task.sample_theta(g, (B,))
    x = task.sample_data(g, B, Th)
    y = task.simulate(g, x, theta_0[:, None])[..., 0]
    lo, hi = (torch.tensor(v, dtype=torch.float32).item()
              for v in (task.epsilon, 1.0 - task.epsilon))
    if ys == "inside":
        y = 0.01 + 0.98 * torch.rand(B, Th, generator=g)
    elif ys == "limits":
        y = torch.where(torch.arange(B * Th).view(B, Th) % 2 == 0,
                        torch.tensor(hi), torch.tensor(lo))
    elif ys == "outside":
        beyond = torch.tensor([np.nextafter(np.float32(hi), 1),
                               np.nextafter(np.float32(lo), 0)])
        y = y.clone()
        y[:, Th // 2] = beyond[torch.arange(B) % 2]
    thetas = task.sample_theta(g, (Lc, B))
    if rho is not None:
        thetas[..., 0] = rho
    if log_u == "tails":
        thetas[..., 4] = 1.0 + 3.0 * 5.5 * torch.where(
            torch.rand(Lc, B, generator=g) < 0.5, -1.0, 1.0)
    return task, x, y.contiguous(), thetas


def _assert_within(got, want, tol):
    """Each logsumexp within ``tol`` of the plain version's; -inf (no
    draw, or an outcome outside the limits) where it is -inf."""
    from aline_tpu_torch.parallel.collectives import lse_value
    a, b = lse_value(got).double(), lse_value(want).double()
    inf = torch.isinf(b)
    assert torch.equal(a[inf], b[inf])
    err = (a[~inf] - b[~inf]).abs()
    assert (err <= tol[~inf]).all(), (
        f"max err {err.max():.3e}, worst share of the tolerance "
        f"{(err / tol[~inf]).max():.3f}")


CES_FOLD_CASES = {
    # (B, Th, Lc, y, rho, log u, n_valid): three blocks of 512 draws
    "simulated": (3, 16, 1300, "sim", None, None, 1300),
    "inside": (3, 16, 1300, "inside", None, None, 1300),
    "at the limits": (3, 16, 1300, "limits", None, None, 1300),
    "outside": (4, 16, 1300, "outside", None, None, 1300),
    "rho 0.01": (3, 16, 1300, "sim", 0.01, None, 1300),
    "rho 0.01, inside": (3, 16, 1300, "inside", 0.01, None, 1300),
    "rho 1": (3, 16, 1300, "sim", 1.0, None, 1300),
    "log u in the tails": (3, 16, 1300, "sim", None, "tails", 1300),
    "log u in the tails, inside": (3, 16, 1300, "inside", None, "tails",
                                   1300),
    "n_valid 0": (3, 16, 1300, "sim", None, None, 0),
    "n_valid 1": (3, 16, 1300, "sim", None, None, 1),
    "n_valid partial": (3, 16, 1300, "sim", None, None, 700),
    "Th 1": (5, 1, 1300, "sim", None, None, 1300),
    "Th 40 (two tiles)": (2, 40, 1300, "inside", None, None, 900),
}


@pytest.mark.parametrize("case", list(CES_FOLD_CASES))
@pytest.mark.parametrize("filled", [False, True])
def test_ces_emulated_kernel_matches_the_plain_fold(case, filled):
    B, Th, Lc, ys, rho, log_u, n = CES_FOLD_CASES[case]
    task, x, y, thetas = _ces_case(B, Th, Lc, seed=Th + n, ys=ys, rho=rho,
                                   log_u=log_u)
    state = _state(B, Th, seed=3 if filled else None)
    got = emulated_ces_fold(state, task, x, y, thetas, n)
    want = efk.eig_fold_plain(state, x, y, thetas, n, task.log_likelihood)
    tol = efk.ces_fold_tolerance(state, task, x, y, thetas, n)
    assert torch.isfinite(tol).all()
    _assert_within(got, want, tol)
    if n == 0:
        # no valid draw: the state bit for bit
        assert torch.equal(got.max, state.max)
        assert torch.equal(got.sumexp, state.sumexp)


def test_ces_cases_cover_the_kernels_branches_and_tiles():
    """The cases above take every branch of the density, and Th = 40
    runs in two of the kernel's tiles."""
    task = _ces_task()
    lo, hi = (np.float32(v) for v in (task.epsilon, 1.0 - task.epsilon))
    for ys, want in (("sim", {"lo", "hi"}), ("inside", {"in"}),
                     ("limits", {"lo", "hi"}), ("outside", {"out"})):
        y = _ces_case(4, 16, 1, ys=ys)[2].numpy()
        got = set()
        got |= {"lo"} if (y == lo).any() else set()
        got |= {"hi"} if (y == hi).any() else set()
        got |= {"in"} if ((y > lo) & (y < hi)).any() else set()
        got |= {"out"} if ((y > hi) | (y < lo)).any() else set()
        assert want <= got, (ys, got)
    assert 40 > CES_TILE_MAX >= 16
    assert CES_THREADS % 32 == 0 and CES_DRAWS >= 1


@pytest.mark.parametrize("stepwise", [False, True])
def test_ces_bounds_match_jax(monkeypatch, stepwise):
    """The bounds on given thetas with the emulated kernel in the fold's
    place, against the JAX package's, within
    ``tests/test_torch_ces.py``'s 1e-4 abs and rel: chunks of 600 draws
    (two blocks), the last 300 long, rho over the whole prior."""
    B, Th, L, L_chunk = 3, 6, 1500, 600
    jt = JaxCES(jcfg.parse_overrides(["task=ces"]).task)
    task = _ces_task()
    rng = np.random.default_rng(11)
    f32 = np.float32

    def draws(n):
        return np.concatenate(
            [rng.uniform(0.01, 1.0, size=(n, 1)),
             rng.dirichlet(np.ones(3), size=n),
             rng.normal(1.0, 3.0, size=(n, 1))], axis=-1).astype(f32)

    theta_0 = draws(B)
    x = rng.uniform(0.0, 100.0, size=(B, Th, 6)).astype(f32)
    y = np.asarray(jt.simulate(jax.random.key(3), jnp.asarray(x),
                               jnp.asarray(theta_0)[:, None]))
    thetas = draws(L * B).reshape(L, B, 5)
    want = jax_eig(jt, jnp.asarray(theta_0), jnp.asarray(x), jnp.asarray(y),
                   L, jax.random.key(0), L_chunk=L_chunk, stepwise=stepwise,
                   thetas=jnp.asarray(thetas))
    calls = []

    def recorded(kernel, state, x_, y_, th, n, **kw):
        calls.append((kernel, n))
        return emulated_ces_fold(state, task, x_, y_, th, n)

    monkeypatch.setattr(efk, "eig_fold", recorded)
    got = eig.compute_eig_from_history(
        task, *(torch.from_numpy(a.copy()) for a in (theta_0, x, y)), L,
        seed=0, L_chunk=L_chunk, stepwise=stepwise,
        thetas=torch.from_numpy(thetas))
    # the given thetas' chunks, whole
    assert calls == [("ces_eig_fold", 600)] * 3
    for g, w, name in zip(got, want, ("pce", "nmc")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_ces_emulated_chunk_padding_adds_nothing():
    task, x, y, thetas = _ces_case(2, 5, 1100, seed=4)
    state = _state(2, 5, seed=1)
    padded = emulated_ces_fold(state, task, x, y, thetas, 600)
    exact = emulated_ces_fold(state, task, x, y, thetas[:600], 600)
    assert torch.equal(padded.max, exact.max)
    assert torch.equal(padded.sumexp, exact.sumexp)


@pytest.mark.parametrize("case", ["float64", "bfloat16", "y_shape",
                                  "theta_rows", "theta_width", "x_width",
                                  "state_shape", "x_rank", "device"])
@pytest.mark.parametrize("fold", ["loc", "ces"])
def test_fold_refuses_what_it_does_not_take(fold, case):
    """What the fold launcher refuses, reached through each kernel task's
    ``fold_eig_chunk``."""
    task = _task() if fold == "loc" else _ces_task()
    x, y, thetas = _drawn(task, 2, 3, 10, seed=8)
    args = dict(state=_state(2, 3), x=x, y=y, thetas=thetas)
    err = ValueError
    if case in ("float64", "bfloat16"):
        on = "thetas" if fold == "loc" else "x"
        args[on] = args[on].to(getattr(torch, case))
        err = TypeError
    elif case == "y_shape":
        args["y"] = y[..., None]
    elif case == "theta_rows":
        args["thetas"] = thetas[:, :1]
    elif case == "theta_width":
        args["thetas"] = thetas[..., :-1]
    elif case == "x_width":
        args["x"] = x[..., :-1]
    elif case == "state_shape":
        args["state"] = lse_init((2, 4))
    elif case == "x_rank":
        args["x"] = x[0]
    elif case == "device":
        args = {k: (LogSumExpState(*(t.to("meta") for t in v))
                    if k == "state" else v.to("meta"))
                for k, v in args.items()}
    with pytest.raises(err):
        task.fold_eig_chunk(args["state"], args["x"], args["y"],
                            args["thetas"], 10)
