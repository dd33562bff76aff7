"""tpuvo_torch PICP vs tpuvo's: the plain solver against the XLA solver, and
the fused kernel's wrapper (its plain version on the CPU) against the Pallas
kernel in interpret mode — all five cases of tests/test_pallas_picp.py,
including iteration parity under the early stop.  The CUDA kernel itself is
held to its plain version on the card (tests/test_torch_cuda.py).

Tolerances follow tests/test_pallas_picp.py: the relative-chi stop is
knife-edge under another summation order, so iterations may differ by one
and poses are compared at the converged solution (atol 1e-3 .. 5e-4), inlier
counts exactly.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.config import EngineConfig as JEngineConfig, PICPConfig as JPICPConfig
from tpuvo.ops import picp as jpicp
from tpuvo.ops.pallas.picp_kernel import solve_pallas
from tpuvo_torch.config import PICPConfig
from tpuvo_torch.ops import picp as tpicp
from tpuvo_torch.ops.cuda import picp_kernel as tk
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_picp import make_problem as _make_problem  # noqa: E402

CFG = JEngineConfig()
K = CFG.K()
W, H = CFG.width, CFG.height


def make_problem(noise=0.5, pose_err=0.05, seed=0, n=128):
    pts, obs, T_gt, T0 = _make_problem(n_pts=n, noise=noise, pose_err=pose_err, seed=seed)
    X = np.zeros((128, 3), np.float32)
    X[: len(pts)] = pts
    Z = np.zeros((128, 2), np.float32)
    Z[: len(obs)] = obs
    V = np.zeros(128, bool)
    V[: len(pts)] = True
    return X, Z, V, T_gt, T0


def t(x):
    return torch.as_tensor(np.array(x))


def jax_both(X, Z, V, T0, **cfg):
    jc = JPICPConfig(**cfg)
    args = (jnp.asarray(T0), jnp.asarray(X), jnp.asarray(Z), None, jnp.asarray(V), W, H, jc)
    return (jpicp.solve(jnp.asarray(K), *args),
            solve_pallas(K, *args, interpret=True))


def port_both(X, Z, V, T0, **cfg):
    tc = PICPConfig(**cfg)
    args = (t(T0), t(X), t(Z), None, t(V), W, H, tc)
    return tpicp.solve(t(K), *args), tk.solve_cuda(K, *args)


def test_linearize_matches_jax():
    X, Z, V, _, T0 = make_problem(seed=4)
    idx = np.arange(128)[::-1].copy()
    lj = jpicp.linearize(jnp.asarray(K), jnp.asarray(T0), jnp.asarray(X[idx]), jnp.asarray(Z),
                         jnp.asarray(idx), jnp.asarray(V), W, H, 3000.0)
    lt = tpicp.linearize(t(K), t(T0), t(X[idx]), t(Z), t(idx), t(V), W, H, 3000.0)
    # fp32 sums of 128 terms in another order: errors scale with the largest
    # entry (~1e6-1e7), so entries that cancel to ~0 get atol 1e-5 * max|H|
    for got, ref in ((lt.H, lj.H), (lt.b, lj.b)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    assert int(lt.num_inliers) == int(lj.num_inliers)
    np.testing.assert_allclose(float(lt.chi_inliers), float(lj.chi_inliers), rtol=1e-4)


@pytest.mark.parametrize("kernel_thr", [3000.0, 1000.0])
def test_kernel_matches_xla_solver(kernel_thr):
    X, Z, V, _, T0 = make_problem()
    ref, pal = jax_both(X, Z, V, T0, kernel_threshold=kernel_thr)
    plain, kern = port_both(X, Z, V, T0, kernel_threshold=kernel_thr)
    for got in (plain, kern):
        for r in (ref, pal):
            assert int(got.num_inliers) == int(r.num_inliers)
            assert bool(got.converged) == bool(r.converged)
            np.testing.assert_allclose(got.T.numpy(), np.asarray(r.T), atol=5e-3)
            assert np.isclose(float(got.chi_inliers), float(r.chi_inliers), rtol=5e-2)
    # the wrapper's CPU path IS the plain solver
    assert torch.equal(kern.T, plain.T)


def test_kernel_with_outliers():
    X, Z, V, _, T0 = make_problem(noise=0.0, pose_err=0.05, seed=1)
    rng = np.random.default_rng(1)
    bad = rng.choice(np.nonzero(V)[0], 20, replace=False)
    Z2 = Z.copy()
    Z2[bad] += rng.uniform(100, 250, (20, 2))
    ref, pal = jax_both(X, Z2, V, T0, kernel_threshold=1000.0)
    _, kern = port_both(X, Z2, V, T0, kernel_threshold=1000.0)
    for r in (ref, pal):
        np.testing.assert_allclose(kern.T.numpy(), np.asarray(r.T), atol=5e-4)
        assert int(kern.num_inliers) == int(r.num_inliers)


def test_kernel_no_valid_points_is_finite():
    X, Z, V, _, T0 = make_problem()
    _, kern = port_both(X, Z, np.zeros_like(V), T0)
    assert torch.isfinite(kern.T).all()
    assert int(kern.num_inliers) == 0


def test_kernel_batches():
    """A leading batch axis solves each problem independently: batch row b
    equals the unbatched solve of problem b."""
    probs = [make_problem(seed=s) for s in range(4)]
    bX, bZ, bV, _, bT = (np.stack(a) for a in zip(*probs))
    cfg = PICPConfig(convergence_threshold=1e-4)
    got = tk.solve_cuda(K, t(bT), t(bX), t(bZ), None, t(bV), W, H, cfg)
    assert got.T.shape == (4, 4, 4)
    for b, (X, Z, V, _, T0) in enumerate(probs):
        single = tk.solve_cuda(K, t(T0), t(X), t(Z), None, t(V), W, H, cfg)
        np.testing.assert_allclose(got.T[b].numpy(), single.T.numpy(), atol=1e-5)
        assert int(got.iterations[b]) == int(single.iterations)


def test_kernel_iteration_parity_early_stopping():
    """The regression gate of the dropped principal-point Jacobian terms:
    with realistic noise and the production rel-chi 1e-4 stop, the port
    converges in the same number of GN iterations as both JAX solvers (+/-1
    for reduction-order chi ties) and lands on the same pose."""
    for seed in range(3):
        X, Z, V, _, T0 = make_problem(noise=0.5, pose_err=0.05, seed=seed)
        ref, pal = jax_both(X, Z, V, T0, convergence_threshold=1e-4)
        plain, kern = port_both(X, Z, V, T0, convergence_threshold=1e-4)
        assert int(ref.iterations) < 50
        for got in (plain, kern):
            for r in (ref, pal):
                assert abs(int(got.iterations) - int(r.iterations)) <= 1, seed
                np.testing.assert_allclose(got.T.numpy(), np.asarray(r.T), atol=1e-3)


def test_corr_idx_gather_and_unrolled_variants():
    """Correspondence indexing into a larger map, the unrolled and the
    fixed-round drivers, and the annealed threshold, against JAX."""
    X, Z, V, _, T0 = make_problem(seed=5)
    rng = np.random.default_rng(5)
    world = rng.normal(0, 5, (300, 3)).astype(np.float32)
    idx = rng.choice(300, 128, replace=False)
    world[idx] = X
    for fn, kw, cfg in (("solve", {}, dict(convergence_threshold=1e-4)),
                        ("solve_unrolled", dict(rounds=8), {}),
                        ("solve_fixed_rounds", dict(rounds=4), {}),
                        ("solve", {}, dict(annealed_kernel=True, kernel_threshold=500.0))):
        rj = getattr(jpicp, fn)(jnp.asarray(K), jnp.asarray(T0), jnp.asarray(world), jnp.asarray(Z),
                                jnp.asarray(idx), jnp.asarray(V), W, H, JPICPConfig(**cfg), **kw)
        rt = getattr(tpicp, fn)(t(K), t(T0), t(world), t(Z), t(idx), t(V), W, H,
                                PICPConfig(**cfg), **kw)
        np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-3)
        assert abs(int(rt.iterations) - int(rj.iterations)) <= 1, fn
        assert int(rt.num_inliers) == int(rj.num_inliers), fn


def test_wrapper_rejects_annealing_on_cuda_only(monkeypatch):
    """The annealed schedule on CPU tensors: the wrapper runs the plain
    solver's schedule (no launch), and the kernel's arguments carry the
    schedule (flag and multiplier) for CUDA tensors."""
    X, Z, V, _, T0 = make_problem()
    cfg = PICPConfig(annealed_kernel=True, anneal_mult=3.0)
    n0 = tk.launches
    res = tk.solve_cuda(K, t(T0), t(X), t(Z), None, t(V), W, H, cfg)
    ref = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H, cfg)
    assert all(torch.equal(a, b) for a, b in zip(res, ref)) and tk.launches == n0
    args = kernel_args(monkeypatch, t(T0), t(X), t(Z), None, t(V), cfg)
    assert args[-3:-1] == (1, 3.0)  # anneal, anneal_mult
    assert kernel_args(monkeypatch, t(T0), t(X), t(Z), None, t(V), PICPConfig())[-3:-1] == (0, 4.0)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_kernel_outputs_have_the_plain_dtypes(batch):
    """The kernel writes the typed PICPResult itself (no conversion kernel
    after it): the buffers the wrapper gives it have the plain solver's
    dtypes and shapes."""
    X, Z, V, _, T0 = make_problem()
    ref = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H, PICPConfig())
    out = tk.empty_result(batch, "cpu")
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == batch + r.shape


def test_prepare_rejects_what_the_kernel_does_not_take(monkeypatch):
    """prepare refuses more points than a block stages and tensors off the
    card, and accepts the annealed schedule (it reaches the launch)."""
    X, Z, V, _, T0 = make_problem()
    n = tk.MAX_POINTS + 1
    big = lambda a: t(np.resize(a, (n,) + a.shape[1:]))
    with pytest.raises(ValueError, match="at most"):
        tk.prepare(K, t(T0), big(X), big(Z), None, big(V), W, H, PICPConfig())
    with pytest.raises(ValueError, match="kernel argument on cpu"):
        tk.prepare(K, t(T0), t(X), t(Z), None, t(V), W, H, PICPConfig())
    args = kernel_args(monkeypatch, t(T0), t(X), t(Z), None, t(V),
                       PICPConfig(annealed_kernel=True))
    assert args[-3] == 1


def kernel_args(monkeypatch, T0, X, Z, idx, V, cfg, thr=None):
    """The argument tuple prepare hands the kernel library for these CPU
    tensors (the device check and the library stubbed; nothing launches)."""
    import types

    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(tk.build, "check_device", lambda *a: None)
        mp.setattr(tk.build, "library", lambda: types.SimpleNamespace(
            tpuvo_picp_solve=lambda *a: calls.append(a) or 0))
        mp.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=0))
        n0 = tk.launches
        launch, _ = tk.prepare(K, T0, X, Z, idx, V, W, H, cfg, thr)
        launch()
        assert tk.launches == n0 + 1
    return calls[0]


def test_kernel_per_problem_thresholds():
    """A (B,) threshold tensor gives each problem its own robust threshold:
    problem b equals the solve with cfg.kernel_threshold = thr[b]."""
    probs = [make_problem(seed=s) for s in range(3)]
    bX, bZ, bV, _, bT = (np.stack(a) for a in zip(*probs))
    bZ[:, :12] += 40.0  # outliers whose chi (3200) lies between the thresholds
    thr = [1000.0, 3000.0, 10000.0]
    cfg = PICPConfig(convergence_threshold=1e-4)
    got = tk.solve_cuda(K, t(bT), t(bX), t(bZ), None, t(bV), W, H, cfg, torch.tensor(thr))
    for b in range(3):
        one = tk.solve_cuda(K, t(bT[b]), t(bX[b]), t(bZ[b]), None, t(bV[b]), W, H,
                            PICPConfig(convergence_threshold=1e-4, kernel_threshold=thr[b]))
        np.testing.assert_allclose(got.T[b].numpy(), one.T.numpy(), atol=1e-5)
        assert int(got.num_inliers[b]) == int(one.num_inliers)
    assert len(set(got.num_inliers.tolist())) > 1  # the thresholds split the inlier sets


# --- the plain solve across round counts; it stops after the last round ---
def round_count_batch():
    """Problems that stop after 1 round (too few points), a few rounds
    (noisy), and all 50 (noise-free at a stop threshold no round meets)."""
    probs = [make_problem(noise=n, pose_err=0.05, seed=s)
             for s, n in enumerate((0.5, 0.3, 1.0, 2.0, 0.0, 0.0))]
    X, Z, V, _, T0 = (np.stack(a) for a in zip(*probs))
    V[0, 4:] = False   # 4 points: fewer than MIN_INLIERS
    return X, Z, V, T0


MIN_INLIERS = 10


@pytest.mark.parametrize("conv", [1e-4, 1e-5])
def test_solve_batch_matches_jax_across_round_counts(conv):
    import jax

    X, Z, V, T0 = round_count_batch()
    cfg = dict(convergence_threshold=conv, min_num_inliers=MIN_INLIERS)
    ref = jax.vmap(lambda T, x, z, v: jpicp.solve(jnp.asarray(K), T, x, z, None, v, W, H,
                                                  JPICPConfig(**cfg)))(
        *map(jnp.asarray, (T0, X, Z, V)))
    got = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H, PICPConfig(**cfg))
    its = got.iterations.numpy()
    assert its[0] == 1 and its.max() > 16  # round counts spread from 1 to the tens
    assert np.array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert np.array_equal(got.num_inliers.numpy(), np.asarray(ref.num_inliers))
    noisy = slice(0, 4)  # noise-free problems cannot hold iteration parity (ROADMAP §3)
    assert np.abs(its[noisy] - np.asarray(ref.iterations)[noisy]).max() <= 1
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=1e-3)


@pytest.mark.parametrize("conv", [1e-4, 0.0])
def test_solve_runs_no_round_after_every_problem_is_done(monkeypatch, conv):
    """One host check of the done flags a round: the loop stops right after
    the round in which the last problem finished (an idle round under the
    done-mask costs a round's launches, far more than the check)."""
    rounds = []
    one_round = tpicp.one_round
    monkeypatch.setattr(tpicp, "one_round", lambda *a: rounds.append(1) or one_round(*a))
    X, Z, V, T0 = round_count_batch()
    cfg = PICPConfig(convergence_threshold=conv, min_num_inliers=MIN_INLIERS)
    got = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H, cfg)
    assert len(rounds) == int(got.iterations.max())
    assert conv or len(rounds) == 50  # no round meets a stop threshold of 0
    rounds.clear()
    got = tpicp.solve(t(K), t(T0[:1]), t(X[:1]), t(Z[:1]), None, t(V[:1]), W, H, cfg)
    assert int(got.iterations[0]) == 1 and len(rounds) == 1


# --- the annealed schedule, the unrolled cap and the kernel's packing -----
def anneal_batch():
    """Six noisy problems started far enough off that the first rounds'
    median chi lies above every threshold below; ten rows of each 40 px
    off (chi 3200)."""
    probs = [make_problem(noise=0.5, pose_err=0.08, seed=s) for s in range(6)]
    X, Z, V, _, T0 = (np.stack(a) for a in zip(*probs))
    Z[:, :10] += 40.0
    return X, Z, V, T0


@pytest.mark.parametrize("per_problem", [False, True])
def test_annealed_batch_matches_jax_vmap(per_problem):
    """The plain annealed solve over a batch (a threshold per problem, or
    the config's) against jax.vmap of tpuvo's solve: T to 1e-3, inliers
    exact, iterations +/-1 (the rel-chi stop under another summation
    order).  The schedule must matter: without it the solves differ."""
    import jax

    X, Z, V, T0 = anneal_batch()
    thr = np.array([50.0, 200.0, 1000.0, 50.0, 200.0, 1000.0], np.float32)
    cfg = dict(annealed_kernel=True, convergence_threshold=1e-4, kernel_threshold=200.0)
    jthr = jnp.asarray(thr) if per_problem else jnp.full(6, 200.0, jnp.float32)
    ref = jax.vmap(lambda T, x, z, v, h: jpicp.solve(jnp.asarray(K), T, x, z, None, v, W, H,
                                                     JPICPConfig(**cfg), h))(
        *map(jnp.asarray, (T0, X, Z, V)), jthr)
    tthr = t(thr) if per_problem else None
    got = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H, PICPConfig(**cfg), tthr)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=1e-3)
    assert np.array_equal(got.num_inliers.numpy(), np.asarray(ref.num_inliers))
    assert np.abs(got.iterations.numpy() - np.asarray(ref.iterations)).max() <= 1
    assert np.array_equal(got.converged.numpy(), np.asarray(ref.converged))
    flat = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H,
                       PICPConfig(**dict(cfg, annealed_kernel=False)), tthr)
    assert not torch.equal(flat.T, got.T)
    assert not torch.equal(flat.iterations, got.iterations)


@pytest.mark.parametrize("rounds", [1, 3, 8])
def test_unrolled_is_solve_with_max_iterations(rounds):
    """solve_unrolled(rounds=r) is bit for bit solve with max_iterations=r
    (the same stop rule, finished problems frozen): the card runs the
    unrolled driver as the kernel with that cap."""
    X, Z, V, T0 = round_count_batch()
    for thr in (None, t(np.array([3000.0, 100.0, 3000.0, 500.0, 3000.0, 3000.0], np.float32))):
        cfg = PICPConfig(convergence_threshold=1e-4, min_num_inliers=MIN_INLIERS)
        got = tpicp.solve_unrolled(t(K), t(T0), t(X), t(Z), None, t(V), W, H, cfg, thr,
                                   rounds=rounds)
        ref = tpicp.solve(t(K), t(T0), t(X), t(Z), None, t(V), W, H,
                          PICPConfig(convergence_threshold=1e-4, min_num_inliers=MIN_INLIERS,
                                     max_iterations=rounds), thr)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), rounds
        assert int(got.iterations.max()) == rounds


@pytest.mark.parametrize("form", ["per-observation", "gathered"])
def test_packing_of_multi_axis_batches_is_bit_equal(form):
    """pack_args / unpack_result, the kernel's view of a (2, 3)-batched
    solve (corr_idx None, or gathered from a map per problem, with a
    threshold per problem): the plain solve on the packed (6,) batch,
    unpacked, equals the plain solve on the (2, 3) batch bit for bit."""
    X, Z, V, _, T0 = (np.stack(a) for a in zip(*[make_problem(seed=s) for s in range(6)]))
    thr = t(np.array([1000.0, 3000.0, 200.0, 1000.0, 3000.0, 200.0], np.float32).reshape(2, 3))
    idx = None
    if form == "gathered":
        rng = np.random.default_rng(1)
        world = rng.normal(0, 5, (6, 300, 3)).astype(np.float32)
        idx = np.stack([rng.choice(300, 128, replace=False) for _ in range(6)])
        world[np.arange(6)[:, None], idx] = X
        X, idx = world, t(idx.reshape(2, 3, 128))
    shape = lambda a: t(a.reshape((2, 3) + a.shape[1:]))
    args = (shape(T0), shape(X), shape(Z), idx, shape(V))
    cfg = PICPConfig(convergence_threshold=1e-4)
    ref = tpicp.solve(t(K), *args, W, H, cfg, thr)
    lead, *packed, pthr = tk.pack_args(*args, thr)
    assert lead == (2, 3) and packed[0].shape == (6, 4, 4) and pthr.shape == (6,)
    got = tk.unpack_result(tpicp.solve(t(K), *packed, W, H, cfg, pthr), lead)
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, ref))
    # one problem: no leading axis, and a scalar threshold tensor broadcast
    lead, *packed, pthr = tk.pack_args(*(a[1, 2] for a in args[:3]),
                                       None if idx is None else idx[1, 2], args[4][1, 2],
                                       thr[1, 2])
    assert lead == () and packed[0].shape == (1, 4, 4) and pthr.shape == (1,)
    one = tk.unpack_result(tpicp.solve(t(K), *packed, W, H, cfg, pthr), lead)
    assert one.T.shape == (4, 4) and one.iterations.shape == ()
    # lanes of a larger tensor stay views (the kernel reads them at their stride)
    big = torch.zeros((6, 130, 2))
    lane_view = big[:, 1:129]
    _, _, _, uv, _, _, _ = tk.pack_args(shape(T0).reshape(6, 4, 4), t(X).reshape(6, -1, 3),
                                        lane_view, None, t(V))
    assert uv.data_ptr() == lane_view.data_ptr() and uv.stride() == lane_view.stride()


def test_kernel_args_take_K_on_the_card_without_a_host_read(monkeypatch):
    """K as a host array goes to the kernel as four floats and a NULL
    pointer; a K tensor's values are not read on the host when it is on the
    card (its pointer goes instead: checked on the card)."""
    X, Z, V, _, T0 = make_problem()
    args = kernel_args(monkeypatch, t(T0), t(X), t(Z), None, t(V), PICPConfig())
    fx, fy, cx, cy = args[20:24]
    assert args[6] is None and (fx, fy, cx, cy) == (float(K[0, 0]), float(K[1, 1]),
                                                   float(K[0, 2]), float(K[1, 2]))


def kernel_route(monkeypatch, card: bool):
    """Every PICP solve routed as on a CUDA device (card=True) or on the
    CPU, with no CUDA tensor: ``solve_cuda``'s device test is fixed, the
    kernel's ``prepare`` records what it was handed and answers with the
    plain solve of exactly that (so the caller goes on), and the plain
    loops record their calls.  Returns {"kernel": [...], "plain": [...]}."""
    seen = {"kernel": [], "plain": []}
    solve = tpicp.solve
    monkeypatch.setattr(tk, "on_card", lambda _t: card)

    def prepare(K_, T0, world, uv, idx, valid, w, h, cfg, thr=None):
        seen["kernel"].append(dict(cfg=cfg, thr=thr, batch=tuple(T0.shape[:-2]),
                                   gathered=idx is not None, K=K_))
        res = solve(torch.as_tensor(K_, dtype=torch.float32), T0, world, uv, idx, valid,
                    w, h, cfg, thr)
        return (lambda: None), res

    monkeypatch.setattr(tk, "prepare", prepare)
    for name in ("solve", "solve_unrolled"):
        fn = getattr(tpicp, name)
        monkeypatch.setattr(tpicp, name, lambda *a, _f=fn, _n=name, **kw:
                            (seen["plain"].append(_n), _f(*a, **kw))[1])
    return seen
