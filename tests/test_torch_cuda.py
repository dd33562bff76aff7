"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without a card they skip.
This file imports no JAX (the machine with the card has none), so it runs
there on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than the plain versions —
PICP poses atol 1e-4 and iterations +/-1 (knife-edge relative-chi stop),
match decisions exact and distances atol 1e-5.
"""

import numpy as np
import pytest
import torch

from tpuvo_torch.config import EngineConfig, MatcherConfig, PICPConfig
from tpuvo_torch.data import synthetic
from tpuvo_torch.engine import vo
from tpuvo_torch.engine.state import VOState
from tpuvo_torch.ops import lie, picp
from tpuvo_torch.ops.cuda import match_kernel, picp_kernel

pytestmark = pytest.mark.cuda
CFG = EngineConfig()
K = CFG.K()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run "
                    "`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py` on the card")
    return torch.device("cuda")


def picp_problems(B, seed=0, n=128, noise=0.5):
    """B PICP problems: points in front of a camera, noisy projections, a
    perturbed initial world-in-camera pose."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, (B, n)), rng.uniform(-3, 3, (B, n)),
                  rng.uniform(3, 15, (B, n))], -1).astype(np.float32)
    uv = X[..., :2] / X[..., 2:] * 180.0 + np.array([320.0, 240.0])
    Z = (uv + noise * rng.standard_normal(uv.shape)).astype(np.float32)
    V = (uv[..., 0] > 0) & (uv[..., 0] < 639) & (uv[..., 1] > 0) & (uv[..., 1] < 479)
    V[:, -10:] = False
    dv = torch.as_tensor(rng.normal(0, 0.03, (B, 6)).astype(np.float32))
    return X, Z, V, lie.v2t_euler(dv).numpy()


def test_picp_kernel_matches_plain(dev):
    for B in (1, 64):
        X, Z, V, T0 = (torch.as_tensor(a, device=dev) for a in picp_problems(B, seed=B))
        for cfg in (PICPConfig(convergence_threshold=1e-4), PICPConfig(kernel_threshold=1000.0)):
            n0 = picp_kernel.launches
            got = picp_kernel.solve_cuda(K, T0, X, Z, None, V, 640, 480, cfg)
            assert picp_kernel.launches == n0 + 1
            ref = picp.solve(torch.as_tensor(K, device=dev), T0, X, Z, None, V, 640, 480, cfg)
            torch.testing.assert_close(got.T, ref.T, atol=1e-4, rtol=0)
            assert torch.equal(got.num_inliers, ref.num_inliers)
            assert (got.iterations - ref.iterations).abs().max() <= 1


def test_picp_kernel_gathers_by_corr_idx(dev):
    X, Z, V, T0 = picp_problems(1, seed=3)
    rng = np.random.default_rng(3)
    world = rng.normal(0, 5, (1000, 3)).astype(np.float32)
    idx = rng.choice(1000, 128, replace=False)
    world[idx] = X[0]
    args = [torch.as_tensor(a, device=dev) for a in (T0[0], world, Z[0], idx, V[0])]
    cfg = PICPConfig(convergence_threshold=1e-4)
    got = picp_kernel.solve_cuda(K, args[0], args[1], args[2], args[3], args[4], 640, 480, cfg)
    ref = picp.solve(torch.as_tensor(K, device=dev), *args, 640, 480, cfg)
    torch.testing.assert_close(got.T, ref.T, atol=1e-4, rtol=0)


def test_picp_kernel_rejects_annealing_and_bad_input(dev):
    X, Z, V, T0 = (torch.as_tensor(a, device=dev) for a in picp_problems(2))
    with pytest.raises(ValueError, match="annealing"):
        picp_kernel.solve_cuda(K, T0, X, Z, None, V, 640, 480, PICPConfig(annealed_kernel=True))
    with pytest.raises(ValueError):
        picp_kernel.solve_cuda(K, T0, X.cpu(), Z, None, V, 640, 480, PICPConfig())


def match_sets(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    d1 = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (m, 10)).astype(np.float32)
    tgt = rng.choice(m, n // 2, replace=False)
    d2[tgt] = d1[: n // 2] + rng.normal(0, 0.02, (n // 2, 10)).astype(np.float32)
    d2[3] = d2[m // 2] = d1[n - 1]  # exact duplicates: first index, distance 0
    v2 = np.ones(m, bool)
    v2[100:130] = False
    return [torch.as_tensor(a, device=dev) for a in (d1, np.ones(n, bool), d2, v2)]


@pytest.mark.parametrize("m", [512, 8191, 8192])
def test_match_kernel_matches_plain(dev, m):
    d1, v1, d2, v2 = match_sets(128, m, m, dev)
    n0 = match_kernel.launches
    got = match_kernel.match_descriptors_cuda(d1, v1, d2, v2)
    assert match_kernel.launches == n0 + 1
    best, idx, second = match_kernel.match_topk_reference(d1, v1, d2, v2)
    valid = (best < 0.2) & (best / second < 0.8) & v1
    assert torch.equal(got.valid, valid)
    assert torch.equal(got.idx, idx)  # every row has a valid column
    torch.testing.assert_close(got.best, best, atol=1e-5, rtol=0)
    assert int(got.idx[-1]) == 3 and float(got.best[-1]) == 0.0
    none = match_kernel.match_descriptors_cuda(d1, v1, d2, torch.zeros_like(v2))
    assert not none.valid.any() and torch.isinf(none.best).all()


def test_track_step_on_card_matches_cpu(dev):
    """Teacher forcing on a small fixture: each CPU state stepped on the
    card through both kernels matches the CPU step."""
    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       matcher=MatcherConfig(method="pallas"),
                       picp=PICPConfig(backend="pallas", convergence_threshold=1e-4))
    world = synthetic.make_world(13, n_landmarks=300, xy_extent=8.0)
    seq = synthetic.render_sequence(world, synthetic.make_planar_trajectory(10, seed=13), cfg,
                                    pixel_noise=0.3, seed=13)
    F = seq.uv.shape[0]
    fr, frg = vo.frames_of(seq, 0, F), vo.frames_of(seq, 0, F, dev)
    state, _ = vo.bootstrap(vo.make_generator(42), vo.frame_at(fr, 0), vo.frame_at(fr, 1), cfg)
    for i in range(F - 1):
        s2, lg = vo.track_step(state, vo.frame_at(fr, i), vo.frame_at(fr, i + 1), cfg)
        sg = VOState(*(x.to(dev) for x in state))
        s2g, lgg = vo.track_step(sg, vo.frame_at(frg, i), vo.frame_at(frg, i + 1), cfg)
        torch.testing.assert_close(lgg.pose.cpu(), lg.pose, atol=1e-4, rtol=0)
        assert int(lgg.n_map_matches) == int(lg.n_map_matches)
        assert int(lgg.num_inliers) == int(lg.num_inliers)
        state = s2
