"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without a card they skip.
This file imports no JAX (the machine with the card has none), so it runs
there on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than the plain versions —
PICP poses atol 1e-4 and iterations +/-1 (knife-edge relative-chi stop),
match decisions exact and distances atol 1e-5.  The SLAM backend on the
card against the CPU (its sums and products run in another order there):
BA poses atol 1e-4, points atol 1e-2; slam_step window poses atol 1e-3.
Kernel C (the bootstrap's eigensolvers) against its plain version:
eigenvalues and singular values within 1e-5 of the largest, vectors of
separated values (gaps >= 0.375 against a largest of 10) within 1e-4,
a repeated eigenvalue's space by its projector within 1e-5.
"""

import numpy as np
import pytest
import torch

from tpuvo_torch.config import EngineConfig, MatcherConfig, PICPConfig
from tpuvo_torch.data import synthetic
from tpuvo_torch.engine import vo
from tpuvo_torch.engine.state import VOState
from tpuvo_torch.ops import lie, picp
from tpuvo_torch.ops.cuda import match_kernel, picp_kernel, smalleig

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


def check_picp(got, ref):
    """The kernel against the plain solve: T within 1e-4, inlier counts and
    `converged` identical, iterations within 1, the same dtypes."""
    torch.testing.assert_close(got.T, ref.T, atol=1e-4, rtol=0)
    assert torch.equal(got.num_inliers, ref.num_inliers)
    assert torch.equal(got.converged, ref.converged)
    assert (got.iterations - ref.iterations).abs().max() <= 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape


def test_picp_kernel_matches_plain(dev):
    for B in (1, 64):
        X, Z, V, T0 = (torch.as_tensor(a, device=dev) for a in picp_problems(B, seed=B))
        if B == 1:
            X, Z, V, T0 = X[0], Z[0], V[0], T0[0]
        for cfg in (PICPConfig(convergence_threshold=1e-4), PICPConfig(kernel_threshold=1000.0)):
            n0 = picp_kernel.launches
            got = picp_kernel.solve_cuda(K, T0, X, Z, None, V, 640, 480, cfg)
            assert picp_kernel.launches == n0 + 1
            ref = picp.solve(torch.as_tensor(K, device=dev), T0, X, Z, None, V, 640, 480, cfg)
            check_picp(got, ref)


@pytest.mark.parametrize("case", ["N=300", "B=256 ragged"])
def test_picp_kernel_edges(dev, case):
    """More points than the block has threads, and a batch whose problems
    keep 25-100% of their rows valid (two keep none).  With only a handful
    of valid points the solve is chaotic under any change of summation
    order: the plain solve on the CPU, its points permuted, already moves
    beyond these limits, so no parity limit can hold it."""
    if case == "N=300":
        X, Z, V, T0 = picp_problems(4, seed=5, n=300)
    else:
        X, Z, V, T0 = picp_problems(256, seed=6)
        rng = np.random.default_rng(6)
        V &= rng.random(V.shape) < rng.uniform(0.25, 1.0, (256, 1))
        V[:2] = False
    args = [torch.as_tensor(a, device=dev) for a in (T0, X, Z)]
    V = torch.as_tensor(V, device=dev)
    # the tracker's rel-chi 1e-4: at the default 1e-5 a problem of a few
    # dozen points already stops rounds apart with its points permuted, on
    # the CPU
    for cfg in (PICPConfig(convergence_threshold=1e-4),
                PICPConfig(kernel_threshold=1000.0, keep_outliers=True,
                           convergence_threshold=1e-4)):
        got = picp_kernel.solve_cuda(K, *args, None, V, 640, 480, cfg)
        ref = picp.solve(torch.as_tensor(K, device=dev), *args, None, V, 640, 480, cfg)
        check_picp(got, ref)


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
    """The kernel takes the annealed schedule (one launch, as the plain
    solve) and a K tensor on the card; it refuses an input off the card."""
    X, Z, V, T0 = (torch.as_tensor(a, device=dev) for a in picp_problems(2))
    cfg = PICPConfig(annealed_kernel=True, convergence_threshold=1e-4)
    Kd = torch.as_tensor(K, device=dev)
    n0 = picp_kernel.launches
    got = picp_kernel.solve_cuda(Kd, T0, X, Z, None, V, 640, 480, cfg)
    assert picp_kernel.launches == n0 + 1
    check_picp(got, picp.solve(Kd, T0, X, Z, None, V, 640, 480, cfg))
    with pytest.raises(ValueError):
        picp_kernel.solve_cuda(K, T0, X.cpu(), Z, None, V, 640, 480, PICPConfig())


def anneal_problems(B, seed, dev):
    """B problems started far off (the first rounds' median chi lies above
    the thresholds), ten rows of each 40 px off, 60-100% of rows valid."""
    rng = np.random.default_rng(seed)
    X, Z, V, _ = picp_problems(B, seed=seed)
    Z[:, :10] += 40.0
    V &= rng.random(V.shape) < rng.uniform(0.6, 1.0, (B, 1))
    dv = torch.as_tensor(rng.normal(0, 0.08, (B, 6)).astype(np.float32))
    T0 = lie.v2t_euler(dv).numpy()
    return [torch.as_tensor(a, device=dev) for a in (T0, X, Z, V)]


@pytest.mark.parametrize("case", ["B=1 gathered from 512 slots", "B=256 thresholds per lane"])
def test_picp_kernel_annealed_matches_plain(dev, case):
    """The annealed schedule (a lower median of the in-bounds chi each
    round) in the kernel against the plain solve: the tracker's B=1 form
    gathered from a 512-slot map, and 256 problems with a threshold each
    (the sweep's lanes).  The schedule must matter: without it the kernel
    gives other poses."""
    T0, X, Z, V = anneal_problems(1 if case.startswith("B=1") else 256, 12, dev)
    cfg = PICPConfig(annealed_kernel=True, convergence_threshold=1e-4, kernel_threshold=200.0)
    thr, idx = None, None
    if case.startswith("B=1"):
        rng = np.random.default_rng(12)
        world = torch.as_tensor(rng.normal(0, 5, (512, 3)).astype(np.float32), device=dev)
        idx = torch.as_tensor(rng.choice(512, 128, replace=False), device=dev)
        world[idx] = X[0]
        T0, X, Z, V = T0[0], world, Z[0], V[0]
    else:
        thr = torch.tensor([50.0, 200.0, 1000.0], device=dev).repeat(86)[:256]
    Kd = torch.as_tensor(K, device=dev)
    got = picp_kernel.solve_cuda(K, T0, X, Z, idx, V, 640, 480, cfg, thr)
    check_picp(got, picp.solve(Kd, T0, X, Z, idx, V, 640, 480, cfg, thr))
    import dataclasses

    flat = picp_kernel.solve_cuda(K, T0, X, Z, idx, V, 640, 480,
                                  dataclasses.replace(cfg, annealed_kernel=False), thr)
    assert not torch.equal(flat.T, got.T)


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


def check_match(got, d1, v1, d2, v2):
    """The kernel against the plain matcher: decisions and idx identical
    (rows with no valid column included), best within 1e-5."""
    best, idx, second = match_kernel.match_topk_reference(d1, v1, d2, v2)
    valid = (best < 0.2) & (best / second < 0.8) & v1
    assert torch.equal(got.valid, valid)
    assert torch.equal(got.idx, torch.where(torch.isfinite(best), idx, 0))
    torch.testing.assert_close(got.best, best, atol=1e-5, rtol=0)


@pytest.mark.parametrize("m", [512, 8191, 8192])
def test_match_kernel_matches_plain(dev, m):
    d1, v1, d2, v2 = match_sets(128, m, m, dev)
    n0 = match_kernel.launches
    got = match_kernel.match_descriptors_cuda(d1, v1, d2, v2)
    assert match_kernel.launches == n0 + 1
    check_match(got, d1, v1, d2, v2)
    assert int(got.idx[-1]) == 3 and float(got.best[-1]) == 0.0
    none = match_kernel.match_descriptors_cuda(d1, v1, d2, torch.zeros_like(v2))
    assert not none.valid.any() and torch.isinf(none.best).all() and not none.idx.any()


@pytest.mark.parametrize("n,m,d", [(100, 8192, 10), (300, 8191, 10), (1, 130, 10),
                                   (128, 8192, 32), (77, 1000, 7)])
def test_match_kernel_shapes(dev, n, m, d):
    """Query counts that are not a multiple of the query tile, ragged last
    map tiles, and descriptor widths other than 10 (the kernel's generic
    instantiation)."""
    rng = np.random.default_rng(n + m + d)
    d1 = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    hit = rng.choice(m, min(n, m) // 2, replace=False)
    d2[hit] = d1[: len(hit)] + rng.normal(0, 0.02, (len(hit), d)).astype(np.float32)
    v1, v2 = rng.random(n) < 0.9, rng.random(m) < 0.95
    args = [torch.as_tensor(a, device=dev) for a in (d1, v1, d2, v2)]
    check_match(match_kernel.match_descriptors_cuda(*args), *args)


def test_match_kernel_unaligned_views(dev):
    """Views that start off the kernel's copy alignment (the map off 16
    bytes, the valid masks off 4) give the same answer."""
    d1, v1, d2, v2 = match_sets(131, 8193, 12, dev)
    args = (d1[3:], v1[3:], d2[1:], v2[1:])
    assert args[2].data_ptr() % 16 and args[1].data_ptr() % 4 and args[3].data_ptr() % 4
    check_match(match_kernel.match_descriptors_cuda(*args), *args)


def test_match_kernel_duplicates_across_cluster_blocks(dev):
    """Exact copies of a query placed in two different blocks of a cluster,
    on both sides of a map split, a staged-tile edge and a row-lane edge,
    and on the last row: the lower index wins, at distance exactly 0, and
    the ratio test rejects the pair (second = 0)."""
    n, m = 128, 8192
    qb, qpt, splits = match_kernel.launch_plan(n, m, 10, torch.cuda.get_device_properties(0)
                                               .multi_processor_count)
    rows = match_kernel.tile_rows(10)
    per_split = -(-(-(-m // rows)) // splits) * rows
    lane_rows = rows // (128 // (qb // qpt))
    pairs = [(5, per_split + 3), (per_split - 1, per_split), (2 * per_split + 1, 5 * per_split),
             (rows - 1, rows), (lane_rows - 1, lane_rows), (m - 2, m - 1)]
    d1, v1, d2, v2 = match_sets(n, m, 11, dev)
    for q, (lo, hi) in enumerate(pairs):
        d2[lo] = d2[hi] = d1[q]
        v2[lo] = v2[hi] = True
    got = match_kernel.match_descriptors_cuda(d1, v1, d2, v2)
    check_match(got, d1, v1, d2, v2)
    for q, (lo, _) in enumerate(pairs):
        assert int(got.idx[q]) == lo and float(got.best[q]) == 0.0
        assert float(got.second[q]) == 0.0 and not bool(got.valid[q])


def ba_window_problem(seed=3, W=8, L=400):
    """A noisy window with perturbed poses 2.. and points (test_ba's shape)."""
    from tpuvo_torch.ba.window import BAProblem

    rng = np.random.default_rng(seed)
    world = synthetic.make_world(seed, n_landmarks=L, xy_extent=6.0)
    gt = synthetic.make_planar_trajectory(W, step=0.25, turn=0.05, seed=seed)
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=0.3, seed=seed)
    poses = np.stack([np.linalg.inv(synthetic.camera_pose_from_gt(g, CFG)) for g in gt])
    xi = torch.as_tensor(0.02 * rng.standard_normal((W, 6)).astype(np.float32))
    xi[:2] = 0.0
    poses = lie.se3_exp(xi) @ torch.as_tensor(poses.astype(np.float32))
    points = world.xyz + 0.03 * rng.standard_normal(world.xyz.shape)
    return BAProblem(poses, torch.as_tensor(points.astype(np.float32)),
                     torch.as_tensor(seq.uv[:W]),
                     torch.as_tensor(np.where(seq.valid, seq.id_real, 0)[:W].astype(np.int64)),
                     torch.as_tensor(seq.valid[:W]), torch.ones(L, dtype=torch.bool),
                     torch.arange(W) < 2)


def test_ba_solve_on_card_matches_cpu(dev):
    """ba_solve (compacted and capped, LM and fixed damping) on the card vs
    the CPU.  The card's products sum in another order: poses atol 1e-4,
    points atol 1e-2; the integer stats exact."""
    from tpuvo_torch.ba.window import ba_solve
    from tpuvo_torch.config import BAConfig

    p = ba_window_problem()
    pg = type(p)(*(x.to(dev) for x in p))
    for cfg in (BAConfig(iterations=8), BAConfig(iterations=6, compact_cap=64),
                BAConfig(iterations=4, lm_adaptive=False)):
        ref, sr = ba_solve(p, torch.as_tensor(K), 640, 480, cfg)
        got, sg = ba_solve(pg, torch.as_tensor(K, device=dev), 640, 480, cfg)
        torch.testing.assert_close(got.poses.cpu(), ref.poses, atol=1e-4, rtol=0)
        torch.testing.assert_close(got.points.cpu(), ref.points, atol=1e-2, rtol=0)
        assert int(sg.num_obs) == int(sr.num_obs)


def test_slam_step_on_card_matches_cpu(dev):
    """Teacher forcing: each CPU SLAM carry stepped on the card through both
    kernels matches the CPU step, local BA included (W=6 window)."""
    from tpuvo_torch.engine import slam

    cfg = EngineConfig(mode="fixed", map_capacity=1024, fuse_frame_matchers=True,
                       local_ba_window=6, local_ba_iterations=4,
                       matcher=MatcherConfig(method="pallas"),
                       picp=PICPConfig(backend="pallas", convergence_threshold=1e-4))
    gt = synthetic.make_loop_trajectory(200, step=1.0, seed=7)[:16]
    world = synthetic.make_world(7, n_landmarks=4000, xy_extent=float(np.abs(gt[:, :2]).max()) + 15,
                                 z_range=(0.0, 8.0))
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3, seed=7)
    F = seq.uv.shape[0]
    fr, frg = vo.frames_of(seq, 0, F, "cpu"), vo.frames_of(seq, 0, F, dev)
    state, _ = vo.bootstrap(vo.make_generator(42), vo.frame_at(fr, 0), vo.frame_at(fr, 1), cfg)
    carry = slam.init_carry(state, F, fr.uv.shape[1], cfg)
    n0 = picp_kernel.launches
    for i in range(F - 1):
        c2, lg = slam.slam_step(carry, vo.frame_at(fr, i), vo.frame_at(fr, i + 1), cfg)
        g2, lgg = slam.slam_step(slam.carry_to(carry, dev), vo.frame_at(frg, i),
                                 vo.frame_at(frg, i + 1), cfg)
        torch.testing.assert_close(lgg.pose.cpu(), lg.pose, atol=1e-4, rtol=0)
        torch.testing.assert_close(g2.poses_all.cpu(), c2.poses_all, atol=1e-3, rtol=0)
        assert torch.equal(g2.buf_valid.cpu(), c2.buf_valid)
        assert int(lgg.n_map_matches) == int(lg.n_map_matches)
        assert g2.n_ba == c2.n_ba
        carry = c2
    assert carry.n_ba > 3 and picp_kernel.launches == n0 + F - 1


def test_topology_one_launch_matches_per_frame(dev):
    """_global_topology sends all F frames to the top-2 kernel as one
    (F·N)-row launch; each row matches its per-frame call, and the launch
    matches the plain version on the same (F·N)-row input (decisions
    exact, best within 1e-5)."""
    from tpuvo_torch.engine.ba_refine import _global_topology
    from tpuvo_torch.ops.match import accept_matches

    cfg = EngineConfig(matcher=MatcherConfig(method="pallas"))
    rng = np.random.default_rng(0)
    F, N, M = 200, 128, 8192  # the refiner's 25,600 rows
    map_desc = rng.uniform(-1, 1, (M, 10)).astype(np.float32)
    desc = rng.uniform(-1, 1, (F, N, 10)).astype(np.float32)
    hit = rng.random((F, N)) < 0.5
    desc[hit] = map_desc[rng.integers(0, M, hit.sum())] + rng.normal(0, 0.02, (hit.sum(), 10))
    args = [torch.as_tensor(a, device=dev) for a in
            (map_desc, rng.random(M) < 0.95, desc, rng.random((F, N)) < 0.9)]
    n0 = match_kernel.launches
    lm, valid = _global_topology(*args, cfg)
    assert match_kernel.launches == n0 + 1
    for f in range(F):
        r = match_kernel.match_descriptors_cuda(args[2][f], args[3][f], args[0], args[1])
        assert torch.equal(valid[f], r.valid)
        assert torch.equal(lm[f][r.valid], r.idx[r.valid])
    assert int(valid.sum()) > F * N // 4
    d1, v1 = args[2].reshape(F * N, 10), args[3].reshape(F * N)
    best, idx, second = match_kernel.match_topk_reference(d1, v1, args[0], args[1])
    mc = cfg.matcher
    want = accept_matches(best, second, v1, mc.distance_threshold, mc.ratio_threshold)
    assert torch.equal(valid.reshape(-1), want)
    assert torch.equal(lm.reshape(-1)[want], idx[want])
    check_match(match_kernel.match_descriptors_cuda(d1, v1, args[0], args[1]),
                d1, v1, args[0], args[1])


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
    fr, frg = vo.frames_of(seq, 0, F, "cpu"), vo.frames_of(seq, 0, F, dev)
    state, _ = vo.bootstrap(vo.make_generator(42), vo.frame_at(fr, 0), vo.frame_at(fr, 1), cfg)
    for i in range(F - 1):
        s2, lg = vo.track_step(state, vo.frame_at(fr, i), vo.frame_at(fr, i + 1), cfg)
        sg = VOState(*(x.to(dev) for x in state))
        s2g, lgg = vo.track_step(sg, vo.frame_at(frg, i), vo.frame_at(frg, i + 1), cfg)
        torch.testing.assert_close(lgg.pose.cpu(), lg.pose, atol=1e-4, rtol=0)
        assert int(lgg.n_map_matches) == int(lg.n_map_matches)
        assert int(lgg.num_inliers) == int(lg.num_inliers)
        state = s2


# ------------------------------------------------------------------ lanes --
def lane_match_sets(m, dev, B=3, seed=21):
    """B lanes of match_sets at map size m; lane 1's map all invalid."""
    sets = [match_sets(128, m, seed + b, dev) for b in range(B)]
    d1, v1, d2, v2 = (torch.stack(a) for a in zip(*sets))
    v2[1] = False
    return d1, v1, d2, v2


def check_lanes(got, d1, v1, d2, v2):
    """Each lane of a launch against the plain version on that lane."""
    for b in range(d1.shape[0]):
        check_match(type(got)(*(x[b] for x in got)), d1[b], v1[b], d2[b], v2[b])


@pytest.mark.parametrize("m", [511, 512, 8191])
def test_match_kernel_lanes(dev, m):
    """One launch for B = 3 lanes, each against its own map (odd m puts odd
    lanes' maps off 16 bytes), one lane's map all invalid, exact duplicates
    in each lane: every lane as the plain version, in one launch."""
    d1, v1, d2, v2 = lane_match_sets(m, dev)
    n0 = match_kernel.launches
    got = match_kernel.match_descriptors_cuda(d1, v1, d2, v2)
    assert match_kernel.launches == n0 + 1 and got.idx.shape == (3, 128)
    check_lanes(got, d1, v1, d2, v2)
    assert not got.valid[1].any() and torch.isinf(got.best[1]).all()
    for b in (0, 2):  # the duplicate pair: first index, distance 0
        assert int(got.idx[b, -1]) == 3 and float(got.best[b, -1]) == 0.0
    best, idx, _ = match_kernel.match_topk_reference(d1, v1, d2, v2)  # the plain version, lanes
    fin = torch.isfinite(best)
    assert torch.equal(got.idx[fin], idx[fin])


def test_match_kernel_lane_views_and_duplicates_across_blocks(dev):
    """Lanes that are views: queries as frame i of (B, F, N, D) frames, maps
    as the first C rows of (B, C + 1, D) (lane stride off 16 bytes), valid
    flags off 4 bytes, and one query lane shared by all (stride 0); copies of
    a query on both sides of the cluster's map splits in every lane."""
    n, m, B = 128, 8192, 3
    d1, v1, d2, v2 = lane_match_sets(m, dev)
    qb, qpt, splits = match_kernel.launch_plan(n, m, 10, torch.cuda.get_device_properties(0)
                                               .multi_processor_count, B)
    per_split = -(-(-(-m // match_kernel.tile_rows(10))) // splits) * match_kernel.tile_rows(10)
    for b in range(B):
        d2[b, 5] = d2[b, per_split + 3] = d1[b, 0]
        v2[b, 5] = v2[b, per_split + 3] = True
    frames = torch.stack([d1 - 1.0, d1], 1)  # (B, 2, N, D)
    maps = torch.cat([d2, d2[:, :1]], 1)     # (B, m + 1, D)
    flags = torch.cat([v2, v2[:, :1]], 1)
    args = (frames[:, 1], v1, maps[:, :m], flags[:, :m])
    assert args[2].stride(0) * 4 % 16 and args[3].stride(0) % 4
    got = match_kernel.match_descriptors_cuda(*args)
    check_lanes(got, d1, v1, d2, v2)
    for b in range(B):
        assert int(got.idx[b, 0]) == 5 and float(got.best[b, 0]) == 0.0
    shared = match_kernel.match_descriptors_cuda(d1[0].expand(B, n, 10), v1[0].expand(B, n),
                                                 d2, v2)
    check_lanes(shared, d1[0].expand(B, n, 10), v1[0].expand(B, n), d2, v2)


def test_picp_kernel_per_problem_thresholds(dev):
    """A (B,) threshold array: every problem as the plain solve with the same
    thresholds, on a ragged batch (each problem keeps 60-100% of its rows)
    with outliers whose chi lies between the thresholds."""
    B = 96
    X, Z, V, T0 = picp_problems(B, seed=9)
    Z[:, :10] += 40.0  # chi 3200: an outlier at 1000 and 3000, an inlier at 10000
    rng = np.random.default_rng(9)
    V &= rng.random(V.shape) < rng.uniform(0.6, 1.0, (B, 1))
    args = [torch.as_tensor(a, device=dev) for a in (T0, X, Z)]
    V = torch.as_tensor(V, device=dev)
    thr = torch.tensor([1000.0, 3000.0, 10000.0], device=dev).repeat(B // 3)
    cfg = PICPConfig(convergence_threshold=1e-4)
    got = picp_kernel.solve_cuda(K, *args, None, V, 640, 480, cfg, thr)
    ref = picp.solve(torch.as_tensor(K, device=dev), *args, None, V, 640, 480, cfg, thr)
    check_picp(got, ref)
    for k, t in enumerate((1000.0, 3000.0, 10000.0)):  # the lanes of threshold t, bit for bit
        one = picp_kernel.solve_cuda(K, *args, None, V, 640, 480,
                                     PICPConfig(convergence_threshold=1e-4, kernel_threshold=t))
        assert torch.equal(got.T[k::3], one.T[k::3])


def test_batched_track_step_on_card_matches_cpu(dev):
    """Teacher forcing of three lanes (own noise, own map): each CPU batched
    state stepped on the card through both kernels (one launch each for
    all lanes) matches the CPU batched step."""
    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       matcher=MatcherConfig(method="pallas"),
                       picp=PICPConfig(backend="pallas", convergence_threshold=1e-4))
    world = synthetic.make_world(13, n_landmarks=300, xy_extent=8.0)
    seqs = [synthetic.render_sequence(world, synthetic.make_planar_trajectory(10, seed=13), cfg,
                                      pixel_noise=0.3, seed=s) for s in (13, 14, 15)]
    fr, frg = vo.lanes_of(seqs, "cpu"), vo.lanes_of(seqs, dev)
    state, _ = vo.bootstrap(vo.make_generator(42), vo.lane_frame_at(fr, 0),
                            vo.lane_frame_at(fr, 1), cfg)
    for i in range(fr.uv.shape[1] - 1):
        s2, lg = vo.track_step(state, vo.lane_frame_at(fr, i), vo.lane_frame_at(fr, i + 1), cfg)
        a0, b0 = picp_kernel.launches, match_kernel.launches
        _, lgg = vo.track_step(VOState(*(x.to(dev) for x in state)), vo.lane_frame_at(frg, i),
                               vo.lane_frame_at(frg, i + 1), cfg)
        assert (picp_kernel.launches - a0, match_kernel.launches - b0) == (1, 1)
        torch.testing.assert_close(lgg.pose.cpu(), lg.pose, atol=1e-4, rtol=0)
        assert torch.equal(lgg.n_map_matches.cpu(), lg.n_map_matches)
        state = s2


def lanes_step_as_alone(dev, cfg, thresholds=None):
    """Teacher forcing of three lanes on the card: each lane's state stepped
    alone (no lane axis; with thresholds, at its own) gives the batched
    step's pose, new landmarks and whole state bit for bit."""
    import dataclasses

    world = synthetic.make_world(13, n_landmarks=300, xy_extent=8.0)
    seqs = [synthetic.render_sequence(world, synthetic.make_planar_trajectory(10, seed=13), cfg,
                                      pixel_noise=0.3, seed=s) for s in (13, 14, 15)]
    fr = vo.lanes_of(seqs, dev)
    thr = None if thresholds is None else torch.tensor(thresholds, device=dev)
    cfgs = [cfg if thresholds is None else cfg.replace(
        picp=dataclasses.replace(cfg.picp, kernel_threshold=t)) for t in thresholds or (0,) * 3]
    state, _ = vo.bootstrap(vo.make_generator(42), vo.lane_frame_at(fr, 0),
                            vo.lane_frame_at(fr, 1), cfg)
    lane = lambda tup, b: type(tup)(*(x[b] for x in tup))
    for i in range(fr.uv.shape[1] - 1):
        curr, nxt = vo.lane_frame_at(fr, i), vo.lane_frame_at(fr, i + 1)
        s2, lg = vo.track_step(state, curr, nxt, cfg, thr)
        for b, cb in enumerate(cfgs):
            s1, l1 = vo.track_step(lane(state, b), lane(curr, b), lane(nxt, b), cb)
            assert torch.equal(l1.pose, lg.pose[b]), (i, b)
            assert int(l1.n_new_points) == int(lg.n_new_points[b]), (i, b)
            for k, x in s1._asdict().items():
                assert torch.equal(x, getattr(s2, k)[b]), (i, b, k)
        state = s2


LANE_CFG = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                        matcher=MatcherConfig(method="pallas"),
                        picp=PICPConfig(backend="pallas", convergence_threshold=1e-4))


def test_lane_step_equals_the_lane_alone_on_card(dev):
    """Three lanes at the sweep's thresholds (kernel A solves each lane as
    it solves it alone, and the step's small products are written out,
    ``linalg_small.matmul_small``): each steps as alone, bit for bit."""
    lanes_step_as_alone(dev, LANE_CFG, (1000.0, 3000.0, 10000.0))


def test_motion_model_lane_equals_the_lane_alone_on_card(dev):
    """Three lanes with the motion model on (alpha = 0.5): the prediction
    and the velocity are written out too, so each lane steps as alone, bit
    for bit."""
    lanes_step_as_alone(dev, LANE_CFG.replace(motion_model_init=True, motion_model_alpha=0.5))


def test_cli_run_on_card_launches_kernel_b_per_frame(dev, tmp_path, monkeypatch, capsys):
    """``python -m tpuvo_torch --matcher pallas run`` on a written 20-frame
    dataset, on the card by default: kernel B once per tracked frame plus
    the bootstrap's match, and the trajectory the CLI evaluates equals a
    ``run_sequence`` with the config the CLI loads."""
    from tpuvo_torch import cli
    from tpuvo_torch.data import load_camera_config, load_sequence
    from tpuvo_torch.data.writer import write_dataset
    from tpuvo_torch.engine import eval as ev

    world = synthetic.make_world(5, n_landmarks=800, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(20, step=0.2, turn=0.03, seed=5)
    d = write_dataset(str(tmp_path / "data"), synthetic.render_sequence(world, gt, seed=5),
                      world, CFG)
    seen, evaluate = [], ev.evaluate
    monkeypatch.setattr(ev, "evaluate", lambda p, *a, **kw: (seen.append(p), evaluate(p, *a, **kw))[1])
    a0, b0 = picp_kernel.launches, match_kernel.launches
    cli.main(["--data", d, "--frames", "20", "--matcher", "pallas", "run",
              "--out", str(tmp_path / "out")])
    assert match_kernel.launches - b0 == 20  # 19 tracked frames + the bootstrap
    assert picp_kernel.launches - a0 == 19   # the CLI's default PICP is kernel A too
    assert seen[0].is_cuda and "ate_robot" in capsys.readouterr().out
    cfg = load_camera_config(f"{d}/camera.dat", mode="fixed").replace(
        matcher=MatcherConfig(method="pallas"))
    _, _, poses, _ = vo.run_sequence(load_sequence(d, 20), cfg)
    assert torch.equal(seen[0], poses)


# --- the sharded layer at world size 1 (NCCL in process) and the plain PICP's syncs
@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run "
                    "`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py` on the card")
    import socket

    import torch.distributed as dist

    from tpuvo_torch.parallel.mesh import local_mesh

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield local_mesh(1), local_mesh(1, axis="edge")
    finally:
        dist.destroy_process_group()


def test_sharded_match_pallas_is_kernel_b_once(nccl_mesh):
    """The sharded matcher (method="pallas") at world size 1: bit-equal to
    one unsharded kernel-B call, and one kernel-B launch per call."""
    from tpuvo_torch.parallel.match_sharded import sharded_match_descriptors

    g = torch.Generator(device="cuda").manual_seed(0)
    d1 = torch.rand(128, 10, device="cuda", generator=g) * 2 - 1
    d2 = torch.rand(8192, 10, device="cuda", generator=g) * 2 - 1
    d2[100], d2[5000] = d1[3], d1[3] + 0.01
    d2[4095] = d2[4096] = d1[7]
    v1 = torch.ones(128, dtype=torch.bool, device="cuda")
    v2 = torch.rand(8192, device="cuda", generator=g) < 0.95
    v2[100] = v2[5000] = v2[4095] = v2[4096] = True
    ref = match_kernel.match_descriptors_cuda(d1, v1, d2, v2)
    n0 = match_kernel.launches
    got = sharded_match_descriptors(nccl_mesh[0], d1, v1, d2, v2, method="pallas")
    assert match_kernel.launches - n0 == 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.idx[3]) == 100 and int(got.idx[7]) == 4095


def test_sharded_ba_on_card_matches_cpu(nccl_mesh):
    """The sharded Schur BA on the card (world size 1, fixed damping) vs the
    port's ba_solve on the CPU: poses atol 1e-4, points atol 1e-2 (as
    test_ba_solve_on_card_matches_cpu), the integer stats exact."""
    from tpuvo_torch.ba.window import ba_solve
    from tpuvo_torch.config import BAConfig
    from tpuvo_torch.parallel.ba_sharded import (gather_points, shard_ba_problem,
                                                 sharded_ba_solve,
                                                 sharded_problem_from_numpy)

    p = ba_window_problem()
    cfg = BAConfig(iterations=6, lm_adaptive=False)
    ref, sr = ba_solve(p, torch.as_tensor(K), 640, 480, cfg)
    sp = sharded_problem_from_numpy(shard_ba_problem(p, 1)._asdict(), "cuda")
    got, sg = sharded_ba_solve(nccl_mesh[0], sp, torch.as_tensor(K, device="cuda"), 640, 480, cfg)
    torch.testing.assert_close(got.poses.cpu(), ref.poses, atol=1e-4, rtol=0)
    pts = gather_points(got, p.points.shape[0], nccl_mesh[0])
    torch.testing.assert_close(torch.as_tensor(pts), ref.points, atol=1e-2, rtol=0)
    assert (int(sg.num_obs), int(sg.num_inliers)) == (int(sr.num_obs), int(sr.num_inliers))


def count_syncs(fn):
    """(fn()'s result, the host syncs while it ran) by torch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, sum("called a synchronizing" in str(w.message) for w in caught)


def test_plain_picp_solve_syncs_once_a_round(dev):
    """The plain solve (the CPU's path, the card's reference) reads its done
    flags once a round: one host sync a round, 50 in a 50-round call, and
    no other."""
    X, Z, V, T0 = picp_problems(4, seed=2, noise=0.0)
    cfg = PICPConfig(convergence_threshold=0.0)   # no round meets it: all 50 run
    T0, X, Z, V = (torch.as_tensor(a, device=dev) for a in (T0, X, Z, V))
    Kd = torch.as_tensor(K, device=dev)
    picp.solve(Kd, T0, X, Z, None, V, 640, 480, cfg)
    res, syncs = count_syncs(lambda: picp.solve(Kd, T0, X, Z, None, V, 640, 480, cfg))
    assert int(res.iterations.max()) == cfg.max_iterations == 50
    assert syncs == 50


@pytest.mark.parametrize("picp_cfg", [dict(), dict(unrolled_rounds=8)])
def test_track_step_xla_launches_kernel_a_without_a_sync(dev, monkeypatch, picp_cfg):
    """backend='xla' (and its unrolled driver) on the card: each track_step
    launches kernel A once, its solve syncs the host 0 times (the plain
    loop read it once a round), and the step matches the CPU's."""
    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       matcher=MatcherConfig(method="pallas"),
                       picp=PICPConfig(convergence_threshold=1e-4, **picp_cfg))
    world = synthetic.make_world(13, n_landmarks=300, xy_extent=8.0)
    seq = synthetic.render_sequence(world, synthetic.make_planar_trajectory(10, seed=13), cfg,
                                    pixel_noise=0.3, seed=13)
    F = seq.uv.shape[0]
    fr, frg = vo.frames_of(seq, 0, F, "cpu"), vo.frames_of(seq, 0, F, dev)
    solve, syncs = vo.solve_cuda, []

    def counted(*a, **kw):
        res, n = count_syncs(lambda: solve(*a, **kw))
        syncs.append(n)
        return res

    monkeypatch.setattr(vo, "solve_cuda", counted)
    state, _ = vo.bootstrap(vo.make_generator(42), vo.frame_at(fr, 0), vo.frame_at(fr, 1), cfg)
    for i in range(F - 1):
        s2, lg = vo.track_step(state, vo.frame_at(fr, i), vo.frame_at(fr, i + 1), cfg)
        n0 = picp_kernel.launches
        _, lgg = vo.track_step(VOState(*(x.to(dev) for x in state)), vo.frame_at(frg, i),
                               vo.frame_at(frg, i + 1), cfg)
        assert picp_kernel.launches == n0 + 1
        torch.testing.assert_close(lgg.pose.cpu(), lg.pose, atol=1e-4, rtol=0)
        assert int(lgg.num_inliers) == int(lg.num_inliers)
        state = s2
    assert len(syncs) == 2 * (F - 1) and syncs[1::2] == [0] * (F - 1)


def test_pnp_ransac_on_card_is_kernel_a_once(dev):
    """pnp_ransac on CUDA tensors polishes its B refits in one kernel-A
    launch (K a CUDA tensor, read by the kernel); the poses agree with the
    CPU run and the truth (the 12x12 eigh of the DLT runs in another
    library on the card)."""
    from tpuvo_torch.ops import pnp

    rng = np.random.default_rng(4)
    B, N = 4, 128
    T_true = lie.v2t_euler(torch.as_tensor(rng.normal(0, 0.1, (B, 6)).astype(np.float32)))
    X = np.stack([rng.uniform(-4, 4, (B, N)), rng.uniform(-3, 3, (B, N)),
                  rng.uniform(4, 15, (B, N))], -1).astype(np.float32)
    Xw = torch.einsum("bij,bnj->bni", lie.inv_se3(T_true)[:, :3, :3], torch.as_tensor(X)) \
        + lie.inv_se3(T_true)[:, None, :3, 3]
    uv = torch.as_tensor(X[..., :2] / X[..., 2:] * 180.0 + np.array([320.0, 240.0], np.float32)
                         + 0.3 * rng.standard_normal((B, N, 2)).astype(np.float32))
    uv[:, :12] += 60.0
    valid = torch.ones(B, N, dtype=torch.bool)
    U = pnp.ransac_uniforms(torch.Generator().manual_seed(2), (B, 64, N), "cpu")
    Kt = torch.as_tensor(K)
    ref, ok_ref, n_ref = pnp.pnp_ransac(None, Kt, Xw, uv, valid, 640, 480, uniforms=U)
    n0 = picp_kernel.launches
    got, ok, n_inl = pnp.pnp_ransac(None, Kt.to(dev), Xw.to(dev), uv.to(dev), valid.to(dev),
                                    640, 480, uniforms=U.to(dev))
    assert picp_kernel.launches == n0 + 1
    assert torch.equal(ok.cpu(), ok_ref) and bool(ok.all())
    assert (n_inl.cpu() - n_ref).abs().max() <= 2
    torch.testing.assert_close(got.cpu(), ref, atol=1e-3, rtol=0)
    assert float((got.cpu() - T_true).abs().max()) < 0.05


def test_shard_ba_problem_on_card(dev):
    """shard_ba_problem reads a problem on the card to the host once and
    returns its shards on the card, equal to the CPU problem's."""
    from tpuvo_torch.parallel.ba_sharded import shard_ba_problem

    p = ba_window_problem()
    ref = shard_ba_problem(p, 3)
    got = shard_ba_problem(type(p)(*(x.to(dev) for x in p)), 3)
    for k in ("poses", "points", "point_valid", "obs_uv", "obs_lm", "obs_valid", "fixed"):
        a, b = getattr(ref, k), getattr(got, k)
        assert a.device.type == "cpu" and b.is_cuda and torch.equal(a, b.cpu()), k
    assert np.array_equal(ref.lm_perm, got.lm_perm) and ref.active == got.active


# -------------------------------------------------------------- the graphs --
def test_capture_of_a_host_read_raises(dev):
    """A step with a host read (or a host-to-card copy) slipped in does not
    capture: the capture raises, naming the op, and nothing runs eagerly in
    its place; the card is usable after it."""
    from tpuvo_torch.utils import graphs

    x = torch.ones(8, device=dev)
    prog = graphs.Program("probe", dict(x=x), (x,))
    c0, r0 = graphs.captures, graphs.replays
    with pytest.raises(graphs.GraphCaptureError, match="_local_scalar_dense"):
        prog.replay("host read", lambda b: b["x"] * float(b["x"].sum()))
    with pytest.raises(graphs.GraphCaptureError):
        prog.replay("host data", lambda b: b["x"] + torch.tensor([1.0], device=dev))
    assert not prog.graphs and (graphs.captures, graphs.replays) == (c0, r0)
    out = prog.replay("fine", lambda b: b["x"] * 2)
    torch.cuda.synchronize()
    assert float(out.sum()) == 16.0 and graphs.captures == c0 + 1


def test_replayed_scan_equals_eager(dev, monkeypatch):
    """run_sequence on the card replays the captured bootstrap once and the
    captured step once a frame; its poses and logs are the eager loop's bit
    for bit, and a second run captures nothing."""
    from tpuvo_torch.utils import graphs

    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       matcher=MatcherConfig(method="pallas"),
                       picp=PICPConfig(backend="pallas", convergence_threshold=1e-4))
    world = synthetic.make_world(13, n_landmarks=300, xy_extent=8.0)
    seq = synthetic.render_sequence(world, synthetic.make_planar_trajectory(10, seed=13), cfg,
                                    pixel_noise=0.3, seed=13)
    F = seq.uv.shape[0]
    r0 = graphs.replays
    _, logs, poses, _ = vo.run_sequence(seq, cfg, device=dev)
    c1 = graphs.captures
    _, logs2, poses2, _ = vo.run_sequence(seq, cfg, device=dev)
    assert graphs.captures == c1 and graphs.replays == r0 + 2 * F
    monkeypatch.setattr(graphs, "on_card", lambda _t: False)
    _, ref_logs, ref_poses, _ = vo.run_sequence(seq, cfg, device=dev)
    assert torch.equal(poses, ref_poses) and torch.equal(poses2, ref_poses)
    for a, b in zip(logs, ref_logs):
        assert torch.equal(a, b)


# -------------------------------------------------------------- kernel C --
def gapped_psd(B, seed, w=None, n=9):
    """B symmetric PSD (n, n) Q diag(w) Qᵀ: w given, else spread over [1, 10]
    with gaps >= 0.375."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    if w is None:
        w = np.cumsum(rng.uniform(0.5, 1.5, (B, n)), -1)
        w = 1 + 9 * (w - w[:, :1]) / (w[:, -1:] - w[:, :1])
    w = np.broadcast_to(np.asarray(w, float), (B, n))
    return torch.as_tensor(np.einsum("bij,bj,bkj->bik", Q, w, Q), dtype=torch.float32)


def gapped_mat3(B, seed):
    """B (3, 3) U diag(s) Vᵀ with s in [2.5, 3.5], [1.5, 2], [0.2, 1]."""
    rng = np.random.default_rng(seed)
    U, V = (np.linalg.qr(rng.standard_normal((B, 3, 3)))[0] for _ in range(2))
    s = rng.uniform((2.5, 1.5, 0.2), (3.5, 2.0, 1.0), (B, 3))
    return torch.as_tensor(np.einsum("bij,bj,bkj->bik", U, s, V), dtype=torch.float32)


@pytest.mark.parametrize("B", [1, 3, 256])
def test_kernel_c_matches_its_plain_version(dev, B):
    """sym_eig (9x9) and svd3 (3x3), one launch each for the batch, against
    torch.linalg's with the same canonical signs."""
    A, M = gapped_psd(B, B).to(dev), gapped_mat3(B, B).to(dev)
    n0 = smalleig.launches
    w, V = smalleig.sym_eig(A)
    U, S, Vt = smalleig.svd3(M)
    assert smalleig.launches == n0 + 2
    wr, Vr = smalleig.sym_eig_reference(A)
    Ur, Sr, Vtr = smalleig.svd3_reference(M)
    assert float((w - wr).abs().max()) <= 1e-5 * 10
    assert float((V - Vr).abs().max()) <= 1e-4
    assert float((S - Sr).abs().max()) <= 1e-5 * 3.5
    assert float(max((U - Ur).abs().max(), (Vt - Vtr).abs().max())) <= 1e-4


def test_kernel_c_edges(dev):
    """A repeated eigenvalue (its space), sigma3 = 0 (the null pair and the
    essential projection), an all-zero matrix ((0, I) and (I, 0, I)) and a
    NaN matrix (NaN, the other lanes as launched alone)."""
    A = gapped_psd(3, 1, w=[1, 2, 2, 2, 3, 5, 5, 7, 9]).to(dev)
    w, V = smalleig.sym_eig(A)
    wr, Vr = smalleig.sym_eig_reference(A)
    assert float((w - wr).abs().max()) <= 1e-5 * 9
    for cols in ([0], [1, 2, 3], [4], [5, 6], [7], [8]):
        P, Pr = V[..., cols] @ V[..., cols].mT, Vr[..., cols] @ Vr[..., cols].mT
        assert float((P - Pr).abs().max()) <= 1e-5, cols
    rng = np.random.default_rng(2)
    Uq, Vq = (np.linalg.qr(rng.standard_normal((8, 3, 3)))[0] for _ in range(2))
    E = torch.as_tensor(Uq @ np.diag([1.0, 1.0, 0.0]) @ Vq.swapaxes(-1, -2), dtype=torch.float32,
                        device=dev)
    U, S, Vt = smalleig.svd3(E)
    Ur, Sr, Vtr = smalleig.svd3_reference(E)
    assert float((S - Sr).abs().max()) <= 1e-5
    for a, b in ((Vt[..., 2, :], Vtr[..., 2, :]), (U[..., :, 2], Ur[..., :, 2])):
        assert float((1 - (a * b).sum(-1).abs()).max()) <= 1e-6
    diag = torch.tensor([1.0, 1.0, 0.0], device=dev)
    assert float(((U * diag) @ Vt - E).abs().max()) <= 1e-5
    Z = gapped_psd(4, 3).to(dev)
    Z[1], Z[2] = 0.0, float("nan")
    w, V = smalleig.sym_eig(Z)
    assert bool((w[1] == 0).all()) and torch.equal(V[1], torch.eye(9, device=dev))
    assert bool(torch.isnan(w[2]).all() and torch.isnan(V[2]).all())
    alone = smalleig.sym_eig(Z[[0, 3]])
    assert torch.equal(w[[0, 3]], alone[0]) and torch.equal(V[[0, 3]], alone[1])
    M = gapped_mat3(4, 4).to(dev)
    M[1], M[2] = 0.0, float("nan")
    out = smalleig.svd3(M)
    eye = torch.eye(3, device=dev)
    assert torch.equal(out[0][1], eye) and torch.equal(out[2][1], eye) and not out[1][1].any()
    assert all(bool(torch.isnan(x[2]).all()) for x in out)
    alone = smalleig.svd3(M[[0, 3]])
    assert all(torch.equal(x[[0, 3]], y) for x, y in zip(out, alone))


def test_kernel_c_off_its_fast_paths(dev):
    """Gapped 9x9 matrices on which sym_eig leaves its fast paths with a
    finite answer, so that it solves them again by the IEEE operators
    (``chip_smoke.off_fast_path_psd``: scaled by 2^60, 2^-62, 2^-70, a
    subnormal a_00, theta above 2^60): each against the plain version, and
    the exact scalings of a matrix the fast paths solve give 2^e w and the
    same V, bit for bit."""
    import chip_smoke as cs

    for name, A in cs.off_fast_path_psd(dev).items():
        assert cs.leaves_fast_path(A).all(), name
        w, V = smalleig.sym_eig(A)
        wr, Vr = smalleig.sym_eig_reference(A)
        assert float(((w - wr).abs() / wr.abs().amax(-1, keepdim=True)).max()) <= 1e-5, name
        assert float((V - Vr).abs().max()) <= 1e-4, name
    base = cs.gapped_psd(*cs.OFF_FAST_BASE, dev=dev)
    assert not cs.leaves_fast_path(base).any()
    w, V = smalleig.sym_eig(base)
    for e in cs.OFF_FAST_SCALES:
        ws, Vs = smalleig.sym_eig(base * 2.0 ** e)
        assert torch.equal(ws, w * 2.0 ** e) and torch.equal(Vs, V), e


def test_bootstrap_jit_on_card_equals_bootstrap(dev):
    """The bootstrap's graph against the eager bootstrap, bit for bit, at one
    lane and at three; a call makes no host sync and credits kernels B and C
    (three launches) per replay."""
    import warnings

    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       matcher=MatcherConfig(method="pallas"))
    seqs = [synthetic.render_sequence(synthetic.make_world(s, n_landmarks=300, xy_extent=8.0),
                                      synthetic.make_planar_trajectory(3, seed=s), cfg,
                                      pixel_noise=0.3, seed=s) for s in (13, 14, 15)]
    one = vo.frames_of(seqs[0], 0, 2, dev)
    three = vo.lanes_of(seqs, dev)
    for pair in ((vo.frame_at(one, 0), vo.frame_at(one, 1)),
                 (vo.lane_frame_at(three, 0), vo.lane_frame_at(three, 1))):
        for seed in (42, 43):
            e = vo.bootstrap(vo.make_generator(seed), *pair, cfg)
            g = vo.bootstrap_jit(vo.make_generator(seed), *pair, cfg)
            for a, b in zip((*e[0], *e[1].values()), (*g[0], *g[1].values())):
                assert torch.equal(a, b)
        b0, c0 = match_kernel.launches, smalleig.launches
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                vo.bootstrap_jit(vo.make_generator(7), *pair, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert not [w for w in caught if "synchronizing" in str(w.message)]
        assert (match_kernel.launches - b0, smalleig.launches - c0) == (1, 3)


def test_fixed_order_sums_give_the_same_bits_twice(dev):
    """ba_solve and pgo_solve twice on the card: the same bits (their sums
    run in a planned order, no atomics); a segmented sum captured in a graph
    gives the eager bits."""
    from tpuvo_torch.ba import assembly
    from tpuvo_torch.ba.posegraph import PoseGraph, odometry_edges, pgo_solve
    from tpuvo_torch.ba.window import ba_solve
    from tpuvo_torch.config import BAConfig

    p = type(ba_window_problem())(*(x.to(dev) for x in ba_window_problem()))
    Kd = torch.as_tensor(K, device=dev)
    a, b = (ba_solve(p, Kd, 640, 480, BAConfig(iterations=6))[0] for _ in range(2))
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    rng = np.random.default_rng(5)
    n = 40
    xi = torch.as_tensor(0.05 * rng.standard_normal((n, 6)).astype(np.float32), device=dev)
    poses = lie.se3_exp(xi)
    ij, T, w = odometry_edges(poses)
    extra = torch.as_tensor(rng.integers(0, n, (60, 2)), device=dev)
    Tx = lie.inv_se3(poses[extra[:, 0]]) @ poses[extra[:, 1]]
    graph = PoseGraph(lie.se3_exp(0.5 * xi) @ poses, torch.cat([ij, extra]), torch.cat([T, Tx]),
                      torch.cat([w, torch.ones(60, device=dev)]), torch.arange(n, device=dev) == 0)
    g1, g2 = (pgo_solve(graph, iterations=15)[0].poses for _ in range(2))
    assert torch.equal(g1, g2)
    idx = torch.as_tensor(rng.integers(0, 500, 4000), device=dev)
    vals = torch.randn(4000, 6, 3, device=dev)
    plan = assembly.plan(idx, 500)
    ref = assembly.segment_sum(vals, plan)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assembly.segment_sum(vals, plan)
    torch.cuda.current_stream().wait_stream(side)
    graph_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_):
        out = assembly.segment_sum(vals, plan)
    graph_.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_capture_cache_evicts_and_recaptures(dev, monkeypatch):
    """Past the cache's bound an entry is dropped and its memory freed; the
    key captures again and gives the same bits."""
    from tpuvo_torch.utils import graphs

    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       matcher=MatcherConfig(method="pallas"))
    world = synthetic.make_world(13, n_landmarks=300, xy_extent=8.0)
    seq = synthetic.render_sequence(world, synthetic.make_planar_trajectory(12, seed=13), cfg,
                                    pixel_noise=0.3, seed=13)
    part = lambda n: type(seq)(*(x[:n] for x in seq))
    graphs.clear()
    ref = {n: vo.run_sequence(part(n), cfg, device=dev)[2] for n in (8, 10, 12)}
    monkeypatch.setattr(graphs, "CACHE_BYTES", 1)  # every capture drops the others
    graphs.clear()
    e0 = graphs.evictions
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for n in (8, 10, 12, 8):
        assert torch.equal(vo.run_sequence(part(n), cfg, device=dev)[2], ref[n]), n
        assert len(graphs._cache) <= 2
    assert graphs.evictions - e0 >= 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    for n in (8, 10, 12):
        vo.run_sequence(part(n), cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= held + (8 << 20)  # bounded, not one entry a length
    graphs.clear()


# ------------------------------------------------------ the program's spans --
SPAN_F = 6  # frames: the local BA (W = 2, every 2nd frame) at k = 2, 4; track only at 1, 3, 5


def span_session(dev):
    """A SPAN_F-frame OnlineSLAM session on the card, synchronised."""
    from tpuvo_torch.engine import slam

    cfg = EngineConfig(mode="fixed", map_capacity=1024, local_ba_window=2,
                       local_ba_iterations=2, matcher=MatcherConfig(method="pallas"),
                       picp=PICPConfig(backend="pallas", convergence_threshold=1e-4))
    gt = synthetic.make_loop_trajectory(200, step=1.0, seed=7)[:SPAN_F]
    world = synthetic.make_world(7, n_landmarks=4000, xy_extent=float(np.abs(gt[:, :2]).max()) + 15,
                                 z_range=(0.0, 8.0))
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3, seed=7)
    s = slam.OnlineSLAM(cfg, max_frames=SPAN_F, seed=42)
    s.start(vo.frame_of(seq, 0, dev), vo.frame_of(seq, 1, dev))
    for i in range(1, SPAN_F):
        s.step(vo.frame_of(seq, i, dev))
    torch.cuda.synchronize()
    return s


def test_capture_spans_on_card(dev):
    """Captured under the profiler (host and card): one ``tpuvo.capture.*``
    span a capture, named by graph and branch."""
    from torch.profiler import ProfilerActivity, profile

    from tpuvo_torch.utils import graphs

    graphs.clear()
    c0 = graphs.captures
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        span_session(dev)
    spans = [e.name() for e in prof.profiler.kineto_results.events()
             if "CPU" in str(e.device_type()) and e.name().startswith("tpuvo.capture.")]
    assert len(spans) == graphs.captures - c0 == 3
    assert set(spans) == {"tpuvo.capture.bootstrap", "tpuvo.capture.slam_step.ba",
                          "tpuvo.capture.slam_step.track"}
    graphs.clear()


def test_replay_spans_on_card(dev):
    """Warmed up, then profiled as the benchmark profiles a slice
    (``vobench.trace.profiled``): one ``tpuvo.replay.*`` span a
    ``cudaGraphLaunch``, around it, named by graph and branch (both SLAM
    branches seen); and the parsed trace keeps no ``tpuvo.*`` event among
    the device activity (the profiler's mirror of a span on the device's
    timeline is a user annotation, no work)."""
    from collections import Counter

    from vobench.trace import profiled

    span_session(dev)
    got = {}
    with profiled(got):
        span_session(dev)
    tr = got["trace"]
    spans = [e for e in tr.host if e.name.startswith("tpuvo.replay.")]
    calls = [e for e in tr.host if "cudaGraphLaunch" in e.name]
    assert len(spans) == len(calls) == SPAN_F
    assert Counter(s.name for s in spans) == {"tpuvo.replay.bootstrap": 1,
                                              "tpuvo.replay.slam_step.ba": 2,
                                              "tpuvo.replay.slam_step.track": 3}
    for c in calls:
        assert sum(s.start <= c.start and c.end <= s.end for s in spans) == 1
    assert tr.device
    assert not [e.name for e in tr.device if e.name.startswith("tpuvo.")]


# ------------------------------------------- the pose graph's LM iteration --
def pose_graph(dev, seed=5, n=200, extra=32, outliers=4):
    """A perturbed pose graph of the refine's shape (200 poses, odometry and
    32 loop edges), the first ``outliers`` loop edges corrupted, on which
    the LM keeps some steps and rolls others back."""
    from tpuvo_torch.ba.posegraph import PoseGraph, odometry_edges

    rng = np.random.default_rng(seed)
    xi = torch.as_tensor(0.05 * rng.standard_normal((n, 6)).astype(np.float32), device=dev)
    poses = lie.se3_exp(xi)
    ij, T, w = odometry_edges(poses, weight=25.0)
    ex = torch.as_tensor(rng.integers(0, n, (extra, 2)), device=dev)
    Tx = lie.inv_se3(poses[ex[:, 0]]) @ poses[ex[:, 1]]
    bad = lie.se3_exp(torch.as_tensor(rng.standard_normal((outliers, 6)).astype(np.float32),
                                      device=dev))
    Tx = torch.cat([bad @ Tx[:outliers], Tx[outliers:]])
    return PoseGraph(lie.se3_exp(0.5 * xi) @ poses, torch.cat([ij, ex]), torch.cat([T, Tx]),
                     torch.cat([w, torch.ones(extra, device=dev)]),
                     torch.arange(n, device=dev) == 0)


def eager(monkeypatch, fn):
    """``fn()`` with the graphs off: the eager loops, for a comparison only
    (the package has no such switch)."""
    from tpuvo_torch.utils import graphs

    with monkeypatch.context() as m:
        m.setattr(graphs, "on_card", lambda _t: False)
        out = fn()
    torch.cuda.synchronize()
    return out


def assert_bits(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_bits(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bits(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_graphed_pgo_solve_equals_eager_on_card(dev, monkeypatch):
    """``pgo_solve`` replaying its captured LM iteration against the eager
    loop, under the L2 and the robust threshold: poses, chi, inlier count
    and every recorded iteration (poses, lam, chi) bit for bit, with kept
    and rolled-back steps among them; one capture per threshold, and a
    second graph of the same shapes with other loop pairs replays it with
    its own plans, to the bits of its own eager solve."""
    from tpuvo_torch.ba.posegraph import pgo_solve
    from tpuvo_torch.utils import graphs

    g5, g6 = pose_graph(dev, 5), pose_graph(dev, 6)
    assert not torch.equal(g5.edges_ij, g6.edges_ij)
    graphs.clear()
    for thr in (1.0e8, 1.0):
        c0 = graphs.captures
        for g in (g5, g6):
            rec_e, rec_g = {}, {}
            ref = eager(monkeypatch, lambda: pgo_solve(g, iterations=30, kernel_threshold=thr,
                                                       record=rec_e))
            r0 = graphs.replays
            got = pgo_solve(g, iterations=30, kernel_threshold=thr, record=rec_g)
            torch.cuda.synchronize()
            assert graphs.replays - r0 == 30
            assert_bits(got, ref, f"thr {thr}")
            assert_bits(rec_g, rec_e, f"thr {thr}")
            its = rec_g["iterations"]
            kept = [bool(b["lam"] < a["lam"]) for a, b in zip(its, its[1:])]
            assert any(kept) and not all(kept), thr
        assert graphs.captures - c0 == 1
    graphs.clear()


def drifted_loop(dev, F=48, seed=3):
    """A small drifted loop (``tests/test_torch_loop.loop_fixture``'s): the
    arguments of ``close_loops`` after K, on ``dev``."""
    gt = synthetic.make_loop_trajectory(F, step=0.5, seed=seed, turn_frames=6)
    ext = float(np.abs(gt[:, :2]).max()) + 10.0
    world = synthetic.make_world(seed, n_landmarks=1500, xy_extent=ext, z_range=(0.0, 6.0))
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=0.3, seed=seed)
    poses = np.stack([synthetic.camera_pose_from_gt(g, CFG) for g in gt]).astype(np.float32)
    drift = np.array([0.4, -0.3, 0.1, 0.0, 0.0, 0.08], np.float32)
    xi = np.linspace(0, 1, F, dtype=np.float32)[:, None] * drift
    drifted = (lie.se3_exp(torch.as_tensor(xi)).numpy() @ poses).astype(np.float32)
    obs_lm = np.where(seq.valid, seq.id_real, 0).astype(np.int32)
    args = (drifted, world.xyz, np.ones(world.xyz.shape[0], bool), seq.uv, obs_lm, seq.valid)
    return tuple(torch.as_tensor(np.asarray(a), device=dev) for a in args)


def test_close_loops_on_card_replays_its_pgo(dev, monkeypatch):
    """``close_loops`` twice on the card: two captures on the first call and
    none on the second, one replay per LM iteration (60 + 20) each time;
    its result and record the eager call's bits; kernels A and D launched
    as often as the eager call launches them (a replay credits what it
    captured)."""
    from tpuvo_torch.ba.loop import close_loops
    from tpuvo_torch.ops.cuda import segsum
    from tpuvo_torch.utils import graphs

    args = drifted_loop(dev)
    Kd = torch.as_tensor(K, device=dev)
    run = lambda rec: close_loops(Kd, *args, 640, 480, record=rec)
    counts = lambda: (picp_kernel.launches, segsum.launches)
    graphs.clear()
    rec_e = {}
    n0 = counts()
    ref = eager(monkeypatch, lambda: run(rec_e))
    want = tuple(b - a for a, b in zip(n0, counts()))
    assert int(ref[1]) > 0 and want == (1, 2 * 80)
    for call in range(2):
        c0, r0, n0 = graphs.captures, graphs.replays, counts()
        rec_g = {}
        got = run(rec_g)
        torch.cuda.synchronize()
        assert graphs.captures - c0 == (2 if call == 0 else 0)
        assert graphs.replays - r0 == 60 + 20
        assert tuple(b - a for a, b in zip(n0, counts())) == want
        assert_bits(got, ref)
        assert_bits(rec_g, rec_e)
    graphs.clear()
