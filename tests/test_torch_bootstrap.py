"""The bootstrap as a graph (``vo.bootstrap_jit``) and what it needs, on the
CPU: kernel C's plain versions (``ops/cuda/smalleig``), the bootstrap
capture-safe under ``graphs.host_sync_guard``, ``bootstrap_jit`` on the
stand-in graph (``test_torch_graphs.FakeGraph``) against ``bootstrap`` and
against JAX's ``bootstrap_jit``, every entry point that bootstraps doing it
through one replay, the capture cache's bound, and the fixed-order BA and
pose-graph sums (``ba/assembly``).

Tolerances of the eigensolvers (float32 in, float64 or JAX's float32 as the
reference): eigenvalues within 1e-5 of the largest (a backward-stable
solver errs by ~n·eps·|A|: 1e-6 at n = 9); an eigenvector or singular
vector within 1e-6 of parallel (1 - |<v, v_ref>|) where its eigenvalue is
separated by a gap >= 0.375 against a largest of 10 (an angle of ~eps·30,
~1e-12 in 1 - cos, but the dot of two float32 unit vectors rounds to
within ~n·eps of 1); the refit's
smallest eigenvector, whose gap lies near fp32 rounding of the largest
(``test_torch_geometry``), within 1e-4 for the noise-free problem and
2e-3 with pixel noise; spaces of a repeated eigenvalue compared by their
projectors within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry import K, t, two_view
from test_torch_graphs import (CFG, F, assert_same, fake, kernels,  # noqa: F401 (fixtures)
                               launches, lanes, make_seq)
from test_torch_vo import both_cfgs, jax_sample_idx, make_seq as vo_seq, to_np
from tpuvo.engine import vo as jvo
from tpuvo_torch.data import synthetic
from tpuvo_torch import bench as tbench
from tpuvo_torch.ba import assembly, posegraph as tpg, window as tw
from tpuvo_torch.engine import drivers as tdrivers, slam as tslam, vo as tvo
from tpuvo_torch.ops import twoview as ttv
from tpuvo_torch.ops.cuda import smalleig as tc
from tpuvo_torch.utils import graphs
from tpuvo_torch.utils.graphs import host_sync_guard
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

EIG_REL = 1e-5     # eigenvalues, relative to the largest
VEC_GAP = 1e-6     # 1 - |<v, v_ref>| of a vector with a gap
PROJ = 1e-5        # projectors of a repeated eigenvalue's space


# ------------------------------------------------------ kernel C, plain --
def refit_matrices():
    """The RANSAC refit's 9x9 AᵀA (``twoview.essential_8pt``) of three
    two-view problems, weighted by their true inliers: noise-free, 0.3 px
    with 15 outliers, 0.3 px."""
    mats = []
    for seed, noise, outliers in ((3, 0.0, 0), (3, 0.3, 15), (5, 0.3, 0)):
        _, _, _, uv1, uv2 = two_view(seed=seed, noise=noise, outliers=outliers)
        x1, x2 = ttv.normalize_points(t(uv1), t(K)), ttv.normalize_points(t(uv2), t(K))
        w = (torch.arange(len(uv1)) >= outliers).float()
        A = ttv._epipolar_rows(x1, x2) * w[:, None]
        mats.append(A.mT @ A)
    return torch.stack(mats)


def psd(seed, B=4, w=None):
    """B symmetric PSD 9x9 Q diag(w) Qᵀ: w given, else spread over [1, 10]
    with gaps >= 0.375."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((B, 9, 9)))[0]
    if w is None:
        w = np.cumsum(rng.uniform(0.5, 1.5, (B, 9)), -1)
        w = 1 + 9 * (w - w[:, :1]) / (w[:, -1:] - w[:, :1])
    w = np.broadcast_to(np.asarray(w, float), (B, 9))
    return torch.as_tensor(np.einsum("bij,bj,bkj->bik", Q, w, Q), dtype=torch.float32)


def references(A):
    """(eigenvalues, eigenvectors) by numpy in float64 and by JAX in float32."""
    w64, V64 = np.linalg.eigh(A.numpy().astype(np.float64))
    wj, Vj = jnp.linalg.eigh(jnp.asarray(A.numpy()))
    return (w64, V64), (np.asarray(wj), np.asarray(Vj))


def parallel_err(V, Vr, cols):
    """max over columns of 1 - |<v, v_ref>|."""
    return float(np.max(1 - np.abs(np.sum(np.asarray(V)[..., cols] * Vr[..., cols], -2))))


def assert_canonical(V):
    """Each column's largest-magnitude component is positive."""
    k = np.argmax(np.abs(V), -2)
    assert (np.take_along_axis(V, k[..., None, :], -2) > 0).all()


def test_sym_eig_plain_on_matrices_with_a_gap():
    A = psd(0)
    w, V = tc.sym_eig(A)
    assert_canonical(V.numpy())
    for wr, Vr in references(A):
        assert np.abs(w.numpy() - wr).max() <= EIG_REL * np.abs(wr).max()
        assert parallel_err(V, Vr, slice(None)) <= VEC_GAP


@pytest.mark.parametrize("case", [0, 1, 2])
def test_sym_eig_plain_on_the_refits_matrices(case):
    A = refit_matrices()[case]
    w, V = tc.sym_eig(A)
    # the refit keeps the smallest eigenvector: 1e-4 noise-free, 2e-3 with
    # 0.3 px (its eigenvalue's gap is near fp32 rounding of the largest)
    tol = 1e-4 if case == 0 else 2e-3
    for wr, Vr in references(A):
        assert np.abs(w.numpy() - wr).max() <= EIG_REL * np.abs(wr).max()
        assert parallel_err(V, Vr, [0]) <= tol
    assert_canonical(V.numpy())


def test_sym_eig_plain_on_a_repeated_eigenvalue():
    A = psd(1, w=[1, 2, 2, 2, 3, 5, 5, 7, 9])
    w, V = tc.sym_eig(A)
    for wr, Vr in references(A):
        assert np.abs(w.numpy() - wr).max() <= EIG_REL * 9
        for cols in ([0], [1, 2, 3], [4], [5, 6], [7], [8]):
            P = V.numpy()[..., cols] @ V.numpy()[..., cols].swapaxes(-1, -2)
            Pr = Vr[..., cols] @ Vr[..., cols].swapaxes(-1, -2)
            assert np.abs(P - Pr).max() <= PROJ, cols


def essential(seed, B=4):
    rng = np.random.default_rng(seed)
    U, V = (np.linalg.qr(rng.standard_normal((B, 3, 3)))[0] for _ in range(2))
    return torch.as_tensor(U @ np.diag([1.0, 1.0, 0.0]) @ V.swapaxes(-1, -2), dtype=torch.float32)


@pytest.mark.parametrize("case", ["random", "essential (sigma3 = 0)"])
def test_svd3_plain(case):
    A = torch.randn(6, 3, 3, generator=torch.Generator().manual_seed(2)) if case == "random" \
        else essential(3)
    U, S, Vt = tc.svd3(A)
    assert_canonical(Vt.mT.numpy())
    np.testing.assert_allclose((U @ torch.diag_embed(S) @ Vt).numpy(), A.numpy(), atol=1e-5)
    for M in (U, Vt):
        np.testing.assert_allclose((M @ M.mT).numpy(), np.broadcast_to(np.eye(3), M.shape),
                                   atol=1e-5)
    U64, S64, Vt64 = np.linalg.svd(A.numpy().astype(np.float64))
    Uj, Sj, Vtj = (np.asarray(x) for x in jnp.linalg.svd(jnp.asarray(A.numpy())))
    for Ur, Sr, Vtr in ((U64, S64, Vt64), (Uj, Sj, Vtj)):
        assert np.abs(S.numpy() - Sr).max() <= 1e-5 * np.abs(Sr).max()
        # an essential matrix's sigma1 = sigma2: only their plane and the
        # null pair (u3, v3) are determined
        cols = slice(None) if case == "random" else [2]
        assert parallel_err(Vt.mT, Vtr.swapaxes(-1, -2), cols) <= VEC_GAP
        assert parallel_err(U, Ur, cols) <= VEC_GAP
    if case != "random":  # the projection of essential_8pt gives E back
        E = (U * torch.tensor([1.0, 1.0, 0.0])) @ Vt
        np.testing.assert_allclose(E.numpy(), A.numpy(), atol=1e-5)


def test_kernel_c_refuses_what_it_does_not_take():
    """The kernel's ``prepare`` takes CUDA float32 (..., n, n), n <= 9: a
    CPU tensor, n = 10 and float64 raise (the wrappers give CPU tensors to
    the plain versions before that)."""
    with pytest.raises(ValueError, match="CUDA device"):
        tc.prepare_sym_eig(torch.eye(3))
    with pytest.raises(ValueError, match="1..9"):
        tc.prepare_sym_eig(torch.eye(10))
    with pytest.raises(ValueError, match="float32"):
        tc.prepare_svd3(torch.eye(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="3, 3"):
        tc.prepare_svd3(torch.eye(4))


# --------------------------------------------------- the bootstrap, eager --
def boot_frames(lane_axis: bool):
    if lane_axis:
        fr = lanes()
        return tvo.lane_frame_at(fr, 0), tvo.lane_frame_at(fr, 1)
    fr = tvo.frames_of(make_seq(), 0, 2, "cpu")
    return tvo.frame_at(fr, 0), tvo.frame_at(fr, 1)


def draw(f0, seed=5):
    return ttv.draw_samples(torch.Generator().manual_seed(seed), f0.valid,
                            CFG.ransac.num_hypotheses, CFG.ransac.sample_size)


@pytest.mark.parametrize("given", [False, True], ids=["drawn", "sample_idx"])
@pytest.mark.parametrize("lane_axis", [False, True], ids=["one lane", "B=3 lanes"])
def test_bootstrap_is_capture_safe(kernels, lane_axis, given):
    """Every op of the bootstrap is one a CUDA graph captures (kernels B and
    C routed as on the card): one launch of kernel B (the pallas matcher)
    and three of kernel C (the refit's eigenvector, its projection, the
    decomposition), for every lane at once."""
    f0, f1 = boot_frames(lane_axis)
    idx = draw(f0) if given else None
    # a first call fills the per-device constants (K, the decomposition's
    # W), as a graph's warm-up calls do before its capture
    tvo.bootstrap(tvo.make_generator(42), f0, f1, CFG, idx)
    b0, c0 = launches()[1], tc.launches
    with host_sync_guard("the bootstrap"):
        state, diag = tvo.bootstrap(tvo.make_generator(42), f0, f1, CFG, idx)
    assert (launches()[1] - b0, tc.launches - c0) == (1, 3)
    assert bool((diag["n_map_points"] > 0).all())


# ------------------------------------------------ the bootstrap, a graph --
@pytest.mark.parametrize("given", [False, True], ids=["drawn", "sample_idx"])
@pytest.mark.parametrize("lane_axis", [False, True], ids=["one lane", "B=3 lanes"])
def test_bootstrap_jit_equals_bootstrap(fake, lane_axis, given):
    """Bit-equal to the eager bootstrap; one capture per (cfg, shape), none
    on a second call; another seed replays the same graph and gives that
    seed's eager bootstrap; each replay credits kernels B and C."""
    f0, f1 = boot_frames(lane_axis)
    idx = draw(f0) if given else None
    fake(True)
    for seed in (42, 42, 7):
        ref = tvo.bootstrap(tvo.make_generator(seed), f0, f1, CFG, idx)
        before = launches()[1], tc.launches
        got = tvo.bootstrap_jit(tvo.make_generator(seed), f0, f1, CFG, idx)
        assert_same(got, ref, f"seed {seed}")
        assert (launches()[1] - before[0], tc.launches - before[1]) == (1, 3)
    assert graphs.captures == 1 and graphs.replays == 3


def test_bootstrap_jit_draws_what_bootstrap_draws(fake):
    """The uniforms copied into the graph are the generator's draw of the
    eager bootstrap: the seed's hypotheses on both routes."""
    f0, f1 = boot_frames(False)
    fake(True)
    tvo.bootstrap_jit(tvo.make_generator(3), f0, f1, CFG)
    u = next(iter(graphs._cache.values())).buffers["u"]
    ref = ttv.hypothesis_uniforms(tvo.make_generator(3), f0.valid.shape,
                                  CFG.ransac.num_hypotheses)
    assert torch.equal(u, ref)


def test_bootstrap_jit_matches_jax(fake):
    """The port's graphed bootstrap on the CPU against JAX's bootstrap_jit
    with JAX's own draw, at test_torch_vo's bootstrap tolerances."""
    jc, tcfg = both_cfgs(mode="fixed", map_capacity=256, max_obs=64)
    seq = vo_seq(jc)
    f0j, f1j = jvo.frame_of(seq, 0), jvo.frame_of(seq, 1)
    sj, dj = jvo.bootstrap_jit(jax.random.PRNGKey(42), f0j, f1j, jc)
    fake(True)
    st, dt = tvo.bootstrap_jit(None, tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"),
                               tcfg, sample_idx=jax_sample_idx(42, f0j, f1j, jc))
    assert graphs.captures == 1
    # the refit's fp32 9x9 eigenvector differs between the libraries at ~1e-3
    np.testing.assert_allclose(dt["T_boot"].numpy(), np.asarray(dj["T_boot"]), atol=2e-3)
    for k in ("n_matches", "n_ransac_inliers", "n_map_points"):
        assert int(dt[k]) == int(dj[k]), k
    for k in ("map_valid", "map_id_real", "map_id_meas", "map_count", "map_desc"):
        assert np.array_equal(to_np(getattr(st, k)), to_np(getattr(sj, k))), k
    v = np.asarray(sj.map_valid)
    np.testing.assert_allclose(st.map_xyz.numpy()[v], np.asarray(sj.map_xyz)[v], rtol=5e-2,
                               atol=5e-2)


def entry_points(seq, tmp_path):
    fr = tvo.frames_of(seq, 0, F, "cpu")
    pair = tvo.frame_at(fr, 0), tvo.frame_at(fr, 1)
    rest = tvo.Frame(*(x[:-1] for x in fr)), tvo.Frame(*(x[1:] for x in fr))

    def online(cls):
        s = cls(CFG)
        return s.start(*pair), s.step(tvo.frame_at(fr, 2))

    return {
        "full_run_jit": lambda: tvo.full_run_jit(tvo.make_generator(42), *pair, *rest, CFG),
        "run_sequence": lambda: tvo.run_sequence(seq, CFG, device="cpu"),
        "run_batch": lambda: tvo.run_batch(lanes(), CFG),
        "run_threshold_sweep": lambda: tvo.run_threshold_sweep(seq, [1e3, 1e4], CFG,
                                                               device="cpu"),
        "OnlineVO.start": lambda: online(tvo.OnlineVO),
        "run_sequence_chunked": lambda: tvo.run_sequence_chunked(seq, CFG, checkpoint_every=4,
                                                                 device="cpu"),
        "run_sequence_slam": lambda: tslam.run_sequence_slam(seq, CFG, device="cpu"),
        "OnlineSLAM.start": lambda: online(lambda c: tslam.OnlineSLAM(c, max_frames=F)),
        "run_triangulate_test": lambda: tdrivers.run_triangulate_test(
            seq, synthetic.make_world(13, n_landmarks=300, xy_extent=8.0), CFG, device="cpu"),
        "bench accuracy_gate": lambda: tbench.accuracy_gate(seq, fr, CFG, str(tmp_path))["acc"],
    }


ENTRIES = ["full_run_jit", "run_sequence", "run_batch", "run_threshold_sweep", "OnlineVO.start",
           "run_sequence_chunked", "run_sequence_slam", "OnlineSLAM.start",
           "run_triangulate_test", "bench accuracy_gate"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_bootstrap_through_one_replay(fake, monkeypatch, entry, tmp_path):
    """Each entry point that bootstraps gives what it gave with the eager
    bootstrap (the graphs off), and bootstraps through one replay of
    ``bootstrap_jit``'s graph."""
    run = entry_points(make_seq(), tmp_path)[entry]
    fake(False)
    ref = run()
    names = []
    replay = graphs.Program.replay
    monkeypatch.setattr(graphs.Program, "replay",
                        lambda self, *a: (names.append(self.name), replay(self, *a))[1])
    fake(True)
    got = run()
    if entry == "run_triangulate_test":  # numpy triples (ids, estimates, GT)
        assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, ref))
    else:
        assert_same(got, ref, entry)
    assert names.count("bootstrap") == 1, names


# ---------------------------------------------------- the capture cache --
def test_cache_is_bounded_and_a_dropped_entry_gives_the_same_bits(fake, monkeypatch):
    """Past CACHE_BYTES the least recently used entries are dropped; a
    dropped key captures again and gives the same bits; a session whose
    graph is dropped takes its state out and goes on as before."""
    seq = make_seq()
    fake(False)
    ref = {n: tvo.run_sequence(make_seq(frames=n), CFG, device="cpu")[2] for n in (6, 7, 8)}
    sess = tvo.OnlineVO(CFG)
    sess.start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    ref_steps = [sess.step(tvo.frame_of(seq, i, "cpu")) for i in range(1, 6)]
    fake(True)
    tvo.run_sequence(make_seq(frames=8), CFG, device="cpu")
    monkeypatch.setattr(graphs, "CACHE_BYTES", graphs.cached_bytes())  # room for one run
    for n in (6, 7, 8, 6):
        assert_same(tvo.run_sequence(make_seq(frames=n), CFG, device="cpu")[2], ref[n], n)
        assert graphs.cached_bytes() <= graphs.CACHE_BYTES
    assert graphs.evictions >= 3 and len(graphs._cache) <= 2
    s = tvo.OnlineVO(CFG)
    s.start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    got = [s.step(tvo.frame_of(seq, i, "cpu")) for i in range(1, 3)]
    held = s._prog
    tvo.run_sequence(make_seq(frames=7), CFG, device="cpu")  # drops the session's graph
    assert not held.live and held.owner is None
    got += [s.step(tvo.frame_of(seq, i, "cpu")) for i in range(3, 6)]
    assert_same(got, ref_steps)


# ------------------------------------------------- the fixed-order sums --
def test_segment_sum_is_index_add_in_entry_order():
    """On the CPU the planned sums are index_add_'s bit for bit (each
    target's entries in entry order, from zero); an empty target is 0."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 300, (2048,), generator=g)
    idx[idx == 7] = 8  # target 7 gets nothing
    vals = torch.randn(2048, 6, 3, generator=g)
    got = assembly.segment_sum(vals, assembly.plan(idx, 300))
    assert torch.equal(got, torch.zeros(300, 6, 3).index_add_(0, idx, vals))
    assert not got[7].any()


def test_ba_plans_reuse_the_landmark_sort():
    """The landmark-and-frame plan reuses the landmark sort: the order a
    fresh stable sort of landmark * W + frame gives; the sums unchanged by
    a plan made once for the solve."""
    from test_torch_ba import make_problem

    prob = tw.problem_from_numpy(make_problem(), "cpu")
    by_lm, by_lm_frame = tw.assembly_plans(prob)
    W, N = prob.obs_lm.shape
    L = prob.points.shape[0]
    lm = torch.clamp(prob.obs_lm.long(), 0, L - 1).reshape(-1)
    fresh = assembly.plan(lm * W + torch.arange(W)[:, None].expand(W, N).reshape(-1), L * W)
    assert torch.equal(by_lm_frame.order, fresh.order)
    assert torch.equal(by_lm_frame.bounds, fresh.bounds)
    K = torch.as_tensor(CFG.K())
    cfg = tw.BAConfig()
    assert_same(tw.linearize_ba(prob, K, CFG.width, CFG.height, cfg, (by_lm, by_lm_frame)),
                tw.linearize_ba(prob, K, CFG.width, CFG.height, cfg, (by_lm, fresh)))


def test_pgo_sums_are_index_add_in_edge_order():
    """H and b of linearize_pgo: the four blocks of every edge summed as the
    chained index_add_ did (the (i,i) blocks in edge order, then (j,j),
    (i,j), (j,i))."""
    g = torch.Generator().manual_seed(1)
    Fp, E = 12, 40
    ij = torch.randint(0, Fp, (E, 2), generator=g)
    ii, jj = ij[:, 0], ij[:, 1]
    blocks = [torch.randn(E, 6, 6, generator=g) for _ in range(4)]
    ref = torch.zeros(Fp * Fp, 6, 6)
    for tgt, blk in zip((ii * Fp + ii, jj * Fp + jj, ii * Fp + jj, jj * Fp + ii), blocks):
        ref.index_add_(0, tgt, blk)
    graph = tpg.PoseGraph(torch.eye(4).expand(Fp, 4, 4), ij, torch.eye(4).expand(E, 4, 4),
                          torch.ones(E), torch.zeros(Fp, dtype=torch.bool))
    by_block, _ = tpg.assembly_plans(graph)
    assert torch.equal(assembly.segment_sum(torch.cat(blocks), by_block), ref)
