"""tpuvo_torch matchers vs tpuvo's, including the fused top-2 kernel's plain
version against the Pallas kernel in interpret mode (CPU), and the CUDA
kernel against its plain version on the card (tests/test_torch_cuda.py).

Decisions (idx, valid) must agree exactly; distances to 1e-5 absolute
(fp32 sums of 10 products of O(1) values, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.ops import match as jm
from tpuvo.ops.pallas.match_kernel import match_descriptors_pallas
from tpuvo_torch.ops import match as tm
from tpuvo_torch.ops.cuda import match_kernel as tk
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

ATOL = 1e-5


def t(x):
    return torch.as_tensor(np.array(x))


def same_decisions(got, ref, check_best=True):
    v = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), v)
    assert np.array_equal(got.idx.numpy()[v], np.asarray(ref.idx)[v])
    if check_best:
        np.testing.assert_allclose(got.best.numpy()[v], np.asarray(ref.best)[v], atol=ATOL)


def random_sets(n=64, m=1024, seed=0, invalid=(100, 130)):
    rng = np.random.default_rng(seed)
    d1 = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (m, 10)).astype(np.float32)
    tgt = rng.choice(m, n // 2, replace=False)
    d2[tgt] = d1[: n // 2] + rng.normal(0, 0.02, (n // 2, 10)).astype(np.float32)
    v1 = np.ones(n, bool)
    v1[-3:] = False
    v2 = np.ones(m, bool)
    v2[invalid[0]:invalid[1]] = False
    return d1, v1, d2, v2


@pytest.mark.parametrize("method", ["direct", "mxu", "mxu_bf16"])
def test_match_descriptors_methods(method):
    d1, v1, d2, v2 = random_sets(40, 300, seed=1)
    ref = jm.match_descriptors(*map(jnp.asarray, (d1, v1, d2, v2)), method=method)
    got = tm.match_descriptors(*map(t, (d1, v1, d2, v2)), method=method)
    same_decisions(got, ref)
    fin = np.isfinite(np.asarray(ref.second))
    np.testing.assert_allclose(got.second.numpy()[fin], np.asarray(ref.second)[fin], atol=ATOL)


def test_top2_first_index_tie():
    """A duplicate of the best at a later index is the second-best; the
    first index wins (ratio 1 -> rejected)."""
    d1 = np.zeros((1, 10), np.float32)
    d2 = np.zeros((3, 10), np.float32)
    d2[0] += 0.05
    d2[1] += 0.01
    d2[2] += 0.01
    for method in ("direct", "mxu", "pallas"):
        got = tm.match_descriptors(t(d1), t(np.ones(1, bool)), t(d2), t(np.ones(3, bool)),
                                   method=method)
        assert int(got.idx[0]) == 1 and not bool(got.valid[0])
        assert float(got.best[0]) == float(got.second[0])


def test_match_pair_and_stats():
    a1, va1, b1, vb1 = random_sets(32, 200, seed=2)
    a2, va2, b2, vb2 = random_sets(32, 32, seed=3, invalid=(5, 9))
    args = (a1, va1, b1, vb1, a2, va2, b2, vb2)
    r1j, r2j = jm.match_descriptors_pair(*map(jnp.asarray, args))
    r1t, r2t = tm.match_descriptors_pair(*map(t, args))
    same_decisions(r1t, r1j)
    same_decisions(r2t, r2j)
    ids1 = np.arange(32, dtype=np.int32)
    ids2 = np.random.default_rng(4).integers(0, 40, 200).astype(np.int32)
    sj = jm.match_stats(r1j, jnp.asarray(ids1), jnp.asarray(va1), jnp.asarray(ids2), jnp.asarray(vb1))
    st = tm.match_stats(r1t, t(ids1), t(va1), t(ids2), t(vb1))
    assert [int(x) for x in st] == [int(x) for x in sj]


# --- the fused top-2 kernel: plain version vs the Pallas kernel (interpret)
def run_pallas_pair(d1, v1, d2, v2, tile_m=512):
    ref = match_descriptors_pallas(*map(jnp.asarray, (d1, v1, d2, v2)), tile_m=tile_m,
                                   interpret=True)
    got = tm.match_descriptors(*map(t, (d1, v1, d2, v2)), method="pallas")
    return ref, got


def test_kernel_matches_pallas_random():
    rng = np.random.default_rng(0)
    d1 = rng.uniform(-1, 1, (64, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (1024, 10)).astype(np.float32)
    d2[5] = d1[3] + 0.01
    d2[700] = d1[20] + 0.02   # cross-tile best
    v2 = np.ones(1024, bool)
    v2[100:130] = False
    ref, got = run_pallas_pair(d1, np.ones(64, bool), d2, v2)
    same_decisions(got, ref)


def test_kernel_cross_tile_top2():
    d1 = np.zeros((8, 10), np.float32)
    d2 = np.ones((1024, 10), np.float32)
    d2[3] = 0.05
    d2[900] = 0.06
    ref, got = run_pallas_pair(d1, np.ones(8, bool), d2, np.ones(1024, bool))
    assert int(got.idx[0]) == 3
    np.testing.assert_allclose(float(got.second[0]), float(ref.second[0]), atol=ATOL)


def test_kernel_unaligned_sizes():
    rng = np.random.default_rng(2)
    d1 = rng.uniform(-1, 1, (50, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (700, 10)).astype(np.float32)
    d2[650] = d1[10]
    ref, got = run_pallas_pair(d1, np.ones(50, bool), d2, np.ones(700, bool))
    same_decisions(got, ref)


def test_kernel_duplicate_descriptors_tie():
    """Exact duplicates in the map (the fixtures re-triangulate landmarks)
    sit at exactly the same distance: the first index wins in both, and
    both reject on the ratio test."""
    rng = np.random.default_rng(5)
    d1 = rng.uniform(-1, 1, (16, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (512, 10)).astype(np.float32)
    d2[40] = d2[300] = d1[2]
    d2[41] = d2[42] = d1[3] + 0.01
    ref, got = run_pallas_pair(d1, np.ones(16, bool), d2, np.ones(512, bool))
    same_decisions(got, ref)
    assert int(got.idx[2]) == 40 and int(got.idx[3]) == 41
    assert not bool(got.valid[2]) and not bool(got.valid[3])
    assert float(got.best[2]) == 0.0  # identical descriptors: exactly 0


def test_kernel_all_invalid_map():
    d1, v1, d2, _ = random_sets(16, 256, seed=6)
    ref, got = run_pallas_pair(d1, v1, d2, np.zeros(256, bool))
    assert not got.valid.any() and not np.asarray(ref.valid).any()
    r = tk.match_descriptors_cuda(t(d1), t(v1), t(d2), t(np.zeros(256, bool)))
    assert torch.isinf(r.best).all() and (r.idx == 0).all() and not r.valid.any()


def test_wrapper_routes_cpu_to_plain_version():
    d1, v1, d2, v2 = random_sets(32, 200, seed=7)
    n0 = tk.launches
    r = tk.match_descriptors_cuda(*map(t, (d1, v1, d2, v2)))
    rb, ri, rs = tk.match_topk_reference(*map(t, (d1, v1, d2, v2)))
    assert tk.launches == n0  # no kernel launch for CPU tensors
    assert torch.equal(r.idx, ri) and torch.equal(r.best, rb) and torch.equal(r.second, rs)


@pytest.mark.parametrize("N,M,D,plan", [
    (128, 8192, 10, (16, 1, 8)),     # the tracker's map match: 8 x 8 = 64 blocks
    (128, 8191, 10, (16, 1, 8)),
    (128, 512, 10, (16, 1, 4)),      # a small map: each split holds one 128-row tile
    (300, 8192, 10, (32, 1, 8)),     # N not a multiple of the query tile
    (25600, 8192, 10, (256, 4, 8)),  # the refiner's topology: 100 x 8 = 800 blocks
    (25600, 8192, 32, (128, 1, 4)),  # other widths: one query a thread, 32-row tiles
    (128, 8192, 32, (16, 1, 8)),
    (5, 40, 10, (8, 1, 1)),
])
def test_launch_plan(N, M, D, plan):
    """The query tile and the cluster size the wrapper gives the CUDA kernel
    (132 SMs, as on an H100 SXM)."""
    qb, qpt, splits = tk.launch_plan(N, M, D, 132)
    assert (qb, qpt, splits) == plan
    assert (qb, qpt) in tk.QUERY_TILES and splits in (1, 2, 4, 8)
    assert 128 % (qb // qpt) == 0 and (qpt == 1 or D == 10)
    assert splits <= max(1, -(-M // tk.tile_rows(D)))  # no split without a tile
    if N == 128 and M >= 8 * tk.tile_rows(D):
        assert -(-N // qb) * splits >= tk.BUSY_BLOCKS


@pytest.mark.parametrize("D", [0, 65])
def test_launch_plan_rejects_widths_the_kernel_does_not_take(D):
    with pytest.raises(ValueError, match="width"):
        tk.launch_plan(128, 8192, D, 132)


def test_prepare_needs_card_tensors():
    d1, v1, d2, v2 = random_sets(8, 64, seed=8)
    with pytest.raises(ValueError, match="kernel argument on cpu"):
        tk.prepare(t(d1), t(v1), t(d2), t(v2), 0.2, 0.8)


@pytest.mark.parametrize("lanes,M,plan", [
    (256, 512, (128, 4, 2)),    # the batched tracker: one 4-a-thread tile a lane
    (256, 8192, (128, 4, 2)),
    (3, 8191, (32, 1, 8)),      # few lanes: a narrower tile keeps 64 blocks busy
    (1, 8192, (16, 1, 8)),      # one lane: the single sequence's plan
])
def test_launch_plan_lanes(lanes, M, plan):
    """Lanes multiply the blocks: at 256 lanes of N = 128 no query tile is
    split and the map splits stop at LANE_BLOCKS_PER_SM blocks per SM."""
    assert tk.launch_plan(128, M, 10, 132, lanes) == plan
    qb, _, splits = plan
    assert lanes * splits * -(-128 // qb) >= tk.BUSY_BLOCKS
    with pytest.raises(ValueError, match="lanes"):
        tk.launch_plan(128, M, 10, 132, tk.MAX_LANES + 1)


def test_wrapper_lanes_match_each_lane_alone():
    """With a leading lane axis (each lane its own map: odd M, one lane's
    map all invalid, lanes that are views) the plain version and the
    matchers give every lane the answer it gets alone."""
    sets = [random_sets(32, 255, seed=s) for s in range(3)]
    d1, v1, d2, v2 = (t(np.stack(a)) for a in zip(*sets))
    v2[1] = False
    frames = torch.stack([d1, d1 + 1.0], 1)  # (B, 2, N, D): lane views of stride 2·N·D
    for method in ("pallas", "mxu", "direct"):
        got = tm.match_descriptors(frames[:, 0], v1, d2, v2, method=method)
        assert got.idx.shape == (3, 32)
        for b in range(3):
            one = tm.match_descriptors(d1[b], v1[b], d2[b], v2[b], method=method)
            for x, y in zip(got, one):
                assert torch.equal(x[b], y), (method, b)
    assert not got.valid[1].any()
