"""The batched tracker (a leading lane axis of B distinct sequences) against
``jax.vmap`` of the JAX package's own functions, on the CPU.

B = 3 lanes of one small sequence, each with its own 0.25 px pixel noise
(bench.py:245-249, made with numpy) and its own RANSAC draw.  The JAX side
runs the XLA PICP solver (its Pallas solver has no CPU mode) and the pallas
matcher in interpret mode, as tests/test_lifecycle.py:152-156 vmaps them.

Tolerances are those of test_torch_vo.test_track_step_from_jax_state (pose
atol 1e-4, counts exact, GN iterations +/-1, map positions 1e-3), T_boot
those of its bootstrap test (2e-3: the RANSAC refit's fp32 eigenvector),
with one reading-based exception: the map positions hold 1e-3 on >= 99%
of the slots.  With three noisy lanes a few landmarks are triangulated
20-35 m away at low parallax (ungated, nearly at infinity), where the two
packages' ~1e-6 pose difference moves their depth by up to 1.3e-3
relative (23% ungated): 2-3 of ~650-830 slots a step.
Pixels: every landmark the step added whose two viewing rays are well
posed reprojects into the step's two cameras within 0.05 px (every older
one is JAX's own).  Well posed is vobench/check.py's rule, on JAX's poses
and matches: rays at least RAY_MIN times the gate's parallax apart,
meeting at least DEPTH_MIN metres in front of both cameras.  Elsewhere
the DLT and its two Gauss-Newton polishes have no fixed point to reach
(rays that meet behind a camera walk the point outward by a step or more
per polish), so the float32 bits of each host's products decide where a
landmark stops; their masks, ids and counts are still held exactly.
The teacher-forced steps run at rel-chi 1e-4 (bench's and the card
fixtures' value): at the default 1e-5 the stop is knife-edge on these
noisier lanes, and one lane stepped ALONE by each package already stops 2
rounds apart (7 vs 5 on the fused-gating branch's first step, chi equal
to 5e-6 relative), which no lane axis causes.
A lane of a batched step against the same lane stepped alone: the lane
runs batched products where the single sequence runs 2-D ones, so the
pose may differ in its last float32 bits (readings: at most 1.9e-6 on a
coordinate of 3.9); matches, new landmarks and counts exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry import assert_pose_within, record_refits, refit_kappa
from test_torch_vo import BRANCHES, LOG_COUNTS, both_cfgs, make_seq, to_np
from tpuvo.engine import state as jstate, vo as jvo
from tpuvo.ops import match as jmatch
from tpuvo_torch.engine import state as tstate, vo as tvo
from vobench.check import DEPTH_MIN, RAY_MIN
from vobench.reference.vo import rays
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

B = 3
FIELDS = ("uv", "desc", "id_meas", "id_real", "valid")
MAP_FIELDS = ("map_valid", "map_id_real", "map_id_meas", "map_last_seen", "map_count",
              "frame_idx", "map_desc")


def lane_arrays(seq, seed=5, sigma=0.25):
    """The sequence's frames tiled over B lanes (B, F, N, ...), each lane's
    uv with its own noise times valid."""
    rng = np.random.default_rng(seed)
    a = {k: np.repeat(getattr(seq, k)[None], B, 0) for k in FIELDS}
    noise = sigma * rng.standard_normal(a["uv"].shape) * a["valid"][..., None]
    a["uv"] = (a["uv"] + noise).astype(np.float32)
    return a


def jax_frame(a, i):
    return jvo.Frame(*(jnp.asarray(a[k][:, i]) for k in FIELDS))


def torch_frames(a):
    return tvo.Frame(*(torch.as_tensor(a[k]) for k in FIELDS))


def jax_sample_idx(key, f0, f1, cfg):
    """JAX's RANSAC draw for its bootstrap with ``key`` (one lane)."""
    res = jmatch.match_descriptors(f0.desc, f0.valid, f1.desc, f1.valid,
                                   cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
                                   cfg.matcher.method)
    g = jax.random.gumbel(key, (cfg.ransac.num_hypotheses, f0.uv.shape[0]))
    scores = jnp.where(res.valid[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(scores, cfg.ransac.sample_size)[1])


def lane_sample_idx(keys, a, cfg):
    """Every lane's JAX draw, (B, H, S)."""
    f0, f1 = jax_frame(a, 0), jax_frame(a, 1)
    lane = lambda f, b: jvo.Frame(*(x[b] for x in f))
    return torch.as_tensor(np.stack([jax_sample_idx(keys[b], lane(f0, b), lane(f1, b), cfg)
                                     for b in range(B)]))


def jax_boot(jc, keys, a):
    return jax.jit(jax.vmap(lambda k, f0, f1: jvo.bootstrap(k, f0, f1, jc)))(
        keys, jax_frame(a, 0), jax_frame(a, 1))


def project(T_wc, X, K):
    """Pixels of world points X (B, C, 3) in cameras T_wc (B, 4, 4), and
    whether each lies in front."""
    T = np.linalg.inv(T_wc.astype(np.float64))
    p = np.einsum("bij,bcj->bci", T[:, :3, :3], X) + T[:, None, :3, 3]
    h = p @ K.T
    return h[..., :2] / np.where(np.abs(h[..., 2:]) > 1e-9, h[..., 2:], 1.0), p[..., 2] > 0.1


@functools.lru_cache(maxsize=None)
def jax_lane_matcher(distance, ratio, method):
    return jax.jit(jax.vmap(lambda d1, v1, d2, v2: jmatch.match_descriptors(
        d1, v1, d2, v2, distance, ratio, method)))


def well_posed(sj, sj2, lj, curr, nxt, cfg):
    """(B, C): whether each landmark JAX's step added has well-posed rays
    (vobench/check.py's rule: ``rays`` of the pixels JAX's 2D-2D match
    pairs, from JAX's poses before and after the step); True for every
    slot the step did not add."""
    new = np.asarray(sj2.map_valid) & ~np.asarray(sj.map_valid)
    mc = cfg.matcher
    m = jax_lane_matcher(mc.distance_threshold, mc.ratio_threshold, mc.method)(
        *(jnp.asarray(x.numpy()) for x in (curr.desc, curr.valid, nxt.desc, nxt.valid)))
    idx = np.asarray(m.idx)
    ids, c_ids, c_valid = np.asarray(sj2.map_id_meas), curr.id_meas.numpy(), curr.valid.numpy()
    uv1 = np.zeros(new.shape + (2,))
    uv2 = np.zeros(new.shape + (2,))
    for b, s in zip(*np.nonzero(new)):
        k = np.flatnonzero((c_ids[b] == ids[b, s]) & c_valid[b])[0]
        uv1[b, s], uv2[b, s] = curr.uv[b, k].numpy(), nxt.uv[b, idx[b, k]].numpy()
    wic = lambda T: torch.linalg.inv(torch.as_tensor(np.asarray(T, np.float64)))
    angle, depth = rays(torch.as_tensor(cfg.K(), dtype=torch.float64), wic(sj.pose),
                        wic(lj.pose), torch.as_tensor(uv1), torch.as_tensor(uv2))
    ok = (angle.numpy() >= RAY_MIN * cfg.landmark_min_parallax_rad) & (depth.numpy() >= DEPTH_MIN)
    return ~new | ok


def assert_step(st2, lt, sj2, lj, what, sj=None, frames=None, cfg=None):
    """The port's batched step against JAX's vmapped one, every lane.  With
    sj (JAX's state before the step), frames (the step's (curr, nxt)) and
    cfg, each landmark with well-posed rays (``well_posed``) must also
    reproject into the step's two cameras within 0.05 px."""
    np.testing.assert_allclose(lt.pose.numpy(), np.asarray(lj.pose), atol=1e-4, err_msg=what)
    for k in LOG_COUNTS:
        assert np.array_equal(to_np(getattr(lt, k)), to_np(getattr(lj, k))), (what, k)
    assert np.abs(lt.iterations.numpy() - np.asarray(lj.iterations)).max() <= 1, what
    for k in MAP_FIELDS:
        assert np.array_equal(to_np(getattr(st2, k)), to_np(getattr(sj2, k))), (what, k)
    v = np.asarray(sj2.map_valid)
    xt, xj = st2.map_xyz.numpy().astype(np.float64), np.asarray(sj2.map_xyz, np.float64)
    assert np.mean(np.all(np.isclose(xt[v], xj[v], rtol=1e-3, atol=1e-3), -1)) >= 0.99, what
    if sj is not None:  # what a triangulation fixes: the landmark's pixels in both views
        K = cfg.K().astype(np.float64)
        well = well_posed(sj, sj2, lj, *frames, cfg)
        for T in (np.asarray(sj.pose), np.asarray(lj.pose)):
            (ut, _), (uj, front) = project(T, xt, K), project(T, xj, K)
            m = v & front & well
            np.testing.assert_allclose(ut[m], uj[m], atol=0.05, err_msg=f"{what} pixels")
    np.testing.assert_allclose(st2.vel.numpy(), np.asarray(sj2.vel), atol=1e-4, err_msg=what)


def move_a_well_posed_landmark(st2, sj, sj2, lj, frames, cfg):
    """The planted fault of the pixel check: the first landmark the step
    added with well-posed rays moved sideways (along its first camera's x
    axis) by 1% of its depth there.  Returns whether there was one."""
    new = np.asarray(sj2.map_valid) & ~np.asarray(sj.map_valid)
    hit = np.argwhere(new & well_posed(sj, sj2, lj, *frames, cfg))
    if not len(hit):
        return False
    b, s = hit[0]
    T = np.asarray(sj.pose, np.float64)[b]
    depth = (np.linalg.inv(T) @ np.append(np.asarray(sj2.map_xyz, np.float64)[b, s], 1.0))[2]
    st2.map_xyz[b, s] += torch.as_tensor(0.01 * depth * T[:3, 0], dtype=torch.float32)
    return True


# ------------------------------------------------------------ map append --
@pytest.mark.parametrize("reuse", [False, True])
def test_batched_append_to_map_matches_jax(reuse):
    """Three lanes with their own occupancy, counts and candidates: the
    slots each candidate lands in, and every state field, exactly."""
    jc, _ = both_cfgs(mode="fixed", map_capacity=32, max_obs=16)
    rng = np.random.default_rng(1)
    empty = {k: np.asarray(v) for k, v in jstate.empty_state(jc)._asdict().items()}
    fields = {k: np.repeat(v[None], B, 0) for k, v in empty.items()}
    if reuse:
        fields["map_valid"] = rng.random((B, 32)) < np.array([0.3, 0.7, 0.95])[:, None]
        fields["map_count"] = fields["map_valid"].sum(1).astype(np.int32)
    else:
        fields["map_count"] = np.array([0, 20, 30], np.int32)
        fields["map_valid"] = np.arange(32)[None] < fields["map_count"][:, None]
    fields["frame_idx"] = np.array([5, 6, 7], np.int32)
    n = 16
    xyz = rng.normal(0, 3, (B, n, 3)).astype(np.float32)
    desc = rng.normal(0, 1, (B, n, 10)).astype(np.float32)
    ids = (np.arange(B * n, dtype=np.int32) + 100).reshape(B, n)
    mask = rng.random((B, n)) < 0.8
    sj = jstate.VOState(**{k: jnp.asarray(v) for k, v in fields.items()})
    outj = jax.vmap(lambda s, x, d, i, m: jvo._append_to_map(s, x, d, i, i + 1, m,
                                                             reuse_slots=reuse))(
        sj, jnp.asarray(xyz), jnp.asarray(desc), jnp.asarray(ids), jnp.asarray(mask))
    outt = tvo._append_to_map(tstate.state_from_numpy(fields, "cpu"), torch.as_tensor(xyz),
                              torch.as_tensor(desc), torch.as_tensor(ids),
                              torch.as_tensor(ids + 1), torch.as_tensor(mask), reuse_slots=reuse)
    for k in tstate.VOState._fields:
        assert np.array_equal(to_np(getattr(outt[0], k)), to_np(getattr(outj[0], k))), k
    for t, j in zip(outt[1:], outj[1:]):  # n_added, landing slots, inserted
        assert np.array_equal(to_np(t), to_np(j))


# ------------------------------------------------------------- bootstrap --
def test_batched_bootstrap_matches_jax():
    """Each lane's bootstrap with JAX's own RANSAC draw for its split key."""
    jc, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64)
    a = lane_arrays(make_seq(jc))
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    sj, dj = jax_boot(jc, keys, a)
    fr = torch_frames(a)
    st, dt = tvo.bootstrap(None, tvo.lane_frame_at(fr, 0), tvo.lane_frame_at(fr, 1), tc,
                           sample_idx=lane_sample_idx(keys, a, jc))
    np.testing.assert_allclose(dt["T_boot"].numpy(), np.asarray(dj["T_boot"]), atol=2e-3)
    for k in ("n_matches", "n_ransac_inliers", "n_map_points"):
        assert np.array_equal(to_np(dt[k]), to_np(dj[k])), k
    for k in ("map_valid", "map_id_real", "map_id_meas", "map_count", "map_desc"):
        assert np.array_equal(to_np(getattr(st, k)), to_np(getattr(sj, k))), k
    # landmarks over the 0.2 m baseline inherit T_boot's difference (see
    # test_torch_vo.test_bootstrap_matches_jax)
    v = np.asarray(sj.map_valid)
    np.testing.assert_allclose(st.map_xyz.numpy()[v], np.asarray(sj.map_xyz)[v],
                               rtol=5e-2, atol=5e-2)
    assert len({int(n) for n in dt["n_ransac_inliers"]} | {0}) > 1  # lanes really differ


# ------------------------------------------------------------ track_step --
@pytest.mark.parametrize("branch,fault", [(b, None) for b in sorted(BRANCHES)]
                         + [("fused-gating", "moved-landmark")],
                         ids=sorted(BRANCHES) + ["fused-gating-moved-landmark"])
def test_batched_track_step_from_jax_state(branch, fault):
    """Teacher forcing per lane: at every step JAX's vmapped state converts
    across (state_from_numpy keeps the lane axis) and one batched port step
    must reproduce JAX's vmapped step on every lane.  With the fault
    ``moved-landmark`` (move_a_well_posed_landmark), the first step that
    adds a well-posed landmark must fail the comparison."""
    kw = dict(map_capacity=256, max_obs=64)
    kw.update(BRANCHES[branch])
    kw["picp"] = {"convergence_threshold": 1e-4, **kw.get("picp", {})}
    jc, tc = both_cfgs(**kw)
    jc = jc.replace(picp=dataclasses.replace(jc.picp, backend="xla"))
    a = lane_arrays(make_seq(jc))
    F = a["uv"].shape[1]
    sj, _ = jax_boot(jc, jax.random.split(jax.random.PRNGKey(42), B), a)
    jstep = jax.jit(jax.vmap(lambda s, c, n: jvo.track_step(s, c, n, jc)))
    fr = torch_frames(a)
    for i in range(F - 1):
        st = tstate.state_from_numpy(sj, "cpu")
        sj2, lj = jstep(sj, jax_frame(a, i), jax_frame(a, i + 1))
        frames = tvo.lane_frame_at(fr, i), tvo.lane_frame_at(fr, i + 1)
        st2, lt = tvo.track_step(st, *frames, tc)
        assert lt.pose.shape == (B, 4, 4) and st2.map_xyz.shape[0] == B
        if fault and move_a_well_posed_landmark(st2, sj, sj2, lj, frames, tc):
            with pytest.raises(AssertionError, match="pixels"):
                assert_step(st2, lt, sj2, lj, f"{branch} step {i}", sj, frames, tc)
            return
        assert_step(st2, lt, sj2, lj, f"{branch} step {i}", sj, frames, tc)
        sj = sj2
    assert not fault, "no step added a well-posed landmark to move"


@pytest.mark.parametrize("branch", ["plain-parity", "motion-evict", "pallas-both"])
def test_lane_equals_single_sequence_step(branch):
    """A batched run stepped lane by lane: each lane's step alone (no lane
    axis) gives the batched step's map matches, new landmarks and counts
    exactly and its pose to a few float32 ulps (atol 1e-6 + rtol 1e-6)."""
    kw = dict(map_capacity=256, max_obs=64)
    kw.update(BRANCHES[branch])
    _, tc = both_cfgs(**kw)
    a = lane_arrays(make_seq(tc, noise=0.3))
    fr = torch_frames(a)
    F = a["uv"].shape[1]
    state, _ = tvo.bootstrap(tvo.make_generator(3), tvo.lane_frame_at(fr, 0),
                             tvo.lane_frame_at(fr, 1), tc)
    for i in range(F - 1):
        curr, nxt = tvo.lane_frame_at(fr, i), tvo.lane_frame_at(fr, i + 1)
        s2, lg, mt = tvo.track_step(state, curr, nxt, tc, return_matches=True)
        for b in range(B):
            lane = lambda tup: type(tup)(*(x[b] for x in tup))
            s1, l1, m1 = tvo.track_step(lane(state), lane(curr), lane(nxt), tc,
                                        return_matches=True)
            for x, y in zip(m1, mt):  # matches, new-landmark slots and positions
                assert torch.equal(x, y[b]), (branch, i, b)
            torch.testing.assert_close(l1.pose, lg.pose[b], atol=1e-6, rtol=1e-6)
            for k in LOG_COUNTS:
                assert int(getattr(l1, k)) == int(getattr(lg, k)[b]), (branch, i, b, k)
            for k in MAP_FIELDS:
                assert torch.equal(getattr(s1, k), getattr(s2, k)[b]), (branch, i, b, k)
        state = s2


@pytest.mark.parametrize("shapes", [((3, 3), (B, 3, 4)), ((B, 32, 3), (B, 3, 3)),
                                    ((B, 32, 3, 4), (B, 32, 4, 1)), ((B, 3, 3), (B, 3, 1))],
                         ids=["K-pose", "points-pose", "per-point-AtB", "pose-vector"])
def test_written_out_products_give_a_lane_its_bits_alone(shapes):
    """linalg_small.matmul_terms, the card's form of the tracker's small
    products: within float32 rounding of torch's product (rtol 1e-6), and
    each lane gets the bits of its own arguments multiplied alone."""
    from tpuvo_torch.ops.linalg_small import matmul_terms

    rng = np.random.default_rng(5)
    A, C = (torch.as_tensor(rng.normal(0, 10, s).astype(np.float32)) for s in shapes)
    got = matmul_terms(A, C)
    torch.testing.assert_close(got, A.double() @ C.double(), rtol=1e-6, atol=1e-4,
                               check_dtype=False)
    for b in range(B):
        alone = matmul_terms(A[b] if A.dim() == C.dim() else A, C[b])
        assert torch.equal(alone, got[b])


@pytest.mark.parametrize("kernel,fault", [(False, None), (True, None),
                                          (False, "reversed-translation")],
                         ids=["False", "True", "False-reversed-translation"])
def test_run_batch_matches_single_sequence_runs(kernel, fault, monkeypatch):
    """run_batch over lanes_of(B sequences) with every lane's RANSAC draw
    given equals run_sequence of each sequence with its draw: the bootstrap
    counts exactly, the first pose (the identity) exactly, and T_boot and
    the first tracked pose in rotation and translation direction within
    the conditioning of the sequence's own refit (assert_pose_within): on
    the CPU a lane's products are BLAS calls of other shapes and
    alignments than the sequence's, whose last bits differ by host, and
    the refit's float32 eigenvector carries them up to eps·λmax / (λ1 -
    λ0); the first tracked pose inherits T_boot's through the bootstrap's
    map.  The whole run within 1e-2 (the tracker's feedback compounds
    them: readings up to 5.0e-3 after 9 steps).  With the fault
    ``reversed-translation`` (the lane's first tracked pose moved to minus
    its position) the comparison must fail."""
    kw = dict(matcher=dict(method="pallas"), picp=dict(backend="pallas")) if kernel else {}
    _, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64, **kw)
    seqs = [make_seq(tc, seed=s, noise=0.3) for s in (13, 14, 15)]
    idx = torch.stack([tvo.twoview.draw_samples(torch.Generator().manual_seed(s),
                                                torch.ones(64, dtype=torch.bool), 512, 8)
                       for s in range(B)])
    state, logs, poses, diag = tvo.run_batch(tvo.lanes_of(seqs, "cpu"), tc, sample_idx=idx)
    assert poses.shape == (B, 10, 4, 4) and logs.n_new_points.shape == (B, 9)
    if fault:
        poses[0, 1, :3, 3] *= -1
    refits = record_refits(monkeypatch)
    for b, seq in enumerate(seqs):
        s1, l1, p1, d1 = tvo.run_sequence(seq, tc, device="cpu", sample_idx=idx[b])
        for k in ("n_matches", "n_ransac_inliers", "n_map_points"):
            assert int(diag[k][b]) == int(d1[k]), k
        assert torch.equal(poses[b, 0], p1[0])
        kappa = refit_kappa(*refits[-1])
        assert_pose_within(diag["T_boot"][b], d1["T_boot"], kappa, f"lane {b} T_boot")
        if fault:
            with pytest.raises(AssertionError, match="first tracked pose"):
                assert_pose_within(poses[b, 1], p1[1], kappa, f"lane {b} first tracked pose")
            return
        assert_pose_within(poses[b, 1], p1[1], kappa, f"lane {b} first tracked pose")
        torch.testing.assert_close(poses[b], p1, atol=1e-2, rtol=0)
        assert int(logs.n_map_matches[b, 0]) == int(l1.n_map_matches[0])


# ------------------------------------------------------- threshold sweep --
THRESHOLDS = [1000.0, 3000.0, 10000.0]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_threshold_sweep_step_from_jax_state(backend):
    """The sweep's step, teacher-forced: JAX's vmapped track_step over the
    threshold axis (its run_threshold_sweep's body) against the port's
    batched step with a (B,) threshold tensor; with picp.backend="pallas"
    the port routes the per-lane thresholds to the PICP kernel's plain
    version (JAX to its XLA solver, as a traced threshold does there)."""
    jc, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64,
                       picp=dict(backend=backend, convergence_threshold=1e-4))
    jc = jc.replace(picp=dataclasses.replace(jc.picp, backend="xla"))
    seq = make_seq(jc, noise=0.3)
    F = seq.uv.shape[0]
    thr = jnp.asarray(THRESHOLDS, jnp.float32)
    s0, _ = jvo.bootstrap_jit(jax.random.PRNGKey(42), jvo.frame_of(seq, 0), jvo.frame_of(seq, 1), jc)
    sj = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), s0)
    jstep = jax.jit(jax.vmap(lambda s, c, n, t: jvo.track_step(s, c, n, jc, kernel_threshold=t),
                             in_axes=(0, None, None, 0)))
    fr = tvo.frames_of(seq, 0, F, "cpu")
    lanes = lambda f: tvo.Frame(*(x.expand((B,) + x.shape) for x in f))
    differ = 0
    for i in range(F - 1):
        st = tstate.state_from_numpy(sj, "cpu")
        sj2, lj = jstep(sj, jvo.frame_of(seq, i), jvo.frame_of(seq, i + 1), thr)
        frames = lanes(tvo.frame_at(fr, i)), lanes(tvo.frame_at(fr, i + 1))
        st2, lt = tvo.track_step(st, *frames, tc, kernel_threshold=torch.tensor(THRESHOLDS))
        assert_step(st2, lt, sj2, lj, f"sweep {backend} step {i}", sj, frames, tc)
        differ += int(len(set(lt.num_inliers.tolist())) > 1)
        sj = sj2
    assert differ > 0  # the thresholds really split the lanes' inlier sets


def test_run_threshold_sweep_matches_jax():
    """run_threshold_sweep against JAX's: with JAX's RANSAC draw the shared
    bootstrap is JAX's, and each lane's whole run (9 steps) stays within
    the per-step tolerances of JAX's lane; lane b equals the port's own
    run_sequence at threshold b (the same CPU ops, within 1e-5)."""
    jc, tc = both_cfgs(mode="fixed", map_capacity=256, max_obs=64,
                       picp=dict(convergence_threshold=1e-4))
    seq = make_seq(jc, noise=0.0)
    f0, f1 = jvo.frame_of(seq, 0), jvo.frame_of(seq, 1)
    from test_torch_vo import jax_sample_idx as seed_sample_idx

    idx = seed_sample_idx(42, f0, f1, jc)
    _, lj, pj = jvo.run_threshold_sweep(seq, THRESHOLDS, jc, seed=42)
    st, lt, pt = tvo.run_threshold_sweep(seq, THRESHOLDS, tc, seed=42, device="cpu",
                                         sample_idx=idx)
    assert pt.shape == (B,) + tuple(np.asarray(pj).shape[1:])
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    for k in ("n_map_matches", "n_new_points", "map_count"):
        assert np.array_equal(to_np(getattr(lt, k)), to_np(getattr(lj, k))), k
    for b, t in enumerate(THRESHOLDS):
        cfg_b = tc.replace(picp=dataclasses.replace(tc.picp, kernel_threshold=t))
        _, lb, pb, _ = tvo.run_sequence(seq, cfg_b, device="cpu", sample_idx=idx)
        torch.testing.assert_close(pt[b], pb, atol=1e-5, rtol=0)
        assert torch.equal(lt.num_inliers[b], lb.num_inliers)
