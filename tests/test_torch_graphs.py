"""The compiled layer (``tpuvo_torch/utils/graphs.py``, the port's ``jax.jit``)
on the CPU.

1. The steps are capture-safe: ``track_step`` (one lane, B=3 lanes, the
   sweep's thresholds, ``return_matches``) and the index-based SLAM step
   (with and without the local BA) run under ``graphs.host_sync_guard``,
   which fails on every op that synchronises with the host on CUDA.  The
   kernels are routed as on the card (``test_torch_picp.kernel_route``;
   kernel C, the bootstrap's eigensolvers, through its ``prepare``) and are
   opaque to the guard, as a launch is.
2. The graph plumbing, with ``FakeGraph`` standing in for the CUDA graph:
   every graphed entry point is bit-equal to its eager loop, an output is
   never overwritten by a later step, one capture is made per (cfg,
   shape) (a second call makes none: JAX's "no recompile"), and a replay
   credits the kernel launches that the eager run makes.
3. Parity with JAX: the graphed SLAM step from JAX's own carry against
   ``jslam.slam_step_jit``, on frames with and without the local BA, at
   ``tests/test_torch_slam.py``'s tolerances.
4. The pose graph's LM iteration: a whole ``pgo_solve`` runs under the
   guard (a conversion to ``meta`` passes it), and on ``FakeGraph`` it and
   ``close_loops`` give the eager loop's bits and record, one capture per
   threshold and one replay per iteration.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from test_torch_picp import kernel_route
from test_torch_slam import COUNTS, both_cfgs as slam_cfgs, fixture as slam_fixture, jax_carry
from tpuvo.engine import slam as jslam, vo as jvo
from tpuvo_torch.ba import posegraph as tpg
from tpuvo_torch.config import EngineConfig, MatcherConfig, PICPConfig
from tpuvo_torch.data import synthetic
from tpuvo_torch.engine import slam as tslam, vo as tvo
from tpuvo_torch.engine.state import VOState
from tpuvo_torch.ops import lie as tlie
from tpuvo_torch.ops.cuda import match_kernel as tm, picp_kernel as tk, smalleig as tc
from tpuvo_torch.utils import graphs
from tpuvo_torch.utils.graphs import GraphCaptureError, host_sync_guard

F = 10
CFG = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                   matcher=MatcherConfig(method="pallas"),
                   picp=PICPConfig(convergence_threshold=1e-4))
SLAM_CFG = CFG.replace(map_capacity=512, local_ba_window=4, local_ba_every=2,
                       local_ba_iterations=3)
THRESHOLDS = [1000.0, 3000.0, 10000.0]


def make_seq(cfg=CFG, seed=13, frames=F, noise=0.3):
    world = synthetic.make_world(seed, n_landmarks=300, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(frames, seed=seed)
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=noise, seed=seed)


def lanes(n=3, frames=F):
    return tvo.lanes_of([make_seq(seed=s, frames=frames) for s in range(13, 13 + n)], "cpu")


@pytest.fixture
def kernels(monkeypatch):
    """The kernels routed as on the card: the PICP solves through
    ``picp_kernel.prepare`` (``kernel_route``), the matcher through
    ``match_descriptors_cuda``, the eigensolvers through ``smalleig``'s
    ``prepare_sym_eig`` / ``prepare_svd3``; each counts a launch as its
    wrapper does, and computes its plain version out of sight of the guard
    (a kernel's launch is no aten op)."""
    kernel_route(monkeypatch, True)
    prepare, match = tk.prepare, tm.match_descriptors_cuda

    def quiet_prepare(*a, **kw):
        with _disable_current_modes():
            _, res = prepare(*a, **kw)

        def launch():
            tk.launches += 1
        return launch, res

    def quiet_match(*a, **kw):
        with _disable_current_modes():
            res = match(*a, **kw)
        tm.launches += 1
        return res

    monkeypatch.setattr(tk, "prepare", quiet_prepare)
    monkeypatch.setattr(tm, "match_descriptors_cuda", quiet_match)
    route_kernel_c(monkeypatch)
    monkeypatch.setattr(tk, "launches", 0)
    monkeypatch.setattr(tm, "launches", 0)


def route_kernel_c(monkeypatch):
    """Kernel C's calls routed as on the card: each ``prepare`` answers
    with the plain version out of sight of the guard and counts a launch."""
    monkeypatch.setattr(tc, "on_card", lambda _t: True)

    def quiet(reference):
        def prepare(A, rotations=None):
            with _disable_current_modes():
                res = reference(A)

            def launch():
                tc.launches += 1
            return launch, res
        return prepare

    monkeypatch.setattr(tc, "prepare_sym_eig", quiet(tc.sym_eig_reference))
    monkeypatch.setattr(tc, "prepare_svd3", quiet(tc.svd3_reference))
    monkeypatch.setattr(tc, "launches", 0)


def _write(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _write(d, s)


class FakeGraph:
    """CPU stand-in for ``graphs.CUDAGraph``: the warm-up calls, then the
    "capture", which records ``fn`` and runs it once for its output tensors
    (a real capture runs nothing and leaves them unwritten).  A replay runs
    ``fn`` on the static buffers with the launch counters held (a real
    replay runs none of the wrappers' Python) and writes its results into
    the output tensors returned at capture, as a real graph does."""

    def __init__(self, fn, warm):
        for _ in range(graphs.WARMUP):
            warm()
        self._fn = fn
        self.outputs = fn()

    def replay(self):
        held = [m.launches for m in graphs.COUNTED]
        out = self._fn()
        for m, n in zip(graphs.COUNTED, held):
            m.launches = n
        _write(self.outputs, out)


@pytest.fixture
def fake(monkeypatch, kernels):
    """Graphs on, faked: returns a switch ``use(on)`` between the graphed
    entry points (on) and the eager ones (off); the cache and the counters
    start empty and are restored after the test."""
    monkeypatch.setattr(graphs, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graphs, "_cache", {})
    for name in ("captures", "replays", "warmup_launches"):
        monkeypatch.setattr(graphs, name, 0)

    def use(on: bool):
        monkeypatch.setattr(graphs, "on_card", lambda _t: on)
    return use


def launches():
    return tk.launches, tm.launches


def assert_same(a, b, what=""):
    """Bit equality of two pytrees of tensors (and ints)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{getattr(a, '_fields', range(len(a)))[i]}]")
    elif isinstance(a, dict):
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k}]")
    else:
        assert a == b, what


# -------------------------------------------------------------- 1. guard --
@pytest.mark.parametrize("case", ["item", "bool", "mask", "nonzero", "host data", "to host",
                                  "eigh", "svd", "solve"])
def test_guard_names_the_op_that_syncs(case):
    x = torch.arange(6.0).reshape(2, 3)
    A = torch.eye(3) * 2
    op = {"item": lambda: x.sum().item(), "bool": lambda: bool((x > 0).all()),
          "mask": lambda: x[x > 2], "nonzero": lambda: torch.nonzero(x),
          "host data": lambda: torch.tensor([1.0, 2.0]),
          # a copy to the card, as dispatched (no card here to run it)
          "to host": lambda: torch.ops.aten._to_copy.default(x, device=torch.device("cuda")),
          "eigh": lambda: torch.linalg.eigh(A), "svd": lambda: torch.linalg.svd(A),
          "solve": lambda: torch.linalg.solve(A, x.T)}[case]
    with pytest.raises(GraphCaptureError, match="capturing the probe: aten::"):
        with host_sync_guard("the probe"):
            op()
    with host_sync_guard("the probe") as g:  # what a graph takes passes
        torch.where(x > 2, x, 0.0).cumsum(-1).index_select(0, torch.zeros(1, dtype=torch.long))
    assert g.last_op == "aten::index_select"


def boot(cfg, frames, lane_axis=False):
    f0, f1 = ((tvo.lane_frame_at(frames, 0), tvo.lane_frame_at(frames, 1)) if lane_axis
              else (tvo.frame_at(frames, 0), tvo.frame_at(frames, 1)))
    return tvo.bootstrap(tvo.make_generator(42), f0, f1, cfg)[0]


@pytest.mark.parametrize("case", ["one lane", "B=3 lanes", "sweep thresholds", "return_matches",
                                  "xla backend, mxu matcher"])
def test_track_step_is_capture_safe(kernels, case):
    """Every op of a tracker step is one a CUDA graph captures: no host
    read, no data-dependent size, no host-to-card copy."""
    cfg = CFG if case != "xla backend, mxu matcher" else CFG.replace(
        matcher=MatcherConfig(method="mxu"), picp=PICPConfig(backend="xla"))
    thr, kw = None, {}
    if case == "B=3 lanes":
        fr = lanes()
        state = boot(cfg, fr, lane_axis=True)
        curr, nxt = tvo.lane_frame_at(fr, 1), tvo.lane_frame_at(fr, 2)
    else:
        fr = tvo.frames_of(make_seq(), 0, F, "cpu")
        state = boot(cfg, fr)
        curr, nxt = tvo.frame_at(fr, 1), tvo.frame_at(fr, 2)
        if case == "sweep thresholds":
            thr = torch.tensor(THRESHOLDS)
            state = VOState(*(x.expand((3,) + x.shape).contiguous() for x in state))
            curr, nxt = (tvo.Frame(*(x.expand((3,) + x.shape) for x in f)) for f in (curr, nxt))
        kw = dict(return_matches=case == "return_matches")
    a0 = launches()
    with host_sync_guard(case):
        out = tvo.track_step(state, curr, nxt, cfg, thr, **kw)
    assert launches() == (a0[0] + 1, a0[1] + (cfg.matcher.method == "pallas"))
    assert len(out) == (3 if kw.get("return_matches") else 2)


@pytest.mark.parametrize("due", [False, True], ids=["track only", "with local BA"])
def test_slam_step_is_capture_safe(kernels, due):
    seq = make_seq(SLAM_CFG, frames=12)
    fr = tvo.frames_of(seq, 0, 12, "cpu")
    carry = tslam.init_carry(boot(SLAM_CFG, fr), 12, fr.uv.shape[1], SLAM_CFG)
    for i in range(8):  # past the first window
        carry, _ = tslam.slam_step(carry, tvo.frame_at(fr, i), tvo.frame_at(fr, i + 1), SLAM_CFG)
    if tslam.local_ba_due(carry.k, SLAM_CFG) != due:
        carry, _ = tslam.slam_step(carry, tvo.frame_at(fr, 8), tvo.frame_at(fr, 9), SLAM_CFG)
    assert tslam.local_ba_due(carry.k, SLAM_CFG) == due
    k = tslam._device_k(carry)
    with host_sync_guard("the SLAM step"):
        out, log = tslam._step(carry, k, tvo.frame_at(fr, carry.k - 1), tvo.frame_at(fr, carry.k),
                               SLAM_CFG, due)
    ref, ref_log = tslam.slam_step(carry, tvo.frame_at(fr, carry.k - 1),
                                   tvo.frame_at(fr, carry.k), SLAM_CFG)
    assert_same(tuple(out[:5]), tuple(ref[:5]))
    assert_same(log, ref_log)


def test_capture_of_a_host_read_raises_and_never_runs_eagerly(fake):
    """A body with a host read slipped in: the capture raises, naming the op;
    nothing falls back to the eager step."""
    fake(True)
    x = torch.ones(3)
    prog = graphs.Program("probe", dict(x=x), (x,))
    ran = []

    def body(b):
        ran.append(1)
        return b["x"] * float(b["x"].sum())

    with pytest.raises(GraphCaptureError, match=r"probe \[None\].*_local_scalar_dense"):
        prog.replay(None, body)
    assert graphs.captures == 0 and graphs.replays == 0 and not prog.graphs
    assert len(ran) == graphs.WARMUP + 1  # the warm-ups, then the capture that raised


# ---------------------------------------------------------- 2. plumbing --
def run_entry(entry, seq, fr, sweep_lanes):
    """One call of a driver; returns what it returns."""
    if entry == "make_tracker":
        s0 = boot(CFG, fr)
        return tvo.make_tracker(CFG)(s0, tvo.Frame(*(x[:-1] for x in fr)),
                                     tvo.Frame(*(x[1:] for x in fr)))
    if entry == "full_run_jit":
        return tvo.full_run_jit(tvo.make_generator(42), tvo.frame_at(fr, 0), tvo.frame_at(fr, 1),
                                tvo.Frame(*(x[:-1] for x in fr)), tvo.Frame(*(x[1:] for x in fr)),
                                CFG)
    if entry == "run_sequence":
        return tvo.run_sequence(seq, CFG, device="cpu")
    if entry == "run_sequence, log_stats off":
        return tvo.run_sequence(seq, CFG.replace(log_stats=False), device="cpu")
    if entry == "run_batch":
        return tvo.run_batch(sweep_lanes, CFG)
    if entry == "run_threshold_sweep":
        return tvo.run_threshold_sweep(seq, THRESHOLDS, CFG, device="cpu")
    if entry == "track_step_jit":
        s = boot(CFG, fr)
        out = []
        for i in range(3):
            s, lg, m = tvo.track_step_jit(s, tvo.frame_at(fr, i), tvo.frame_at(fr, i + 1), CFG,
                                          return_matches=True)
            out.append((s, lg, m))
        return out
    raise KeyError(entry)


SCAN_ENTRIES = ["make_tracker", "full_run_jit", "run_sequence", "run_sequence, log_stats off",
                "run_batch", "run_threshold_sweep", "track_step_jit"]


@pytest.mark.parametrize("entry", SCAN_ENTRIES)
def test_graphed_tracker_equals_eager(fake, entry):
    """Bit-equal to the eager loop; one capture per (cfg, shape); the second
    call captures nothing and replays once a frame; the replays credit the
    eager run's kernel launches."""
    seq = make_seq()
    fr = tvo.frames_of(seq, 0, F, "cpu")
    lanes3 = lanes()
    fake(False)
    ref = run_entry(entry, seq, fr, lanes3)
    eager_launches = launches()
    fake(True)
    tk.launches = tm.launches = 0
    got = run_entry(entry, seq, fr, lanes3)
    assert_same(got, ref, entry)
    assert launches() == eager_launches
    # the entry points that bootstrap do it through bootstrap_jit: its graph too
    boots = entry not in ("make_tracker", "track_step_jit")
    assert graphs.captures == 1 + boots
    steps = (3 if entry == "track_step_jit" else F - 1) + boots
    assert graphs.replays == steps
    tk.launches = tm.launches = 0
    again = run_entry(entry, seq, fr, lanes3)
    assert_same(again, ref, entry)
    assert graphs.captures == 1 + boots and graphs.replays == 2 * steps
    assert launches() == eager_launches


def test_scan_outputs_survive_later_calls(fake):
    """What one call returned is not overwritten by the next call's replays
    (the graph's buffers are copied out)."""
    fake(True)
    a, b = make_seq(seed=13), make_seq(seed=14)
    _, logs_a, poses_a, _ = tvo.run_sequence(a, CFG, device="cpu")
    keep = poses_a.clone(), logs_a.num_inliers.clone()
    _, _, poses_b, _ = tvo.run_sequence(b, CFG, device="cpu")
    assert graphs.captures == 2  # the bootstrap's graph and the scan's
    assert not torch.equal(poses_a, poses_b)
    assert torch.equal(poses_a, keep[0]) and torch.equal(logs_a.num_inliers, keep[1])


def test_one_capture_per_config_and_shape(fake):
    """run_sequence captures the bootstrap and the scan: one each per
    (cfg, shape); a shorter sequence shares the bootstrap's graph."""
    fake(True)
    seq = make_seq()
    tvo.run_sequence(seq, CFG, device="cpu")
    tvo.run_sequence(seq, CFG, device="cpu")
    assert graphs.captures == 2
    tvo.run_sequence(make_seq(frames=F - 2), CFG, device="cpu")    # another scan shape
    assert graphs.captures == 3
    tvo.run_sequence(seq, CFG.replace(max_new_landmarks_per_frame=16), device="cpu")
    assert graphs.captures == 5
    tvo.run_sequence(seq, CFG, device="cpu")
    assert graphs.captures == 5 and len(graphs._cache) == 5


def test_online_vo_equals_eager_and_keeps_its_poses(fake):
    """OnlineVO's graphed steps: the eager poses, each returned pose kept as
    it was; two sessions of one shape share the graph, each taking its
    state out when the other steps; a checkpoint mid-session resumes."""
    seq = make_seq()
    frame = lambda i: tvo.frame_of(seq, i, "cpu")

    def session():
        s = tvo.OnlineVO(CFG, seed=42)
        s.start(frame(0), frame(1))
        return s

    fake(False)
    e = session()
    ref = [e.step(frame(i)) for i in range(1, F)]
    fake(True)
    s1, s2 = session(), session()
    got1, got2 = [], []
    for i in range(1, F):
        got1.append(s1.step(frame(i)))
        if i % 2:
            got2.append(s2.step(frame(len(got2) + 1)))
    got1_kept = [p.clone() for p in got1]
    assert graphs.captures == 2  # the bootstrap's graph and the step's
    assert_same(got1, ref)
    assert_same(got1, got1_kept)
    assert_same(got2, ref[:len(got2)])
    assert_same(s1.state, e.state)
    assert graphs.replays == 2 + len(got1) + len(got2)


def test_online_vo_checkpoint_resume_on_the_graph(fake, tmp_path):
    seq = make_seq()
    frame = lambda i: tvo.frame_of(seq, i, "cpu")
    fake(False)
    e = tvo.OnlineVO(CFG, seed=42)
    e.start(frame(0), frame(1))
    ref = [e.step(frame(i)) for i in range(1, F)]
    fake(True)
    s = tvo.OnlineVO(CFG, seed=42)
    s.start(frame(0), frame(1))
    got = [s.step(frame(i)) for i in range(1, 5)]
    s.checkpoint(str(tmp_path / "s.npz"))
    r = tvo.OnlineVO.resume(str(tmp_path / "s.npz"), CFG, device="cpu")
    got += [r.step(frame(i)) for i in range(5, F)]
    assert_same(got, ref)
    assert graphs.captures == 2  # the bootstrap's graph and the step's


def test_chunked_with_resume_equals_eager(fake, tmp_path):
    """run_sequence_chunked on the graphs: a crash after two chunks, then a
    resume, gives the uninterrupted eager run; one capture per chunk
    length (4 and the last, 1), and the first call's bootstrap."""
    seq = make_seq()
    fake(False)
    ref_state, ref_poses, _ = tvo.run_sequence_chunked(seq, CFG, checkpoint_every=4,
                                                       device="cpu")
    fake(True)
    path = str(tmp_path / "c.npz")
    _, _, step = tvo.run_sequence_chunked(seq, CFG, checkpoint_path=path, checkpoint_every=4,
                                          max_chunks=1, device="cpu")
    assert step == 4
    state, poses, step = tvo.run_sequence_chunked(seq, CFG, checkpoint_path=path,
                                                  checkpoint_every=4, device="cpu")
    assert step == F - 1
    assert_same(poses, ref_poses)
    assert_same(state, ref_state)
    assert graphs.captures == 3 and graphs.replays == 1 + F - 1


def test_graphed_slam_equals_eager(fake):
    """run_sequence_slam and OnlineSLAM on the two SLAM graphs (with and
    without the local BA) after the bootstrap's: the eager carry, logs and
    poses bit for bit, two captures each and one for the bootstrap (which
    both share), one replay a frame, the eager launches."""
    n = 12
    seq = make_seq(SLAM_CFG, frames=n)
    fake(False)
    ref = tslam.run_sequence_slam(seq, SLAM_CFG, device="cpu")
    eager_launches = launches()
    e = tslam.OnlineSLAM(SLAM_CFG, max_frames=n)
    e.start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    e_poses = [e.step(tvo.frame_of(seq, i, "cpu")) for i in range(1, n)]
    fake(True)
    tk.launches = tm.launches = 0
    got = tslam.run_sequence_slam(seq, SLAM_CFG, device="cpu")
    assert_same(got, ref)
    assert launches() == eager_launches
    assert ref[3]["n_local_ba_runs"] > 0
    assert graphs.captures == 3 and graphs.replays == n
    s = tslam.OnlineSLAM(SLAM_CFG, max_frames=n)
    s.start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    s_poses = [s.step(tvo.frame_of(seq, i, "cpu")) for i in range(1, n)]
    assert_same(s_poses, e_poses)
    assert_same(s.poses, e.poses)
    assert_same(s.carry, e.carry)
    assert s.n_local_ba_runs == e.n_local_ba_runs and s.frame_count == n
    assert graphs.captures == 5
    with pytest.raises(RuntimeError, match="max_frames"):
        s.step(tvo.frame_of(seq, 1, "cpu"))


# ------------------------------------------------------------- 3. vs JAX --
@pytest.mark.parametrize("branch", ["plain", "kernel-options"])
def test_graphed_slam_step_from_jax_carry(fake, branch):
    """``slam_step_jit`` on the (fake) graphs from JAX's carry, each step,
    against JAX's ``slam_step_jit``: on frames with the local BA and
    without, at test_torch_slam's tolerances (pose and window 1e-4, counts
    exact, landmarks 2e-3)."""
    jc, tc = slam_cfgs(**({"matcher": "pallas", "picp": "pallas"} if branch != "plain" else {}))
    seq = slam_fixture(jc)
    sj, _ = jvo.bootstrap_jit(jax.random.PRNGKey(42), jvo.frame_of(seq, 0), jvo.frame_of(seq, 1),
                              jc)
    carry = jax_carry(sj, jc, seq.uv.shape[1])
    frames = tvo.frames_of(seq, 0, 14, "cpu")
    fake(True)
    fired = []
    for i in range(13):
        ct = tslam.carry_from_numpy(carry, "cpu")
        cj2, lj = jslam.slam_step_jit(carry, jvo.frame_of(seq, i), jvo.frame_of(seq, i + 1), jc)
        ct2, lt = tslam.slam_step_jit(ct, tvo.frame_at(frames, i), tvo.frame_at(frames, i + 1), tc)
        fired.append(tslam.local_ba_due(ct.k, tc))
        np.testing.assert_allclose(lt.pose.numpy(), np.asarray(lj.pose), atol=1e-4,
                                   err_msg=f"step {i}")
        for k in COUNTS:
            assert int(getattr(lt, k)) == int(getattr(lj, k)), (i, k)
        assert ct2.k == int(cj2[6]) and ct2.n_ba == int(cj2[5])
        bv = np.asarray(cj2[3])
        assert np.array_equal(ct2.buf_valid.numpy(), bv), i
        assert np.array_equal(ct2.buf_lm.numpy()[bv], np.asarray(cj2[2])[bv]), i
        v = np.asarray(cj2[0].map_valid)
        assert np.array_equal(ct2.state.map_valid.numpy(), v), i
        np.testing.assert_allclose(ct2.state.map_xyz.numpy()[v], np.asarray(cj2[0].map_xyz)[v],
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(ct2.poses_all.numpy(), np.asarray(cj2[1]), atol=1e-4,
                                   err_msg=f"step {i}")
        carry = cj2
    assert any(fired) and not all(fired)
    assert graphs.captures == 2 and graphs.replays == 13


# ------------------------------------------- 4. the pose graph's LM iteration --
def pose_graph(seed=5, n=40, extra=60, outliers=8):
    """A perturbed pose graph: odometry and ``extra`` random loop edges, the
    first ``outliers`` of them corrupted, on which the LM keeps some steps
    and rolls others back under either threshold."""
    rng = np.random.default_rng(seed)
    xi = torch.as_tensor(0.05 * rng.standard_normal((n, 6)).astype(np.float32))
    poses = tlie.se3_exp(xi)
    ij, T, w = tpg.odometry_edges(poses)
    ex = torch.as_tensor(rng.integers(0, n, (extra, 2)))
    Tx = tlie.inv_se3(poses[ex[:, 0]]) @ poses[ex[:, 1]]
    bad = tlie.se3_exp(torch.as_tensor(rng.standard_normal((outliers, 6)).astype(np.float32)))
    Tx = torch.cat([bad @ Tx[:outliers], Tx[outliers:]])
    return tpg.PoseGraph(tlie.se3_exp(0.5 * xi) @ poses, torch.cat([ij, ex]), torch.cat([T, Tx]),
                         torch.cat([w, torch.ones(extra)]), torch.arange(n) == 0)


def check_pgo_record(its, graph, out, iterations):
    """``pgo_solve``'s record: iterations + 1 states of poses, lam and chi,
    from the input to the output, no two sharing storage, with kept and
    rolled-back steps among them."""
    assert len(its) == iterations + 1
    assert all(set(e) == {"poses", "lam", "chi"} for e in its)
    ptrs = [t.untyped_storage().data_ptr() for e in its for t in e.values()]
    assert len(set(ptrs)) == len(ptrs)
    assert torch.equal(its[0]["poses"], graph.poses) and torch.equal(its[-1]["poses"], out.poses)
    kept = [bool(b["lam"] < a["lam"]) for a, b in zip(its, its[1:])]
    assert any(kept) and not all(kept)


def test_guard_passes_a_conversion_to_meta():
    """functorch's shape propagation converts to ``meta`` inside a jvp: no
    bytes move, and the guard lets it pass; a copy between the host and
    the card is still named (read from ``_sync_reason`` itself: no card
    here)."""
    x = torch.ones(3)
    with host_sync_guard("the probe") as g:
        x.to("meta")
        x.to(device="meta", dtype=torch.float64)
    assert g.last_op.startswith("aten::")
    to_copy = torch.ops.aten._to_copy.default
    assert graphs._sync_reason(to_copy, (x,), {"device": torch.device("meta")}) is None
    for dev in ("cuda", "cuda:0"):
        for card in (False, True):
            assert (graphs._sync_reason(to_copy, (x,), {"device": torch.device(dev)}, card)
                    == "copies between the host and the card")


def test_guard_of_a_card_capture_passes_host_arithmetic():
    """Guarding a capture on the card, an op on CPU tensors alone stays on
    the host and cannot sync with the card (functorch's ``jacfwd`` counts
    its basis's offsets in a CPU tensor in some torch versions): it
    passes, and a copy to the card does not.  Guarding CPU tensors, every
    op is checked as if on the card."""
    n = torch.tensor([6, 6])
    host = [(torch.ops.aten.lift_fresh.default, (n,), {}),
            (torch.ops.aten._local_scalar_dense.default, (n[0],), {}),
            (torch.ops.aten.zeros.default, ([3],), {"device": torch.device("cpu")})]
    for func, args, kw in host:
        assert graphs._sync_reason(func, args, kw, card=True) is None, func
    assert graphs._sync_reason(*host[0], card=False) == "makes a tensor from host data"
    assert graphs._sync_reason(*host[1], card=False) == "reads a device value on the host"
    assert (graphs._sync_reason(torch.ops.aten._to_copy.default, (n,),
                                {"device": torch.device("cuda")}, card=True)
            == "copies between the host and the card")


@pytest.mark.parametrize("thr", [1.0e8, 1.0], ids=["L2", "robust"])
def test_pgo_solve_is_capture_safe(thr):
    """A whole ``pgo_solve`` (its plans, first chi and LM iterations) runs
    under the guard: the LM iteration stays capturable.  Its record."""
    g = pose_graph()
    rec = {}
    with host_sync_guard("the pose graph's solve"):
        out, stats = tpg.pgo_solve(g, iterations=12, kernel_threshold=thr, record=rec)
    check_pgo_record(rec["iterations"], g, out, 12)
    assert torch.equal(stats.chi, rec["iterations"][-1]["chi"])


def test_graphed_pgo_solve_equals_eager(fake):
    """``pgo_solve`` on the (fake) graph: the eager poses, chi, inlier
    count and every recorded iteration bit for bit; one capture per
    threshold, one replay an iteration; a second graph of the same shapes
    with other loop pairs replays the same capture with its own plans."""
    graphs_ = [pose_graph(5), pose_graph(6)]
    for thr in (1.0e8, 1.0):
        for g in graphs_:
            fake(False)
            rec_e = {}
            ref = tpg.pgo_solve(g, iterations=12, kernel_threshold=thr, record=rec_e)
            fake(True)
            rec_g = {}
            got = tpg.pgo_solve(g, iterations=12, kernel_threshold=thr, record=rec_g)
            assert_same(got, ref, f"thr {thr}")
            assert_same(rec_g, rec_e, f"thr {thr}")
            check_pgo_record(rec_g["iterations"], g, got[0], 12)
    assert not torch.equal(graphs_[0].edges_ij, graphs_[1].edges_ij)
    assert graphs.captures == 2 and graphs.replays == 4 * 12


def test_close_loops_replays_its_pgo(fake):
    """``close_loops`` with its two PGO passes on the (fake) graphs: the
    eager result and record bit for bit, two captures on the first call
    and none on the second, one replay per LM iteration (60 + 20)."""
    from test_torch_loop import KT, T, loop_fixture
    from tpuvo_torch.ba import loop as tloop

    seq, world, _, drifted, obs_lm = loop_fixture()
    args = (drifted, world.xyz, np.ones(world.xyz.shape[0], bool), seq.uv, obs_lm, seq.valid)
    fake(False)
    rec_e = {}
    ref = tloop.close_loops(KT, *map(T, args), 640, 480, record=rec_e)
    fake(True)
    for call in range(2):
        c0, r0 = graphs.captures, graphs.replays
        rec_g = {}
        got = tloop.close_loops(KT, *map(T, args), 640, 480, record=rec_g)
        assert_same(got, ref)
        assert_same(rec_g, rec_e)
        assert graphs.captures - c0 == (2 if call == 0 else 0)
        assert graphs.replays - r0 == 60 + 20
    assert int(ref[1]) > 0
