"""tpuvo_torch.engine.slam vs tpuvo.engine.slam: ``slam_step`` teacher-forced
from JAX's own carry (``carry_from_numpy``) on a 24-frame, 1024-slot
KITTI-scale fixture with a 6-frame window, so the local BA fires on most
steps; the port's streaming and batch entry points; the evict-age guard.

Tolerances (per step, same input carry): the tracked pose and, after a
local BA, the window's corrected poses atol 1e-4 (fp32 GN and BA, sums in
another order; readings at most 5.7e-6); every count exact; landmarks
rtol/atol 2e-3 (triangulated tens of meters out; readings at most 9.0e-4
relative).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.config import EngineConfig as JCfg, MatcherConfig as JMatcher, PICPConfig as JPICP
from tpuvo.data import synthetic
from tpuvo.engine import slam as jslam, vo as jvo
from tpuvo_torch.config import EngineConfig, MatcherConfig, PICPConfig
from tpuvo_torch.engine import slam as tslam, state as tstate, vo as tvo
from tpuvo_torch.ops import lie as tlie
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

F = 24
COUNTS = ("num_inliers", "n_map_matches", "n_frame_matches", "n_new_points", "map_count")


def both_cfgs(matcher="mxu", picp="xla", **kw):
    base = dict(mode="fixed", n_frames=F, map_capacity=1024, fuse_frame_matchers=True,
                local_ba_window=6, local_ba_every=2, local_ba_iterations=4, **kw)
    # JAX's Pallas PICP has no CPU mode: its XLA solver is the same math
    j = JCfg(matcher=JMatcher(method=matcher), picp=JPICP(convergence_threshold=1e-4), **base)
    t = EngineConfig(matcher=MatcherConfig(method=matcher),
                     picp=PICPConfig(convergence_threshold=1e-4, backend=picp), **base)
    return j, t


def fixture(cfg, seed=7):
    gt = synthetic.make_loop_trajectory(200, step=1.0, seed=seed)[:F]
    ext = float(np.abs(gt[:, :2]).max()) + 15.0
    world = synthetic.make_world(seed, n_landmarks=4000, xy_extent=ext, z_range=(0.0, 8.0))
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3, seed=seed)


def jax_carry(state, cfg, N):
    Nb = N + cfg.max_new_landmarks_per_frame
    R = cfg.local_ba_window * cfg.local_ba_stride
    return (state, jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (F, 4, 4)).copy(),
            jnp.zeros((R, Nb), jnp.int32), jnp.zeros((R, Nb), bool),
            jnp.zeros((R, Nb, 2), jnp.float32), jnp.int32(0), jnp.int32(1))


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("branch", ["plain", "kernel-options"])
def test_slam_step_from_jax_carry(branch):
    """Every step starts from JAX's carry; the port's step reproduces
    JAX's (pose, logs, ring buffers, map, and the BA-corrected window).
    "kernel-options" runs the port with both kernels' options (their plain
    versions on the CPU) against JAX's Pallas matcher in interpret mode."""
    jc, tc = both_cfgs(**({"matcher": "pallas", "picp": "pallas"} if branch != "plain" else {}))
    seq = fixture(jc)
    sj, _ = jvo.bootstrap_jit(jax.random.PRNGKey(42), jvo.frame_of(seq, 0), jvo.frame_of(seq, 1), jc)
    carry = jax_carry(sj, jc, seq.uv.shape[1])
    frames = tvo.frames_of(seq, 0, F, "cpu")
    R = tc.local_ba_window
    n_ba = 0
    for i in range(F - 1):
        ct = tslam.carry_from_numpy(carry, "cpu")
        cj2, lj = jslam.slam_step_jit(carry, jvo.frame_of(seq, i), jvo.frame_of(seq, i + 1), jc)
        ct2, lt = tslam.slam_step(ct, tvo.frame_at(frames, i), tvo.frame_at(frames, i + 1), tc)
        fired = ct.k >= R and ct.k % 2 == 0
        n_ba += fired
        np.testing.assert_allclose(lt.pose.numpy(), np.asarray(lj.pose), atol=1e-4,
                                   err_msg=f"step {i}")
        for k in COUNTS:
            assert int(getattr(lt, k)) == int(getattr(lj, k)), (i, k)
        assert ct2.k == int(cj2[6]) and ct2.n_ba == int(cj2[5]) == n_ba
        bv = np.asarray(cj2[3])  # ring buffers: validity, ids where valid, pixels
        assert np.array_equal(ct2.buf_valid.numpy(), bv), i
        assert np.array_equal(ct2.buf_lm.numpy()[bv], np.asarray(cj2[2])[bv]), i
        np.testing.assert_allclose(ct2.buf_uv.numpy(), np.asarray(cj2[4]), atol=1e-6)
        for k in ("map_valid", "map_id_real", "map_count", "map_desc"):
            assert np.array_equal(to_np(getattr(ct2.state, k)), to_np(getattr(cj2[0], k))), (i, k)
        v = np.asarray(cj2[0].map_valid)
        np.testing.assert_allclose(ct2.state.map_xyz.numpy()[v], np.asarray(cj2[0].map_xyz)[v],
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(ct2.poses_all.numpy(), np.asarray(cj2[1]), atol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(ct2.state.pose.numpy(), np.asarray(cj2[0].pose), atol=1e-4)
        carry = cj2
    assert n_ba == len([k for k in range(1, F) if k >= R and k % 2 == 0]) > 5


def test_online_slam_matches_batch_and_carry_round_trip():
    """OnlineSLAM and run_sequence_slam run the same slam_step: the same
    poses, bit for bit; the numpy converters round-trip a carry."""
    _, tc = both_cfgs()
    seq = fixture(tc)
    n = 14
    sub = type(seq)(*[np.asarray(a)[:n] for a in seq])
    state, logs, poses, diag = tslam.run_sequence_slam(sub, tc, seed=42, device="cpu")
    assert diag["n_local_ba_runs"] == len([k for k in range(1, n) if k >= 6 and k % 2 == 0])
    assert torch.isfinite(poses).all() and logs.pose.shape == (n - 1, 4, 4)
    s = tslam.OnlineSLAM(tc, max_frames=n, seed=42)
    s.start(tvo.frame_of(sub, 0, "cpu"), tvo.frame_of(sub, 1, "cpu"))
    for i in range(1, n):
        s.step(tvo.frame_of(sub, i, "cpu"))
    assert torch.equal(s.poses, poses)
    assert s.n_local_ba_runs == diag["n_local_ba_runs"] and s.frame_count == n
    with pytest.raises(RuntimeError, match="max_frames"):
        s.step(tvo.frame_of(sub, 1, "cpu"))
    back = tslam.carry_from_numpy(tslam.carry_to_numpy(s._carry), "cpu")
    for a, b in zip(back, s._carry):
        if isinstance(a, int):
            assert a == b
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_slam_strided_window_slots():
    """local_ba_stride=2: the window is every 2nd frame back from k, read
    from ring slots f % R by gathers at a device k — the frames and slots
    of JAX's ``idxs = k - S·(W-1-i)`` and its gather of ``idxs % R``."""
    cfg = EngineConfig(local_ba_window=4, local_ba_stride=2, map_capacity=16)
    W, S, R, F = 4, 2, 8, 40
    state = tstate.empty_state(cfg, "cpu")
    for k in range(R, F - 1):
        carry = tslam.SLAMCarry(
            state, tlie.se3_exp(torch.arange(F, dtype=torch.float32)[:, None] * torch.ones(6) * 1e-2),
            torch.arange(R)[:, None].expand(R, 3).clone(), torch.ones((R, 3), dtype=torch.bool),
            torch.zeros((R, 3, 2)), 0, k)
        prob, win = tslam.local_ba_problem(carry, cfg)
        idxs = k - S * (W - 1 - np.arange(W))
        assert np.array_equal(np.arange(F)[win], idxs), k
        assert np.array_equal(prob.obs_lm[:, 0].numpy(), idxs % R), k
        torch.testing.assert_close(prob.poses, tlie.inv_se3(carry.poses_all[idxs]))
        assert tslam.local_ba_due(k, cfg) == (k % 2 == 0)
    assert not tslam.local_ba_due(R - 2, cfg)


def test_check_evict_age_raises():
    cfg = EngineConfig(mode="fixed", local_ba_window=8, local_ba_stride=4, local_ba_every=2,
                       map_evict_age=20)
    with pytest.raises(ValueError, match="ring"):
        tslam._check_evict_age(cfg)
    seq = fixture(cfg)
    with pytest.raises(ValueError, match="ring"):
        tslam.run_sequence_slam(seq, cfg, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tslam.OnlineSLAM(cfg).start(tvo.frame_of(seq, 0, "cpu"), tvo.frame_of(seq, 1, "cpu"))
    tslam._check_evict_age(cfg.replace(map_evict_age=35))  # beyond the horizon: fine
    tslam._check_evict_age(cfg.replace(map_evict_age=0))   # eviction off: fine


@pytest.mark.parametrize("entry", ["run_sequence", "run_sequence_slam", "frames_of", "frame_of"])
def test_entry_points_default_to_the_card(entry):
    """The port's entry points run on the card unless the caller asks for
    the CPU; without a card a call with the default device raises, it never
    falls back to the CPU."""
    fn = {"run_sequence": tvo.run_sequence, "run_sequence_slam": tslam.run_sequence_slam,
          "frames_of": tvo.frames_of, "frame_of": tvo.frame_of}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    _, cfg = both_cfgs()
    seq = fixture(cfg)
    args = {"frames_of": (seq, 0, 2), "frame_of": (seq, 0)}.get(entry, (seq, cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)


def test_local_ba_cfg_matches_jax():
    jc, tc = both_cfgs()
    assert dataclasses.asdict(tslam._local_ba_cfg(tc)) == dataclasses.asdict(jslam._local_ba_cfg(jc))
