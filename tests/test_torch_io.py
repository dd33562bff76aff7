"""tpuvo_torch's data layer vs tpuvo's (CPU): the `.dat` parsers (the port's
native and Python parsers against the JAX package's), ``from_camera_dat``,
``make_kitti_like_trajectory`` and the dataset writer.

The bundled dataset is not in the repository, so the datasets are written
by ``tpuvo_torch.data.writer`` from ``tpuvo_torch.data.synthetic``.  Every
comparison is exact: ``%.9g`` keeps every float32.
"""

import dataclasses
import os

import numpy as np
import pytest

from tpuvo.config import EngineConfig as JCfg
from tpuvo.data import loader as jloader, native as jnative, synthetic as jsynthetic
from tpuvo_torch.config import EngineConfig
from tpuvo_torch.data import loader, native, synthetic
from tpuvo_torch.data.writer import differing_fields, write_camera, write_dataset
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

FRAMES = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(dir, the rendered sequence, its world): 8 frames, 128 observations a
    frame (0.3 px noise, so uv carries full float32 mantissas)."""
    cfg = EngineConfig()
    world = synthetic.make_world(3, n_landmarks=1000, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(FRAMES, seed=3)
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3, descriptor_noise=0.01, seed=3)
    d = write_dataset(str(tmp_path_factory.mktemp("ds")), seq, world, cfg)
    return d, seq, world


def test_writer_round_trip(dataset):
    """Both port parsers give back the rendered arrays exactly."""
    d, seq, _ = dataset
    assert seq.n_obs.min() > 0 and seq.n_obs.max() == 128
    for use_native in (True, False):
        got = loader.load_sequence(d, FRAMES, use_native=use_native)
        assert differing_fields(seq, got) == [], use_native
        for a, b in zip(got, seq):
            assert a.dtype == b.dtype and a.shape == b.shape


def test_parsers_match_jax(dataset):
    """parse_measurement and load_sequence: JAX's Python parser (and JAX's
    native one where csrc/libtpuvo_io.so loads) against the port's Python
    and native parsers — all eight arrays exactly equal."""
    d, _, _ = dataset
    for i in (0, FRAMES - 1):
        path = os.path.join(d, f"meas-{i:05d}.dat")
        pj, pt = jloader.parse_measurement(path), loader.parse_measurement(path)
        assert pj[0] == pt[0] == i
        for a, b in zip(pj[1:], pt[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ref = jloader.load_sequence(d, FRAMES, use_native=False)
    ours = [loader.load_sequence(d, FRAMES, use_native=u) for u in (True, False)]
    jax_native = [jnative.load_sequence(d, FRAMES, "meas-", 128)] if jnative.available() else []
    for got in ours + jax_native:
        assert differing_fields(ref, got) == []


def test_load_world_points_skips_bad_lines(dataset, tmp_path):
    d, _, world = dataset
    with open(os.path.join(d, "world.dat")) as f:
        lines = f.read().splitlines()
    bad = ["", "7 1.0 2.0", "8 1 2 3 x 0 0 0 0 0 0 0 0 0", "   ", "9 " + " ".join(["1"] * 12)]
    path = tmp_path / "world.dat"
    path.write_text("\n".join(lines[:5] + bad + lines[5:]) + "\n")
    wj, wt = jloader.load_world_points(str(path)), loader.load_world_points(str(path))
    for a, b in zip(wj, wt):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(wt.ids, world.ids)
    assert np.array_equal(wt.xyz, world.xyz) and np.array_equal(wt.desc, world.desc)


def test_load_trajectory(dataset):
    d, seq, _ = dataset
    path = os.path.join(d, "trajectoy.dat")
    (oj, gj), (ot, gt) = jloader.load_trajectory(path), loader.load_trajectory(path)
    assert np.array_equal(oj, ot) and np.array_equal(gj, gt)
    assert np.array_equal(gt, seq.gt_pose) and np.array_equal(ot, seq.odom_pose)


@pytest.mark.parametrize("overrides", [{}, {"mode": "fixed"}, {"mode": "parity", "max_obs": 64}])
def test_from_camera_dat_matches_jax(dataset, tmp_path, overrides):
    """Field for field against the JAX package, on the written camera.dat
    and on one with another camera."""
    d, _, _ = dataset
    other = EngineConfig(fx=200.5, fy=190.25, cx=300.0, cy=250.0, width=800, height=600,
                         z_far=7.5, cam_to_image_translation=(0.3, -0.1, 0.05))
    write_camera(str(tmp_path / "camera.dat"), other)
    paths = [os.path.join(d, "camera.dat"), str(tmp_path / "camera.dat")]
    for path in paths:
        cj = JCfg.from_camera_dat(path, **overrides)
        ct = loader.load_camera_config(path, **overrides)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.K()[0, 0] == 200.5 and ct.cam_to_image_translation == (
        np.float32(0.3), np.float32(-0.1), np.float32(0.05))


def test_max_obs_overflow_raises_in_both(dataset):
    d, seq, _ = dataset
    with pytest.raises(ValueError) as ej:
        jloader.load_sequence(d, FRAMES, max_obs=64)
    for use_native in (True, False):
        with pytest.raises(ValueError) as et:
            loader.load_sequence(d, FRAMES, max_obs=64, use_native=use_native)
        assert str(et.value) == str(ej.value)
    assert "128 observations exceeds max_obs=64" in str(ej.value)


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """The native parser with an empty build directory and no cached
    library (restored afterwards)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    yield
    native.library.cache_clear()


def test_missing_compiler_warns_not_silent(dataset, fresh_native, monkeypatch):
    """No compiler: one warning naming the reason, then the Python parser
    (the same arrays); no second warning from the cached answer."""
    d, seq, _ = dataset
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    with pytest.warns(RuntimeWarning, match="no C\\+\\+ compiler.*no-such-c\\+\\+-compiler"):
        got = loader.load_sequence(d, FRAMES)
    assert differing_fields(seq, got) == []
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.library() is None


def test_failed_build_raises(fresh_native, monkeypatch):
    monkeypatch.setenv("CXX", "false")  # a compiler that exits 1
    with pytest.raises(RuntimeError, match="false failed on loader.cpp"):
        native.library()


def test_native_parse_error_raises(dataset, tmp_path):
    with pytest.raises(OSError, match="cannot read"):
        native.load_sequence(str(tmp_path), 1, "meas-", 128)  # no such file


@pytest.mark.parametrize("n,seed", [(300, 0), (500, 7), (120, 3)])
def test_kitti_like_trajectory_matches_jax(n, seed):
    a, b = jsynthetic.make_kitti_like_trajectory(n, seed=seed), synthetic.make_kitti_like_trajectory(n, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_native_available_matches_jax():
    """available() says whether the parser library can be used: built from
    the same source, it is there wherever the JAX package's is."""
    assert native.available() is (native.library() is not None)
    if jnative.available():
        assert native.available()
