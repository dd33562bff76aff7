"""Kernel D (``csrc/segsum.cu``, ``ops/cuda/segsum``): the BA's and the pose
graph's fixed-order segment sums.

On the CPU: the plain path is the gather and ``torch.segment_reduce`` bit
for bit, entries that are all +-0.0 leave such a sum's bits unchanged (what
the kernel's design rests on), the wrapper's checks, and the skew of the
SLAM cell's local-BA plans (one inert segment of zeros holds most entries).
On the card (``cuda`` marker; this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_segsum.py

the kernel is bit-equal to ``torch.segment_reduce(values[order], ...)``,
eager and in a captured graph, on random plans and on the cell's own; a
``ba_solve`` and a 200-frame SLAM sequence give the bits of the plain sums.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from tpuvo_torch.ba import assembly
from tpuvo_torch.ops.cuda import segsum
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(3, 3), (3,), (6, 3), (6, 6), (6,)]
LONG = 4500  # entries of the long, mostly zero segment (the local BA's inert slot: ~4,400)


def parent_sum(values, p):
    """The sums as the port computed them before kernel D: the gather in
    plan order, then ``torch.segment_reduce`` over the segment lengths."""
    return torch.segment_reduce(values[p.order], "sum", lengths=p.bounds.diff(), axis=0,
                                unsafe=True)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def skewed_case(shape, n=12_000, n_targets=700, seed=0, device="cpu"):
    """(values (n, *shape), plan): random targets with a few left empty, a
    LONG-entry segment (target n_targets - 1) of zeros with a few nonzero
    entries among them, and values holding NaN, +0.0 and -0.0 (whole
    entries and single columns)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n_targets - 1, (n,), generator=g)
    idx[(idx == 3) | (idx == 4) | (idx == n_targets - 2)] = 5  # empty targets
    inert = torch.randperm(n, generator=g)[:LONG]
    idx[inert] = n_targets - 1
    vals = torch.randn(n, *shape, generator=g)
    flat = vals.reshape(n, -1)
    flat[inert] = 0.0
    flat[inert[::7]] = -0.0
    flat[inert[3::500], 0] = 1.5                      # a few nonzero entries in the long segment
    flat[:50, 0] = -0.0                                # single -0.0 columns
    flat[50:60] = -0.0                                 # whole -0.0 entries
    flat[60, -1] = float("nan")
    flat[inert[10], -1] = float("nan")                 # a NaN among the zeros
    flat[61, 0] = float("inf")
    return vals.to(device), assembly.plan(idx.to(device), n_targets)


# ------------------------------------------------------------- CPU side --
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_path_is_the_gather_and_segment_reduce(shape):
    """On the CPU ``assembly.segment_sum`` is the parent's expression bit for
    bit (NaN, +-0.0, empty targets and a long segment included)."""
    vals, p = skewed_case(shape)
    n0 = segsum.launches
    got = assembly.segment_sum(vals, p)
    assert segsum.launches == n0
    assert same_bits(got, parent_sum(vals, p))
    assert same_bits(got[3], torch.zeros(shape))  # an empty target is +0.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_zero_entries_leave_the_ordered_sum_unchanged(shape):
    """What kernel D rests on: an ordered sum from +0.0 is never -0.0, so the
    entries whose values are all +-0.0 can be left out of its plan without
    moving a bit, NaN and inf included."""
    vals, p = skewed_case(shape, seed=1)
    flat = vals.reshape(vals.shape[0], -1)
    keep = (flat[p.order] != 0).any(1)  # NaN != 0
    targets = torch.repeat_interleave(torch.arange(p.bounds.numel() - 1), p.bounds.diff())
    short = assembly.plan(targets[keep], p.bounds.numel() - 1)
    short = short._replace(order=p.order[keep][short.order])
    assert int(keep.sum()) < vals.shape[0] - LONG // 2
    assert same_bits(parent_sum(vals, short), parent_sum(vals, p))


def test_prepare_checks_its_inputs():
    """The wrapper raises on the CPU (the kernel runs on the card only), on
    a dtype or layout it does not take and on a plan of another length."""
    vals, p = skewed_case((3, 3), n=64, n_targets=8)
    for args, what in (((vals, p.order, p.bounds), "on cpu"),
                       ((vals.double(), p.order, p.bounds), "float32"),
                       ((vals, p.order.int(), p.bounds), "int64"),
                       ((vals.transpose(1, 2), p.order, p.bounds), "contiguous"),
                       ((vals, p.order[:-1], p.bounds), "entries")):
        with pytest.raises(ValueError, match=what):
            segsum.prepare(*args)


def cell_local_ba(frames=40):
    """The SLAM cell's configuration (``vobench/configs/kitti_loop200.json``)
    and the local-BA problems an ``OnlineSLAM`` session solves over its first
    ``frames`` frames on the CPU: [(problem, K, width, height, BAConfig)]."""
    from tpuvo_torch.engine import slam, vo
    from vobench import gen, program

    config = json.loads((ROOT / "vobench" / "configs" / "kitti_loop200.json").read_text())
    cfg = program.engine_config(config)
    batch = gen.to_device(gen.problems(gen.sequence(config), 1, 0.1, seed=1), "cpu")
    frame = lambda i: vo.Frame(*(batch[k][0, i] for k in vo.Frame._fields))
    calls = []
    solve = slam.ba_solve

    def recorded(*args, **kw):
        calls.append(args)
        return solve(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(slam, "ba_solve", recorded)
        s = slam.OnlineSLAM(cfg, max_frames=frames, seed=3)
        s.start(frame(0), frame(1))
        for i in range(2, frames):
            s.step(frame(i))
    return cfg, calls


@pytest.fixture(scope="module")
def cell_problems():
    return cell_local_ba()


def linearized_sums(problem, K, width, height, ba_cfg):
    """[(values, plan)] of one ``linearize_ba`` of the (compacted) problem, as
    ``ba_solve`` hands them to ``assembly.segment_sum``."""
    from tpuvo_torch.ba import window

    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(assembly, "segment_sum", lambda v, p: seen.append((v, p)) or parent_sum(v, p))
        window.ba_solve(problem, K, width, height, dataclasses.replace(ba_cfg, iterations=1))
    return seen


def test_the_cells_local_ba_plans_have_one_long_segment_of_zeros(cell_problems):
    """The mechanism kernel D answers: in the cell's local BA (16 frames x
    432 slots, compacted to 512 landmarks) the inert last slot collects
    every invalid observation, far more entries than any landmark, and
    every one of its entries is an exact zero."""
    cfg, calls = cell_problems
    assert len(calls) >= 10
    (values, by_lm), (_, _), (wfl, by_lm_frame) = linearized_sums(*calls[-1])
    lengths = by_lm.bounds.diff()
    n = values.shape[0]
    assert n == cfg.local_ba_window * (cfg.max_obs + cfg.max_new_landmarks_per_frame)
    assert by_lm.bounds.numel() - 1 == cfg.local_ba_compact_cap
    inert = cfg.local_ba_compact_cap - 1
    assert int(lengths.argmax()) == inert and int(lengths[inert]) > n // 3
    assert int(lengths[inert]) > 10 * int(lengths[:inert].max())
    rows = by_lm.order[by_lm.bounds[inert]:]
    assert not values[rows].any() and not wfl[rows].any()


# ------------------------------------------------------------ card side --
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_segsum.py` on the card")
    return torch.device("cuda")


def on(dev, p):
    return type(p)(*(x.to(dev) for x in p))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_d_is_segment_reduce_bit_for_bit(dev, shape):
    """Kernel D against the parent's gather + ``torch.segment_reduce`` on the
    card: NaN, +-0.0, inf, empty targets and a 4,500-entry segment of mostly
    zeros; one launch; the same bits inside a captured graph."""
    vals, p = skewed_case(shape, device=dev)
    ref = parent_sum(vals, p)
    n0 = segsum.launches
    got = assembly.segment_sum(vals, p)
    assert segsum.launches == n0 + 1
    assert same_bits(got, ref)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assembly.segment_sum(vals, p)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = assembly.segment_sum(vals, p)
    out.fill_(7.0)
    graph.replay()
    torch.cuda.synchronize()
    assert same_bits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no entries", "one target", "1.6M near-empty targets",
                                  "wide rows (cols 100)", "long dense segment",
                                  "unaligned base (cols 36)"])
def test_kernel_d_shapes(dev, case):
    """The plan's shapes the launch adapts to: no entries at all (every
    target +0.0), one target, the global sweep's 1.6M targets over 25,600
    entries, a column count compiled without a constant, a segment of 5,000
    nonzero entries (a chain across three tiles), and values whose base is
    4 bytes off the vector loads' alignment."""
    g = torch.Generator().manual_seed(7)
    n, T, shape = dict(**{"no entries": (0, 50, (6, 3)), "one target": (3000, 1, (3, 3)),
                          "1.6M near-empty targets": (25_600, 8192 * 200, (6, 3)),
                          "wide rows (cols 100)": (4000, 300, (100,)),
                          "long dense segment": (5000, 2, (6,)),
                          "unaligned base (cols 36)": (3000, 400, (6, 6))})[case]
    idx = torch.randint(0, T, (n,), generator=g)
    if case == "long dense segment":
        idx[:] = 1
    vals, p = torch.randn(n, *shape, generator=g).to(dev), assembly.plan(idx.to(dev), T)
    if case == "unaligned base (cols 36)":
        vals = torch.cat([torch.zeros(1, device=dev), vals.reshape(-1)])[1:].view(vals.shape)
        assert vals.is_contiguous() and vals.data_ptr() % 16 == 4
    got = assembly.segment_sum(vals, p)
    assert same_bits(got, parent_sum(vals, p))
    if case == "no entries":
        assert same_bits(got, torch.zeros(T, *shape, device=dev))


@pytest.mark.cuda
def test_kernel_d_rejects_bad_inputs_on_card(dev):
    """A CPU/CUDA mix, another dtype, a non-contiguous tensor: each raises,
    with no fallback."""
    vals, p = skewed_case((6, 3), n=256, n_targets=16, device=dev)
    for args, what in (((vals, p.order.cpu(), p.bounds), "on cpu"),
                       ((vals, p.order, p.bounds.cpu()), "on cpu"),
                       ((vals.half(), p.order, p.bounds), "float32"),
                       ((vals, p.order, p.bounds.int()), "int64"),
                       ((vals.transpose(1, 2), p.order, p.bounds), "contiguous"),
                       ((vals, p.order[::2], p.bounds), "entries")):
        with pytest.raises(ValueError, match=what):
            segsum.segment_sum(*args)


@pytest.mark.cuda
def test_kernel_d_on_the_cells_local_ba(dev, cell_problems):
    """The cell's local-BA problems moved to the card: each of their sums
    (Hll, bl by landmark, Wfl by landmark and frame) is the parent's bit for
    bit; ``ba_solve`` gives the bits it gives with the plain sums patched in,
    and launches kernel D three times an LM iteration."""
    from tpuvo_torch.ba import window

    cfg, calls = cell_problems
    for problem, K, width, height, ba_cfg in calls[-3:]:
        args = (on(dev, problem), K.to(dev), width, height, ba_cfg)
        sums = linearized_sums(*args)
        assert len(sums) == 3
        for values, p in sums:
            assert same_bits(segsum.segment_sum(values, p.order, p.bounds), parent_sum(values, p))
        n0 = segsum.launches
        got, stats = window.ba_solve(*args)
        assert segsum.launches - n0 == 3 * ba_cfg.iterations
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(segsum, "segment_sum", lambda v, o, b: parent_sum(v, assembly.SumPlan(o, b)))
            ref, ref_stats = window.ba_solve(*args)
        assert same_bits(got.poses, ref.poses) and same_bits(got.points, ref.points)
        assert all(same_bits(a, b) for a, b in zip(stats, ref_stats))


@pytest.mark.cuda
def test_slam_sequence_on_card_is_the_plain_sums_bit_for_bit(dev):
    """A 200-frame ``OnlineSLAM`` session of the cell on the card (its steps
    replayed as graphs) gives the ``poses_all`` and map of the same session
    with the plain sums patched in (the graphs captured again)."""
    from tpuvo_torch.engine import slam, vo
    from tpuvo_torch.utils import graphs
    from vobench import gen, program

    config = json.loads((ROOT / "vobench" / "configs" / "kitti_loop200.json").read_text())
    cfg = program.engine_config(config)
    batch = gen.to_device(gen.problems(gen.sequence(config), 1, 0.1, seed=2), dev)
    frame = lambda i: vo.Frame(*(batch[k][0, i] for k in vo.Frame._fields))
    F = config["data"]["frames"]

    def session():
        graphs.clear()
        s = slam.OnlineSLAM(cfg, max_frames=F, seed=11)
        s.start(frame(0), frame(1))
        for i in range(2, F):
            s.step(frame(i))
        c = s.carry
        return c.poses_all, c.state.map_xyz, c.n_ba

    poses, xyz, n_ba = session()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(segsum, "segment_sum", lambda v, o, b: parent_sum(v, assembly.SumPlan(o, b)))
        ref_poses, ref_xyz, _ = session()
    graphs.clear()
    assert n_ba > 80
    assert same_bits(poses, ref_poses) and same_bits(xyz, ref_xyz)
