"""tpuvo_torch.parallel vs tpuvo.parallel: the sharded matcher (kernel B's
plain version per shard on the CPU), the sharded Schur BA, the edge-sharded
PGO and the distributed checkpointer.

The JAX side runs on its 8-way virtual CPU mesh (tests/conftest.py) at
``local_mesh(4)``; the port runs 4 gloo ranks, started once for the module
as torchrun would start them (MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/
LOCAL_RANK, so ``maybe_distributed_init`` itself joins the group), from a
worker script that imports only torch and tpuvo_torch; rank 0 writes the
results, and every rank checks its own checkpoint shards.  The host-side
partitioners are compared in process, exactly; a world-size-1 gloo group
in process holds every sharded function to its unsharded port.

Tolerances: matcher decisions and indices exact; distances rtol 1e-6 where
both packages sum in the same way (direct), and as tests/test_torch_match.py
holds kernel B's plain version to the Pallas kernel (atol 1e-5: the Pallas
kernel sums |a|^2 + |b|^2 - 2ab through a matmul, kernel B in descriptor
order) for method="pallas"; the sharded BA against JAX's sharded BA on the
same 4 shards: poses 1e-4, observed points 1e-3, integer statistics exact;
against JAX's single-device BA, tests/test_parallel.py's 5e-4 / 5e-3; PGO
tests/test_posegraph.py's poses 2e-3, chi rtol 1e-3.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpuvo.ba import posegraph as jpg
from tpuvo.ba.window import ba_solve as jba_solve
from tpuvo.config import BAConfig as JBAConfig, EngineConfig as JEngineConfig
from tpuvo.ops import lie as jlie
from tpuvo.parallel import local_mesh as jlocal_mesh
from tpuvo.parallel import ba_sharded as jbs
from tpuvo.parallel.match_sharded import sharded_match_descriptors as jsharded_match
from tpuvo.parallel.posegraph_sharded import shard_edges as jshard_edges
from tpuvo_torch.ba.posegraph import graph_from_numpy, graph_to_numpy, pgo_solve
from tpuvo_torch.ba.window import ba_solve, problem_from_numpy
from tpuvo_torch.config import BAConfig, EngineConfig
from tpuvo_torch.ops.match import match_descriptors
from tpuvo_torch.parallel import mesh as tmesh
from tpuvo_torch.parallel.ba_sharded import (gather_points, shard_ba_problem,
                                             sharded_ba_solve, sharded_ba_step)
from tpuvo_torch.parallel.match_sharded import sharded_match_descriptors
from tpuvo_torch.parallel.posegraph_sharded import shard_edges, sharded_pgo_solve
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ba import make_ba_problem  # noqa: E402
from test_posegraph import _circle_gt, _noisy_chain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
CFG = JEngineConfig()
W_PX, H_PX = CFG.width, CFG.height
BA_CFG = dict(iterations=8, damping=1e-3, lm_adaptive=False)
PGO_ITERS = 15
METHODS = ("direct", "pallas")


# ------------------------------------------------------------------ inputs --
def match_cases():
    """name -> (d1, v1, d2, v2), all (64, 10) queries against a 4096-row map
    (1024 rows a shard at 4 ranks; one shape, so JAX compiles each method
    once): tests/test_parallel.py's three cases (the first on a rendered
    frame in place of the bundled data), duplicates across shard edges, an
    all-invalid shard, a map valid in one shard only, and no valid row."""
    from tpuvo.data import synthetic

    N, M, E = 64, 4096, 1024   # E: the shard edge
    world = synthetic.make_world(0, n_landmarks=400, xy_extent=6.0)
    gt = synthetic.make_planar_trajectory(2, step=0.25, turn=0.05, seed=0)
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=0.0, seed=0)
    q, qv = seq.desc[0][:N].astype(np.float32), seq.valid[0][:N]
    rng = np.random.default_rng(0)
    cases = {}
    d2 = rng.uniform(-1, 1, (M, 10)).astype(np.float32)
    d2[37] = q[5]
    d2[2411] = q[5] + 0.01
    v2 = np.ones(M, bool)
    v2[100:120] = False
    cases["frame"] = (q, qv, d2, v2)

    d1 = np.zeros((N, 10), np.float32)
    d2 = np.ones((M, 10), np.float32)
    d2[3] = 0.05       # shard 0: best
    d2[2300] = 0.06    # shard 2: second
    cases["cross_shard"] = (d1, np.ones(N, bool), d2, np.ones(M, bool))

    rng = np.random.default_rng(5)
    d1 = rng.uniform(-1, 1, (N, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (M, 10)).astype(np.float32)
    d2[100] = d1[3]            # exact hit, shard 0
    d2[3000] = d1[3] + 0.01    # runner-up in a later shard
    v2 = np.ones(M, bool)
    v2[512:540] = False
    cases["pallas_parity"] = (d1, np.ones(N, bool), d2, v2)

    rng = np.random.default_rng(7)
    d1 = rng.uniform(-1, 1, (N, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (M, 10)).astype(np.float32)
    d2[E - 1] = d2[E] = d1[0]                    # exact duplicates either side of an edge
    d2[2 * E - 1], d2[2 * E] = d1[1] + 0.01, d1[1]  # best after the edge, runner-up before
    d2[3 * E - 1], d2[3 * E] = d1[2], d1[2] + 0.3   # best before the edge, far runner-up after
    cases["edge_duplicates"] = (d1, np.ones(N, bool), d2, np.ones(M, bool))

    v2 = np.ones(M, bool)
    v2[E:2 * E] = False                 # shard 1 has no valid row
    d2b = d2.copy()
    d2b[E + 6] = d1[4]                  # an exact hit hidden in the invalid shard
    cases["invalid_shard"] = (d1, np.ones(N, bool), d2b, v2)

    v2 = np.zeros(M, bool)
    v2[3 * E:] = True                   # only the last shard is valid
    cases["one_valid_shard"] = (d1, np.ones(N, bool), d2, v2)
    cases["all_invalid"] = (d1, np.ones(N, bool), d2, np.zeros(M, bool))
    return cases


def ba_problem():
    prob, _, world = make_ba_problem(W=6, L=256, pose_noise=0.02, point_noise=0.03, seed=0)
    return prob, world.xyz.shape[0]


def pgo_graph():
    """tests/test_posegraph.py's sharded-vs-single graph (F=24, 2 loop edges)."""
    F = 24
    gt = _circle_gt(F)
    rels, dead = _noisy_chain(gt, seed=5)
    ii = jnp.arange(F - 1, dtype=jnp.int32)
    lc_pairs = [(0, 12), (3, 21)]
    lc_T = jnp.stack([jlie.inv_se3(jnp.asarray(gt[i])) @ jnp.asarray(gt[j])
                      for i, j in lc_pairs])
    return jpg.PoseGraph(
        jnp.asarray(dead),
        jnp.concatenate([jnp.stack([ii, ii + 1], -1), jnp.asarray(lc_pairs, jnp.int32)], 0),
        jnp.concatenate([jnp.asarray(rels), lc_T], 0),
        jnp.concatenate([jnp.ones(F - 1, jnp.float32), jnp.full(2, 10.0, jnp.float32)], 0),
        jnp.zeros(F, bool).at[0].set(True),
    )


def np_fields(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


# ------------------------------------------------------------------ worker --
WORKER = textwrap.dedent(
    """
    import os, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from tpuvo_torch.ba.posegraph import graph_from_numpy
    from tpuvo_torch.ba.window import problem_from_numpy
    from tpuvo_torch.config import BAConfig, EngineConfig
    from tpuvo_torch.engine.state import VOState, empty_state
    from tpuvo_torch.parallel import mesh as pm
    from tpuvo_torch.parallel.ba_sharded import (gather_points, shard_ba_problem,
                                                 sharded_ba_solve, sharded_ba_step)
    from tpuvo_torch.parallel.match_sharded import sharded_match_descriptors
    from tpuvo_torch.parallel.posegraph_sharded import sharded_pgo_solve
    from tpuvo_torch.utils.checkpoint import DistCheckpointer

    inp, out_path, ckpt_dir = sys.argv[1:4]
    world = pm.maybe_distributed_init("cpu")
    rank = dist.get_rank()
    assert world == int(os.environ["WORLD_SIZE"]) == dist.get_world_size()
    mesh = pm.local_mesh(device_type="cpu")
    edge_mesh = pm.local_mesh(axis="edge", device_type="cpu")
    z = dict(np.load(inp))
    out = {}
    t = torch.as_tensor

    for name in z["match_names"]:
        d1, v1, d2, v2 = (t(z[f"match_{name}_{k}"]) for k in ("d1", "v1", "d2", "v2"))
        for method in ("direct", "pallas"):
            r = sharded_match_descriptors(mesh, d1, v1, d2, v2, method=method)
            for k, v in r._asdict().items():
                out[f"match_{name}_{method}_{k}"] = v.numpy()

    try:  # a map that does not divide over the ranks: every rank raises, none waits
        sharded_match_descriptors(mesh, d1, v1, d2[:-1], v2[:-1])
    except ValueError:
        out["indivisible_map_raises"] = np.array(True)

    ec = EngineConfig()
    K = t(ec.K())
    prob = problem_from_numpy({k[3:]: z[k] for k in z if k.startswith("ba_")}, "cpu")
    L = prob.points.shape[0]
    cfg = BAConfig(iterations=int(z["ba_iterations"]), damping=float(z["ba_damping"]),
                   lm_adaptive=False)
    sp = shard_ba_problem(prob, world)
    solved, stats = sharded_ba_solve(mesh, sp, K, ec.width, ec.height, cfg)
    out["ba_solve_poses"] = solved.poses.numpy()
    out["ba_solve_points"] = gather_points(solved, L, mesh)
    out["ba_solve_stats"] = np.array([float(stats.chi), int(stats.num_inliers),
                                      int(stats.num_obs)])
    stepped, st1 = sharded_ba_step(mesh, sp, K, ec.width, ec.height, cfg)
    out["ba_step_poses"] = stepped.poses.numpy()
    out["ba_step_points"] = gather_points(stepped, L, mesh)
    out["ba_step_stats"] = np.array([float(st1.chi), int(st1.num_inliers), int(st1.num_obs)])

    graph = graph_from_numpy({k[4:]: z[k] for k in z if k.startswith("pgo_")}, "cpu")
    g2, ps = sharded_pgo_solve(edge_mesh, graph, iterations=int(z["pgo_iterations"]))
    out["pgo_poses"] = g2.poses.numpy()
    out["pgo_stats"] = np.array([float(ps.chi), int(ps.num_inliers), int(ps.iterations)])

    # the sharded BA state: each rank writes only its own landmark shard
    ck = DistCheckpointer(os.path.join(ckpt_dir, "ba"), keep=2)
    state = {"poses": solved.poses,
             "points": DTensor.from_local(solved.points, mesh, [Shard(0)], run_check=False)}
    for step in (7, 8, 9):
        ck.save(step, state, extra={"step": step})
    steps = sorted(int(d) for d in os.listdir(os.path.join(ckpt_dir, "ba")))
    assert steps == [8, 9], steps
    assert ck.latest_step() == 9
    target = {"poses": torch.zeros_like(solved.poses),
              "points": DTensor.from_local(torch.zeros_like(solved.points), mesh, [Shard(0)],
                                           run_check=False)}
    restored, extra = ck.restore(target=target)
    assert int(extra["step"]) == 9
    assert torch.equal(restored["poses"], solved.poses)
    assert torch.equal(restored["points"].to_local(), solved.points)  # this rank's shard
    whole, _ = ck.restore(8)  # no target: every shard, on every rank
    out["ckpt_points"] = whole["points"].numpy()
    ck.close()

    # a VOState round trip with the state_type tag, and a dict that is not one
    vo = empty_state(ec, "cpu")
    g = torch.Generator().manual_seed(3)
    vo = vo._replace(pose=torch.randn(4, 4, generator=g),
                     map_xyz=torch.randn(vo.map_xyz.shape, generator=g),
                     map_valid=torch.rand(vo.map_valid.shape, generator=g) < 0.5,
                     map_count=torch.tensor(11, dtype=torch.int32),
                     frame_idx=torch.tensor(9, dtype=torch.int32))
    ck = DistCheckpointer(os.path.join(ckpt_dir, "vo"), keep=3)
    ck.save(9, vo, extra={"seed": 42})
    ck.save(10, vo._asdict())
    old = {k: v for k, v in vo._asdict().items()
           if k not in ("vel", "map_last_seen", "frame_idx")}
    ck.save(11, old)
    vo2, extra = ck.restore(step=9)
    assert type(vo2) is VOState and int(extra["seed"]) == 42
    assert all(torch.equal(a, b) for a, b in zip(vo, vo2))
    d, _ = ck.restore(step=10)
    assert type(d) is dict and set(d) == set(VOState._fields)
    vo3, _ = ck.restore(target=empty_state(ec, "cpu"))   # latest: 11, fields backfilled
    assert type(vo3) is VOState and torch.equal(vo3.map_xyz, vo.map_xyz)
    assert torch.equal(vo3.vel, torch.eye(4)) and int(vo3.frame_idx) == 0
    assert not vo3.map_last_seen.any()

    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"OK rank={rank}", flush=True)
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """The 4 worker processes: started at once, waited for on first use."""

    def __init__(self, tmp):
        inputs = {"match_names": np.array(list(match_cases()))}
        for name, (d1, v1, d2, v2) in match_cases().items():
            inputs.update({f"match_{name}_d1": d1, f"match_{name}_v1": v1,
                           f"match_{name}_d2": d2, f"match_{name}_v2": v2})
        prob, _ = ba_problem()
        inputs.update({f"ba_{k}": v for k, v in np_fields(prob).items()})
        inputs.update(ba_iterations=BA_CFG["iterations"], ba_damping=BA_CFG["damping"])
        inputs.update({f"pgo_{k}": v for k, v in np_fields(pgo_graph()).items()})
        inputs["pgo_iterations"] = PGO_ITERS
        np.savez(tmp / "inputs.npz", **inputs)
        script = tmp / "worker.py"
        script.write_text(WORKER)
        self.out = tmp / "out.npz"
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(RANKS),
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "OMP_NUM_THREADS": "1"}
        self.procs = [
            subprocess.Popen([sys.executable, str(script), str(tmp / "inputs.npz"),
                              str(self.out), str(tmp / "ckpt")],
                             env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(RANKS)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"{RANKS}-rank gloo run timed out")
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"OK rank={r}" in out, f"rank {r} failed:\n{out}"
            self._results = dict(np.load(self.out))
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# The init checks run first: they need this process without a group.
def test_maybe_distributed_init_raises_on_bad_port(monkeypatch):
    assert not dist.is_initialized()
    assert tmesh.maybe_distributed_init("cpu") == 1  # no launcher variables: one process
    for k, v in dict(MASTER_ADDR="127.0.0.1", RANK="0", WORLD_SIZE="1",
                     LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    for bad in ("notaport", "0", "70000"):
        monkeypatch.setenv("MASTER_PORT", bad)
        with pytest.raises(RuntimeError, match="torchrun"):
            tmesh.maybe_distributed_init("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError, match="LOCAL_RANK missing"):
        tmesh.maybe_distributed_init("cpu")
    assert not dist.is_initialized()


def test_cli_raises_on_a_failed_distributed_init(monkeypatch, tmp_path):
    from tpuvo_torch import cli

    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="notaport", RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["--device", "cpu", "--data", str(tmp_path), "run"])
    assert not dist.is_initialized()


def test_cli_refuses_more_than_one_rank(monkeypatch, tmp_path):
    """No subcommand shards its work: two ranks would each run the whole
    pipeline into the same --out, so the CLI stops before any work."""
    from tpuvo_torch import cli

    ran = []
    monkeypatch.setattr(tmesh, "maybe_distributed_init", lambda device: 2)
    monkeypatch.setattr(cli, "cmd_run", lambda args: ran.append(args))
    with pytest.raises(SystemExit, match="nproc_per_node 1"):
        cli.main(["--device", "cpu", "--data", str(tmp_path), "run"])
    assert not ran
    monkeypatch.setattr(tmesh, "maybe_distributed_init", lambda device: 1)
    cli.main(["--device", "cpu", "--data", str(tmp_path), "run"])
    assert len(ran) == 1


def test_checkpointer_without_a_group(tmp_path):
    """One process, no group: a VOState comes back tagged, retention keeps 3."""
    from tpuvo_torch.engine.state import VOState, empty_state
    from tpuvo_torch.utils.checkpoint import DistCheckpointer

    assert not dist.is_initialized()
    vo = empty_state(EngineConfig(), "cpu")
    vo = vo._replace(map_xyz=torch.randn(vo.map_xyz.shape, generator=torch.Generator()
                                         .manual_seed(0)))
    ck = DistCheckpointer(str(tmp_path / "ck"))
    for step in (3, 5, 9, 12):
        ck.save(step, vo._replace(frame_idx=torch.tensor(step, dtype=torch.int32)),
                extra={"seed": 42})
    assert ck.latest_step() == 12 and sorted(map(int, os.listdir(tmp_path / "ck"))) == [5, 9, 12]
    got, extra = ck.restore(step=9)
    assert type(got) is VOState and int(got.frame_idx) == 9 and int(extra["seed"]) == 42
    assert all(torch.equal(a, b) for a, b in zip(got[:-1], vo[:-1]))
    ck.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.kill()


# --------------------------------------------------------- host side, exact --
@pytest.mark.parametrize("n_shards,obs_pad_to", [(1, None), (3, None), (4, None), (8, None),
                                                 (4, 40)])
def test_shard_ba_problem_matches_jax(n_shards, obs_pad_to):
    prob, _ = ba_problem()
    ref = jbs.shard_ba_problem(prob, n_shards, obs_pad_to)
    got = shard_ba_problem(problem_from_numpy(np_fields(prob), "cpu"), n_shards, obs_pad_to)
    for k in ("poses", "points", "point_valid", "obs_uv", "obs_lm", "obs_valid", "fixed"):
        a, b = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert np.array_equal(ref.lm_perm, got.lm_perm) and ref.active == got.active


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_shard_ba_problem_keeps_the_problem_device(source):
    """A CPU problem (or the JAX package's problem, read with np.asarray as
    JAX reads it, asked for on the CPU) gives CPU tensors, equal to the JAX
    partitioner's; the converters default to the card and raise without
    one, unless the caller asks for the CPU."""
    from tpuvo_torch.parallel.ba_sharded import sharded_problem_from_numpy

    prob, _ = ba_problem()
    ref = jbs.shard_ba_problem(prob, 3)
    if source == "torch":
        got = shard_ba_problem(problem_from_numpy(np_fields(prob), "cpu"), 3)
    else:
        got = sharded_problem_from_numpy(jbs.shard_ba_problem(prob, 3), "cpu")
    for k in ("poses", "points", "point_valid", "obs_uv", "obs_lm", "obs_valid", "fixed"):
        a, b = np.asarray(getattr(ref, k)), getattr(got, k)
        assert b.device.type == "cpu" and np.array_equal(a, b.numpy()), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_problem_from_numpy(got)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            problem_from_numpy(np_fields(prob))


def test_shard_edges_matches_jax():
    g = pgo_graph()
    for n in (1, 4, 5, 7):
        ref = jshard_edges(g, n)
        got = shard_edges(graph_from_numpy(np_fields(g), "cpu"), n)
        for k, v in graph_to_numpy(got).items():
            assert np.array_equal(np.asarray(getattr(ref, k)), v), (n, k)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_gather_points_round_trip(n_shards):
    prob, L = ba_problem()
    sp = shard_ba_problem(problem_from_numpy(np_fields(prob), "cpu"), n_shards)
    pts = gather_points(sp, L)
    assert np.array_equal(pts, np.asarray(prob.points))
    assert np.array_equal(pts, jbs.gather_points(jbs.shard_ba_problem(prob, n_shards), L))


# ------------------------------------------------ 4 gloo ranks vs the JAX mesh --
@pytest.fixture(scope="module")
def jmesh():
    return jlocal_mesh(RANKS, axis="lm")


@pytest.mark.parametrize("method", METHODS)
def test_sharded_match_matches_jax(ranks, jmesh, method):
    # one jit per method: an eager shard_map compiles on every call
    jmatch_sharded = jax.jit(lambda *a: jsharded_match(jmesh, *a, method=method))
    for name, (d1, v1, d2, v2) in match_cases().items():
        ref = jmatch_sharded(*map(jnp.asarray, (d1, v1, d2, v2)))
        res = ranks.results()
        got = {k: res[f"match_{name}_{method}_{k}"] for k in ("idx", "valid", "best", "second")}
        valid = np.asarray(ref.valid)
        assert np.array_equal(got["valid"], valid), name
        assert np.array_equal(got["idx"][valid], np.asarray(ref.idx)[valid]), name
        # the JAX kernel's invalid columns sit at ~1.7e38, the port's at +inf
        for k in ("best", "second"):
            r = np.asarray(getattr(ref, k))
            fin = r < 1e38
            assert np.array_equal(fin, np.isfinite(got[k])), (name, k)
            if method == "direct":
                np.testing.assert_allclose(got[k][fin], r[fin], rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(got[k][fin], r[fin], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_match_equals_unsharded_port(ranks, method):
    """Bit-equal to one unsharded call: the shards' distances are the same
    sums, the first shard wins ties, the runner-up is the other minimum."""
    for name, (d1, v1, d2, v2) in match_cases().items():
        ref = match_descriptors(*map(torch.as_tensor, (d1, v1, d2, v2)), method=method)
        res = ranks.results()
        for k, v in ref._asdict().items():
            assert np.array_equal(res[f"match_{name}_{method}_{k}"], v.numpy()), (name, k)


def test_sharded_match_shard_edges_and_invalid_shards(ranks):
    E = 1024
    res = ranks.results()
    assert res.get("indivisible_map_raises")
    idx = lambda case: res[f"match_{case}_pallas_idx"]
    valid = lambda case: res[f"match_{case}_pallas_valid"]
    best = lambda case: res[f"match_{case}_pallas_best"]
    # exact duplicates across the shard edge: the first (shard 0) wins, ratio 1 rejects
    assert idx("edge_duplicates")[0] == E - 1 and not valid("edge_duplicates")[0]
    assert idx("edge_duplicates")[1] == 2 * E and valid("edge_duplicates")[1]
    assert idx("edge_duplicates")[2] == 3 * E - 1 and valid("edge_duplicates")[2]
    # an invalid shard never wins, whatever it holds
    assert idx("invalid_shard")[4] != E + 6
    assert np.all((idx("invalid_shard") < E) | (idx("invalid_shard") >= 2 * E))
    assert np.all(idx("one_valid_shard") >= 3 * E) and np.isfinite(best("one_valid_shard")).all()
    # no valid row anywhere: idx 0, +inf, rejected (as one unsharded call)
    assert np.all(idx("all_invalid") == 0) and not valid("all_invalid").any()
    assert np.isinf(best("all_invalid")).all()


@pytest.fixture(scope="module")
def jax_ba(jmesh):
    prob, L = ba_problem()
    cfg = JBAConfig(**BA_CFG)
    K = jnp.asarray(CFG.K())
    sp = jbs.shard_ba_problem(prob, RANKS)
    solved, stats = jbs.sharded_ba_solve(jmesh, sp, K, W_PX, H_PX, cfg)
    # jitted: an eager shard_map runs op by op
    poses, points, st1 = jax.jit(lambda ps, pt: (lambda o: (o[0].poses, o[0].points, o[1]))(
        jbs.sharded_ba_step(jmesh, sp._replace(poses=ps, points=pt), K, W_PX, H_PX, cfg)))(
            sp.poses, sp.points)
    stepped = sp._replace(poses=poses, points=points)
    single, _ = jba_solve(prob, K, W_PX, H_PX, cfg)
    seen = np.zeros(L, bool)
    seen[np.unique(np.asarray(prob.obs_lm)[np.asarray(prob.obs_valid)])] = True
    return dict(solve=(solved, stats), step=(stepped, st1), single=single, L=L, seen=seen)


@pytest.mark.parametrize("which", ["solve", "step"])
def test_sharded_ba_matches_jax_sharded(ranks, jax_ba, which):
    sp, stats = jax_ba[which]
    res = ranks.results()
    seen = jax_ba["seen"]
    np.testing.assert_allclose(res[f"ba_{which}_poses"], np.asarray(sp.poses), atol=1e-4)
    np.testing.assert_allclose(res[f"ba_{which}_points"][seen],
                               jbs.gather_points(sp, jax_ba["L"])[seen], atol=1e-3)
    chi, n_in, n_obs = res[f"ba_{which}_stats"]
    assert (int(n_in), int(n_obs)) == (int(stats.num_inliers), int(stats.num_obs))
    np.testing.assert_allclose(chi, float(stats.chi), rtol=1e-3, atol=1e-6)


def test_sharded_ba_matches_jax_single_device(ranks, jax_ba):
    res, single, seen = ranks.results(), jax_ba["single"], jax_ba["seen"]
    np.testing.assert_allclose(res["ba_solve_poses"], np.asarray(single.poses), atol=5e-4)
    np.testing.assert_allclose(res["ba_solve_points"][seen],
                               np.asarray(single.points)[seen], atol=5e-3)


def test_sharded_pgo_matches_jax(ranks):
    g = pgo_graph()
    out, stats = jpg.pgo_solve(g, iterations=PGO_ITERS)
    res = ranks.results()
    np.testing.assert_allclose(res["pgo_poses"], np.asarray(out.poses), atol=2e-3)
    chi, _, iters = res["pgo_stats"]
    assert np.isclose(chi, float(stats.chi), rtol=1e-3, atol=1e-5)
    assert int(iters) == PGO_ITERS


def test_dist_checkpointer_across_ranks(ranks):
    """Every rank restored its own shard bit-equal (checked in the worker:
    retention keeps the newest 2 of 3 steps, latest_step, the VOState tag,
    field backfill); the whole state restored without a target is every
    shard in order."""
    res = ranks.results()
    prob, L = ba_problem()
    pts = res["ckpt_points"]                      # (S, Ls, 3), the solved shards
    sp = shard_ba_problem(problem_from_numpy(np_fields(prob), "cpu"), RANKS)
    assert pts.shape == tuple(sp.points.shape)
    assert np.array_equal(gather_points(sp._replace(points=torch.as_tensor(pts)), L),
                          res["ba_solve_points"])


# --------------------------------------- world size 1, in process: = unsharded --
@pytest.fixture(scope="module")
def world1():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield tmesh.local_mesh(1, device_type="cpu"), tmesh.local_mesh(
            1, axis="edge", device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("method", METHODS)
def test_world1_match_equals_unsharded(world1, method):
    for name, case in match_cases().items():
        args = [torch.as_tensor(x) for x in case]
        got = sharded_match_descriptors(world1[0], *args, method=method)
        ref = match_descriptors(*args, method=method)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), name


def test_world1_ba_equals_unsharded(world1):
    prob, L = ba_problem()
    tp = problem_from_numpy(np_fields(prob), "cpu")
    cfg = BAConfig(**BA_CFG)
    K = torch.as_tensor(EngineConfig().K())
    sp, stats = sharded_ba_solve(world1[0], shard_ba_problem(tp, 1), K, W_PX, H_PX, cfg)
    ref, rstats = ba_solve(tp, K, W_PX, H_PX, cfg)
    np.testing.assert_allclose(sp.poses.numpy(), ref.poses.numpy(), atol=1e-5)
    seen = np.zeros(L, bool)
    seen[np.unique(np.asarray(prob.obs_lm)[np.asarray(prob.obs_valid)])] = True
    np.testing.assert_allclose(gather_points(sp, L, world1[0])[seen],
                               ref.points.numpy()[seen], atol=1e-4)
    assert int(stats.num_obs) == int(rstats.num_obs)
    assert int(stats.num_inliers) == int(rstats.num_inliers)
    sp1, st1 = sharded_ba_step(world1[0], shard_ba_problem(tp, 1), K, W_PX, H_PX, cfg)
    ref1, rst1 = ba_solve(tp, K, W_PX, H_PX, cfg.replace(iterations=1))
    np.testing.assert_allclose(sp1.poses.numpy(), ref1.poses.numpy(), atol=1e-5)
    assert (int(st1.num_obs), int(st1.num_inliers)) == (int(rst1.num_obs), int(rst1.num_inliers))


def test_world1_pgo_equals_unsharded(world1):
    g = graph_from_numpy(np_fields(pgo_graph()), "cpu")
    got, gs = sharded_pgo_solve(world1[1], g, iterations=PGO_ITERS)
    ref, rs = pgo_solve(g, iterations=PGO_ITERS)
    np.testing.assert_allclose(got.poses.numpy(), ref.poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(gs.chi), float(rs.chi), rtol=1e-5)
    assert int(gs.num_inliers) == int(rs.num_inliers)


def test_world1_checkpointer_sharded_state(world1, tmp_path):
    from torch.distributed.tensor import DTensor, Shard

    from tpuvo_torch.utils.checkpoint import DistCheckpointer

    pts = torch.arange(24.0).reshape(1, 8, 3)
    ck = DistCheckpointer(str(tmp_path / "w1"))
    for step in range(5):
        ck.save(step, {"points": DTensor.from_local(pts + step, world1[0], [Shard(0)])})
    assert ck.latest_step() == 4 and sorted(os.listdir(tmp_path / "w1")) == ["2", "3", "4"]
    out, _ = ck.restore(3)
    assert torch.equal(out["points"], pts + 3)
    with pytest.raises(FileNotFoundError):
        DistCheckpointer(str(tmp_path / "empty")).restore()
