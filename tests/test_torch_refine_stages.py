"""The loop-closure refine's stages (``ba_refine.refine_trajectory_loop``
with ``record``) held to the benchmark's plain reference
(``vobench/reference/refine.py``) on the CPU, on a small loop of the
refine cell's world (60 frames, 128 keypoints, 1,024 slots) tracked by
``run_sequence_slam``; and the reference's PGO and fine sweep held to the
JAX package's on the same inputs.

Tolerances: counts, pairs, the sweep count and the hand-off exact; gaps
below 1e-4 (poses: metres; points: relative to the nearest camera), where
the TF32 control reads 1e-3 to 1e-1 at this size; against JAX, poses
atol 1e-3 and points rtol/atol 1e-2, as ``test_torch_loop.py``'s refiners.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvo.ba import posegraph as jpg
from tpuvo.config import BAConfig as JBA, EngineConfig as JCfg
from tpuvo.engine import ba_refine as jref
from tpuvo_torch.config import BAConfig
from tpuvo_torch.engine import ba_refine, slam, vo
from vobench import check, gen, manifest, program
from vobench.reference import refine as ref
import xdist_threads  # noqa: F401  (torch's share of the cores under xdist)

F, N, CAP = 60, 128, 1024


def small_config() -> dict:
    config = json.loads((pathlib.Path(manifest.HERE) / "configs"
                         / "kitti_loop200_refine.json").read_text())
    config["data"]["frames"] = config["engine"]["n_frames"] = F
    config["engine"].update(max_obs=N, map_capacity=CAP, max_new_landmarks_per_frame=16)
    config["refine"]["ba"].update(window=F, max_landmarks=CAP)
    return config


@pytest.fixture(scope="module")
def unit():
    """One tracked sequence of the small loop and its refine, recorded."""
    config = small_config()
    cfg = program.engine_config(config)
    host = gen.problems(gen.sequence(config), 1, 0.1, 7)
    x = gen.to_device(host, "cpu")
    seq = vo.Frame(*(x[k][0] for k in vo.Frame._fields))
    state, _, poses, _ = slam.run_sequence_slam(seq, cfg, seed=11, device="cpu")
    ba = BAConfig(**config["refine"]["ba"])
    rec = {}
    out = ba_refine.refine_trajectory_loop(state, seq, poses, cfg, ba, n_sweeps=3, record=rec)
    return dict(config=config, cfg=cfg, ba=ba, seq=seq, state=state, poses=poses, rec=rec,
                out=out, frames={k: torch.as_tensor(np.array(v[0])) for k, v in host.items()})


def test_record_changes_nothing(unit):
    """Without ``record`` the refine returns the same poses, points and
    stats, bit for bit."""
    p, x, st = ba_refine.refine_trajectory_loop(unit["state"], unit["seq"], unit["poses"],
                                                unit["cfg"], unit["ba"], n_sweeps=3)
    assert torch.equal(p, unit["out"][0]) and torch.equal(x, unit["out"][1])
    assert st == unit["out"][2]


def test_each_stage_holds_to_the_reference(unit):
    """The benchmark's check, stage by stage and LM iteration by iteration
    from the program's own record: exact where it is exact, within float32
    rounding elsewhere."""
    st, rec = unit["state"], unit["rec"]
    p, x, stats = unit["out"]
    assert stats[0]["n_loop_edges"] >= 1 and len(rec["sweeps"]) >= 3
    item = dict(rec=rec, poses=p, points=x, stats=stats, tracked=unit["poses"],
                map=dict(xyz=st.map_xyz, desc=st.map_desc, valid=st.map_valid),
                frames=unit["frames"])
    driver = manifest.driver({"driver": "refine"})
    nums = driver.numbers(dict(refine=[item], units=[]), unit["config"], "cpu")
    for k in ("covis_faults", "loop_pair_faults", "sweep_count_faults", "handoff_faults"):
        assert nums[k] == 0, k
    assert nums["topology_mismatch_share"] == 0 and nums["loop_edge_one_side_share"] == 0
    assert nums["pgo_step_flip_share"] == 0 and nums["sweep_step_flip_share"] == 0
    for k in ("loop_edge_rot_gap", "loop_edge_trans_gap", "pgo_l2_pose_gap",
              "pgo_robust_pose_gap", "coarse_pose_gap", "coarse_point_gap", "fine_pose_gap",
              "fine_point_gap", "pgo_step_pose_gap", "coarse_step_pose_gap",
              "coarse_step_point_gap", "fine_step_pose_gap", "fine_step_point_gap"):
        assert nums[k + "_p90"] < 1e-4, (k, nums[k + "_p90"])


def test_reference_pgo_and_fine_sweep_match_jax(unit):
    """The reference's L2 PGO pass (from the program's graph) and one fine
    sweep (from the program's input to it) land on the JAX package's."""
    config, rec = unit["config"], unit["rec"]
    fx, lp = config["fixed_by_program"], rec["loops"]
    poses = rec["poses_in"]
    eij, eT, ew = ref.graph_edges(poses, lp["pairs"], lp["Z"], lp["w"], fx["odo_weight"],
                                  fx["loop_weight"])
    fixed = torch.arange(F) < 1
    pr, _ = ref.pgo(poses, eij, eT, ew, fixed, 20, 1.0e8)
    gj = jpg.PoseGraph(poses=jnp.asarray(poses.numpy()), edges_ij=jnp.asarray(eij.numpy()),
                       edges_T=jnp.asarray(eT.numpy()), edges_w=jnp.asarray(ew.numpy()),
                       fixed=jnp.asarray(fixed.numpy()))
    oj, _ = jpg.pgo_solve(gj, iterations=20, kernel_threshold=1.0e8)
    np.testing.assert_allclose(pr.numpy(), np.asarray(oj.poses), atol=1e-3)

    s = rec["sweeps"][1]
    assert s["kind"] == "fine"
    st, fr = unit["state"], unit["frames"]
    ba = config["refine"]["ba"]
    K = check.camera(config, "cpu").K
    p, x, chi, inl, _ = ref.sweep(s["poses_before"], s["points_before"], st.map_valid, fr["uv"],
                                  rec["obs_lm"], rec["obs_valid"], K, ba["huber_threshold"],
                                  False, ba["iterations"])
    e = config["engine"]
    jc = JCfg(**{k: config["camera"][k] for k in ("fx", "fy", "cx", "cy", "width", "height")})
    jba = JBA(window=F, iterations=ba["iterations"], huber_threshold=ba["huber_threshold"],
              max_landmarks=e["map_capacity"], cull_bounds=False)
    pj, xj, cj, ij, _ = jref._global_sweep(
        jnp.asarray(s["poses_before"].numpy()), jnp.asarray(s["points_before"].numpy()),
        jnp.asarray(st.map_valid.numpy()), jnp.asarray(fr["uv"].numpy()),
        jnp.asarray(rec["obs_lm"].numpy()), jnp.asarray(rec["obs_valid"].numpy()),
        jnp.asarray(K.numpy()), jc, jba)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-3)
    v = st.map_valid.numpy()
    np.testing.assert_allclose(x.numpy()[v], np.asarray(xj)[v], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(float(chi), float(cj), rtol=1e-3)
    assert int(inl) == int(ij)


# Correspondences of one loop pair of the refine cell on the card (400
# keypoints): the 8 of a sampled hypothesis, one of them a landmark that an
# ill-posed triangulation put 8.4e24 m out, then 4 more of the pair.
LOOP_K = [[718.8560180664062, 0.0, 607.1928100585938], [0.0, 718.8560180664062, 185.2156982421875],
          [0.0, 0.0, 1.0]]
LOOP_X = [[3.885225296020508, -1.3228511810302734, 19.74164390563965],
          [-14.396720886230469, -0.24866566061973572, 23.226926803588867],
          [1.0529192686080933, -0.09010551869869232, 55.657161712646484],
          [-6.9474029541015625, -2.6526994705200195, 13.128128051757812],
          [5.6749563468360065e+23, 1.4108069867573065e+23, -8.409354114370121e+24],
          [-5.752125263214111, -2.5040030479431152, 15.648442268371582],
          [-4.3566718101501465, 0.5988976955413818, 42.98716354370117],
          [5.183804035186768, 0.6404694318771362, 22.90296173095703],
          [19.360450744628906, -5.204342842102051, 51.87771987915039],
          [13.34096622467041, 0.6448063850402832, 42.6602668762207],
          [-27.219261169433594, -1.6754164695739746, 56.53318786621094],
          [-4.311321258544922, 0.6096441149711609, 16.818410873413086]]
LOOP_UV = [[637.3748168945312, 138.1979217529297], [25.706802368164062, 176.3623504638672],
           [536.793701171875, 184.08413696289062], [74.60587310791016, 33.4109992980957],
           [477.7283935546875, 173.67767333984375], [210.86288452148438, 66.39100646972656],
           [444.53985595703125, 195.01683044433594], [663.4751586914062, 205.6194305419922],
           [782.9829711914062, 116.05076599121094], [738.6539916992188, 196.07803344726562],
           [157.8192901611328, 162.7844696044922], [300.3753967285156, 211.0481414794922]]


@pytest.mark.parametrize("impl", ["program", "reference"])
def test_pnp_dlt_drops_a_hypothesis_whose_normalisation_overflows(impl):
    """The landmark at 8.4e24 m overflows the masked sums of the Hartley
    normalisation in float32 (an unsampled row's (-mean)² is inf, times its
    zero weight NaN), so the hypothesis's AᵀA is NaN, on which torch's eigh
    raised for the whole batch on the card.  That hypothesis is dropped (ok
    false, the identity), as JAX's NaN drops it; the other, on the 8 sane
    rows, gets what it gets alone, bit for bit."""
    from tpuvo_torch.ops import pnp

    dlt = pnp.pnp_dlt if impl == "program" else ref.dlt
    K, X, uv = torch.tensor(LOOP_K), torch.tensor(LOOP_X), torch.tensor(LOOP_UV)
    far = torch.arange(12) < 8
    sane = (torch.arange(12) != 4) & (torch.arange(12) < 9)
    valid = torch.stack([far, sane])
    T, ok = dlt(K, X.expand(2, 12, 3), uv.expand(2, 12, 2), valid)
    alone, ok_alone = dlt(K, X[None], uv[None], sane[None])
    assert ok.tolist() == [False, True] and bool(ok_alone[0])
    assert torch.equal(T[0], torch.eye(4)) and torch.equal(T[1], alone[0])
