"""How ``correct`` is decided: what the timed path produced, held to the
plain reference (``vobench/reference``) at the timed sizes.

The tracker's feedback loop is chaotic (a 1e-6 difference in one pose
gives another trajectory), so the reference follows the program step by
step from the program's own state, which the answers carry:
  * the bootstrap's pose (``boot_numbers``): the reference works the
    two-view RANSAC out again in float64 from the frames and the run's
    draw; the program's rotation is held to it, and its cheirality exactly
    (the translation's direction is ill-posed in float32 on these short
    baselines, so the pose is not compared entry by entry);
  * the bootstrap's points are worked out again from the program's
    bootstrap pose;
  * every step k of every compared problem starts from the program's pose
    of frame k-1 and from the program's map as step k found it: the slots
    appended before it (without eviction and without a backend a slot is
    written once, in order, and ``map_last_seen`` keeps the step that wrote
    it);
  * the hand-off between steps that this skips is checked by itself and
    exactly: the valid slots are the first ``map_count``, in the order of
    the steps that wrote them, each with the descriptor of the keypoint
    that founded it (``state_faults``).

The numbers (each a share or a gap; see ``numbers``) are compared with the
limits of ``vobench/limits/<cell>.json``, set from the readings of sound
runs and of the lower-precision control (PERF.md).
"""

from __future__ import annotations

import math

import torch

from vobench.reference import vo as ref


# A new landmark counts in the comparison when its two viewing rays (the
# reference's, from the poses the step starts and ends at) make an angle of
# at least RAY_MIN times the gate's least parallax and meet at least
# DEPTH_MIN metres in front of both cameras.  Otherwise the two-view
# triangulation is ill-posed (a point far away or near the direction of
# travel; or no baseline, when the step's pose stayed put): its float32 DLT
# lands anywhere along the rays, often at a camera centre, where the gate's
# parallax and reprojection tests pass, so two float32 implementations keep
# different ones and place them apart.  The rule is on the reference's
# inputs and outputs, never on the program's.
RAY_MIN = 2.0
DEPTH_MIN = 1.0


def camera(config: dict, device) -> ref.Cam:
    c = config["camera"]
    K = torch.tensor([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]],
                     device=device)
    return ref.Cam(K, c["width"], c["height"])


def ref_config(config: dict) -> dict:
    e = config["engine"]
    return dict(
        matcher=dict(distance_threshold=e["matcher"]["distance_threshold"],
                     ratio_threshold=e["matcher"]["ratio_threshold"]),
        picp={k: e["picp"][k] for k in ("kernel_threshold", "damping", "max_iterations",
                                        "convergence_threshold", "min_num_inliers",
                                        "min_matches_reuse_pose")},
        distance_threshold=e["matcher"]["distance_threshold"],
        ratio_threshold=e["matcher"]["ratio_threshold"],
        sample_size=e["ransac"]["sample_size"],
        inlier_threshold_px=e["ransac"]["inlier_threshold_px"],
        triangulation_refine_iters=e["triangulation_refine_iters"],
        max_new_landmarks_per_frame=e["max_new_landmarks_per_frame"],
        gate=e["mode"] == "fixed",
        landmark_max_reproj_px=e["landmark_max_reproj_px"],
        landmark_min_parallax_rad=e["landmark_min_parallax_rad"],
    )


def uniforms(seed: int, shape) -> torch.Tensor:
    """The RANSAC draw of a bootstrap seeded ``seed``: uniforms of the given
    (lanes..., H, N) shape from a CPU generator (the draw the program
    documents for its ``seed`` argument)."""
    return torch.rand(tuple(shape), generator=torch.Generator().manual_seed(seed))


def pose_gap(a, b):
    """Largest entry of the difference of two camera poses' top 3x4."""
    return torch.nan_to_num((a[..., :3, :4] - b[..., :3, :4]).abs().flatten(-2).amax(-1),
                            nan=math.inf)


def _q(x, q: float) -> float:
    if x.numel() == 0:
        return 0.0
    return float(torch.quantile(x.double().cpu(), q))


def numbers(answers: dict, inputs: dict, draws, config: dict, device="cuda",
            block: int = 512) -> dict:
    """The compared numbers of P problems.

    answers: the program's (``program.py`` layout, lane axis P): T_boot,
    poses (P, F, 4, 4), map_xyz, map_desc, map_id_meas, map_valid,
    map_last_seen, map_count; inputs: the frames handed to the program
    (P, F, N, ...); draws: (P, H, N) each problem's RANSAC uniforms."""
    a = {k: v.to(device) for k, v in answers.items()}
    x = {k: v.to(device) for k, v in inputs.items()}
    cam = camera(config, device)
    cfg = ref_config(config)
    P, F = a["poses"].shape[:2]
    N = x["uv"].shape[2]
    C = a["map_valid"].shape[1]
    fr = lambda i: {k: v[:, i] for k, v in x.items()}

    # -- the program's appended points on a (problem, step, keypoint) grid --
    valid, seen = a["map_valid"], a["map_last_seen"].long()
    p_idx = torch.arange(P, device=device)[:, None].expand(P, C)
    im = a["map_id_meas"].long().clamp(0, N - 1)
    has_p = torch.zeros(P, F, N, dtype=torch.bool, device=device)
    xyz_p = torch.zeros(P, F, N, 3, device=device)
    sel = valid & (seen < F)
    has_p[p_idx[sel], seen[sel], im[sel]] = True
    xyz_p[p_idx[sel], seen[sel], im[sel]] = a["map_xyz"][sel]

    # -- the hand-off, exactly: slots in order, founded by their keypoints --
    slot = torch.arange(C, device=device)
    faults = int((valid != (slot[None] < a["map_count"].long()[:, None])).sum())
    order = torch.where(valid, seen, F + 1)
    faults += int(((order[:, 1:] < order[:, :-1]) & valid[:, 1:]).sum())
    found = torch.where(seen > 0, seen - 1, 0).clamp(max=F - 1)
    d_src = x["desc"][p_idx, found, im]
    faults += int(((d_src != a["map_desc"]).any(-1) & valid).sum())

    has_r = torch.zeros(P, F, N, dtype=torch.bool, device=device)
    xyz_r = torch.zeros(P, F, N, 3, device=device)
    posed = torch.ones(P, F, N, dtype=torch.bool, device=device)  # see RAY_MIN
    ray_min = RAY_MIN * config["engine"]["landmark_min_parallax_rad"]

    def put(pp, kk, new, cand):
        well = (new.ray >= ray_min) & (new.depth >= DEPTH_MIN)
        for sel, grid, val in ((new.ok, has_r, True), (cand, posed, well)):
            rows = pp[:, None].expand_as(sel)[sel]
            ks = kk[:, None].expand_as(sel)[sel]
            ids = new.id_meas.long().clamp(0, N - 1)[sel]
            grid[rows, ks, ids] = val if isinstance(val, bool) else val[sel]
        ok = new.ok
        xyz_r[pp[:, None].expand_as(ok)[ok], kk[:, None].expand_as(ok)[ok],
              new.id_meas.long().clamp(0, N - 1)[ok]] = new.xyz[ok]

    # -- the bootstrap's points from the program's pose (its pose: ---------
    # -- ``boot_numbers``) ----------------------------------------------------
    _, m = ref.bootstrap_pose(fr(0), fr(1), draws.to(device), cam, cfg)
    new = ref.bootstrap_points(fr(0), fr(1), m, a["T_boot"], cam, cfg, C)
    put(torch.arange(P, device=device), torch.zeros(P, dtype=torch.long, device=device), new,
        m.valid)

    # -- every step from the program's state --------------------------------
    pairs = torch.stack(torch.meshgrid(torch.arange(P, device=device),
                                       torch.arange(1, F, device=device), indexing="ij"),
                        -1).reshape(-1, 2)
    step_gap = []
    for lo in range(0, len(pairs), block):
        pp, kk = pairs[lo:lo + block, 0], pairs[lo:lo + block, 1]
        mvalid = valid[pp] & (seen[pp] < kk[:, None])
        mp = ref.Map(a["map_xyz"][pp], a["map_desc"][pp], mvalid, mvalid.sum(-1))
        curr = {k: v[pp, kk - 1] for k, v in x.items()}
        nxt = {k: v[pp, kk] for k, v in x.items()}
        pose, new, ex = ref.step(a["poses"][pp, kk - 1], mp, curr, nxt, cam, cfg, extras=True)
        step_gap.append(pose_gap(a["poses"][pp, kk], pose))
        put(pp, kk, new, ex["cand"])
    step_gap = torch.cat(step_gap)

    # -- the appended points, problem by problem and step by step -----------
    both = has_p & has_r & posed
    centre = torch.cat([torch.zeros(P, 1, 3, device=device), a["poses"][:, :-1, :3, 3]], 1)
    rel = ((xyz_p - xyz_r).norm(dim=-1)
           / (xyz_r - centre[:, :, None]).norm(dim=-1).clamp(min=1e-6))[both]
    rel = torch.nan_to_num(rel, nan=math.inf)
    n_union = int(((has_p | has_r) & posed).sum())
    return dict(
        step_pose_gap_p50=_q(step_gap, 0.5),
        step_pose_gap_p90=_q(step_gap, 0.9),
        step_pose_gap_max=float(step_gap.max()) if step_gap.numel() else 0.0,
        landmark_gap_p50=_q(rel, 0.5),
        landmark_gap_p90=_q(rel, 0.9),
        landmark_mismatch_share=(int(((has_p ^ has_r) & posed).sum()) / n_union
                                 if n_union else 1.0),
        landmark_mismatch_share_all=(int((has_p ^ has_r).sum()) / max(int((has_p | has_r).sum()), 1)),
        state_faults=float(faults),
        problems=float(P),
        steps=float(step_gap.numel()),
        landmarks=float(n_union),
    )


def _skew(t):
    z = torch.zeros_like(t[..., 0])
    return torch.stack([z, -t[..., 2], t[..., 1], t[..., 2], z, -t[..., 0],
                        -t[..., 1], t[..., 0], z], -1).view(t.shape[:-1] + (3, 3))


def _relative(T_boot):
    """(R, unit t) in float64 of a bootstrap pose (camera 1 in the world of
    camera 0): X1 = R X0 + t."""
    W = ref.inv_se3(T_boot.double())
    t = W[..., :3, 3]
    return W[..., :3, :3], t / t.norm(dim=-1, keepdim=True)


def _sampson64(R, t, x1, x2):
    """Sampson error (L, N) of normalized matches under E = [t]x R."""
    E = _skew(t) @ R
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    Ex1, Etx2 = x1h @ E.mT, x2h @ E
    num = (x2h * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / den


def _parallax(R, x1, x2):
    """The angle (rad) between each match's two viewing rays under R."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    r2 = x2h @ R  # camera 1's ray in camera 0's frame: Rᵀ x2h
    cos = (x1h * r2).sum(-1) / (x1h.norm(dim=-1) * r2.norm(dim=-1))
    return torch.arccos(cos.clamp(-1.0, 1.0))


def _in_front(R, t, x1, x2):
    """Whether each match triangulates (least squares in depth) in front of
    both cameras."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    a, b = x1h @ R.mT, -x2h                                   # z1 a + z2 b = -t
    aa, ab, bb = (a * a).sum(-1), (a * b).sum(-1), (b * b).sum(-1)
    at, bt = -(a * t[..., None, :]).sum(-1), -(b * t[..., None, :]).sum(-1)
    det = aa * bb - ab * ab
    z1, z2 = (bb * at - ab * bt) / det, (aa * bt - ab * at) / det
    return (z1 > 0) & (z2 > 0)


def boot_numbers(T_boot, f0: dict, f1: dict, draws, config: dict, device="cuda",
                 block: int = 64) -> dict:
    """The compared numbers of P bootstraps: the program's pose (T_boot
    (P, 4, 4)) against the reference's two-view RANSAC run in float64 on the
    same frames (f0, f1: dicts of (P, N, ...)) and draws (P, H, N).

    The 8-point hypotheses and refit take the smallest eigenvector of AᵀA,
    which float32 fixes only to ~ε·λmax/gap: on these short baselines the
    translation's direction is ill-posed in float32 (PERF.md), and two sound
    float32 runs pick poses ~1e-4-1e-3 apart.  So the pose is held to
    float64, and by what stays well-posed, per problem:

      * ``boot_rot_gap``: ||R_prog - R_64||_F / sqrt(2), the angle (rad)
        between the two rotations where it is small (an arccos of the trace
        would read float32's departure from orthonormality);
      * ``boot_front_loss``: the pose recovery's cheirality, exactly: of
        the well-posed inliers (Sampson under the float64 pose below the
        RANSAC's threshold, rays at least RAY_MIN times the gate's least
        parallax apart), the share in front of both cameras under the
        float64 pose less that under the program's.  A match with less
        parallax flips its depth's sign with the last bits of the pose;
      * read, not compared: the pose's largest entry gap ``boot_pose_gap``.
    Each as its median and 90th percentile over the problems."""
    cam = camera(config, device)
    cam64 = ref.Cam(cam.K.double(), cam.width, cam.height)
    cfg = ref_config(config)
    K = cam64.K
    norm = lambda uv: torch.stack([(uv[..., 0].double() - K[0, 2]) / K[0, 0],
                                   (uv[..., 1].double() - K[1, 2]) / K[1, 1]], -1)
    d64 = lambda f: {k: (v.double() if v.is_floating_point() else v) for k, v in f.items()}
    thr = (cfg["inlier_threshold_px"] / float(K[0, 0])) ** 2
    ray_min = RAY_MIN * config["engine"]["landmark_min_parallax_rad"]
    cols = dict(boot_rot_gap=[], boot_front_loss=[], boot_pose_gap=[])
    for lo in range(0, T_boot.shape[0], block):
        a = d64({k: v[lo:lo + block].to(device) for k, v in f0.items()})
        b = d64({k: v[lo:lo + block].to(device) for k, v in f1.items()})
        T_p = T_boot[lo:lo + block].to(device).double()
        T_r, m = ref.bootstrap_pose(a, b, draws[lo:lo + block].to(device).double(), cam64, cfg)
        x1, x2, v = norm(a["uv"]), norm(ref.take(b["uv"], m.idx)), m.valid
        (R_p, t_p), (R_r, t_r) = _relative(T_p), _relative(T_r)
        inl = (_sampson64(R_r, t_r, x1, x2) < thr) & v & (_parallax(R_r, x1, x2) >= ray_min)
        n_inl = inl.sum(-1).clamp(min=1)
        front_p, front_r = _in_front(R_p, t_p, x1, x2), _in_front(R_r, t_r, x1, x2)
        cols["boot_rot_gap"].append((R_p - R_r).flatten(-2).norm(dim=-1) / math.sqrt(2.0))
        cols["boot_front_loss"].append(((front_r & inl).sum(-1) - (front_p & inl).sum(-1))
                                       / n_inl)
        cols["boot_pose_gap"].append(pose_gap(T_p, T_r))
    out = {}
    for k, xs in cols.items():
        x = torch.nan_to_num(torch.cat(xs).double(), nan=math.inf)
        out[k + "_p50"], out[k + "_p90"] = _q(x, 0.5), _q(x, 0.9)
    out["boot_problems"] = float(T_boot.shape[0])
    return out


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) for the numbers the cell's limits
    name; a number that is not finite fails."""
    rows = [(k, nums.get(k, math.inf), float(v["limit"])) for k, v in limits["numbers"].items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def ba_config(config: dict) -> dict:
    e = config["engine"]
    return dict(window=e["local_ba_window"], stride=e["local_ba_stride"],
                every=e["local_ba_every"], iterations=e["local_ba_iterations"],
                compact_cap=e["local_ba_compact_cap"], damping_init=e["local_ba_damping_init"],
                damping=e["ba"]["damping"], huber_threshold=e["ba"]["huber_threshold"])


def slam_numbers(samples: list, config: dict, device="cuda") -> dict:
    """The compared numbers of sampled SLAM steps.

    samples: one dict a sequence: its frames (F, N, ...), its RANSAC draw
    (H, N), the program's T_boot and a copy of its carry after the start
    (``boot``), and ``steps``: (k, carry before step k, carry after it),
    copies of the program's carry (``program.SLAMSession.snapshot``).  The
    reference's SLAM step runs from the carry before; its pose rows (frame
    k and, when the local BA ran, the window), its landmarks (those it
    appended, by keypoint, and those the BA moved, by slot) are held to
    the carry after.  ``state_faults`` counts, exactly, what the step must
    leave alone and changed: pose rows outside those, ring rows other than
    frame k's, slots past the map's count; and its own pose row left as it
    found it."""
    from vobench.reference import slam as ref_slam

    cam = camera(config, device)
    cfg = ref_config(config)
    ba = ba_config(config)
    R = ba["window"] * ba["stride"]
    pose_gaps, lm_gaps, n_mis, n_union, faults = [], [], 0, 0, 0
    n_steps = 0

    def appended(before, after):
        added = after["map_valid"] & ~before["map_valid"]
        return {int(i): x for i, x in zip(after["map_id_meas"][added].tolist(),
                                          after["map_xyz"][added])}

    def well_posed(new, cand):
        """id_meas -> whether the reference's candidate counts (RAY_MIN)."""
        well = (new.ray >= RAY_MIN * config["engine"]["landmark_min_parallax_rad"]) & (
            new.depth >= DEPTH_MIN)
        return {int(i): bool(w) for i, w, c in zip(new.id_meas[0].tolist(), well[0], cand[0])
                if c}

    def compare(prog, refp, posed, centre):
        nonlocal n_mis, n_union
        keys = {i for i in prog.keys() | refp.keys() if posed.get(i, True)}
        n_mis += len(keys - (prog.keys() & refp.keys()))
        n_union += len(keys)
        for i in keys & prog.keys() & refp.keys():
            lm_gaps.append(float((prog[i] - refp[i]).norm()
                                 / (refp[i] - centre).norm().clamp(min=1e-6)))

    for smp in samples:
        x = {k: v.to(device) for k, v in smp["frames"].items()}
        fr = lambda i: {k: v[i][None] for k, v in x.items()}
        _, m = ref.bootstrap_pose(fr(0), fr(1), smp["draws"].to(device)[None], cam, cfg)
        C = smp["boot"]["map_valid"].shape[0]
        new = ref.bootstrap_points(fr(0), fr(1), m, smp["T_boot"].to(device)[None], cam, cfg, C)
        b = {k: v.to(device) for k, v in smp["boot"].items()}
        prog = {int(i): xx for i, xx in zip(b["map_id_meas"][b["map_valid"]].tolist(),
                                            b["map_xyz"][b["map_valid"]])}
        refp = {int(i): xx for i, xx, ok in zip(new.id_meas[0].tolist(), new.xyz[0], new.ok[0])
                if ok}
        compare(prog, refp, well_posed(new, m.valid), torch.zeros(3, device=device))
        for k, before, after in smp["steps"]:
            n_steps += 1
            bf = {kk: v.to(device) for kk, v in before.items()}
            af = {kk: v.to(device) for kk, v in after.items()}
            rf, new, ex = ref_slam.step(bf, k, {kk: v[k - 1] for kk, v in x.items()},
                                        {kk: v[k] for kk, v in x.items()}, cam, cfg, ba)
            due = k >= R and k % ba["every"] == 0
            rows = torch.zeros(bf["poses_all"].shape[0], dtype=torch.bool, device=device)
            rows[k] = True
            if due:
                rows[k - ba["stride"] * (ba["window"] - 1 - torch.arange(ba["window"],
                                                                          device=device))] = True
            pose_gaps.append(float(pose_gap(af["poses_all"][rows], rf["poses_all"][rows]).max()))
            faults += int((af["poses_all"][~rows] != bf["poses_all"][~rows]).any(-1).any(-1).sum())
            faults += int(bool((af["poses_all"][k] == bf["poses_all"][k]).all()))  # not written
            other = torch.arange(R, device=device) != k % R
            faults += int((af["buf_lm"][other] != bf["buf_lm"][other]).sum())
            slot = torch.arange(C, device=device)
            faults += int((af["map_valid"] & (slot >= af["map_count"])).sum())
            centre = af["poses_all"][k, :3, 3]
            # landmarks the BA moved (the slots both sides already held)
            old = bf["map_valid"]
            moved = old & ((af["map_xyz"] != bf["map_xyz"]).any(-1)
                           | (rf["map_xyz"] != bf["map_xyz"]).any(-1))
            d = (af["map_xyz"][moved] - rf["map_xyz"][moved]).norm(dim=-1)
            lm_gaps += (d / (rf["map_xyz"][moved] - centre).norm(dim=-1).clamp(min=1e-6)).tolist()
            # landmarks the step appended, by keypoint
            compare(appended(bf, af), appended(bf, rf), well_posed(new, ex["cand"]), centre)
    pg = torch.nan_to_num(torch.tensor(pose_gaps, dtype=torch.float64), nan=math.inf)
    lg = torch.nan_to_num(torch.tensor(lm_gaps, dtype=torch.float64), nan=math.inf)
    return dict(
        step_pose_gap_p50=_q(pg, 0.5),
        step_pose_gap_p90=_q(pg, 0.9),
        step_pose_gap_max=float(pg.max()) if pg.numel() else 0.0,
        landmark_gap_p50=_q(lg, 0.5),
        landmark_gap_p90=_q(lg, 0.9),
        landmark_mismatch_share=(n_mis / n_union) if n_union else 1.0,
        state_faults=float(faults),
        problems=float(len(samples)),
        steps=float(n_steps),
        landmarks=float(n_union),
    )
