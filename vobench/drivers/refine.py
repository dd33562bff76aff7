"""The loop-closure refine of tracked sequences (``slam --refine loop``):
``sequences`` problems of the configuration's recorded sequence, each with
its own noise, tracked once each at set-up by the SLAM front end
(``slam.run_sequence_slam``, the CLI's path, each with its own RANSAC
seed); then one ``ba_refine.refine_trajectory_loop`` a unit, back to back
in a closed loop over the tracked sequences in turn: the next unit is
handed over once the last unit's refined poses and points are on the
host.  A unit's work is its F refined poses (``frames_per_s``).

The check (``numbers``): a few units of the window, drawn from the seed,
hand out each stage's inputs and outputs through the refine's ``record``
(copied to the host after the unit's latency is taken); the plain
reference (``vobench/reference/refine.py``) starts each stage from the
program's own recorded input.  The PGO passes and the sweeps are long
Levenberg-Marquardt runs, chaotic from a tracked start (two float32 runs of
one sweep end metres apart on the card), so each of their iterations is
also taken alone, from the program's own iterate:
  * exactly (limit 0): the co-visibility counts from the program's
    topology (``covis_faults``), the loop pairs from the program's counts
    (``loop_pair_faults``), the number of sweeps against the stopping rule
    applied to the program's chis (``sweep_count_faults``), and the
    hand-off (``handoff_faults``): each stage starts from the last one's
    output and each solve from its stage's input, with all its iterations,
    and returns its last iterate; the refine returns the last sweep's poses
    and points; pose 0 stays put through the PGO, poses 0 and 1 through
    every sweep; invalid map slots are never written;
  * against limits (``vobench/limits/<cell>.json``), where the control
    reads 3x what sound runs do: the loop edges' rotation and translation
    gaps; each PGO LM iteration's pose gap at the median and the 90th
    percentile; each coarse LM iteration's pose gap and each fine one's
    point gap (relative to the distance from the nearest camera) at the
    median.
Read, not compared: the topology's row mismatch share, the loop edges kept
by one side only, each whole pass's and sweep's gaps, the sweeps' LM
iterations' other gaps (the coarse sweep's points, the fine sweep's poses,
the 90th percentiles, which one accept-test flip in ten can throw), the
share of iterations whose accept test the reference decides otherwise,
each unit's loop edges and sweeps, and the tracked and refined ATE
(metres, the program's own evaluation).
"""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from vobench import check, drive, gen, stats
from vobench.trace import profiled, span

now = time.perf_counter


def _host_inputs(config: dict, traffic: dict, seed: int):
    """(the recorded sequence, its problems): ``drive.session_inputs``'s
    problems, with the sequence's path kept for the ATE."""
    seq = gen.sequence(config)
    return seq, gen.problems(seq, traffic["sequences"], traffic["lane_noise_px"],
                             gen.problem_seed(seed, 1 << 20))


def _frames(host: dict, b: int) -> dict:
    return {k: torch.as_tensor(np.array(v[b])) for k, v in host.items()}


class Refine:
    def __init__(self, config, traffic, seed, device):
        from tpuvo_torch.config import BAConfig
        from tpuvo_torch.engine import ba_refine, slam, vo
        from vobench import program

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.refine_loop = ba_refine.refine_trajectory_loop
        self.cfg = program.engine_config(config)
        self.ba = BAConfig(**config["refine"]["ba"])
        self.n_sweeps = config["refine"]["n_sweeps"]
        t = now()
        seq, self.host = _host_inputs(config, traffic, seed)
        self.path = seq["path"]
        x = gen.to_device(self.host, device)
        self.S, self.F = x["valid"].shape[:2]
        self.seqs, self.tracked = [], []
        for b in range(self.S):
            s = vo.Frame(*(x[k][b] for k in vo.Frame._fields))
            state, _, poses, _ = slam.run_sequence_slam(s, self.cfg, seed=gen.problem_seed(seed, b),
                                                        device=device)
            self.seqs.append(s)
            self.tracked.append((state, poses))
        drive.sync(device)
        self.t_inputs, t = now() - t, now()
        # the first refine of a process is the slow one; it hands out its
        # stages, as a window's checked unit does
        self.unit(0, record={})
        drive.sync(device)
        self.t_warm = now() - t
        print(f"vobench: read warm_refine_s {self.t_warm:.3f}", file=sys.stderr)

    def unit(self, j: int, record=None):
        """Refine tracked sequence j mod S; (poses, points) on the host, and
        the refine's stats."""
        state, poses = self.tracked[j % self.S]
        p, x, st = self.refine_loop(state, self.seqs[j % self.S], poses, self.cfg, self.ba,
                                    n_sweeps=self.n_sweeps, record=record)
        return p.cpu(), x.cpu(), st

    def window(self, seconds: float) -> dict:
        rng = random.Random(self.seed)
        m = self.traffic["check_problems"]
        lat, kept, units, failed = [], [], [], 0
        t0 = t_done = now()
        stop = t0 + seconds
        j = 0
        while now() < stop:
            slot = len(kept) if len(kept) < m else rng.randrange(j + 1)
            rec = {} if slot < m else None
            t = now()
            poses, points, st = self.unit(j, rec)
            t_done = now()
            lat.append(t_done - t)
            failed += int(not (bool(torch.isfinite(poses).all())
                               and bool(torch.isfinite(points).all())))
            units.append(dict(j=j, poses=poses, n_loop_edges=st[0]["n_loop_edges"],
                              n_sweeps=len(st) - 1))
            if rec is not None:
                item = dict(j=j, rec=drive.to_cpu(rec), poses=poses, points=points, stats=st)
                if slot < len(kept):
                    kept[slot] = item
                else:
                    kept.append(item)
            j += 1
        self.kept, self.units = kept, units
        return dict(attempted=len(lat), failed=failed, latencies=lat,
                    metrics=dict(frames_per_s=stats.rate(len(lat) * self.F, t0, t_done)))

    def sample(self, n: int) -> dict:
        """The kept units with what the check reads beside their record (the
        tracked map and poses, the frames), and every unit's read numbers."""
        from tpuvo_torch.engine.eval import evaluate

        ate = lambda p: float(evaluate(p, self.path, self.cfg).ate_rmse)
        tracked = [(drive.to_cpu(st._asdict()), p.cpu()) for st, p in self.tracked]
        ate_tracked = [ate(p) for _, p in tracked]
        units = [dict(n_loop_edges=u["n_loop_edges"], n_sweeps=u["n_sweeps"],
                      ate_tracked=ate_tracked[u["j"] % self.S], ate_refined=ate(u["poses"]))
                 for u in self.units]
        items = []
        for it in self.kept[:n]:
            b = it["j"] % self.S
            st, p = tracked[b]
            items.append(dict(it, map=dict(xyz=st["map_xyz"], desc=st["map_desc"],
                                           valid=st["map_valid"]),
                              tracked=p, frames=_frames(self.host, b)))
        return dict(units=units, refine=items)

    def traced(self) -> dict:
        """The mix's ``trace_units`` refines timed alone (untraced), then the
        same refines under the profiler, each in a span."""
        n = self.traffic["trace_units"]
        t = now()
        for j in range(n):
            self.unit(10**6 + j)
        plain_s = now() - t
        got = {}
        with profiled(got):
            for j in range(n):
                with span("unit"):
                    self.unit(10**6 + j)
        return dict(trace=got["trace"], steps=n, plain_s=plain_s, host={})


def make(config, traffic, seed, device):
    return Refine(config, traffic, seed, device)


# -- the check ---------------------------------------------------------------
def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _rot_gap(A, B):
    return (A[..., :3, :3] - B[..., :3, :3]).flatten(-2).norm(dim=-1) / math.sqrt(2.0)


def _q(xs, q):
    x = torch.nan_to_num(torch.cat([v.double().flatten() for v in xs]) if xs
                         else torch.zeros(0, dtype=torch.float64), nan=math.inf)
    return check._q(x, q)


def _point_gap(prog, refx, before, valid, centres):
    """|prog - ref| over the distance from the nearest camera, for the valid
    points that either side moved from ``before``."""
    moved = valid & ((prog != before).any(-1) | (refx != before).any(-1))
    d = torch.cdist(refx[moved], centres).amin(-1) if moved.any() else refx[:0, 0]
    return (prog[moved] - refx[moved]).norm(dim=-1) / d.clamp(min=1e-6)


def _accepted(a, b, floor: float) -> bool:
    """Whether an LM iteration from state a to state b kept its step: the
    damping halves on a kept step (stays at its floor) and grows on a
    rejected one."""
    return bool(b["lam"] < a["lam"]) or bool((b["lam"] == a["lam"]) & (a["lam"] <= floor))


def numbers(payload: dict, config: dict, device) -> dict:
    """The check's numbers of the kept units (``refine``): each stage of
    the reference from the program's recorded input, and each LM iteration
    of each PGO pass and sweep from the program's own iterate; see the
    module."""
    from vobench.reference import refine as ref, vo as ref_vo

    items = payload.get("refine") or []
    units = payload.get("units") or []
    nums = dict(units=float(len(units)),
                n_loop_edges=[u["n_loop_edges"] for u in units],
                n_sweeps=[u["n_sweeps"] for u in units],
                ate_tracked_m=[round(u["ate_tracked"], 4) for u in units],
                ate_refined_m=[round(u["ate_refined"], 4) for u in units])
    if not items:
        nums["handoff_faults"] = math.inf
        return nums
    r = config["refine"]
    fx, ba = config["fixed_by_program"], r["ba"]
    cam = check.camera(config, device)
    mcfg = check.ref_config(config)
    K = cam.K
    eq = lambda a, b: bool(torch.equal(a, b))
    g = {k: [] for k in ("edge_rot", "edge_trans", "l2", "robust", "coarse_pose", "coarse_point",
                         "fine_pose", "fine_point", "pgo_step", "coarse_step_pose",
                         "coarse_step_point", "fine_step_pose", "fine_step_point")}
    n = dict.fromkeys(("topo_mis", "topo", "covis", "pair", "one_side", "either", "count", "hand",
                       "pgo_steps", "pgo_flips", "ba_steps", "ba_flips"), 0)
    chi_gaps = []
    for it in items:
        rec = _to(it["rec"], device)
        lp = rec["loops"]
        mp = _to(it["map"], device)
        fr = _to(it["frames"], device)
        lm, ok = rec["obs_lm"], rec["obs_valid"]
        poses_in = rec["poses_in"]
        F = poses_in.shape[0]
        faults = []

        # -- the topology, and what follows from the program's ----------------
        lm_r, ok_r = ref.topology(mp["desc"], mp["valid"], fr["desc"], fr["valid"],
                                  mcfg["distance_threshold"], mcfg["ratio_threshold"])
        n["topo_mis"] += int(((ok_r != ok) | (ok_r & ok & (lm_r != lm.long()))).sum())
        n["topo"] += int((ok_r | ok).sum())
        n["covis"] += int((ref.covisibility(lm, ok, mp["valid"]) != lp["covis"]).sum())
        pairs_r, pv_r = ref.loop_pairs(lp["covis"], fx["min_gap"], fx["min_shared"],
                                       fx["max_edges"])
        n["pair"] += int(((pairs_r != lp["pairs"]).any(-1) | (pv_r != lp["pairs_valid"])).sum())

        # -- the loop edges from the program's pairs and draw -----------------
        Z, w = ref.loop_edges(K, poses_in, mp["xyz"], mp["valid"], fr["uv"], lm, ok,
                              lp["pairs"], lp["pairs_valid"], lp["uniforms"], cam, fx)
        kp, kr = lp["w"] > 0, w > 0
        n["one_side"] += int((kp ^ kr).sum())
        n["either"] += int((kp | kr).sum())
        both = kp & kr
        g["edge_rot"].append(_rot_gap(lp["Z"][both], Z[both]))
        g["edge_trans"].append((lp["Z"][both, :3, 3] - Z[both, :3, 3]).norm(dim=-1))

        # -- each PGO pass: whole from its input, and iteration by iteration --
        eij, eT, ew = ref.graph_edges(poses_in, lp["pairs"], lp["Z"], lp["w"],
                                      fx["odo_weight"], fx["loop_weight"])
        fixed = torch.arange(F, device=device) < 1
        for name, start, out, iters, thr in (
                ("l2", poses_in, lp["pgo_l2"], fx["pgo_iterations"], 1.0e8),
                ("robust", lp["pgo_l2"], lp["pgo_robust"], max(fx["pgo_iterations"] // 3, 10),
                 1.0)):
            whole, _ = ref.pgo(start, eij, eT, ew, fixed, iters, thr)
            g[name].append(check.pose_gap(out, whole))
            its = (lp.get("pgo_%s_solve" % name) or {}).get("iterations") or []
            faults += [len(its) != iters + 1,
                       not its or not eq(its[0]["poses"], start),
                       not its or not eq(its[-1]["poses"], out)]
            for a, b in zip(its, its[1:]):
                p1, _, _, acc = ref.pgo_iteration(a["poses"], a["lam"], a["chi"], eij, eT, ew,
                                                  fixed, thr)
                g["pgo_step"].append(check.pose_gap(b["poses"], p1))
                n["pgo_steps"] += 1
                n["pgo_flips"] += int(bool(acc) != _accepted(a, b, 1e-6))

        # -- each sweep: whole from its input, and iteration by iteration -----
        sweeps = rec["sweeps"]
        for s in sweeps:
            coarse = s["kind"] == "coarse"
            kind = "coarse" if coarse else "fine"
            thr = max(ba["huber_threshold"], 1.0e8) if coarse else ba["huber_threshold"]
            p, x, chi, _, _ = ref.sweep(s["poses_before"], s["points_before"], mp["valid"],
                                        fr["uv"], lm, ok, K, thr, coarse, ba["iterations"])
            g[kind + "_pose"].append(check.pose_gap(s["poses_after"][2:], p[2:]))
            g[kind + "_point"].append(_point_gap(s["points_after"], x, s["points_before"],
                                                 mp["valid"], p[:, :3, 3]))
            chi_gaps.append(abs(float(s["chi"]) - float(chi)) / max(abs(float(chi)), 1e-30))
            sv = s.get("solve") or {}
            its = sv.get("iterations") or []
            slots = sv.get("slots")
            faults += [len(its) != ba["iterations"] + 1,
                       "fixed" not in sv or not eq(sv["fixed"],
                                                   torch.arange(F, device=device) < 2)]
            if not its:
                continue
            gather = (lambda X: X) if slots is None else (
                lambda X: X[slots.clamp(max=X.shape[0] - 1)])
            faults.append(not eq(its[0]["points"], gather(s["points_before"])))
            last = its[-1]["points"]
            if slots is not None:  # the solve's points back in their slots
                ext = torch.cat([s["points_before"], s["points_before"][:1]])
                last = ext.index_copy(0, torch.where(slots < mp["xyz"].shape[0], slots,
                                                     mp["xyz"].shape[0]), last)[:-1]
            fin = bool(torch.isfinite(its[-1]["poses"]).all())
            expect = torch.where((fin & torch.isfinite(last).all(1))[:, None], last,
                                 s["points_before"])
            faults.append(not eq(s["points_after"], expect))
            for a, b in zip(its, its[1:]):
                wic, X, _, _, acc, _ = ref.ba_iteration(
                    a["poses"], a["points"], a["lam"], a["chi"], sv["point_valid"], fr["uv"],
                    sv["obs_lm"], ok, sv["fixed"], K, thr, coarse)
                g[kind + "_step_pose"].append(check.pose_gap(b["poses"], wic))
                g[kind + "_step_point"].append(_point_gap(
                    b["points"], X, a["points"], sv["point_valid"],
                    ref_vo.inv_se3(wic)[:, :3, 3]))
                n["ba_steps"] += 1
                n["ba_flips"] += int(bool(acc) != _accepted(a, b, 1e-6))

        # -- the number of sweeps, by the rule on the program's chis ----------
        chis = [float(s["chi"]) for s in sweeps]
        n["count"] += abs(ref.sweep_count(chis, r["n_sweeps"], fx["max_sweeps"],
                                          fx["rel_improvement_stop"]) - len(chis))

        # -- the hand-off between stages, exactly ------------------------------
        n_loops = int(kp.sum())
        rob_ok = bool(torch.isfinite(lp["pgo_robust"]).all()) and n_loops > 0
        faults += [not eq(poses_in, _to(it["tracked"], device)),
                   not eq(lp["poses_pgo"], lp["pgo_robust"] if rob_ok else poses_in),
                   not eq(lp["pgo_l2"][0], poses_in[0]), not eq(lp["pgo_robust"][0], poses_in[0]),
                   it["stats"][0]["n_loop_edges"] != n_loops,
                   len(it["stats"]) - 1 != len(sweeps), not sweeps,
                   not eq(_to(it["poses"], device),
                          sweeps[-1]["poses_after"] if sweeps else poses_in),
                   not eq(_to(it["points"], device),
                          sweeps[-1]["points_after"] if sweeps else mp["xyz"])]
        prev_p, prev_x = lp["poses_pgo"], mp["xyz"]
        for i, s in enumerate(sweeps):
            faults += [s["kind"] != ("coarse" if i == 0 else "fine"),
                       not eq(s["poses_before"], prev_p), not eq(s["points_before"], prev_x),
                       not eq(s["poses_after"][:2], s["poses_before"][:2]),
                       not eq(s["points_after"][~mp["valid"]], s["points_before"][~mp["valid"]])]
            prev_p, prev_x = s["poses_after"], s["points_after"]
        n["hand"] += sum(faults)

    for k, name in (("edge_rot", "loop_edge_rot_gap"), ("edge_trans", "loop_edge_trans_gap"),
                    ("l2", "pgo_l2_pose_gap"), ("robust", "pgo_robust_pose_gap"),
                    ("coarse_pose", "coarse_pose_gap"), ("coarse_point", "coarse_point_gap"),
                    ("fine_pose", "fine_pose_gap"), ("fine_point", "fine_point_gap"),
                    ("pgo_step", "pgo_step_pose_gap"),
                    ("coarse_step_pose", "coarse_step_pose_gap"),
                    ("coarse_step_point", "coarse_step_point_gap"),
                    ("fine_step_pose", "fine_step_pose_gap"),
                    ("fine_step_point", "fine_step_point_gap")):
        nums[name + "_p50"], nums[name + "_p90"] = _q(g[k], 0.5), _q(g[k], 0.9)
    nums.update(
        topology_mismatch_share=n["topo_mis"] / n["topo"] if n["topo"] else 1.0,
        covis_faults=float(n["covis"]), loop_pair_faults=float(n["pair"]),
        loop_edge_one_side_share=n["one_side"] / n["either"] if n["either"] else 0.0,
        pgo_step_flip_share=n["pgo_flips"] / max(n["pgo_steps"], 1),
        sweep_step_flip_share=n["ba_flips"] / max(n["ba_steps"], 1),
        sweep_count_faults=float(n["count"]), handoff_faults=float(n["hand"]),
        sweep_chi_rel_gap_max=max(chi_gaps) if chi_gaps else 0.0,
        checked_units=float(len(items)))
    return nums


def control(config, traffic, seed, precision, device):
    """The reference in the program's place: the reference's own SLAM run
    (float32) of the mix's first ``check_problems`` sequences, each with the
    draw a run gives it, then the reference's whole refine closed loop in
    the control's precision, its stages recorded as the program records
    them; judged as a run is."""
    from vobench.reference import refine as ref, run as ref_run

    e = config["engine"]
    H, N, C = e["ransac"]["num_hypotheses"], e["max_obs"], e["map_capacity"]
    _, host = _host_inputs(config, traffic, seed)
    cam = check.camera(config, device)
    cfg, ba_local = check.ref_config(config), check.ba_config(config)
    items = []
    for b in range(min(traffic["check_problems"], traffic["sequences"])):
        frames = _frames(host, b)
        F = frames["valid"].shape[0]
        fd = {k: v.to(device) for k, v in frames.items()}
        draws = check.uniforms(gen.problem_seed(seed, b), (H, N))
        c = ref_run.run_slam(fd, draws, cam, cfg, ba_local, C, {F - 1})["steps"][-1][2]
        with drive._lowered(precision):
            p, x, rec = ref.refine(c["map_xyz"], c["map_desc"], c["map_valid"], fd,
                                   c["poses_all"], cam, cfg,
                                   dict(config["refine"], fixed_by_program=config["fixed_by_program"]))
        n_loops = int((rec["loops"]["w"] > 0).sum())
        st = [dict(stage="pgo", n_loop_edges=n_loops)] + [{} for _ in rec["sweeps"]]
        items.append(dict(rec=drive.to_cpu(rec), poses=p.cpu(), points=x.cpu(), stats=st,
                          map=dict(xyz=c["map_xyz"].cpu(), desc=c["map_desc"].cpu(),
                                   valid=c["map_valid"].cpu()),
                          tracked=c["poses_all"].cpu(), frames=frames))
    return numbers(dict(refine=items, units=[]), config, device)
