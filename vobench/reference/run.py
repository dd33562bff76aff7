"""The plain reference run closed loop over whole sequences: the bootstrap,
then every step from its own previous state, its map grown by appending.
It stands in the program's place for the lower-precision control and
returns the answers in the layout ``vobench/program.py`` gives the check.
"""

from __future__ import annotations

import torch

from vobench.reference import vo


def _append(mp: dict, new: vo.NewPoints, desc, k: int):
    """Write the landing candidates of ``new`` in order from each problem's
    count; ``desc`` (L, Kc, D) their descriptors."""
    L, C = mp["valid"].shape
    slot = mp["count"][:, None] + torch.cumsum(new.ok.long(), -1) - 1
    rows = torch.arange(L, device=slot.device)[:, None].expand_as(slot)[new.ok]
    s = slot[new.ok]
    mp["xyz"][rows, s] = new.xyz[new.ok]
    mp["desc"][rows, s] = desc[new.ok]
    mp["id_meas"][rows, s] = new.id_meas[new.ok].to(mp["id_meas"].dtype)
    mp["valid"][rows, s] = True
    mp["last_seen"][rows, s] = k
    mp["count"] = mp["count"] + new.ok.sum(-1)


def run(inputs: dict, draws, cam: vo.Cam, cfg: dict, capacity: int) -> dict:
    x = inputs
    L, F, N = x["valid"].shape
    D = x["desc"].shape[-1]
    dev = x["uv"].device
    fr = lambda i: {k: v[:, i] for k, v in x.items()}
    mp = dict(xyz=torch.zeros(L, capacity, 3, device=dev),
              desc=torch.zeros(L, capacity, D, device=dev),
              id_meas=torch.full((L, capacity), -1, dtype=torch.int32, device=dev),
              valid=torch.zeros(L, capacity, dtype=torch.bool, device=dev),
              last_seen=torch.zeros(L, capacity, dtype=torch.int32, device=dev),
              count=torch.zeros(L, dtype=torch.long, device=dev))
    T_boot, m = vo.bootstrap_pose(fr(0), fr(1), draws.to(dev), cam, cfg)
    new = vo.bootstrap_points(fr(0), fr(1), m, T_boot, cam, cfg, capacity)
    _append(mp, new, x["desc"][:, 0], 0)
    n_boot = mp["count"].clone()
    pose = torch.eye(4, device=dev).expand(L, 4, 4).clone()
    poses = [pose]
    Kc = cfg["max_new_landmarks_per_frame"]
    for k in range(1, F):
        curr, nxt = fr(k - 1), fr(k)
        m = vo.Map(mp["xyz"], mp["desc"], mp["valid"], mp["count"])
        pose, new, _ = vo.step(pose, m, curr, nxt, cam, cfg)
        is_new_desc = vo.take(curr["desc"], new.id_meas.long().clamp(0, N - 1))[:, :Kc]
        _append(mp, new, is_new_desc, k)
        poses.append(pose)
    return dict(T_boot=T_boot, n_boot=n_boot, poses=torch.stack(poses, 1),
                map_xyz=mp["xyz"], map_desc=mp["desc"], map_id_meas=mp["id_meas"],
                map_valid=mp["valid"], map_last_seen=mp["last_seen"],
                map_count=mp["count"].to(torch.int32))


def run_slam(frames: dict, draws, cam: vo.Cam, cfg: dict, ba: dict, capacity: int,
             picks) -> dict:
    """The reference SLAM run closed loop over one sequence (frames (F, N,
    ...)), copying its carry after the start and around the steps in
    ``picks``: the layout of ``program.SLAMSession``'s samples."""
    from vobench.reference import slam

    F, N = frames["valid"].shape
    D = frames["desc"].shape[-1]
    dev = frames["uv"].device
    fr = lambda i: {k: v[i][None] for k, v in frames.items()}
    T_boot, m = vo.bootstrap_pose(fr(0), fr(1), draws[None].to(dev), cam, cfg)
    new = vo.bootstrap_points(fr(0), fr(1), m, T_boot, cam, cfg, capacity)
    mp = dict(xyz=torch.zeros(1, capacity, 3, device=dev),
              desc=torch.zeros(1, capacity, D, device=dev),
              id_meas=torch.full((1, capacity), -1, dtype=torch.int32, device=dev),
              valid=torch.zeros(1, capacity, dtype=torch.bool, device=dev),
              last_seen=torch.zeros(1, capacity, dtype=torch.int32, device=dev),
              count=torch.zeros(1, dtype=torch.long, device=dev))
    _append(mp, new, frames["desc"][0][None], 0)
    R = ba["window"] * ba["stride"]
    Nb = N + cfg["max_new_landmarks_per_frame"]
    eye = torch.eye(4, device=dev)
    c = dict(pose=eye.clone(), map_xyz=mp["xyz"][0], map_desc=mp["desc"][0],
             map_id_meas=mp["id_meas"][0], map_valid=mp["valid"][0],
             map_last_seen=mp["last_seen"][0], map_count=mp["count"][0].to(torch.int32),
             poses_all=eye.expand(F, 4, 4).clone(),
             buf_lm=torch.zeros(R, Nb, dtype=torch.int64, device=dev),
             buf_valid=torch.zeros(R, Nb, dtype=torch.bool, device=dev),
             buf_uv=torch.zeros(R, Nb, 2, device=dev))
    out = dict(T_boot=T_boot[0], boot={k: v.clone() for k, v in c.items()}, steps=[])
    for k in range(1, F):
        before = c
        c = slam.step(c, k, {kk: v[k - 1] for kk, v in frames.items()},
                      {kk: v[k] for kk, v in frames.items()}, cam, cfg, ba)[0]
        if k in picks:
            out["steps"].append((k, before, c))
    return out
