"""Kernel B's share of its roofline in the traced slice, in %: the least
time one H100 needs for the work (``vobench.roofline.match_work``: 2·D per
pair of a valid query and a valid target, the targets being the map's
valid slots at each step and frame 1's keypoints in the bootstrap) over
the device time the trace gave ``match_top2_kernel``.  Reads a batched
call's answers and logs; None elsewhere."""

import torch

from vobench import roofline


def read(ctx):
    logs = ctx.get("logs")
    if logs is None:
        return None
    cfg, out = ctx["cfg"], ctx["out"]
    nq = ctx["inputs"]["valid"].sum(-1).double()                  # (B, F) valid keypoints
    count = torch.cat([out["n_boot"][:, None].long(), logs.map_count[:, :-1].long()], 1)
    pairs = float((nq[:, 1:] * count).sum() + (nq[:, 0] * nq[:, 1]).sum())
    B, F = nq.shape
    launches = [(B * (F - 1), cfg.max_obs, cfg.map_capacity), (B, cfg.max_obs, cfg.max_obs)]
    flops, nbytes = roofline.match_work(pairs, launches, cfg.desc_dim)
    return roofline.share_pct(flops, nbytes, ctx["trace"].kernel_s("match_top2_kernel"))

