"""Write a sequence as a dataset in the reference's file layout — the
inverse of ``tpuvo_torch.data.loader``.

``write_dataset(out_dir, seq, world, cfg)`` writes ``meas-%05d.dat`` per
frame, ``world.dat``, ``trajectoy.dat`` [sic] and ``camera.dat`` (the
camera of ``cfg``), so a synthetic sequence can go through the CLI and the
parsers.  Floats are written with ``%.9g``: every float32 survives the
round trip, so the parsers give back the sequence's own arrays.
"""

from __future__ import annotations

import os

import numpy as np

from tpuvo_torch.config import EngineConfig


def _row(values) -> str:
    return " ".join(f"{float(v):.9g}" for v in values)


def write_dataset(out_dir: str, seq, world, cfg: EngineConfig | None = None) -> str:
    """seq: a FrameObservations whose valid rows are a prefix of each frame
    (as ``synthetic.render_sequence`` gives); world: its WorldPoints.
    Returns out_dir."""
    cfg = cfg or EngineConfig()
    os.makedirs(out_dir, exist_ok=True)
    for i in range(seq.uv.shape[0]):
        n = int(seq.n_obs[i])
        if not seq.valid[i, :n].all():
            raise ValueError(f"frame {i}: the valid rows are not the first n_obs={n}")
        lines = [f"seq: {i}", f"gt_pose: {_row(seq.gt_pose[i])}",
                 f"odom_pose: {_row(seq.odom_pose[i])}"]
        lines += [f"point {int(seq.id_meas[i, k])} {int(seq.id_real[i, k])} "
                  f"{_row(seq.uv[i, k])} {_row(seq.desc[i, k])}" for k in range(n)]
        with open(os.path.join(out_dir, f"meas-{i:05d}.dat"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "world.dat"), "w") as f:
        for k in range(len(world.ids)):
            f.write(f"{int(world.ids[k])} {_row(world.xyz[k])} {_row(world.desc[k])}\n")
    with open(os.path.join(out_dir, "trajectoy.dat"), "w") as f:
        for i in range(seq.uv.shape[0]):
            f.write(f"{i} {_row(seq.odom_pose[i])} {_row(seq.gt_pose[i])}\n")
    write_camera(os.path.join(out_dir, "camera.dat"), cfg)
    return out_dir


def write_camera(path: str, cfg: EngineConfig):
    """camera.dat of cfg's camera: K, the mount (cam_transform), the depth
    range and the image size — what ``EngineConfig.from_camera_dat`` reads."""
    with open(path, "w") as f:
        f.write("camera matrix:\n" + "\n".join(_row(r) for r in cfg.K()) + "\n")
        f.write("cam_transform:\n" + "\n".join(_row(r) for r in cfg.mount_T()) + "\n")
        f.write(f"z_near: {cfg.z_near:.9g}\nz_far: {cfg.z_far:.9g}\n"
                f"width: {cfg.width}\nheight: {cfg.height}\n")


def differing_fields(a, b) -> list[str]:
    """The fields of two FrameObservations that differ (empty: all equal)."""
    return [k for k in a._fields if not np.array_equal(getattr(a, k), getattr(b, k))]
