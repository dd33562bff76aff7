"""Structured per-frame metrics -> JSONL (twin of ``tpuvo/utils/metrics.py``).

The reference narrates to stdout (match stats, PICP inliers, map size);
here the same signals are structured records, written once per run from
the tracker's FrameLog.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: dict[str, Any]):
        record = {"ts": time.time(), **record}
        line = json.dumps(record, default=_np_default)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


LOG_FIELDS = ("num_inliers", "chi_inliers", "iterations", "converged", "n_map_matches",
              "n_map_correct", "n_frame_matches", "n_new_points", "map_count",
              "n_dropped_candidates", "n_dropped_overflow")


def log_frame_logs(logger: MetricsLogger, logs, prefix: str = "frame"):
    """Expand a stacked FrameLog (tensors on any device, a frame axis
    first) into per-frame JSONL records; each field is pulled to the host
    once."""
    fields = {k: getattr(logs, k).detach().cpu().numpy() for k in LOG_FIELDS}
    n = len(fields["num_inliers"])
    for i in range(n):
        rec = {"event": prefix, "frame": i + 1}
        rec.update({k: v[i].item() for k, v in fields.items()})
        logger.log(rec)
