"""ctypes binding to the native C++ measurement parser (``csrc/loader.cpp``).

The port's own copy of ``tpuvo/data/native.py``: a zero-dependency C++17
tokenizer that fills caller-allocated padded arrays directly.

At first use the source is compiled with the host C++ compiler (``$CXX``,
else ``c++``; no nvcc) with the flags of ``csrc/Makefile`` into
``build/tpuvo_torch/``, named by a hash of the source and flags, so an
edited source rebuilds and an unchanged one loads the cached build.
Nothing is compiled at import time.

No compiler on the host: ``library()`` warns once with the reason and
returns None, and ``tpuvo_torch.data.loader`` uses the Python parser.  A
compile that fails raises with the compiler's output; a file the parser
cannot read raises too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuvo_torch"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]


def _compiler() -> list[str] | None:
    """The host C++ compiler's command ($CXX, else c++), None if absent."""
    cmd = shlex.split(os.environ.get("CXX") or "c++")
    if not cmd or shutil.which(cmd[0]) is None:
        return None
    return cmd


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL | None:
    """The loaded parser library, compiling it first if needed; None (after
    one warning) when the host has no C++ compiler."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SRC.read_bytes())
    out = BUILD_DIR / f"libtpuvo_io_{h.hexdigest()[:16]}.so"
    if not out.exists():
        cxx = _compiler()
        if cxx is None:
            warnings.warn(
                f"no C++ compiler ({os.environ.get('CXX') or 'c++'!r} not found; set CXX): "
                "the .dat files are read by the Python parser", RuntimeWarning, stacklevel=3)
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        res = subprocess.run([*cxx, *CXXFLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cxx)} failed on {SRC.name} (exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(out))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.tpuvo_parse_measurement.restype = ctypes.c_int
    lib.tpuvo_parse_measurement.argtypes = [
        ctypes.c_char_p,  # path
        ctypes.c_int,     # max_obs
        ctypes.c_int,     # desc_dim
        f32p,             # gt_pose (3,)
        f32p,             # odom_pose (3,)
        i32p,             # id_meas (max_obs,)
        i32p,             # id_real (max_obs,)
        f32p,             # uv (max_obs, 2)
        f32p,             # desc (max_obs, desc_dim)
    ]
    return lib


def available() -> bool:
    """Whether the native parser can be used (builds it at first call)."""
    return library() is not None


def load_sequence(data_dir: str, n_frames: int, prefix: str, max_obs: int):
    """The padded FrameObservations of ``{data_dir}/{prefix}%05d.dat``, i in
    [0, n_frames), parsed by the library (which must be available)."""
    from tpuvo_torch.config import DESC_DIM
    from tpuvo_torch.data.loader import FrameObservations, parse_measurement

    lib = library()
    if lib is None:
        raise RuntimeError("the native parser is not available (no C++ compiler)")
    F = n_frames
    uv = np.zeros((F, max_obs, 2), np.float32)
    desc = np.zeros((F, max_obs, DESC_DIM), np.float32)
    id_meas = np.full((F, max_obs), -1, np.int32)
    id_real = np.full((F, max_obs), -1, np.int32)
    valid = np.zeros((F, max_obs), bool)
    n_obs = np.zeros((F,), np.int32)
    gt_pose = np.zeros((F, 3), np.float32)
    odom_pose = np.zeros((F, 3), np.float32)

    for i in range(F):
        path = os.path.join(data_dir, f"{prefix}{i:05d}.dat")
        n = lib.tpuvo_parse_measurement(
            path.encode(), max_obs, DESC_DIM, gt_pose[i], odom_pose[i],
            id_meas[i], id_real[i], uv[i].reshape(-1), desc[i].reshape(-1),
        )
        if n == -2:  # more observations than max_obs: the Python parser's error
            n = len(parse_measurement(path)[3])
            raise ValueError(f"{path}: {n} observations exceeds max_obs={max_obs}")
        if n < 0:
            raise OSError(f"native parser cannot read {path!r} (rc={n})")
        n_obs[i] = n
        valid[i, :n] = True

    return FrameObservations(uv, desc, id_meas, id_real, valid, n_obs, gt_pose, odom_pose)
