"""Build and load the port's CUDA kernels (``tpuvo_torch/csrc/*.cu``).

At first use every source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.
The library lives in ``build/tpuvo_torch/`` at the repository root, named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached build.  Nothing is compiled at import time.

No ``--use_fast_math``: the PICP relative-chi stop is knife-edge, and
approximate sin/cos/sqrt/division would move GN iteration counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpuvo_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # world, idx, uv, valid, T0, thresholds (or NULL), K on the card (or
    # NULL), then the outputs T, num_inliers, chi_inliers, chi_outliers,
    # iterations, converged; B, N, M, the lane strides of world, idx, uv,
    # valid; fx, fy, cx, cy, width, height, thr, damping, conv, max_it,
    # min_inl, keep_outliers, anneal, anneal_mult, stream
    "tpuvo_picp_solve": [_P] * 13 + [_I] * 3 + [_L] * 4 + [_F] * 9 + [_I] * 4 + [_F, _P],
    # d1, v1, d2, v2, best, idx, second, accept, B (lanes), N, M, D, the
    # lane strides of d1, v1, d2, v2, query tile, queries per thread, map
    # splits, dist_thr, ratio_thr, stream
    "tpuvo_match_top2": [_P] * 8 + [_I] * 4 + [_L] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    # A, w, V, rotations (or NULL), batch, n, stream
    "tpuvo_sym_eig": [_P] * 4 + [_I] * 2 + [_P],
    # A, U, S, Vt, rotations (or NULL), batch, stream
    "tpuvo_svd3": [_P] * 5 + [_I, _P],
    # values, order, bounds, out, n (entries), n_targets, cols, stream
    "tpuvo_segsum": [_P] * 4 + [_L, _L, _I, _P],
    # Wp, Hinv, bl, Hpp, bp, pair_lm, pair_f, lm_bounds, frame_order,
    # frame_bounds, S, b, W, n_max (a frame's pairs at most), stream
    "tpuvo_schur_reduce": [_P] * 12 + [_I, _I, _P],
    # Wp, Hinv, bl, dx, pair_f, lm_bounds, out, La, stream
    "tpuvo_schur_backsub": [_P] * 7 + [_L, _P],
}

_lib = None
build_seconds = None   # wall time of the compile in this process (None: cached)
build_log = ""         # nvcc's output (register / shared-memory report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libtpuvo_torch_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        objs = [out.with_name(f"{src.stem}.{os.getpid()}.o") for src in sources]
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]  # waits for every compile
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log = "".join(logs) + link.stdout + link.stderr
        for obj in objs:
            obj.unlink(missing_ok=True)
        codes = [p.returncode for p in procs] + [link.returncode]
        if any(codes):
            raise RuntimeError(f"nvcc failed (exits {codes}):\n{build_log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_device(*tensors) -> None:
    """Every kernel argument must be a tensor on the current device."""
    import torch

    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device.index != torch.cuda.current_device():
            raise ValueError(f"kernel argument on {t.device}, expected the current CUDA device")


def lanes(x):
    """A kernel argument with a leading lane axis as (tensor, lane stride in
    elements): x itself when each lane is contiguous (a lane of a larger
    tensor, or one lane shared by all at stride 0), else a contiguous copy."""
    if x.shape[0] > 1 and x[0].is_contiguous():
        return x, x.stride(0)
    x = x if x[0].is_contiguous() else x.contiguous()
    return x, x[0].numel()
