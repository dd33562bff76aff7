"""Small dense eigensolvers: wrapper of ``csrc/smalleig.cu`` (kernel C).

Replaces no Pallas kernel: the JAX package's two-view bootstrap calls XLA's
``jnp.linalg.eigh`` (the RANSAC refit's 9x9 normal matrix,
``tpuvo/ops/twoview.py:60``) and ``jnp.linalg.svd`` (the essential-manifold
projection, ``:64``, and ``decompose_essential``, ``:165``).  On the card
``torch.linalg.eigh`` / ``svd`` read their error code on the host, which a
CUDA graph cannot capture, so the bootstrap's graph runs this kernel:

  * ``sym_eig(A)``: batched symmetric (..., n, n) f32, n <= 9 (the lower
    triangle is read, as ``torch.linalg.eigh`` does) -> (eigenvalues in
    ascending order (..., n), eigenvectors as columns (..., n, n));
  * ``svd3(A)``: batched (..., 3, 3) f32 -> (U, S in descending order,
    Vt), as ``torch.linalg.svd``.

Canonical signs: each eigenvector, and each singular pair (u_i, v_i)
together, is flipped so that the largest-magnitude component of the
eigenvector, or of v_i, is positive (the first such component on a tie).
The libraries leave these signs to their algorithms (the JAX package's own
history: ``tpuvo/ops/twoview.py:163-175``); the plain versions here apply
the rule to ``torch.linalg``'s output, so the two routes agree wherever the
vectors are determined (distinct eigenvalues, distinct nonzero singular
values).

Each entry point is one launch for the whole batch.  For CPU tensors the
wrapper runs the plain version; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops.cuda import build

launches = 0  # kernel launches in this process (reset by callers that count)

MAX_N = 9     # the largest symmetric matrix the kernel takes


def on_card(t) -> bool:
    """Whether a call on ``t`` launches the kernel (else its plain version)."""
    return t.is_cuda


def canonical_signs(V):
    """(..., 1, n) of -1 and 1: the sign that makes each column of V
    (..., n, n) have its largest-magnitude component (the first on a tie)
    positive."""
    k = torch.argmax(V.abs(), dim=-2, keepdim=True)
    pick = torch.take_along_dim(V, k, dim=-2)
    return torch.where(pick < 0, -1.0, 1.0).to(V.dtype)


def sym_eig_reference(A):
    """Plain version of ``sym_eig``: ``torch.linalg.eigh`` with the
    canonical signs."""
    w, V = torch.linalg.eigh(A)
    return w, V * canonical_signs(V)


def svd3_reference(A):
    """Plain version of ``svd3``: ``torch.linalg.svd`` with each pair's sign
    set by v_i (a row of Vt)."""
    U, S, Vt = torch.linalg.svd(A)
    sign = canonical_signs(Vt.mT)
    return U * sign, S, Vt * sign.mT


def _flat(A, n: int):
    if A.shape[-2:] != (n, n):
        raise ValueError(f"expected (..., {n}, {n}) matrices, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 matrices, not {A.dtype}")
    flat = A.reshape(-1, n, n).contiguous()
    build.check_device(flat)
    return flat


def prepare_sym_eig(A, rotations=None):
    """Checked kernel arguments for a CUDA tensor (..., n, n), n <= 9, and
    freshly allocated outputs: returns (launch, (w, V)), where ``launch()``
    enqueues one kernel for the whole batch.  ``rotations``: an optional
    int32 tensor of one element per matrix that receives the Jacobi
    rotations applied."""
    n = A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the eigensolver takes 1..{MAX_N} rows, not {n}")
    flat = _flat(A, n)
    batch = flat.shape[0]
    lib = build.library()
    w = torch.empty((batch, n), dtype=torch.float32, device=flat.device)
    V = torch.empty((batch, n, n), dtype=torch.float32, device=flat.device)
    rot = _rotations(rotations, batch)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    args = (flat.data_ptr(), w.data_ptr(), V.data_ptr(), rot, batch, n, stream)

    def launch(_alive=(flat, w, V, rotations)):
        global launches
        build.check(lib.tpuvo_sym_eig(*args), "tpuvo_sym_eig")
        launches += 1

    return launch, (w.reshape(A.shape[:-1]), V.reshape(A.shape))


def prepare_svd3(A, rotations=None):
    """As ``prepare_sym_eig`` for ``svd3``: (launch, (U, S, Vt))."""
    flat = _flat(A, 3)
    batch = flat.shape[0]
    lib = build.library()
    U = torch.empty((batch, 3, 3), dtype=torch.float32, device=flat.device)
    S = torch.empty((batch, 3), dtype=torch.float32, device=flat.device)
    Vt = torch.empty((batch, 3, 3), dtype=torch.float32, device=flat.device)
    rot = _rotations(rotations, batch)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    args = (flat.data_ptr(), U.data_ptr(), S.data_ptr(), Vt.data_ptr(), rot, batch, stream)

    def launch(_alive=(flat, U, S, Vt, rotations)):
        global launches
        build.check(lib.tpuvo_svd3(*args), "tpuvo_svd3")
        launches += 1

    return launch, (U.reshape(A.shape), S.reshape(A.shape[:-1]), Vt.reshape(A.shape))


def _rotations(rotations, batch: int):
    if rotations is None:
        return None
    if (rotations.dtype != torch.int32 or rotations.numel() != batch
            or not rotations.is_contiguous()):
        raise ValueError(f"rotations: a contiguous int32 tensor of {batch} elements")
    build.check_device(rotations)
    return rotations.data_ptr()


def _run(prepare, A):
    launch, result = prepare(A)
    if A.numel():
        launch()
    return result


def sym_eig(A):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric
    (..., n, n) A, n <= 9, with canonical signs: kernel C on the card, its
    plain version on the CPU."""
    if not on_card(A):
        return sym_eig_reference(A)
    return _run(prepare_sym_eig, A)


def svd3(A):
    """(U, S descending, Vt) of (..., 3, 3) A with canonical pair signs:
    kernel C on the card, its plain version on the CPU."""
    if not on_card(A):
        return svd3_reference(A)
    return _run(prepare_svd3, A)
