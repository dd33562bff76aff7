"""The reduced camera system from the nonzero coupling blocks: wrapper of
``csrc/schur.cu`` (kernel F).

Replaces no Pallas kernel: the JAX package forms the bundle adjustment's
reduced camera system (``tpuvo/ba/window.py`` ``schur_parts``,
``backsubstitute``) as dense products over an (L, W, 6, 3) coupling tensor.
A block W_lf is nonzero only where frame f observes landmark l; here the
blocks are one per such (landmark, frame) pair, as ``ba/window.pair_plan``
lays them out (``Wp`` (P, 6, 3) in ascending (landmark, frame) order,
``pair_lm`` / ``pair_f`` each slot's landmark and frame, ``lm_bounds`` each
landmark's contiguous pairs, ``frame_order`` / ``frame_bounds`` the pairs by
frame, each frame's in ascending landmark; inert slots past
``lm_bounds[-1]``):

  * ``reduced_system(Wp, Hinv, bl, Hpp, bp, ...)`` -> (S (6W, 6W), b (6W,)):
    S[f, g] = Hpp_f [f == g] - sum_l (W_lf Hinv_l) W_lgᵀ over the landmarks
    both frames see, b[f] = bp_f - sum_l (W_lf Hinv_l) bl_l over f's;
  * ``backsubstitute(Wp, Hinv, bl, dx, pair_f, lm_bounds)`` -> (La, 3):
    -Hinv_l (bl_l + sum_f W_lfᵀ dx_f) over l's pairs.

Every entry sums its landmark terms (S, b) or frame terms (the landmark
step) in ascending order, one rounded addition at a time from +0.0, in
both versions; the kernel forms each 3- or 6-term product with fused
multiply-adds, the plain version with torch's products, so the two agree
to rounding, not bit for bit.  The kernel gives the same bits on every run.

For CPU tensors the wrappers run the plain versions; for CUDA tensors they
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from tpuvo_torch.ops.cuda import build

launches = 0  # kernel launches in this process (reset by callers that count)


def on_card(t) -> bool:
    """Whether a call on ``t`` launches the kernel (else its plain version)."""
    return t.is_cuda


def _sum_by(terms, bounds):
    """(len(bounds) - 1, ...) sums of consecutive runs of ``terms``, each in
    order from +0.0 (an empty run sums to 0)."""
    return torch.segment_reduce(terms, "sum", offsets=bounds, axis=0, unsafe=True)


def reduced_system_reference(Wp, Hinv, bl, Hpp, bp, pair_lm, pair_f, lm_bounds, frame_order,
                             frame_bounds):
    """Plain version of ``reduced_system``: every block product of two
    pairs of one landmark, sorted stably by output block, summed in order
    (so each block's terms come in ascending landmark)."""
    W = Hpp.shape[0]
    dev = Wp.device
    n = int(lm_bounds[-1])                       # the pairs; inert slots follow
    lm, f = pair_lm[:n], pair_f[:n]
    Y = torch.einsum("pij,pjk->pik", Wp[:n], Hinv[lm])          # W_lf Hinv_l
    k = (lm_bounds[1:] - lm_bounds[:-1])[lm]                    # partners of each pair
    rows = torch.repeat_interleave(torch.arange(n, device=dev), k)
    cols = torch.arange(rows.numel(), device=dev) + torch.repeat_interleave(
        lm_bounds[lm] - (torch.cumsum(k, 0) - k), k)            # (l, g) beside each (l, f)
    terms = torch.einsum("tik,tjk->tij", Y[rows], Wp[cols])
    block = f[rows] * W + pair_f[cols]
    order = torch.argsort(block, stable=True)
    bounds = torch.searchsorted(block[order], torch.arange(W * W + 1, device=dev))
    sums = _sum_by(terms[order], bounds).reshape(W, W, 6, 6).permute(0, 2, 1, 3)
    eye = torch.eye(W, dtype=Hpp.dtype, device=dev)
    S = -sums + torch.einsum("fij,fg->figj", Hpp, eye)
    b_terms = torch.einsum("pik,pk->pi", Y, bl[lm])
    b = bp - _sum_by(b_terms[frame_order[:n]], frame_bounds)
    return S.reshape(6 * W, 6 * W), b.reshape(6 * W)


def backsubstitute_reference(Wp, Hinv, bl, dx, pair_f, lm_bounds):
    """Plain version of ``backsubstitute``: each pair's Wᵀ dx, summed by
    landmark in order."""
    n = int(lm_bounds[-1])
    terms = torch.einsum("pij,pi->pj", Wp[:n], dx[pair_f[:n]])
    return -torch.einsum("lij,lj->li", Hinv, bl + _sum_by(terms, lm_bounds))


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise ValueError(f"schur: {name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"schur: {name} must have the shape {shape}, not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"schur: {name} must be contiguous")


def _check_pairs(Wp, Hinv, bl, pair_f, lm_bounds):
    """(P, La) of the pair arguments both kernels take, checked."""
    P, La = Wp.shape[0], Hinv.shape[0]
    f32, i64 = torch.float32, torch.int64
    for name, t, dtype, shape in (("Wp", Wp, f32, (P, 6, 3)), ("Hinv", Hinv, f32, (La, 3, 3)),
                                  ("bl", bl, f32, (La, 3)), ("pair_f", pair_f, i64, (P,)),
                                  ("lm_bounds", lm_bounds, i64, (La + 1,))):
        _check(name, t, dtype, shape)
    return P, La


def prepare_reduced_system(Wp, Hinv, bl, Hpp, bp, pair_lm, pair_f, lm_bounds, frame_order,
                           frame_bounds):
    """Checked kernel arguments for CUDA tensors, all contiguous on the
    current device (float32 blocks, int64 indices; P = W·N pair slots, no
    frame with more than N pairs, as ``pair_plan`` lays them out), and
    freshly allocated outputs: returns (launch, (S, b)), where ``launch()``
    enqueues the one kernel that writes every element of both."""
    P, La = _check_pairs(Wp, Hinv, bl, pair_f, lm_bounds)
    W = Hpp.shape[0]
    for name, t, dtype, shape in (("Hpp", Hpp, torch.float32, (W, 6, 6)),
                                  ("bp", bp, torch.float32, (W, 6)),
                                  ("pair_lm", pair_lm, torch.int64, (P,)),
                                  ("frame_order", frame_order, torch.int64, (P,)),
                                  ("frame_bounds", frame_bounds, torch.int64, (W + 1,))):
        _check(name, t, dtype, shape)
    if P >= 2**31 or (W and P % W):
        raise ValueError(f"schur: {P} pair slots for {W} frames: not W·N below 2**31")
    args = (Wp, Hinv, bl, Hpp, bp, pair_lm, pair_f, lm_bounds, frame_order, frame_bounds)
    build.check_device(*args)
    lib = build.library()
    S = torch.empty((6 * W, 6 * W), dtype=torch.float32, device=Wp.device)
    b = torch.empty(6 * W, dtype=torch.float32, device=Wp.device)
    stream = torch.cuda.current_stream(Wp.device).cuda_stream
    ptrs = [t.data_ptr() for t in (*args, S, b)] + [W, P // W if W else 0, stream]

    def launch(_alive=(*args, S, b)):
        global launches
        build.check(lib.tpuvo_schur_reduce(*ptrs), "tpuvo_schur_reduce")
        launches += 1

    return launch, (S, b)


def prepare_backsubstitute(Wp, Hinv, bl, dx, pair_f, lm_bounds):
    """As ``prepare_reduced_system``, for ``backsubstitute``: returns
    (launch, out (La, 3))."""
    P, La = _check_pairs(Wp, Hinv, bl, pair_f, lm_bounds)
    _check("dx", dx, torch.float32, (dx.shape[0], 6))
    args = (Wp, Hinv, bl, dx, pair_f, lm_bounds)
    build.check_device(*args)
    lib = build.library()
    out = torch.empty((La, 3), dtype=torch.float32, device=Wp.device)
    stream = torch.cuda.current_stream(Wp.device).cuda_stream
    ptrs = [t.data_ptr() for t in (*args, out)] + [La, stream]

    def launch(_alive=(*args, out)):
        global launches
        build.check(lib.tpuvo_schur_backsub(*ptrs), "tpuvo_schur_backsub")
        launches += 1

    return launch, out


def reduced_system(Wp, Hinv, bl, Hpp, bp, pair_lm, pair_f, lm_bounds, frame_order,
                   frame_bounds):
    """(S (6W, 6W), b (6W,)) from the pair blocks: kernel F on the card, its
    plain version on the CPU."""
    args = (Wp, Hinv, bl, Hpp, bp, pair_lm, pair_f, lm_bounds, frame_order, frame_bounds)
    if not on_card(Wp):
        return reduced_system_reference(*args)
    launch, out = prepare_reduced_system(*args)
    launch()
    return out


def backsubstitute(Wp, Hinv, bl, dx, pair_f, lm_bounds):
    """The landmark steps (La, 3) given the pose steps dx (W, 6): kernel F's
    second launch on the card, its plain version on the CPU."""
    if not on_card(Wp):
        return backsubstitute_reference(Wp, Hinv, bl, dx, pair_f, lm_bounds)
    launch, out = prepare_backsubstitute(Wp, Hinv, bl, dx, pair_f, lm_bounds)
    launch()
    return out
