"""Post-norm AdaLN epilogues with the residual add (kernels 3 and 4), the
forward-mode tangent of kernel 4's epilogue (kernel 12) and the int8 wo
product with the epilogue (kernel 19).

``residual + (LN(y)·g + b)·(1 + scale_b) + shift_b`` with fp32 statistics,
the variance taken as E[y²] − μ² as the TPU kernels take it, and the AdaLN
row ``b`` picked per sample.

* :func:`fused_matmul_modnorm_residual` computes y = x·wo.T inside the
  kernel. CUDA: ``csrc/gemm.cu::swift_mm_modnorm``, replacing
  ``swift_tpu/ops/pallas_modnorm.py::_mm_mn_call``: a thread-block cluster
  splits each 128-row tile's D columns, each block keeps its fp32 slice of
  y in registers, and the rows' partial sums go to every block of the
  cluster through distributed shared memory (:func:`matmul_modnorm_plan`).
* :func:`fused_matmul_modnorm_residual_int8` is kernel 3's function with
  y = int8(x)·int8(wo)ᵀ, inference only. CUDA: ``csrc/gemm.cu::
  swift_mm_modnorm_int8``, replacing ``swift_tpu/ops/pallas_modnorm.py::
  fused_matmul_modnorm_residual_int8`` (body ``_mm_mn_q_kernel``): x
  quantized per token into scratch, then kernel 3's cluster design on s8
  operands (:func:`matmul_modnorm_int8_plan`); on weights quantized once,
  :func:`matmul_modnorm_residual_int8_quantized`.
* :func:`fused_modnorm_residual` takes y ready-made (after the FFN), and
  :func:`modnorm_residual_tangent` is the tangent of that epilogue along
  (y, residual, scale, shift), the AdaLN rows carrying tangents because
  they are Dense(cond(t)); g and b carry none. CUDA: one row-streaming body,
  ``csrc/modnorm.cu::modnorm_rows_kernel<TANGENT>``
  (``swift_modnorm_residual``, replacing ``swift_tpu/ops/pallas_modnorm.py::
  _call``; ``swift_modnorm_residual_tangent``, replacing ``_tangent_call``).
  Kernel 4 does about ten FLOPs for the six bytes it moves per element,
  kernel 12 about 18 for eight (y, dy, the residual's tangent in, the
  tangent out; two more row sums, of dy and of y·dy), far below the ~295
  FLOP/byte at which the H100 stops being memory-bound: device memory
  bounds both. So the design keeps bytes in flight and moves each once: a
  persistent grid, a producer warp copying whole rows by ``cp.async.bulk``
  into a ring of shared-memory stages, one consumer warp a row, g, b and
  the AdaLN rows copied into shared memory once a block; :func:`modnorm_plan`
  sizes the ring. :func:`fused_modnorm_residual` takes
  kernel 12 for the tangent when an input carries one; kernel 3 has no
  tangent route (the JAX package runs wo as a plain product under the jvp)
  and refuses dual inputs.

Under tensor parallelism each rank's wo (or w2) product is a partial sum
of y, so kernel 3 cannot run; ``models.swinv2`` sums the partials over the
model group and runs :func:`fused_modnorm_residual` (kernel 4, 12 under a
jvp) on the whole rows, the role of the JAX package's
``sharded_modnorm_residual`` (``pallas_modnorm.py:110-137``).

Their backward is the vjp of the plain epilogue, as in the JAX package
(``pallas_modnorm.py::_fused_bwd`` and ``_fused_mm_mn_bwd``, which have no
backward kernel): kernel 3's backward recomputes y = x·wo.T with
``torch.matmul`` in x.dtype and differentiates the PyTorch epilogue.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd import forward_ad

from swift_torch.ops import _build, jvp_guard, quant


def reference_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps=1e-6):
    """Plain version. y, residual: (B, ..., D); g, b: (D,); mod_scale,
    mod_shift: (B, D). fp32 math; returns residual.dtype."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf * yf).mean(-1, keepdim=True) - mu * mu
    ln = (yf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()
    shape = (mod_scale.shape[0],) + (1,) * (y.ndim - 2) + (-1,)
    out = ln * (1.0 + mod_scale.float().reshape(shape)) + mod_shift.float().reshape(shape)
    return (out + residual.float()).to(residual.dtype)


def reference_matmul_modnorm_residual(x, w, residual, g, b, mod_scale, mod_shift, eps=1e-6):
    """Plain version of kernel 3: y = x·w.T accumulated in fp32 and kept in
    fp32 (the kernel never rounds it) before the epilogue."""
    y = torch.matmul(x.float(), w.float().t())
    return reference_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps)


def reference_modnorm_residual_tangent(y, dy, dr, g, b, mod_scale, dmod_scale, dmod_shift,
                                       eps=1e-6):
    """Plain version of kernel 12: the tangent of
    :func:`reference_modnorm_residual` at (y, mod_scale) along (dy, the
    residual's tangent dr, dmod_scale, dmod_shift), with the TPU kernel's
    formula (variance E[y²] − μ², fp32 math). Returns dr.dtype."""
    yf, dyf = y.float(), dy.float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf * yf).mean(-1, keepdim=True) - mu * mu
    rs = torch.rsqrt(var + eps)
    yn = (yf - mu) * rs
    dmu = dyf.mean(-1, keepdim=True)
    dvar = 2.0 * ((yf * dyf).mean(-1, keepdim=True) - mu * dmu)
    dyn = rs * (dyf - dmu) - 0.5 * yn * (rs * rs) * dvar
    ln = yn * g.float() + b.float()
    dln = dyn * g.float()
    shape = (mod_scale.shape[0],) + (1,) * (y.ndim - 2) + (-1,)
    row = lambda a: a.float().reshape(shape)  # noqa: E731
    out = dln * (1.0 + row(mod_scale)) + ln * row(dmod_scale) + row(dmod_shift) + dr.float()
    return out.to(dr.dtype)


def _check_epilogue(name, residual, g, b, mod_scale, mod_shift):
    B, D = residual.shape[0], residual.shape[-1]
    _build.check_dtype(name, torch.bfloat16, residual=residual, mod_scale=mod_scale,
                       mod_shift=mod_shift)
    _build.check_dtype(name, torch.float32, g=g, b=b)
    if g.shape != (D,) or b.shape != (D,):
        raise ValueError(f"{name}: g and b must be ({D},)")
    if mod_scale.shape != (B, D) or mod_shift.shape != (B, D):
        raise ValueError(f"{name}: mod_scale and mod_shift must be ({B}, {D})")
    if D % 16:
        raise ValueError(f"{name}: D={D} must be a multiple of 16")


def _vjp(fn, inputs, needs, dout):
    """Gradients of ``fn(*inputs)`` against ``dout`` for the inputs whose
    ``needs`` flag is set (None for the others), by re-running ``fn`` under
    autograd on detached copies."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_(n) for a, n in zip(inputs, needs)]
        out = fn(*args)
        wanted = [a for a in args if a.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout))
    return tuple(next(grads) if n else None for n in needs)


def _recompute_mm_modnorm(x, w, residual, g, b, mod_scale, mod_shift, eps):
    y = torch.matmul(x, w.t())
    return reference_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps)


class _MatmulModnorm(torch.autograd.Function):
    @staticmethod
    def forward(x, w, residual, g, b, mod_scale, mod_shift, eps):
        return _matmul_modnorm_residual(x, w, residual, g, b, mod_scale, mod_shift, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.eps = inputs[-1]
        ctx.save_for_backward(*inputs[:-1])

    @staticmethod
    def backward(ctx, dout):
        eps = ctx.eps
        fn = lambda *a: _recompute_mm_modnorm(*a, eps)  # noqa: E731
        return _vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:-1], dout) + (None,)


class _Modnorm(torch.autograd.Function):
    @staticmethod
    def forward(y, residual, g, b, mod_scale, mod_shift, eps):
        return _modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.eps = inputs[-1]
        ctx.save_for_backward(*inputs[:-1])

    @staticmethod
    def backward(ctx, dout):
        eps = ctx.eps
        fn = lambda *a: reference_modnorm_residual(*a, eps)  # noqa: E731
        return _vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:-1], dout) + (None,)


def fused_matmul_modnorm_residual(x, w, residual, g, b, mod_scale, mod_shift, eps=1e-6):
    """``residual + modnorm(x @ w.T)``. x: (B, ..., K); w: (D, K), the torch
    ``nn.Linear`` layout; residual: (B, ..., D). Returns residual.dtype.

    CPU tensors take :func:`reference_matmul_modnorm_residual`; CUDA tensors
    must be bf16 (g, b fp32) with K % 8 == 0 and D % 16 == 0. While autograd
    records, the backward is the vjp of the plain epilogue."""
    args = (x, w, residual, g, b, mod_scale, mod_shift)
    jvp_guard.refuse_tangents("fused_matmul_modnorm_residual", x=x, w=w, residual=residual,
                              g=g, b=b, mod_scale=mod_scale, mod_shift=mod_shift)
    if _build.recording(*args):
        return _MatmulModnorm.apply(*args, eps)
    return _matmul_modnorm_residual(*args, eps)


# The widest row kernel 3 takes: eight blocks of 216 columns
# (``csrc/gemm.cu::kMnMaxD``).
MATMUL_MODNORM_MAX_D = 1728


def matmul_modnorm_plan(D: int) -> dict:
    """Kernel 3's cluster plan at width D (``swift_mm_modnorm_plan``):
    blocks a cluster, columns a block, shared memory a block in bytes, and
    the clusters the card holds at once (0 before the first launch at D)."""
    plan = (ctypes.c_int * 4)()
    if _build.library().swift_mm_modnorm_plan(D, plan):
        raise ValueError(f"kernel 3 takes D up to {MATMUL_MODNORM_MAX_D}, got {D}")
    return dict(zip(("cluster", "columns", "smem", "resident_clusters"), plan))


def _matmul_modnorm_residual(x, w, residual, g, b, mod_scale, mod_shift, eps):
    if _build.on_cpu(x, w, residual, g, b, mod_scale, mod_shift):
        return reference_matmul_modnorm_residual(x, w, residual, g, b, mod_scale, mod_shift, eps)
    name = "fused_matmul_modnorm_residual"
    _build.check_kernel_inputs(name, x=x, w=w, residual=residual, g=g, b=b,
                               mod_scale=mod_scale, mod_shift=mod_shift)
    _build.check_dtype(name, torch.bfloat16, x=x, w=w)
    _check_epilogue(name, residual, g, b, mod_scale, mod_shift)
    K, D = x.shape[-1], residual.shape[-1]
    if w.shape != (D, K) or K % 8:
        raise ValueError(f"{name}: w must be ({D}, {K}) with K % 8 == 0, got {tuple(w.shape)}")
    if x.shape[:-1] != residual.shape[:-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and residual {tuple(residual.shape)} differ")
    if D > MATMUL_MODNORM_MAX_D:
        raise ValueError(f"{name}: D={D} exceeds the {MATMUL_MODNORM_MAX_D} columns a cluster holds")
    M = x.numel() // K
    out = torch.empty_like(residual)
    _build.check_launch(
        _build.library().swift_mm_modnorm(
            x.data_ptr(), w.data_ptr(), residual.data_ptr(), g.data_ptr(), b.data_ptr(),
            mod_scale.data_ptr(), mod_shift.data_ptr(), out.data_ptr(),
            M, K, D, M // residual.shape[0], float(eps), _build.stream(),
        ),
        name,
    )
    fused_matmul_modnorm_residual.launches += 1
    return out


fused_matmul_modnorm_residual.launches = 0


def reference_matmul_modnorm_residual_int8(x, w, residual, g, b, mod_scale, mod_shift,
                                           eps=1e-6):
    """Plain version of kernel 19, the JAX package's mirror: y =
    :func:`quant.int8_matmul` (x, w) kept in fp32, then the epilogue."""
    y = quant.int8_matmul(x, w)
    return reference_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps)


def reference_matmul_modnorm_residual_int8_quantized(x, wq, sw, residual, g, b, mod_scale,
                                                     mod_shift, eps=1e-6):
    """Plain version of kernel 19 on weights quantized already (wq, sw as
    :func:`quant.quantize_colwise` gives them): x quantized per token, y =
    ((float)(xq·wqᵀ)·sx)·sw in fp32, then the epilogue. Equal bit for bit to
    :func:`reference_matmul_modnorm_residual_int8` on the weights it
    quantizes."""
    y = quant.int8_matmul_quantized(x, wq, sw)
    return reference_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps)


# The widest row kernel 19 takes: eight blocks of 224 columns
# (``csrc/gemm.cu::kMnS8MaxD``; s8 wgmma has no 216-wide form).
MATMUL_MODNORM_INT8_MAX_D = 1792


def matmul_modnorm_int8_plan(D: int) -> dict:
    """Kernel 19's cluster plan at width D (``swift_mm_modnorm_int8_plan``),
    as :func:`matmul_modnorm_plan` gives kernel 3's."""
    plan = (ctypes.c_int * 4)()
    if _build.library().swift_mm_modnorm_int8_plan(D, plan):
        raise ValueError(f"kernel 19 takes D up to {MATMUL_MODNORM_INT8_MAX_D}, got {D}")
    return dict(zip(("cluster", "columns", "smem", "resident_clusters"), plan))


def matmul_modnorm_int8_scratch_bytes(T: int, K: int) -> int:
    """Device scratch of kernel 19 for T tokens of width K: x quantized to
    int8 and one fp32 scale a token. 0.27 GB at 0.25° (264,960 tokens, K =
    1024)."""
    return T * (K + 4)


def matmul_modnorm_residual_int8_quantized(x, wq, sw, residual, g, b, mod_scale, mod_shift,
                                           eps=1e-6):
    """Kernel 19 on weights quantized already, inference only: x (B, ...,
    K); wq (D, K) int8 with its per-row fp32 scales sw (D,), as
    :func:`quant.quantize_colwise` gives them; residual (B, ..., D). Returns
    residual.dtype.

    CPU tensors take :func:`reference_matmul_modnorm_residual_int8_quantized`.
    CUDA tensors: x bf16 (g, b fp32), K and D multiples of 16, D at most
    :data:`MATMUL_MODNORM_INT8_MAX_D`; one ``swift_mm_modnorm_int8`` call (x
    quantized per token into :func:`matmul_modnorm_int8_scratch_bytes` of
    scratch, then the s8 cluster kernel). Counts one launch of
    :func:`fused_matmul_modnorm_residual_int8`. Raises while autograd
    records and on dual tensors."""
    name = "fused_matmul_modnorm_residual_int8"
    _build.refuse_autograd(name, x=x, residual=residual, g=g, b=b, mod_scale=mod_scale,
                           mod_shift=mod_shift)
    if _build.on_cpu(x, wq, sw, residual, g, b, mod_scale, mod_shift):
        return reference_matmul_modnorm_residual_int8_quantized(x, wq, sw, residual, g, b,
                                                                mod_scale, mod_shift, eps)
    _build.check_kernel_inputs(name, x=x, wq=wq, sw=sw, residual=residual, g=g, b=b,
                               mod_scale=mod_scale, mod_shift=mod_shift)
    _build.check_dtype(name, torch.bfloat16, x=x)
    _build.check_dtype(name, torch.int8, wq=wq)
    _build.check_dtype(name, torch.float32, sw=sw)
    _check_epilogue(name, residual, g, b, mod_scale, mod_shift)
    K, D = x.shape[-1], residual.shape[-1]
    if wq.shape != (D, K) or sw.shape != (D,) or K % 16:
        raise ValueError(f"{name}: wq must be ({D}, {K}) with K % 16 == 0 and sw ({D},), got "
                         f"{tuple(wq.shape)} and {tuple(sw.shape)}")
    if x.shape[:-1] != residual.shape[:-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and residual {tuple(residual.shape)} differ")
    if D > MATMUL_MODNORM_INT8_MAX_D:
        raise ValueError(f"{name}: D={D} exceeds the {MATMUL_MODNORM_INT8_MAX_D} columns a "
                         "cluster holds")
    M = x.numel() // K
    xq = torch.empty(M, K, device=x.device, dtype=torch.int8)
    sx = torch.empty(M, device=x.device, dtype=torch.float32)
    out = torch.empty_like(residual)
    _build.check_launch(
        _build.library().swift_mm_modnorm_int8(
            x.data_ptr(), wq.data_ptr(), sw.data_ptr(), residual.data_ptr(), g.data_ptr(),
            b.data_ptr(), mod_scale.data_ptr(), mod_shift.data_ptr(), out.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), M, K, D, M // residual.shape[0], float(eps),
            _build.stream(),
        ),
        name,
    )
    fused_matmul_modnorm_residual_int8.launches += 1
    return out


def fused_matmul_modnorm_residual_int8(x, w, residual, g, b, mod_scale, mod_shift, eps=1e-6):
    """``residual + modnorm(int8(x) @ int8(w).T)``, inference only. x: (B, ...,
    K); w: (D, K) float (the model passes its fp32 parameter); residual: (B,
    ..., D). Returns residual.dtype.

    CPU tensors take :func:`reference_matmul_modnorm_residual_int8`. CUDA
    tensors: w is quantized here, one scale per output feature
    (:func:`quant.quantize_colwise`, as the JAX caller does outside its
    kernel), then kernel 19 (:func:`matmul_modnorm_residual_int8_quantized`)
    quantizes x per token; x bf16 (g, b fp32), K and D multiples of 16, D at
    most :data:`MATMUL_MODNORM_INT8_MAX_D`. Raises while autograd records
    and on dual tensors."""
    name = "fused_matmul_modnorm_residual_int8"
    _build.refuse_autograd(name, x=x, w=w, residual=residual, g=g, b=b, mod_scale=mod_scale,
                           mod_shift=mod_shift)
    if _build.on_cpu(x, w, residual, g, b, mod_scale, mod_shift):
        return reference_matmul_modnorm_residual_int8(x, w, residual, g, b, mod_scale,
                                                      mod_shift, eps)
    _build.check_kernel_inputs(name, x=x, w=w, residual=residual, g=g, b=b,
                               mod_scale=mod_scale, mod_shift=mod_shift)
    K, D = x.shape[-1], residual.shape[-1]
    if w.shape != (D, K) or K % 16:
        raise ValueError(f"{name}: w must be ({D}, {K}) with K % 16 == 0, got {tuple(w.shape)}")
    return matmul_modnorm_residual_int8_quantized(x, *quant.quantize_colwise(w), residual, g, b,
                                                  mod_scale, mod_shift, eps)


fused_matmul_modnorm_residual_int8.launches = 0


# The shared memory a block may use (``csrc/tile_mma.cuh::kMaxSmem``, 227 KB),
# the most rows a stage, the stages of the ring, and the most bytes of AdaLN
# rows a block keeps in shared memory.
MODNORM_SMEM = 232448
MODNORM_MAX_ROWS = 8
MODNORM_STAGES = 3
MODNORM_ADA_SMEM = 65536


@functools.lru_cache(maxsize=None)
def modnorm_plan(D: int, tangent: bool = False, samples: int = 1) -> dict:
    """The launch of kernel 4 (or, ``tangent``, 12) at width D over
    ``samples`` AdaLN rows, one block an SM: ``rows`` a stage (one consumer
    warp each), ``stages`` in the ring, whether the AdaLN rows are copied
    into shared memory (``ada_smem``, where they take at most 64 KB; else
    they are read through L1 and L2), the dynamic ``smem``
    (``csrc/modnorm.cu::modnorm_smem``: 16 bytes of barriers a stage and 16
    more, g and b in fp32, the AdaLN rows where they are kept, then each
    stage a row of each streamed tensor, y and r or y, dy and dr, in bf16 for
    each of its rows) and the ``threads`` of a block (the consumers and one
    producer warp). Cached: the wrappers ask for it on every call.

    Three stages of up to 8 rows: 8 × 3 at D = 1056 for both kernels
    (``scripts/probe_modnorm.py`` on the H100 timed 2, 4 and 6 stages and 4
    to 16 rows no faster); fewer rows for wide rows, and one row in one
    stage at the widest D, 19,360 for 4 and 16,592 for 12. Raises for D
    that is not a positive multiple of 16 or is wider."""
    if D < 16 or D % 16:
        raise ValueError(f"modnorm_plan: D={D} must be a positive multiple of 16")
    tensors = 3 if tangent else 2
    row = 2 * D * tensors
    ada = tensors * samples * 2 * D
    ada_smem = ada <= MODNORM_ADA_SMEM
    free = MODNORM_SMEM - 16 - 8 * D - (ada if ada_smem else 0)
    rows = min(MODNORM_MAX_ROWS, (free // MODNORM_STAGES - 16) // row)
    stages = MODNORM_STAGES if rows >= 1 else min(MODNORM_STAGES, free // (16 + row))
    rows = max(rows, 1)
    if stages < 1:
        raise ValueError(f"modnorm_plan: D={D} is wider than a row the "
                         f"{MODNORM_SMEM}-byte block holds beside g and b")
    return {"rows": rows, "stages": stages, "ada_smem": int(ada_smem),
            "smem": MODNORM_SMEM - free + stages * (16 + rows * row), "threads": 32 * (rows + 1)}


def fused_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps=1e-6):
    """``residual + (LN(y)·g + b)·(1 + mod_scale) + mod_shift``.
    y, residual: (B, ..., D) ; g, b: (D,) ; mod_scale, mod_shift: (B, D).

    CPU tensors take :func:`reference_modnorm_residual`; CUDA tensors go to
    kernel 4 (``swift_modnorm_residual``) and must be bf16 (g, b fp32) with
    D % 16 == 0 and D at most 19,360 (:func:`modnorm_plan`). While autograd
    records, the backward is the vjp of the plain epilogue. When y, the residual or
    the AdaLN rows carry forward-mode tangents, the output is the dual of
    kernel 4's primal and :func:`modnorm_residual_tangent` (a missing
    tangent is zero)."""
    args = (y, residual, g, b, mod_scale, mod_shift)
    if jvp_guard.any_tangent(*args):
        jvp_guard.require_no_tangent("fused_modnorm_residual", g=g, b=b)
        (yp, dy), (rp, dr), (sp, dsc), (hp, dsh) = map(
            forward_ad.unpack_dual, (y, residual, mod_scale, mod_shift))
        out = _modnorm_residual(yp, rp, g, b, sp, hp, eps)
        m = jvp_guard.materialize
        dout = modnorm_residual_tangent(yp, m(dy, yp), m(dr, rp), g, b, sp, m(dsc, sp),
                                        m(dsh, hp), eps)
        return forward_ad.make_dual(out, dout)
    if _build.recording(*args):
        return _Modnorm.apply(*args, eps)
    return _modnorm_residual(*args, eps)


def _modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps):
    if _build.on_cpu(y, residual, g, b, mod_scale, mod_shift):
        return reference_modnorm_residual(y, residual, g, b, mod_scale, mod_shift, eps)
    name = "fused_modnorm_residual"
    _build.check_kernel_inputs(name, y=y, residual=residual, g=g, b=b,
                               mod_scale=mod_scale, mod_shift=mod_shift)
    _build.check_dtype(name, torch.bfloat16, y=y)
    _check_epilogue(name, residual, g, b, mod_scale, mod_shift)
    if y.shape != residual.shape:
        raise ValueError(f"{name}: y {tuple(y.shape)} and residual {tuple(residual.shape)} differ")
    D = y.shape[-1]
    plan = modnorm_plan(D, False, y.shape[0])
    T = y.numel() // D
    out = torch.empty_like(residual)
    _build.check_launch(
        _build.library().swift_modnorm_residual(
            y.data_ptr(), residual.data_ptr(), g.data_ptr(), b.data_ptr(), mod_scale.data_ptr(),
            mod_shift.data_ptr(), out.data_ptr(), T, D, T // y.shape[0], plan["rows"],
            plan["stages"], plan["ada_smem"], float(eps), _build.stream(),
        ),
        name,
    )
    fused_modnorm_residual.launches += 1
    return out


fused_modnorm_residual.launches = 0


def modnorm_residual_tangent(y, dy, dr, g, b, mod_scale, dmod_scale, dmod_shift, eps=1e-6):
    """Tangent of ``residual + modnorm(y)`` along (dy, dr, dmod_scale,
    dmod_shift). y, dy, dr: (B, ..., D); g, b: (D,); mod_scale and its
    tangents: (B, D). Returns dr.dtype.

    CPU tensors take :func:`reference_modnorm_residual_tangent`; CUDA
    tensors go to kernel 12 (``swift_modnorm_residual_tangent``) under
    kernel 4's rules (bf16, g and b fp32, D % 16 == 0), D at most 16,592
    (:func:`modnorm_plan` with ``tangent``)."""
    args = (y, dy, dr, g, b, mod_scale, dmod_scale, dmod_shift)
    if _build.on_cpu(*args):
        return reference_modnorm_residual_tangent(*args, eps)
    name = "modnorm_residual_tangent"
    _build.check_kernel_inputs(name, y=y, dy=dy, dr=dr, g=g, b=b, mod_scale=mod_scale,
                               dmod_scale=dmod_scale, dmod_shift=dmod_shift)
    _build.check_dtype(name, torch.bfloat16, y=y, dy=dy)
    _check_epilogue(name, dr, g, b, dmod_scale, dmod_shift)
    _build.check_dtype(name, torch.bfloat16, mod_scale=mod_scale)
    if not y.shape == dy.shape == dr.shape or mod_scale.shape != dmod_scale.shape:
        raise ValueError(f"{name}: y, dy and dr must share a shape, and the AdaLN rows theirs")
    D = y.shape[-1]
    plan = modnorm_plan(D, True, y.shape[0])
    T = y.numel() // D
    out = torch.empty_like(dr)
    _build.check_launch(
        _build.library().swift_modnorm_residual_tangent(
            y.data_ptr(), dy.data_ptr(), dr.data_ptr(), g.data_ptr(), b.data_ptr(),
            mod_scale.data_ptr(), dmod_scale.data_ptr(), dmod_shift.data_ptr(), out.data_ptr(),
            T, D, T // y.shape[0], plan["rows"], plan["stages"], plan["ada_smem"], float(eps),
            _build.stream(),
        ),
        name,
    )
    modnorm_residual_tangent.launches += 1
    return out


modnorm_residual_tangent.launches = 0
