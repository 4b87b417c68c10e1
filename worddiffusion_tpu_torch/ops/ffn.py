"""Fused LayerNorm + GEGLU feed-forward + residual: the transformer
block's whole FF sub-layer, forward and backward.

Port of ``worddiffusion_tpu/ops/ffn_pallas.py::fused_ln_geglu_ffn_kbwd``:
the forward kernel ``csrc/ln_geglu_ffn.cu`` and the backward kernel
``csrc/ln_geglu_ffn_bwd.cu`` (behind ``ln_geglu_ffn_bwd``), paired by
the ``torch.autograd.Function`` ``LnGegluFFN``, which takes the weights
in parameter layout (both kernels read them so, cast to x's dtype once in
the forward and kept for the backward, and the backward kernel returns
the weight gradients so); ``ffn_sublayer`` skips
the Function where no gradient is wanted, and ``fused_ln_geglu_ffn``
takes the weights in the JAX function's layout. A CUDA tensor launches
the kernels; a CPU tensor takes the plain PyTorch versions
``ln_geglu_ffn_reference`` and ``ln_geglu_ffn_bwd_reference``; a CUDA
input the kernels do not take raises instead of falling back.

The bare GEGLU feed-forward, ``act · W2 + b2`` with no LayerNorm and no
residual, is the port of ``ffn_pallas.py::fused_geglu_ffn`` (its kernel
``_ffn_kernel``): a launch mode of the same CUDA kernel
(``wd_geglu_ffn``), behind the Function ``GegluFFN`` and
``fused_geglu_ffn`` in the JAX layout; its plain version is
``geglu_ffn_reference``. As in JAX, its backward is autograd of the
unfused composition ``geglu_ffn_xla_baseline``. Its caller is the
tensor-parallel FF sub-layer, ``ffn_sublayer_tp``: LayerNorm, then B.2 on
this rank's slice of the inner width, then the sum over the model ranks
and the residual (nothing in the JAX package calls B.2: its partitioning
rule gathers the sharded weights ahead of B.1).

Both kernels take every d = 64k from 64 to 768 (any inner % 64 == 0): the
widths at which JAX's model sends its FF sub-layer to the Pallas kernel,
``kernel_takes(d, 4d)``, the port's copy of that guard
(``check_backward_width`` holds the backward to them). The backward runs
one of two routes by d (``bwd_plan``): up to 320 the fused row kernel, above
it the split one (``csrc/ln_geglu_ffn_bwd.cu``).

``launches``, ``bwd_launches`` and ``geglu_launches`` count kernel
launches, so that a run can show that its main path went through the
kernels; ``plain_calls`` counts the FF sub-layers a model ran plain because
``kernel_takes`` is false at their width (``models/attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..parallel.tensor import copy_to_model, reduce_from_model
from . import build

launches = 0
bwd_launches = 0
geglu_launches = 0
plain_calls = 0

# JAX's VMEM budget for the fused FF (ffn_pallas.py::pick_block_m), bytes
_VMEM_BUDGET = 14 * 1024 * 1024
# The widths the backward kernels take, (least, most, step): the forward's
# (csrc/ln_geglu_ffn_bwd.cu, D_MIN / D_MAX / D_STEP; wd_ln_geglu_ffn_bwd_d)
BWD_WIDTHS = (64, 768, 64)

_GELU_C, _GELU_K = math.sqrt(2.0 / math.pi), 0.044715


def ln_geglu_ffn_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain PyTorch version with the kernel's dtype contract
    (``ffn_pallas.py::_ln_ffn_reference``): fp32 LayerNorm statistics and
    residual, matmul operands in ``x.dtype``, fp32 bias and tanh-GEGLU.

    x [..., d]; gamma, beta [d]; w1 [d, 2*inner]; b1 [2*inner];
    w2 [inner, d]; b2 [d]."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(dt)
    h = (xn @ w1.to(dt)).float() + b1.float()
    a, g = h.chunk(2, dim=-1)
    act = (a * F.gelu(g, approximate="tanh")).to(dt)
    y = (act @ w2.to(dt)).float() + b2.float()
    return (xf + y).to(dt)


def kernel_takes(d: int, inner: int) -> bool:
    """Whether the model runs its FF sub-layer through the fused kernel at
    these widths: the port's copy of JAX's guard
    ``worddiffusion_tpu/ops/ffn_pallas.py::fits_vmem`` (``pick_block_m`` at
    m = 8, whose only row tile is 8), which the model calls on bf16 (2-byte)
    operands: both weight matrices, their fp32 biases, the double-buffered x
    and out tiles, the fp32 [8, 2*inner] GEGLU intermediate and the gated
    activation within the TPU's 14 MiB VMEM budget. The model reads it as
    JAX's does, with inner = 4d: true for every d = 64k up to 768, false from
    832 on, where both run the plain FF. It is a rule of the shape alone,
    decided before any launch."""
    weights = (d * 2 * inner + inner * d) * 2 + (2 * inner + d) * 4
    bm = 8
    tile = 2 * bm * d * 2 * 2 + bm * 2 * inner * 4 + bm * inner * 2
    return weights + tile <= _VMEM_BUDGET


def check_backward_width(d: int) -> None:
    """Raises unless the backward kernels (B.3) take width d: every
    d = 64k from 64 to 768, the widths of the forward kernel, at which the
    model sends its FF sub-layer to the kernels (``kernel_takes(d, 4d)``)."""
    lo, hi, step = BWD_WIDTHS
    if d % step or not lo <= d <= hi:
        raise ValueError(
            f"ln_geglu_ffn_bwd: the FF backward kernel takes d = {step}k from {lo} to {hi}, "
            f"got d = {d}")


def geglu_ffn_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version of the bare GEGLU FFN with the kernel's dtype
    contract (``ffn_pallas.py::_ffn_core``): matmul operands in
    ``x.dtype``, products accumulated and kept in fp32, fp32 bias and
    tanh-GEGLU, the activation rounded to ``x.dtype``, the output in
    ``x.dtype``. x [..., d]; w1 [d, 2*inner]; b1 [2*inner]; w2 [inner, d];
    b2 [d]."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    a, g = h.chunk(2, dim=-1)
    act = (a * F.gelu(g, approximate="tanh")).to(dt)
    return (act.float() @ w2.to(dt).float() + b2.float()).to(dt)


def geglu_ffn_xla_baseline(x, w1, b1, w2, b2):
    """The unfused composition as JAX's ``ffn_pallas.py::_xla_baseline``
    runs it (the function its custom_vjp differentiates): every product
    and bias in ``x.dtype``."""
    dt = x.dtype
    h = x @ w1.to(dt) + b1.to(dt)
    a, g = h.chunk(2, dim=-1)
    return (a * F.gelu(g, approximate="tanh")) @ w2.to(dt) + b2.to(dt)


class GegluFFN(torch.autograd.Function):
    """``GEGLU-FFN(x)`` in the JAX layout: the kernel (CUDA) or the plain
    version (CPU) forward; the backward is autograd of
    ``geglu_ffn_xla_baseline`` on the saved inputs, what JAX's
    ``_geglu_ffn_bwd`` differentiates, so each gradient comes back in its
    input's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return geglu_ffn_reference(x, w1, b1, w2, b2)
        if x.device.type != "cuda":
            raise ValueError(f"fused_geglu_ffn: unsupported device {x.device}")
        bf16 = torch.bfloat16
        return _launch_geglu(x, _contiguous_as(w1.t(), bf16), b1,
                             _contiguous_as(w2.t(), bf16), b2)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = geglu_ffn_xla_baseline(*leaves)
            return torch.autograd.grad(out, leaves, dy)


def ffn_sublayer_tp(x, gamma, beta, w1, b1, w2, b2, mesh, eps: float = 1e-5,
                    kernel: bool = True):
    """x + GEGLU-FFN(LayerNorm(x)) with the FF sharded over the model axis
    of ``mesh`` (Megatron's layout), in parameter layout: w1 [2*inner/M, d]
    this rank's rows of each GEGLU half (a_r, then gate_r), w2 [d, inner/M]
    its columns; gamma, beta, the full b1 [2*inner] and b2 replicated.

    The LayerNorm runs plain (the unfused LN JAX computes in XLA), then
    ``copy_to_model``, then B.2 (``GegluFFN``: the kernel on a CUDA tensor;
    with ``kernel`` False ``geglu_ffn_xla_baseline``) on the local slice with
    a zero b2, then ``reduce_from_model`` (the fp32 sum of the partials), and
    b2 and the residual in fp32. b1's local slice is cut after
    ``copy_to_model``, so its gradient, one slice per rank, is summed to the
    full one on every rank and the replicated b1 stays replicated."""
    dt = x.dtype
    h = F.layer_norm(x.float(), (x.shape[-1],), gamma, beta, eps).to(dt)
    h, b1 = copy_to_model(mesh, h, b1)
    b1 = b1.reshape(2, mesh.model, -1)[:, mesh.model_rank].reshape(-1)
    zero = torch.zeros_like(b2)
    fn = GegluFFN.apply if kernel else geglu_ffn_xla_baseline
    partial = fn(h, w1.t(), b1, w2.t(), zero)
    return (x.float() + (reduce_from_model(mesh, partial) + b2.float())).to(dt)


def fused_geglu_ffn(x, w1, b1, w2, b2):
    """GEGLU-FFN(x) = act · W2 + b2 for x [..., d], w1 [d, 2*inner],
    w2 [inner, d] (the JAX function's layout): the kernel for a CUDA
    tensor, the plain version for a CPU tensor; differentiable."""
    return GegluFFN.apply(x, w1, b1, w2, b2)


def _gelu_and_grad(u):
    """tanh-approximate gelu and its derivative
    (``ffn_pallas.py::_gelu_and_grad``)."""
    t = torch.tanh(_GELU_C * (u + _GELU_K * u * u * u))
    gu = 0.5 * u * (1.0 + t)
    dgu = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_K * u * u)
    return gu, dgu


def ln_geglu_ffn_bwd_reference(x, dy, gamma, beta, w1, b1, w2, eps: float = 1e-5):
    """Plain backward of ``ln_geglu_ffn_reference`` for flat x, dy [M, d],
    with the arithmetic of ``ffn_pallas.py::_ln_ffn_bwd_kernel``: dy is
    cast to x.dtype, LN and GEGLU are recomputed, ``dhc = dh`` in x.dtype
    feeds dxn and dW1, db1 sums the fp32 dh, act in x.dtype feeds dW2.
    Matmul operands are in x.dtype, as in the forward reference.

    Returns (dx in x.dtype, then fp32 dgamma [d], dbeta [d],
    dw1 [d, 2*inner], db1 [2*inner], dw2 [inner, d], db2 [d])."""
    dt = x.dtype
    inner = w2.shape[0]
    w1, w2 = w1.to(dt), w2.to(dt)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    rsig = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    xhat = (xf - mu) * rsig
    gam = gamma.float()
    xn = (xhat * gam + beta.float()).to(dt)
    h = (xn @ w1).float() + b1.float()
    a, u = h[:, :inner], h[:, inner:]
    gu, dgu = _gelu_and_grad(u)
    act = (a * gu).to(dt)

    dy = dy.to(dt)
    dyf = dy.float()
    dact = (dy @ w2.t()).float()
    dh = torch.cat([dact * gu, dact * a * dgu], dim=1)
    dhc = dh.to(dt)
    dxn = (dhc @ w1.t()).float()
    dxhat = dxn * gam
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (dyf + rsig * (dxhat - m1 - xhat * m2)).to(dt)
    return (
        dx, (dxn * xhat).sum(0), dxn.sum(0), (xn.t() @ dhc).float(), dh.sum(0),
        (act.t() @ dy).float(), dyf.sum(0),
    )


def _contiguous_as(w, dt):
    """w in ``dt``, contiguous: itself where it is so, else one copy.
    (``w.to(dt, memory_format=torch.contiguous_format)`` returns a strided
    w unchanged when it already has ``dt``.)"""
    if w.dtype == dt:
        return w.contiguous()
    return w.to(dt, memory_format=torch.contiguous_format)


def _kernel_weights(w1, w2, dt):
    """Parameter-layout weights (w1 [2*inner, d], w2 [d, inner]) ->
    the JAX layout's contiguous [d, 2*inner] and [inner, d] in ``dt``:
    one cast-and-transpose copy each (the plain versions' layout)."""
    return _contiguous_as(w1.t(), dt), _contiguous_as(w2.t(), dt)


class LnGegluFFN(torch.autograd.Function):
    """``x + GEGLU-FFN(LayerNorm(x))`` with the kernel pair on CUDA and the
    plain versions on the CPU; the transformer block's FF sub-layer.

    The weights come in parameter layout and dtype (``proj.weight``
    [2*inner, d], ``out.weight`` [d, inner], fp32 masters). The forward
    casts them to x.dtype (one copy per weight, none where they already
    are) and keeps the casts for the backward; both kernels read that
    layout, so the weight gradients come back in fp32, contiguous and in
    parameter layout, as JAX returns them in the master dtype
    (``ffn_pallas.py:721-726``). The inputs are saved and LN + GEGLU
    recomputed in the backward (``_ln_ffn_kbwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps):
        if x.device.type == "cuda" and any(ctx.needs_input_grad):
            check_backward_width(x.shape[-1])  # before the forward, not in the backward
        w1k, w2k = _contiguous_as(w1, x.dtype), _contiguous_as(w2, x.dtype)
        ctx.save_for_backward(x, gamma, beta, w1k, b1, w2k)
        ctx.eps = eps
        ctx.dtypes = (w1.dtype, w2.dtype, b2.dtype)
        return _sublayer(x, gamma, beta, w1k, b1, w2k, b2, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1k, b1, w2k = ctx.saved_tensors
        d = x.shape[-1]
        dx, dg, dbt, dw1, db1, dw2, db2 = _bwd_params(
            x.reshape(-1, d), dy.reshape(-1, d).to(x.dtype).contiguous(), gamma, beta,
            w1k, b1, w2k, ctx.eps)
        w1_dt, w2_dt, b2_dt = ctx.dtypes
        return (
            dx.reshape(x.shape), dg.to(gamma.dtype), dbt.to(beta.dtype), dw1.to(w1_dt),
            db1.to(b1.dtype), dw2.to(w2_dt), db2.to(b2_dt), None,
        )


def _bwd_params(x, dy, gamma, beta, w1, b1, w2, eps):
    """The backward with parameter-layout weights (w1 [2*inner, d], w2
    [d, inner]) for flat x, dy [M, d]; the weight gradients come back
    contiguous in that layout: the CUDA kernels for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        dx, dg, dbt, dw1, db1, dw2, db2 = ln_geglu_ffn_bwd_reference(
            x, dy, gamma, beta, w1.t(), b1, w2.t(), eps)
        return dx, dg, dbt, dw1.t().contiguous(), db1, dw2.t().contiguous(), db2
    if x.device.type != "cuda":
        raise ValueError(f"ln_geglu_ffn_bwd: unsupported device {x.device}")
    return _launch_bwd(x, dy, gamma, beta, w1, b1, w2, eps)


def ffn_sublayer(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """x + GEGLU-FFN(LayerNorm(x)) with parameter-layout weights (w1
    [2*inner, d], w2 [d, inner]): ``LnGegluFFN`` where a gradient is
    wanted, else its forward alone (regeneration runs under no_grad)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, gamma, beta, w1, b1, w2, b2)):
        return LnGegluFFN.apply(x, gamma, beta, w1, b1, w2, b2, eps)
    return _sublayer(x, gamma, beta, w1, b1, w2, b2, eps)


def fused_ln_geglu_ffn(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """x + GEGLU-FFN(LayerNorm(x)) with the JAX function's layout
    (w1 [d, 2*inner], w2 [inner, d]): ``ffn_sublayer`` on the transposed
    views, so the kernels for a CUDA tensor and the plain versions for a
    CPU tensor; differentiable."""
    return ffn_sublayer(x, gamma, beta, w1.t(), b1, w2.t(), b2, eps)


def _sublayer(x, gamma, beta, w1, b1, w2, b2, eps):
    """The forward with parameter-layout weights: the CUDA kernel on their
    bf16 copies (none where they already are) for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        w1k, w2k = _kernel_weights(w1, w2, x.dtype)
        return ln_geglu_ffn_reference(x, gamma, beta, w1k, b1, w2k, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_geglu_ffn: unsupported device {x.device}")
    bf16 = torch.bfloat16
    return _launch(x, gamma, beta, _contiguous_as(w1, bf16), b1, _contiguous_as(w2, bf16), b2,
                   eps)


def ln_geglu_ffn_bwd(x, dy, gamma, beta, w1, b1, w2, eps: float = 1e-5):
    """The FF sub-layer's backward for flat x, dy [M, d], with the
    operands and returns of the JAX ``_ln_ffn_bwd_pallas`` (w1 [d, 2*inner],
    w2 [inner, d]; dw1 and dw2 in that layout): the CUDA kernels for a CUDA
    tensor (on contiguous parameter-layout copies of the weights, which
    must be bf16; the weight gradients returned as transposed views), the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_geglu_ffn_bwd_reference(x, dy, gamma, beta, w1, b1, w2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_geglu_ffn_bwd: unsupported device {x.device}")
    dx, dg, dbt, dw1, db1, dw2, db2 = _launch_bwd(
        x, dy, gamma, beta, w1.t().contiguous(), b1, w2.t().contiguous(), eps)
    return dx, dg, dbt, dw1.t(), db1, dw2.t(), db2


@functools.cache
def _lib():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wd_ln_geglu_ffn.argtypes = [p] * 8 + [i, i, i, ctypes.c_float, p]
    lib.wd_ln_geglu_ffn.restype = i
    lib.wd_geglu_ffn.argtypes = [p] * 6 + [i, i, i, p]
    lib.wd_geglu_ffn.restype = i
    lib.wd_ln_geglu_ffn_bwd.argtypes = [p] * 18 + [i, i, i, ctypes.c_float, p]
    lib.wd_ln_geglu_ffn_bwd.restype = i
    for fn in ("wd_ln_geglu_ffn_d", "wd_ln_geglu_ffn_bwd_d"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(i)]
        getattr(lib, fn).restype = None
    for fn, args in (("wd_ln_geglu_ffn_plan", [i, ctypes.POINTER(i)]),
                     ("wd_ln_geglu_ffn_cluster", [i, i]),
                     ("wd_ln_geglu_ffn_bwd_plan", [i, i, i, ctypes.POINTER(i)])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i
    lib.wd_ln_geglu_ffn_bwd_part_floats.argtypes = [i, i, i]
    lib.wd_ln_geglu_ffn_bwd_part_floats.restype = ctypes.c_longlong
    lib.wd_cuda_error_string.argtypes = [i]
    lib.wd_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def forward_widths() -> tuple[int, int, int]:
    """The widths the forward kernel takes: (least, most, step)."""
    out = (ctypes.c_int * 3)()
    _lib().wd_ln_geglu_ffn_d(out)
    return tuple(out)


PLAN_KEYS = ("smem", "threads", "warpgroups", "stages", "w2_ring")


def plan(d: int) -> dict:
    """The forward kernel's plan at width d: dynamic shared memory, threads
    a CTA, consumer warpgroups, ring stages, and whether W2 streams through
    the ring in K-quarters (1) or takes a slot of its own (0)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    if _lib().wd_ln_geglu_ffn_plan(d, out):
        raise ValueError(f"fused_ln_geglu_ffn: no plan for d={d}")
    return dict(zip(PLAN_KEYS, out))


def cluster_size(m: int, inner: int) -> int:
    """The CTAs per row tile (thread-block cluster) the forward kernel
    launches with at M rows."""
    return _lib().wd_ln_geglu_ffn_cluster(m, inner)


BWD_ROUTES = ("fused", "split")
BWD_PLAN_KEYS = ("route", "rows_tile", "rows_stages", "rows_ctas", "rows_cluster", "dxn_ctas",
                 "weights_ctas", "weights_cluster", "weights_stages", "weights_tile_n")


def bwd_plan(m: int, d: int, inner: int) -> dict:
    """The backward's launch plan at M rows and width d: its route ("fused":
    the row kernel A, d <= 320; "split": S0-S3); the row kernel's rows a
    tile, ring stages, CTAs and cluster size (the CTAs that share a tile; on
    the split route those of S1, the [a | u] and dact recompute); S2's CTAs
    (the dxn product; 0 on the fused route); the weight-gradient kernel's
    CTAs, cluster size (its split of M), ring stages and column tile."""
    out = (ctypes.c_int * len(BWD_PLAN_KEYS))()
    if _lib().wd_ln_geglu_ffn_bwd_plan(m, d, inner, out):
        raise ValueError(f"ln_geglu_ffn_bwd: no plan for M={m}, d={d}, inner={inner}")
    plan_ = dict(zip(BWD_PLAN_KEYS, out))
    plan_["route"] = BWD_ROUTES[plan_["route"]]
    return plan_


def _check(name, t, shape, dtype, dev):
    if t.get_device() != dev:
        raise ValueError(f"fused_ln_geglu_ffn: {name} is on {t.device}, x on device {dev}")
    if t.shape != shape:
        raise ValueError(f"fused_ln_geglu_ffn: {name} has shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise ValueError(f"fused_ln_geglu_ffn: {name} is {t.dtype}, want {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_ln_geglu_ffn: {name} must be contiguous and 16-byte aligned")


def _check_operands(x, gamma, beta, w1, b1, w2, widths):
    """The kernels' operands; gamma and beta None for the bare FFN. Both
    kernels take the weights in parameter layout (w1 [2*inner, d],
    w2 [d, inner]) and the widths (least, most, step)."""
    d = x.shape[-1]
    inner = w2.shape[-1]
    lo, hi, step = widths
    if d % step or not lo <= d <= hi or inner % 64 or inner < 64:
        raise ValueError(
            f"fused_ln_geglu_ffn: kernel needs d % {step} == 0 with {lo} <= d <= {hi} and "
            f"inner % 64 == 0; got d={d}, inner={inner}"
        )
    dev, bf16, f32 = x.get_device(), torch.bfloat16, torch.float32
    _check("x", x, x.shape, bf16, dev)
    if gamma is not None:
        _check("gamma", gamma, (d,), f32, dev)
        _check("beta", beta, (d,), f32, dev)
    _check("w1", w1, (2 * inner, d), bf16, dev)
    _check("b1", b1, (2 * inner,), f32, dev)
    _check("w2", w2, (d, inner), bf16, dev)
    return d, inner


def _check_fwd(x, gamma, beta, w1, b1, w2, b2):
    d, inner = _check_operands(x, gamma, beta, w1, b1, w2, forward_widths())
    _check("b2", b2, (d,), torch.float32, x.get_device())
    return d, inner


def _raise_on(err, what):
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{_lib().wd_cuda_error_string(err).decode()} (code {err})"
        )


def _launch(x, gamma, beta, w1, b1, w2, b2, eps):
    """B.1 on parameter-layout bf16 weights (w1 [2*inner, d], w2 [d, inner])."""
    global launches
    lib = _lib()
    d, inner = _check_fwd(x, gamma, beta, w1, b1, w2, b2)
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    _raise_on(build.launch_on(x, lambda stream: lib.wd_ln_geglu_ffn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), m, d, inner, eps, stream)), "ln_geglu_ffn")
    launches += 1
    return out


def _launch_geglu(x, w1, b1, w2, b2):
    """B.2 on parameter-layout bf16 weights."""
    global geglu_launches
    lib = _lib()
    d, inner = _check_fwd(x, None, None, w1, b1, w2, b2)
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    _raise_on(build.launch_on(x, lambda stream: lib.wd_geglu_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), m, d, inner, stream)), "geglu_ffn")
    geglu_launches += 1
    return out


def _launch_bwd(x, dy, gamma, beta, w1, b1, w2, eps):
    """B.3 on parameter-layout bf16 weights (w1 [2*inner, d], w2 [d, inner]);
    dw1 [2*inner, d] and dw2 [d, inner] come back so, contiguous."""
    global bwd_launches
    lib = _lib()
    check_backward_width(x.shape[-1])
    d, inner = _check_operands(x, gamma, beta, w1, b1, w2, BWD_WIDTHS)
    if x.dim() != 2:
        raise ValueError(f"ln_geglu_ffn_bwd: x must be [M, d], got {tuple(x.shape)}")
    _check("dy", dy, x.shape, torch.bfloat16, x.get_device())
    m = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    new = torch.zeros if m == 0 else torch.empty  # no rows: the sums are zero
    dx = torch.empty_like(x)
    dg, dbt, db2 = (new(d, **f32) for _ in range(3))
    dw1, db1 = new(2 * inner, d, **f32), new(2 * inner, **f32)
    dw2 = new(d, inner, **f32)
    if m == 0:
        return dx, dg, dbt, dw1, db1, dw2, db2
    # scratch for the weight-gradient kernel, and the partial sums
    xn = torch.empty_like(x)
    dhc = torch.empty(m, 2 * inner, dtype=x.dtype, device=x.device)
    act = torch.empty(m, inner, dtype=x.dtype, device=x.device)
    part = torch.empty(lib.wd_ln_geglu_ffn_bwd_part_floats(m, d, inner), **f32)
    ptrs = [t.data_ptr() for t in (x, dy, gamma, beta, w1, b1, w2, dx, dg, dbt, dw1, db1,
                                   dw2, db2, xn, dhc, act, part)]
    _raise_on(build.launch_on(x, lambda stream: lib.wd_ln_geglu_ffn_bwd(
        *ptrs, m, d, inner, eps, stream)), "ln_geglu_ffn_bwd")
    bwd_launches += 1
    return dx, dg, dbt, dw1, db1, dw2, db2
