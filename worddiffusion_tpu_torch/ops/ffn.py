"""Fused LayerNorm + GEGLU feed-forward + residual: the transformer
block's whole FF sub-layer, forward and backward.

Port of ``worddiffusion_tpu/ops/ffn_pallas.py::fused_ln_geglu_ffn_kbwd``:
the forward kernel ``csrc/ln_geglu_ffn.cu`` and the backward kernel
``csrc/ln_geglu_ffn_bwd.cu`` (behind ``ln_geglu_ffn_bwd``), paired by
the ``torch.autograd.Function`` ``LnGegluFFN``, which takes the weights
in parameter layout; ``fused_ln_geglu_ffn`` takes them in the JAX
function's layout. A CUDA tensor launches the kernels; a CPU tensor
takes the plain PyTorch versions ``ln_geglu_ffn_reference`` and
``ln_geglu_ffn_bwd_reference``; a CUDA input the kernels do not take
raises instead of falling back.

The bare GEGLU feed-forward, ``act · W2 + b2`` with no LayerNorm and no
residual, is the port of ``ffn_pallas.py::fused_geglu_ffn`` (its kernel
``_ffn_kernel``): a launch mode of the same CUDA kernel
(``wd_geglu_ffn``), behind the Function ``GegluFFN`` and
``fused_geglu_ffn`` in the JAX layout; its plain version is
``geglu_ffn_reference``. As in JAX, its backward is autograd of the
unfused composition ``geglu_ffn_xla_baseline``, and nothing on the
port's paths calls it (nothing in the JAX package does either).

``launches``, ``bwd_launches`` and ``geglu_launches`` count kernel
launches, so that a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import build

launches = 0
bwd_launches = 0
geglu_launches = 0

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
        fmt = torch.contiguous_format
        return _launch_geglu(x, w1.to(x.dtype, memory_format=fmt), b1,
                             w2.to(x.dtype, memory_format=fmt), b2)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = geglu_ffn_xla_baseline(*leaves)
            return torch.autograd.grad(out, leaves, dy)


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


def _kernel_weights(w1, w2, dt):
    """Parameter-layout weights (w1 [2*inner, d], w2 [d, inner]) ->
    the kernels' contiguous [d, 2*inner] and [inner, d] in ``dt``: one
    cast-and-transpose copy each."""
    fmt = torch.contiguous_format
    return w1.t().to(dt, memory_format=fmt), w2.t().to(dt, memory_format=fmt)


class LnGegluFFN(torch.autograd.Function):
    """``x + GEGLU-FFN(LayerNorm(x))`` with the kernel pair on CUDA and the
    plain versions on the CPU; the transformer block's FF sub-layer.

    The weights come in parameter layout and dtype (``proj.weight``
    [2*inner, d], ``out.weight`` [d, inner], fp32 masters): the cast to
    x.dtype and the transpose happen inside, so the weight gradients
    come back in fp32 and in parameter layout, as JAX returns them in
    the master dtype (``ffn_pallas.py:721-726``). The inputs are saved
    and LN + GEGLU recomputed in the backward (``_ln_ffn_kbwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.eps = eps
        w1k, w2k = _kernel_weights(w1, w2, x.dtype)
        return _ffn(x, gamma, beta, w1k, b1, w2k, b2, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        d = x.shape[-1]
        w1k, w2k = _kernel_weights(w1, w2, x.dtype)
        dx, dg, dbt, dw1, db1, dw2, db2 = ln_geglu_ffn_bwd(
            x.reshape(-1, d), dy.reshape(-1, d).to(x.dtype).contiguous(), gamma, beta,
            w1k, b1, w2k, ctx.eps)
        return (
            dx.reshape(x.shape), dg.to(gamma.dtype), dbt.to(beta.dtype),
            dw1.t().to(w1.dtype), db1.to(b1.dtype), dw2.t().to(w2.dtype),
            db2.to(b2.dtype), None,
        )


def fused_ln_geglu_ffn(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """x + GEGLU-FFN(LayerNorm(x)) with the JAX function's layout
    (w1 [d, 2*inner], w2 [inner, d]): ``LnGegluFFN`` on the transposed
    views, so the kernels for a CUDA tensor and the plain versions for a
    CPU tensor; differentiable."""
    return LnGegluFFN.apply(x, gamma, beta, w1.t(), b1, w2.t(), b2, eps)


def _ffn(x, gamma, beta, w1, b1, w2, b2, eps):
    """The forward in kernel layout: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_geglu_ffn_reference(x, gamma, beta, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_geglu_ffn: unsupported device {x.device}")
    return _launch(x, gamma, beta, w1, b1, w2, b2, eps)


def ln_geglu_ffn_bwd(x, dy, gamma, beta, w1, b1, w2, eps: float = 1e-5):
    """The FF sub-layer's backward for flat x, dy [M, d], with the
    operands and returns of the JAX ``_ln_ffn_bwd_pallas``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_geglu_ffn_bwd_reference(x, dy, gamma, beta, w1, b1, w2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_geglu_ffn_bwd: unsupported device {x.device}")
    return _launch_bwd(x, dy, gamma, beta, w1, b1, w2, eps)


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
    for fn in ("wd_ln_geglu_ffn_max_d", "wd_ln_geglu_ffn_bwd_max_d",
               "wd_ln_geglu_ffn_bwd_block_m"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i
    lib.wd_cuda_error_string.argtypes = [i]
    lib.wd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"fused_ln_geglu_ffn: {name} is on {t.device}, x on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_ln_geglu_ffn: {name} has shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise ValueError(f"fused_ln_geglu_ffn: {name} is {t.dtype}, want {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_ln_geglu_ffn: {name} must be contiguous and 16-byte aligned")


def _check_operands(x, gamma, beta, w1, b1, w2, max_d):
    """The kernels' operands; gamma and beta None for the bare FFN."""
    d = x.shape[-1]
    inner = w2.shape[0]
    if d % 16 or inner % 64 or d > max_d:
        raise ValueError(
            f"fused_ln_geglu_ffn: kernel needs d % 16 == 0, inner % 64 == 0 and "
            f"d <= {max_d}; got d={d}, inner={inner}"
        )
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, tuple(x.shape), bf16, dev)
    if gamma is not None:
        _check("gamma", gamma, (d,), f32, dev)
        _check("beta", beta, (d,), f32, dev)
    _check("w1", w1, (d, 2 * inner), bf16, dev)
    _check("b1", b1, (2 * inner,), f32, dev)
    _check("w2", w2, (inner, d), bf16, dev)
    return d, inner


def _raise_on(err, what):
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{_lib().wd_cuda_error_string(err).decode()} (code {err})"
        )


def _launch(x, gamma, beta, w1, b1, w2, b2, eps):
    global launches
    lib = _lib()
    d, inner = _check_operands(x, gamma, beta, w1, b1, w2, lib.wd_ln_geglu_ffn_max_d())
    _check("b2", b2, (d,), torch.float32, x.device)
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.wd_ln_geglu_ffn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            m, d, inner, eps, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "ln_geglu_ffn")
    launches += 1
    return out


def _launch_geglu(x, w1, b1, w2, b2):
    global geglu_launches
    lib = _lib()
    d, inner = _check_operands(x, None, None, w1, b1, w2, lib.wd_ln_geglu_ffn_max_d())
    _check("b2", b2, (d,), torch.float32, x.device)
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.wd_geglu_ffn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), m, d, inner, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "geglu_ffn")
    geglu_launches += 1
    return out


def _launch_bwd(x, dy, gamma, beta, w1, b1, w2, eps):
    global bwd_launches
    lib = _lib()
    d, inner = _check_operands(x, gamma, beta, w1, b1, w2, lib.wd_ln_geglu_ffn_bwd_max_d())
    if x.dim() != 2:
        raise ValueError(f"ln_geglu_ffn_bwd: x must be [M, d], got {tuple(x.shape)}")
    _check("dy", dy, tuple(x.shape), torch.bfloat16, x.device)
    m = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    new = torch.zeros if m == 0 else torch.empty  # no rows: the sums are zero
    dx = torch.empty_like(x)
    dg, dbt, db2 = (new(d, **f32) for _ in range(3))
    dw1, db1 = new(d, 2 * inner, **f32), new(2 * inner, **f32)
    dw2 = new(inner, d, **f32)
    if m == 0:
        return dx, dg, dbt, dw1, db1, dw2, db2
    # scratch for the weight-gradient pass, and per-row-tile partial sums
    xn = torch.empty_like(x)
    dhc = torch.empty(m, 2 * inner, dtype=x.dtype, device=x.device)
    act = torch.empty(m, inner, dtype=x.dtype, device=x.device)
    bm = lib.wd_ln_geglu_ffn_bwd_block_m()
    part = torch.empty(-(-m // bm), 3 * d + 2 * inner, **f32)
    ptrs = [t.data_ptr() for t in (x, dy, gamma, beta, w1, b1, w2, dx, dg, dbt, dw1, db1,
                                   dw2, db2, xn, dhc, act, part)]
    with torch.cuda.device(x.device):
        err = lib.wd_ln_geglu_ffn_bwd(
            *ptrs, m, d, inner, eps, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "ln_geglu_ffn_bwd")
    bwd_launches += 1
    return dx, dg, dbt, dw1, db1, dw2, db2
