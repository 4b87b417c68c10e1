"""Fused LayerNorm + GEGLU feed-forward + residual: the transformer
block's whole FF sub-layer.

Port of ``worddiffusion_tpu/ops/ffn_pallas.py::fused_ln_geglu_ffn``
(forward only). ``fused_ln_geglu_ffn`` runs the hand-written CUDA kernel
``csrc/ln_geglu_ffn.cu`` for a CUDA tensor and the plain PyTorch version
``ln_geglu_ffn_reference`` for a CPU tensor; a CUDA input the kernel
does not take raises instead of falling back.

``launches`` counts kernel launches, so that a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

launches = 0


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


def fused_ln_geglu_ffn(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """x + GEGLU-FFN(LayerNorm(x)): the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_geglu_ffn_reference(x, gamma, beta, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_geglu_ffn: unsupported device {x.device}")
    return _launch(x, gamma, beta, w1, b1, w2, b2, eps)


@functools.cache
def _lib():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wd_ln_geglu_ffn.argtypes = [p] * 8 + [i, i, i, ctypes.c_float, p]
    lib.wd_ln_geglu_ffn.restype = i
    lib.wd_ln_geglu_ffn_max_d.argtypes = []
    lib.wd_ln_geglu_ffn_max_d.restype = i
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


def _launch(x, gamma, beta, w1, b1, w2, b2, eps):
    global launches
    lib = _lib()
    d = x.shape[-1]
    inner = w2.shape[0]
    if d % 16 or inner % 64 or d > lib.wd_ln_geglu_ffn_max_d():
        raise ValueError(
            f"fused_ln_geglu_ffn: kernel needs d % 16 == 0, inner % 64 == 0 and "
            f"d <= {lib.wd_ln_geglu_ffn_max_d()}; got d={d}, inner={inner}"
        )
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, tuple(x.shape), bf16, dev)
    _check("gamma", gamma, (d,), f32, dev)
    _check("beta", beta, (d,), f32, dev)
    _check("w1", w1, (d, 2 * inner), bf16, dev)
    _check("b1", b1, (2 * inner,), f32, dev)
    _check("w2", w2, (inner, d), bf16, dev)
    _check("b2", b2, (d,), f32, dev)
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.wd_ln_geglu_ffn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            m, d, inner, eps, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"ln_geglu_ffn kernel launch failed: "
            f"{lib.wd_cuda_error_string(err).decode()} (code {err})"
        )
    launches += 1
    return out
