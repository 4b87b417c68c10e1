"""GroupNorm (+ SiLU) over channel-last activations: every GroupNorm of the
port's models that is not followed by a C -> C 3x3 conv (those run
``ops.gn_conv``).

Port of ``bench_kernels/groupnorm_pallas.py::fused_groupnorm``, with its
layout (x [B, H, W, C] or [B, S, C], channels last) and its body's
arithmetic: fp32 statistics with ``var = E[x²] - mu²`` (the JAX
``GroupNorm32`` formula; clamped at 0 as flax's ``GroupNorm`` does, so a
group of near-equal values gives no NaN), fp32 affine, SiLU in fp32 when
asked, the output in x's dtype. ``fused_groupnorm`` launches
``csrc/groupnorm.cu`` for a CUDA tensor (one cluster launch; the autograd
Function ``GroupNormFn`` wraps it only where a gradient is wanted), takes
the plain PyTorch version ``groupnorm_reference`` for a CPU tensor, and
raises for a CUDA input the kernel does not take instead of falling back.
The JAX kernel has no backward, so the Function's backward recomputes
``groupnorm_reference`` under plain autograd.

``launches`` counts kernel launches and ``bwd_calls`` the Function's
backward calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0
bwd_calls = 0


def groupnorm_reference(x, scale, bias, groups: int, eps: float = 1e-5, silu: bool = False):
    """Plain PyTorch version: x [B, ..., C] in ``groups`` groups of
    channels; fp32 statistics (``E[x²] - mu²``, clamped at 0) and affine,
    fp32 SiLU with ``silu``; the output in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mu.square()).clamp_min(0.0)
    out = ((xf - mu) * torch.rsqrt(var + eps)).reshape(x.shape) * scale.float() + bias.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


class GroupNormFn(torch.autograd.Function):
    """GroupNorm (+ SiLU): the kernel (CUDA) or the plain version (CPU)
    forward; the backward recomputes the plain version under autograd, in
    a fixed order, so two backward calls agree bit for bit."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, silu)
        return _groupnorm(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dout):
        global bwd_calls
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = groupnorm_reference(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, dout)
        bwd_calls += 1
        return (*grads, None, None, None)


def fused_groupnorm(x, scale, bias, groups: int, eps: float = 1e-5, silu: bool = False):
    """GroupNorm (+ SiLU) of x [B, H, W, C] or [B, S, C] in ``groups``
    groups: the kernel for a CUDA tensor, the plain version for a CPU
    tensor; differentiable. Without a gradient to record (no input needs
    one, or under ``torch.no_grad``) it skips the Function's overhead."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormFn.apply(x, scale, bias, groups, eps, silu)
    return _groupnorm(x, scale, bias, groups, eps, silu)


def _groupnorm(x, scale, bias, groups, eps, silu):
    if x.device.type == "cpu":
        return groupnorm_reference(x, scale, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_groupnorm: unsupported device {x.device}")
    return _launch(x, scale, bias, groups, eps, silu)


@functools.cache
def _lib():
    lib = build.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wd_groupnorm.argtypes = [p] * 4 + [i] * 4 + [f, i, p]
    lib.wd_groupnorm.restype = i
    lib.wd_groupnorm_route.argtypes = [i] * 4
    lib.wd_groupnorm_route.restype = i
    lib.wd_groupnorm_max_c.argtypes = []
    lib.wd_groupnorm_max_c.restype = i
    lib.wd_cuda_error_string.argtypes = [i]
    lib.wd_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def max_c() -> int:
    """The widest C the GroupNorm kernels take."""
    return _lib().wd_groupnorm_max_c()


def route(x, groups: int) -> tuple[int, bool]:
    """B.5's route at x's shape: (CTAs per cluster, whether a CTA's range of
    x stays in shared memory between the two passes; if not, it is read
    twice)."""
    b, c = x.shape[0], x.shape[-1]
    r = _lib().wd_groupnorm_route(b, x.numel() // (b * c), c, groups)
    return r >> 1, bool(r & 1)


def check_norm_operands(name: str, x, vectors, groups: int, max_c: int) -> None:
    """The layouts and dtypes the GroupNorm kernels take (shared with
    ``ops.gn_conv``): x bf16, channels last ([B, H, W, C] or [B, S, C]),
    contiguous, 16-byte aligned, C % 8 == 0, C <= ``max_c``, C % groups ==
    0, B <= 65535; the per-channel vectors fp32 [C], contiguous, on x's
    device."""
    c = x.shape[-1] if x.dim() else 0
    if (x.dim() not in (3, 4) or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or x.data_ptr() % 16 or c % 8 or c > max_c or groups < 1 or c % groups
            or not 1 <= x.shape[0] <= 65535):
        raise ValueError(
            f"{name}: x is {x.dtype} {tuple(x.shape)} (contiguous {x.is_contiguous()}) with "
            f"{groups} groups; takes bf16 x [B, H, W, C] or [B, S, C] (channels last, "
            "contiguous, 16-byte aligned; a channels_last NCHW tensor permuted to NHWC is), "
            f"C % 8 == 0, C <= {max_c}, C % groups == 0, B <= 65535; fp32 [C] norms and biases")
    dev = x.get_device()
    for vname, v in vectors.items():
        if (v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous()
                or v.get_device() != dev):
            raise ValueError(f"{name}: {vname} is {v.dtype} {tuple(v.shape)} on {v.device}; "
                             f"takes fp32 [{c}], contiguous, on x's device")


def _launch(x, scale, bias, groups, eps, silu):
    """One cluster launch; the only allocation is the output."""
    global launches
    lib = _lib()
    check_norm_operands("fused_groupnorm", x, {"scale": scale, "bias": bias}, groups, max_c())
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    out = torch.empty_like(x)
    if s == 0:
        return out
    err = build.launch_on(x, lambda stream: lib.wd_groupnorm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, c, groups,
        eps, silu, stream))
    if err:
        raise RuntimeError(
            f"groupnorm kernel launch failed: {lib.wd_cuda_error_string(err).decode()} "
            f"(code {err})")
    launches += 1
    return out
