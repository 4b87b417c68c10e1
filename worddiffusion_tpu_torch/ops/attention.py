"""Fused attention ``softmax(q kᵀ · scale) v``: every attention of the UNet's
spatial transformers.

Port of ``bench_kernels/attention_pallas.py::fused_attention``, with its
layout (q [B, H, Nq, D], k and v [B, H, Nk, D]) and its body's dtype
contract: bf16 q, k, v; fp32 scores, scaled after the product; fp32
softmax; the probabilities cast to v's dtype; fp32 ``p · v``; output in
v's dtype. ``fused_attention`` is the autograd Function ``Attention``: a
CUDA tensor launches the kernel ``csrc/attention.cu``, a CPU tensor takes
the plain PyTorch version ``attention_reference``, and a CUDA input the
kernel does not take raises instead of falling back. The JAX kernel has
no backward (a bare ``pallas_call`` has no VJP), so the Function's
backward recomputes ``attention_reference`` under plain autograd.

``launches`` counts kernel launches and ``bwd_calls`` the Function's
backward calls, so that a run can show that its main path went through
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0
bwd_calls = 0


def attention_reference(q, k, v, scale: float):
    """Plain PyTorch version with the kernel's dtype contract
    (``attention_pallas.py::_attn_kernel``): fp32 scores and softmax,
    probabilities rounded to v's dtype, fp32 ``p · v``."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = sim.softmax(dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


class Attention(torch.autograd.Function):
    """``softmax(q kᵀ · scale) v``: the kernel (CUDA) or the plain version
    (CPU) forward; the backward recomputes the plain version under
    autograd, which runs in a fixed order, so two backward calls agree
    bit for bit (the trainer's bitwise resume rests on it)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _attend(q, k, v, scale)

    @staticmethod
    def backward(ctx, dout):
        global bwd_calls
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = attention_reference(*leaves, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        bwd_calls += 1
        return dq, dk, dv, None


def fused_attention(q, k, v, scale: float):
    """softmax(q kᵀ · scale) v for q [B, H, Nq, D], k/v [B, H, Nk, D]:
    the kernel for a CUDA tensor, the plain version for a CPU tensor;
    differentiable."""
    return Attention.apply(q, k, v, scale)


def _attend(q, k, v, scale):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _launch(q, k, v, scale)


@functools.cache
def _lib():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wd_attention.argtypes = [p] * 4 + [i] * 4 + [ctypes.c_float, p]
    lib.wd_attention.restype = i
    lib.wd_attention_max_d.argtypes = []
    lib.wd_attention_max_d.restype = i
    lib.wd_attention_tile_rows.argtypes = [i, i]
    lib.wd_attention_tile_rows.restype = i
    lib.wd_cuda_error_string.argtypes = [i]
    lib.wd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(q, k, v, max_d):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"fused_attention: q, k, v must be [B, H, N, D], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    nk = k.shape[2]
    if tuple(k.shape) != (b, h, nk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"fused_attention: k and v must be [{b}, {h}, Nk, {d}], got {tuple(k.shape)} "
            f"and {tuple(v.shape)}")
    if d % 16 or d > max_d or nk < 1:
        raise ValueError(
            f"fused_attention: kernel needs D % 16 == 0, D <= {max_d} and Nk >= 1; "
            f"got D={d}, Nk={nk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"fused_attention: {name} is {t.dtype}, want torch.bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} must be contiguous and 16-byte aligned")


def _launch(q, k, v, scale):
    global launches
    lib = _lib()
    _check_operands(q, k, v, lib.wd_attention_max_d())
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    if b * h == 0 or nq == 0:
        return out
    with torch.cuda.device(q.device):
        err = lib.wd_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, nq, k.shape[2],
            d, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"attention kernel launch failed: {lib.wd_cuda_error_string(err).decode()} "
            f"(code {err})")
    launches += 1
    return out
