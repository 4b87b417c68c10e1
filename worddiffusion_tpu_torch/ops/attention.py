"""Fused attention ``softmax(q kᵀ · scale) v``: every attention of the UNet's
spatial transformers.

Port of ``bench_kernels/attention_pallas.py::fused_attention``, with its
layout (q [B, H, Nq, D], k and v [B, H, Nk, D]) and its body's dtype
contract: bf16 q, k, v; fp32 scores, scaled after the product; fp32
softmax; the probabilities cast to v's dtype; fp32 ``p · v``; output in
v's dtype. ``fused_attention`` is the autograd Function ``Attention``: a
CUDA tensor launches the kernel ``csrc/attention.cu``, a CPU tensor takes
the plain PyTorch version ``attention_reference``, and a CUDA input the
kernel does not take raises instead of falling back. The kernel takes head
widths D % 16 == 0 up to 256: the presets' 80, and the 160 of a UNet with
``channel_mult=(1, 2)`` (its middle block's 4 heads of 640), which JAX runs
in XLA at any width. The JAX kernel has
no backward (a bare ``pallas_call`` has no VJP), so the Function's
backward recomputes ``attention_reference`` under plain autograd.

``attention_with_probs`` is the attention-maps path (``UNetConfig.
return_attn``): the output as above and the fp32 probabilities
``softmax(q kᵀ · scale)`` [B, H, Nq, Nk], which on the card come from a
second kernel of ``csrc/attention.cu`` that recomputes the scores and
normalises them by the log-sum-exp B.4 writes beside its output; its plain
version is ``attention_probs_reference``, the JAX model's sown softmax.

``fast=True`` (``UNetConfig.fast_softmax=True``) is the JAX model's
``_attend(fast_softmax=True)`` order (``worddiffusion_tpu/models/attention.py:
88-93``): fp32 scores and max-subtract, ``e = bf16(exp(s - m))``, ``S =
bf16(sum_f32 e)``, ``p = bf16(e / S)``, fp32 ``p · v``. The plain version
computes exactly that; the kernel runs its fast mode, which makes the first
two roundings and differs from the plain version by where each p's bf16
rounding falls (``csrc/attention.cu``'s header). The Function's backward
recomputes the plain version in the same mode.

``launches`` counts B.4's launches (both modes), ``fast_launches`` those in
the fast mode, ``probs_launches`` the maps kernel's and ``bwd_calls`` the
Function's backward calls, so that a run can show that its main path went
through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0
fast_launches = 0
probs_launches = 0
bwd_calls = 0

# The backward recomputes the plain version, which forms the fp32 scores and
# probabilities [B, H, Nq, Nk] and their gradients: about four such tensors.
# Above this many bytes a call raises before allocating them (self-attention
# over a pixel-space image: Nq = Nk = 16384 is 68 GB at B = 16).
BACKWARD_BYTES_LIMIT = 24 * 2 ** 30


def backward_bytes(b: int, h: int, nq: int, nk: int) -> int:
    """What the plain-recompute backward allocates for one call: four fp32
    [B, H, Nq, Nk] tensors."""
    return 4 * 4 * b * h * nq * nk


def check_backward_size(b: int, h: int, nq: int, nk: int) -> None:
    need = backward_bytes(b, h, nq, nk)
    if need > BACKWARD_BYTES_LIMIT:
        raise ValueError(
            f"the attention backward at B={b}, H={h}, Nq={nq}, Nk={nk} would form "
            f"{need / 2 ** 30:.1f} GiB of fp32 scores (limit {BACKWARD_BYTES_LIMIT / 2 ** 30:.0f} "
            "GiB): train self-attention over a pixel-space image at a smaller batch, or in "
            "latent space")


def attention_reference(q, k, v, scale: float, fast: bool = False):
    """Plain PyTorch version with the kernel's dtype contract
    (``attention_pallas.py::_attn_kernel``): fp32 scores and softmax,
    probabilities rounded to v's dtype, fp32 ``p · v``. ``fast``: JAX's
    ``_attend(fast_softmax=True)`` order, the exponentials, their row sum
    and the probabilities each rounded to v's dtype."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if fast:
        e = (sim - sim.amax(dim=-1, keepdim=True)).exp().to(v.dtype)
        p = e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(v.dtype)
    else:
        p = sim.softmax(dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def attention_probs_reference(q, k, scale: float):
    """Plain PyTorch attention maps: fp32 ``softmax(q kᵀ · scale)`` (the JAX
    model's sown ``attn``, ``models/attention.py:198-209``)."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return sim.softmax(dim=-1)


class Attention(torch.autograd.Function):
    """``softmax(q kᵀ · scale) v``: the kernel (CUDA) or the plain version
    (CPU) forward; the backward recomputes the plain version under
    autograd, in the forward's mode (``fast``: JAX's training
    differentiates through the fast order where it is set), which runs in a
    fixed order, so two backward calls agree bit for bit (the trainer's
    bitwise resume rests on it)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fast):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.fast = scale, fast
        return _attend(q, k, v, scale, fast)

    @staticmethod
    def backward(ctx, dout):
        global bwd_calls
        saved = ctx.saved_tensors  # once: a checkpoint (remat) recomputes on each read
        q, k = saved[:2]
        check_backward_size(q.shape[0], q.shape[1], q.shape[2], k.shape[2])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            out = attention_reference(*leaves, ctx.scale, ctx.fast)
            dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        bwd_calls += 1
        return dq, dk, dv, None, None


def fused_attention(q, k, v, scale: float, fast: bool = False):
    """softmax(q kᵀ · scale) v for q [B, H, Nq, D], k/v [B, H, Nk, D]:
    the kernel for a CUDA tensor, the plain version for a CPU tensor;
    differentiable. ``fast``: JAX's fast_softmax order (the kernel's fast
    mode)."""
    return Attention.apply(q, k, v, scale, fast)


def _attend(q, k, v, scale, fast):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, fast)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _launch(q, k, v, scale, fast=fast)


@functools.cache
def _lib():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wd_attention.argtypes = [p] * 5 + [i] * 4 + [ctypes.c_float, i, p]
    lib.wd_attention.restype = i
    lib.wd_attention_probs.argtypes = [p] * 4 + [i] * 4 + [ctypes.c_float, p]
    lib.wd_attention_probs.restype = i
    lib.wd_attention_max_d.argtypes = []
    lib.wd_attention_max_d.restype = i
    lib.wd_attention_tile_rows.argtypes = [i, i]
    lib.wd_attention_tile_rows.restype = i
    lib.wd_attention_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.wd_attention_plan.restype = i
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


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.wd_cuda_error_string(err).decode()} "
                           f"(code {err})")


def _launch(q, k, v, scale, lse=None, fast=False):
    global launches, fast_launches
    lib = _lib()
    _check_operands(q, k, v, lib.wd_attention_max_d())
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    if b * h == 0 or nq == 0:
        return out
    err = build.launch_on(q, lambda stream: lib.wd_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, nq, k.shape[2], d, float(scale),
        int(fast), stream))
    _raise_on(lib, err, "attention kernel")
    launches += 1
    fast_launches += bool(fast)
    return out


PLAN_KEYS = ("rows", "keys", "ctas", "smem", "q_slots", "kv_stages", "producer_regs",
             "consumer_regs")


def plan(bh: int, nq: int, nk: int, d: int = 80) -> dict:
    """The kernel's launch plan for B*H = ``bh`` pairs of Nq, Nk at head
    width d: query rows a CTA, keys a chunk, persistent CTAs, dynamic shared
    memory, q ring slots, k / v ring stages, and the producer's and the
    consumers' registers after setmaxnreg (0 where it is not used)."""
    lib = _lib()
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _raise_on(lib, lib.wd_attention_plan(bh, nq, nk, d, out), "attention plan")
    return dict(zip(PLAN_KEYS, out))


def attention_lse(q, k, v, scale: float):
    """B.4 on CUDA tensors -> (out, lse [B, H, Nq] fp32, each query row's
    ``log(sum exp(q kᵀ · scale))``). Forward only."""
    b, h, nq, _ = q.shape
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, scale, lse), lse


def attention_probs(q, k, lse, scale: float):
    """The maps kernel: ``exp(q kᵀ · scale - lse)`` [B, H, Nq, Nk] fp32 from
    CUDA tensors q, k (B.4's operands) and B.4's ``lse``. Forward only."""
    global probs_launches
    lib = _lib()
    _check_operands(q, k, k, lib.wd_attention_max_d())
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, nq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"attention_probs: lse must be contiguous fp32 [{b}, {h}, {nq}] on "
                         f"{q.device}")
    if b * h > 65535:
        raise ValueError(f"attention_probs: B*H = {b * h} exceeds the grid's 65535")
    p = torch.empty((b, h, nq, nk), dtype=torch.float32, device=q.device)
    err = build.launch_on(q, lambda stream: lib.wd_attention_probs(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), p.data_ptr(), b * h, nq, nk, d,
        float(scale), stream))
    _raise_on(lib, err, "attention maps kernel")
    probs_launches += 1
    return p


def attention_with_probs(q, k, v, scale: float):
    """-> (``softmax(q kᵀ · scale) v`` as ``fused_attention`` gives it, the
    fp32 maps ``softmax(q kᵀ · scale)``): on a CUDA tensor B.4 with its
    log-sum-exp, then the maps kernel; on a CPU tensor the plain versions.
    Forward only (the maps are an analysis output)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale), attention_probs_reference(q, k, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_with_probs: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the attention maps (return_attn) are forward only on the card: "
                         "run the model under torch.no_grad()")
    with torch.no_grad():
        out, lse = attention_lse(q, k, v, scale)
        return out, attention_probs(q, k, lse, scale)
