"""Context-folded attention sub-layer
``y = x + sum_h softmax(LN(x) · wt_h) · vw_h + b_out``: a cross-attention
over a short context (the ``iam`` UNet's 42 character tokens) with its
pre-norm and residual, once the q projection is folded into K and the out
projection into V (``models/attention.py``: ``fold_weights`` and
``build_folds``).

Port of two Pallas TPU kernels of the same function, each with its
layout of the folds, over the one CUDA kernel ``csrc/fold_attention.cu``:

- ``fold_attention``: B.7, ``bench_kernels/attn_fold_pallas.py``,
  wt [B, C, H·L] and vw [B, H·L, C];
- ``fold_attention_heads``: B.8,
  ``bench_kernels/attn_fold_sublayer_pallas.py``, wt4 [B, H, C, L] and
  vw4 [B, H, L, C].

vw and vw4 are the same memory; B.7's wt is handed on as the strided
[B, H, C, L] view of its bytes, which the kernel reads through its
strides. The kernel takes every C % 16 == 0 up to 640: up to 320 its
narrow instance, above it the wide one (two consumer warpgroups), which
reads wt4 by TMA alone, so a wt4 its tensor map cannot read (B.7's rows, an
L stride off 8 elements) is first copied to the L stride ``build_folds``
lays out (``wt_route``: "copy" at C <= 320, "padded" above). Both entries
go through the autograd Function ``FoldAttention``: a CUDA tensor launches
the kernel, a CPU tensor takes the plain PyTorch
version ``fold_attention_reference``, and a CUDA input the kernel does
not take raises instead of falling back. Neither TPU kernel has a
backward kernel (both ``custom_vjp``s recompute through XLA), so the
Function's backward recomputes ``fold_attention_reference`` under plain
autograd.

``launches`` counts kernel launches (through either entry),
``flat_launches`` those through B.7's entry, and ``bwd_calls`` the
Function's backward calls, so that a run can show that its main path went
through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0
flat_launches = 0
bwd_calls = 0


def fold_attention_reference(x, wt4, vw4, gamma, beta, b_out, eps: float = 1e-5):
    """Plain PyTorch version with the kernels' dtype contract
    (``attn_fold_pallas.py::_fold_attn_reference``,
    ``attn_fold_sublayer_pallas.py::fold_attention_reference``): fp32
    LayerNorm rounded to x's dtype, fp32 scores and per-head softmax, the
    probabilities rounded to x's dtype, fp32 ``p · vw``, and
    ``x + out + b_out`` summed in fp32 and rounded once.

    x [B, N, C]; wt4 [B, H, C, L] (any strides); vw4 [B, H, L, C];
    gamma, beta, b_out [C]."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(dt)
    sim = torch.einsum("bnc,bhcl->bhnl", xn.float(), wt4.to(dt).float())
    p = sim.softmax(dim=-1).to(dt)
    out = torch.einsum("bhnl,bhlc->bnc", p.float(), vw4.to(dt).float())
    return (xf + out + b_out.float()).to(dt)


class FoldAttention(torch.autograd.Function):
    """The sub-layer on the per-head layout: the kernel (CUDA) or the plain
    version (CPU) forward; the backward recomputes the plain version under
    autograd, which runs in a fixed order, so two backward calls agree bit
    for bit (the trainer's bitwise resume rests on it)."""

    @staticmethod
    def forward(ctx, x, wt4, vw4, gamma, beta, b_out, eps, flat=False):
        ctx.save_for_backward(x, wt4, vw4, gamma, beta, b_out)
        ctx.eps = eps
        return _fold(x, wt4, vw4, gamma, beta, b_out, eps, flat)

    @staticmethod
    def backward(ctx, dy):
        global bwd_calls
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = fold_attention_reference(*leaves, ctx.eps)
            grads = torch.autograd.grad(y, leaves, dy)
        bwd_calls += 1
        return (*grads, None, None)


def fold_attention(x, wt, vw, gamma, beta, b_out, heads: int, eps: float = 1e-5):
    """B.7's entry: wt [B, C, H·L] (scaled folds), vw [B, H·L, C]."""
    l = wt.shape[-1] // heads
    wt4 = wt.unflatten(-1, (heads, l)).permute(0, 2, 1, 3)  # a view, no copy
    return FoldAttention.apply(x, wt4, vw.unflatten(1, (heads, l)), gamma, beta, b_out, eps,
                               True)


def fold_attention_heads(x, wt4, vw4, gamma, beta, b_out, eps: float = 1e-5):
    """B.8's entry: wt4 [B, H, C, L] (scaled folds), vw4 [B, H, L, C]."""
    return FoldAttention.apply(x, wt4, vw4, gamma, beta, b_out, eps)


def _fold(x, wt4, vw4, gamma, beta, b_out, eps, flat):
    if x.device.type == "cpu":
        return fold_attention_reference(x, wt4, vw4, gamma, beta, b_out, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fold_attention: unsupported device {x.device}")
    return _launch(x, wt4, vw4, gamma, beta, b_out, eps, flat)


@functools.cache
def _lib():
    lib = build.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wd_fold_attention.argtypes = [p] * 7 + [i] * 5 + [ll] * 3 + [ctypes.c_float, p]
    lib.wd_fold_attention.restype = i
    for fn in ("wd_fold_attention_max_c", "wd_fold_attention_max_l"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i
    lib.wd_fold_attention_ctas.argtypes = [i] * 4
    lib.wd_fold_attention_ctas.restype = i
    lib.wd_fold_attention_wt_mode.argtypes = [p] + [i] * 4 + [ll] * 3
    lib.wd_fold_attention_wt_mode.restype = i
    lib.wd_cuda_error_string.argtypes = [i]
    lib.wd_cuda_error_string.restype = ctypes.c_char_p
    return lib


# how wt4 reaches shared memory: TMA boxes of a per-head tensor map, or
# copies by the producer warpgroup's threads (C <= 320; above, one copy to
# the TMA layout first: "padded")
WT_ROUTES = ("tma", "copy")
NARROW_C = 320


def ctas(b: int, n: int, c: int, l: int) -> int:
    """The persistent CTAs the kernel launches at these shapes: as many as
    are resident on the card (one an SM), at most one a 64-row tile; each
    walks its tiles with all H heads."""
    return _lib().wd_fold_attention_ctas(b, n, c, l)


def wt_route(wt4) -> str:
    """How the kernel brings wt4 into shared memory, from its alignment and
    strides: "tma" (a per-head tensor map: strides of multiples of 8
    elements, as build_folds lays wt4 out) or "copy" (B.7's [B, C, H*L]
    rows, the contiguous layout at L = 42, an odd L)."""
    mode = _lib().wd_fold_attention_wt_mode(wt4.data_ptr(), *wt4.shape, *wt4.stride()[:3])
    if mode < 0:
        raise ValueError(f"fold_attention: the kernel does not take wt4 {tuple(wt4.shape)}")
    if mode and wt4.shape[2] > NARROW_C:
        return "padded"
    return WT_ROUTES[mode]


def _tma_layout(wt4):
    """A copy of wt4 with its L stride rounded up to 8 elements, as
    build_folds lays it out, which the wide kernel's tensor map reads (it
    reads no element past a row's L)."""
    b, h, c, l = wt4.shape
    return wt4.new_empty(b, h, c, -(-l // 8) * 8)[..., :l].copy_(wt4)


def _check_operands(x, wt4, vw4, vecs, max_c, max_l):
    if x.dim() != 3 or wt4.dim() != 4 or vw4.dim() != 4:
        raise ValueError(
            f"fold_attention: x must be [B, N, C], wt4 [B, H, C, L] and vw4 [B, H, L, C]; "
            f"got {tuple(x.shape)}, {tuple(wt4.shape)}, {tuple(vw4.shape)}")
    b, _, c = x.shape
    _, h, _, l = wt4.shape
    if tuple(wt4.shape) != (b, h, c, l) or tuple(vw4.shape) != (b, h, l, c):
        raise ValueError(
            f"fold_attention: want wt4 [{b}, H, {c}, L] and vw4 [{b}, H, L, {c}], got "
            f"{tuple(wt4.shape)} and {tuple(vw4.shape)}")
    if c % 16 or c > max_c or not 1 <= l <= max_l or h * l > c:
        raise ValueError(
            f"fold_attention: kernel needs C % 16 == 0, C <= {max_c}, 1 <= L <= {max_l} "
            f"and H * L <= C; got C={c}, H={h}, L={l}")
    for name, t in (("x", x), ("wt4", wt4), ("vw4", vw4)):
        if t.device != x.device:
            raise ValueError(f"fold_attention: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"fold_attention: {name} is {t.dtype}, want torch.bfloat16")
    for name, t in (("x", x), ("vw4", vw4)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fold_attention: {name} must be contiguous and 16-byte aligned")
    if wt4.stride(-1) != 1:
        raise ValueError(f"fold_attention: wt4's L axis must have stride 1, got {wt4.stride()}")
    for name, v in zip(("gamma", "beta", "b_out"), vecs):
        if v.device != x.device or tuple(v.shape) != (c,):
            raise ValueError(f"fold_attention: {name} must be [{c}] on {x.device}, got "
                             f"{tuple(v.shape)} on {v.device}")


def _launch(x, wt4, vw4, gamma, beta, b_out, eps, flat):
    global launches, flat_launches
    lib = _lib()
    _check_operands(x, wt4, vw4, (gamma, beta, b_out), lib.wd_fold_attention_max_c(),
                    lib.wd_fold_attention_max_l())
    b, n, c = x.shape
    h, l = wt4.shape[1], wt4.shape[3]
    # the [C] vectors in fp32 and 16-byte aligned, as the kernel reads them
    # (the parameters already are)
    vecs = [v.float().contiguous() for v in (gamma, beta, b_out)]
    vecs = [v if v.data_ptr() % 16 == 0 else v.clone() for v in vecs]
    out = torch.empty_like(x)
    if b == 0 or n == 0:
        return out
    if c > NARROW_C and wt_route(wt4) == "padded":
        wt4 = _tma_layout(wt4)
    err = build.launch_on(x, lambda stream: lib.wd_fold_attention(
        x.data_ptr(), wt4.data_ptr(), vw4.data_ptr(), *(v.data_ptr() for v in vecs),
        out.data_ptr(), b, n, c, h, l, *wt4.stride()[:3], float(eps), stream))
    if err:
        raise RuntimeError(
            f"fold attention kernel launch failed: {lib.wd_cuda_error_string(err).decode()} "
            f"(code {err})")
    launches += 1
    flat_launches += flat
    return out
