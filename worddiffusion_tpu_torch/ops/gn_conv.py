"""GroupNorm -> SiLU -> 3x3 SAME conv with as many output channels as
input channels: the prologue of every UNet ResBlock and SD-VAE resnet
whose conv keeps the width.

Port of ``bench_kernels/resblock_pallas.py::fused_gn_silu_conv3x3``, with
its activation layout (x [B, H, W, C], channels last) and its body's
arithmetic: the GroupNorm of ``ops.groupnorm`` (fp32 statistics and
affine), SiLU in fp32, the activation rounded to bf16 and zero-padded
AFTER the activation, 9 shifted bf16 products with fp32 accumulation, the
bias added in fp32, the output in x's dtype. The conv weight comes in the
port's parameter layout (OIHW, fp32); the Function casts it to bf16 in
the kernel's [C_out, 3, 3, C_in] layout. ``fused_gn_silu_conv3x3`` is the
autograd Function ``GnSiluConvFn``: a CUDA tensor launches
``csrc/gn_silu_conv3x3.cu``, a CPU tensor takes the plain PyTorch version
``gn_silu_conv3x3_reference`` (the TPU file's own baseline,
``resblock_pallas.py::xla_reference``: plain GroupNorm, SiLU, then
``F.conv2d``), and a CUDA input the kernel does not take raises instead of
falling back. A conv that changes the width (C_in != C_out) raises: those
sites run ``ops.groupnorm`` with SiLU and then their conv. The backward
recomputes the plain version under autograd.

``launches`` counts calls that launched the kernel, ``stats_launches``
those of them that launched B.5's statistics kernel before it (the C entry
says so; ``plan`` shows the same: a sample is more CTAs than a cluster
holds), and ``bwd_calls`` the Function's backward calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .groupnorm import check_norm_operands, groupnorm_reference

launches = 0
stats_launches = 0
bwd_calls = 0


def gn_silu_conv3x3_reference(x, gn_scale, gn_bias, w, b, groups: int, eps: float = 1e-5):
    """Plain PyTorch version: x [B, H, W, C] -> [B, H, W, C] in x's dtype;
    w [C, C, 3, 3] (OIHW), b [C]. The activation is rounded to x's dtype
    before the conv, which runs in x's dtype."""
    h = groupnorm_reference(x, gn_scale, gn_bias, groups, eps, silu=True)
    out = F.conv2d(h.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype), padding=1)
    return out.permute(0, 2, 3, 1)


class GnSiluConvFn(torch.autograd.Function):
    """GroupNorm -> SiLU -> conv3x3: the kernel (CUDA) or the plain version
    (CPU) forward; the backward recomputes the plain version under
    autograd, so the weight and bias gradients come back in their fp32."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, w, b, groups, eps):
        ctx.save_for_backward(x, gn_scale, gn_bias, w, b)
        ctx.args = (groups, eps)
        return _gn_conv(x, gn_scale, gn_bias, w, b, groups, eps)

    @staticmethod
    def backward(ctx, dout):
        global bwd_calls
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = gn_silu_conv3x3_reference(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, dout)
        bwd_calls += 1
        return (*grads, None, None)


def fused_gn_silu_conv3x3(x, gn_scale, gn_bias, w, b, groups: int, eps: float = 1e-5):
    """conv3x3(silu(GroupNorm(x))) + b for x [B, H, W, C], w [C, C, 3, 3]
    (OIHW): the kernel for a CUDA tensor, the plain version for a CPU
    tensor; differentiable."""
    return GnSiluConvFn.apply(x, gn_scale, gn_bias, w, b, groups, eps)


def _gn_conv(x, gn_scale, gn_bias, w, b, groups, eps):
    c = x.shape[-1]
    if tuple(w.shape) != (c, c, 3, 3):
        raise ValueError(
            f"fused_gn_silu_conv3x3: w is {tuple(w.shape)}, takes [C, C, 3, 3] (OIHW) with C = "
            f"{c} = x's channels; a conv that changes the width runs fused_groupnorm("
            "silu=True) and then the conv")
    if x.device.type == "cpu":
        return gn_silu_conv3x3_reference(x, gn_scale, gn_bias, w, b, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv3x3: unsupported device {x.device}")
    return _launch(x, gn_scale, gn_bias, w, b, groups, eps)


@functools.cache
def _lib():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wd_gn_silu_conv3x3.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float,
                                                           ctypes.POINTER(ctypes.c_int), p]
    lib.wd_gn_silu_conv3x3.restype = i
    lib.wd_gn_silu_conv3x3_plan.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.wd_gn_silu_conv3x3_plan.restype = i
    lib.wd_groupnorm_max_c.argtypes = []
    lib.wd_groupnorm_max_c.restype = i
    lib.wd_cuda_error_string.argtypes = [i]
    lib.wd_cuda_error_string.restype = ctypes.c_char_p
    return lib


PLAN_KEYS = ("pixels", "channels", "k_split", "cluster", "ctas", "stages", "smem", "tile_w")


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, w: int, c: int, groups: int) -> dict:
    """The kernel's plan at this shape: pixels and output channels a CTA,
    whether the two consumer warpgroups split K (``k_split``), the cluster
    of a sample's CTAs that takes the GroupNorm statistics in the kernel (0:
    B.5's statistics launch runs first), CTAs, weight stages of the ring,
    shared memory bytes a CTA and the tile's width in pixels."""
    out = (ctypes.c_int * 8)()
    err = _lib().wd_gn_silu_conv3x3_plan(b, h, w, c, groups, out)
    if err:
        raise ValueError(f"gn_silu_conv3x3: no plan for B={b} {h}x{w} C={c} G={groups}")
    return dict(zip(PLAN_KEYS, out))


def kernel_weight(w):
    """OIHW conv weight -> the kernel's bf16 [C_out, 3, 3, C_in], contiguous."""
    return w.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _launch(x, gn_scale, gn_bias, w, b, groups, eps):
    global launches, stats_launches
    lib = _lib()
    if x.dim() != 4:
        raise ValueError(f"fused_gn_silu_conv3x3: x is {tuple(x.shape)}, takes [B, H, W, C]")
    check_norm_operands("fused_gn_silu_conv3x3", x,
                        {"gn_scale": gn_scale, "gn_bias": gn_bias, "b": b}, groups,
                        lib.wd_groupnorm_max_c())
    if w.device != x.device or not w.is_floating_point():
        raise ValueError(f"fused_gn_silu_conv3x3: w is {w.dtype} on {w.device}; takes a float "
                         "[C, C, 3, 3] (OIHW) weight on x's device")
    bsz, h, wd, c = x.shape
    wk = kernel_weight(w)
    out = torch.empty_like(x)
    # B.5's statistics [B, G] (mu, rstd), where the kernel does not take them itself
    stats = torch.empty(bsz * groups * 2, dtype=torch.float32, device=x.device)
    stats_launched = ctypes.c_int(0)
    err = build.launch_on(x, lambda stream: lib.wd_gn_silu_conv3x3(
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(), wk.data_ptr(), b.data_ptr(),
        out.data_ptr(), stats.data_ptr(), bsz, h, wd, c, groups, float(eps),
        ctypes.byref(stats_launched), stream))
    if err:
        raise RuntimeError(
            f"gn_silu_conv3x3 kernel launch failed: {lib.wd_cuda_error_string(err).decode()} "
            f"(code {err})")
    launches += 1
    stats_launches += stats_launched.value
    return out
