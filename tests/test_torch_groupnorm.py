"""The port's GroupNorm (+ SiLU) (``ops.groupnorm``, kernel B.5) against the
JAX Pallas kernel ``bench_kernels/groupnorm_pallas.py::fused_groupnorm``
run in interpret mode, and its Function's CPU backward against plain
autograd.

Tolerances: fp32, 1e-5 absolute (the same formula, other summation
orders); bf16, 2% of max |out| (the output rounds to bf16 after fp32
arithmetic in other orders: one bf16 ulp is 0.4% of a value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_kernels.groupnorm_pallas import fused_groupnorm as jax_groupnorm
from worddiffusion_tpu_torch.models.layers import GroupNorm32
from worddiffusion_tpu_torch.ops import groupnorm

torch.set_num_threads(1)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 32, 64), 32),     # the UNet's grouping, 2 channels a group
    ((2, 4, 16, 48), 48),     # one group per channel (the VAE at narrow widths)
    ((3, 5, 13, 64), 32),     # an odd image
    ((2, 40, 96), 32),        # [B, S, C] tokens
])
def test_reference_matches_pallas_fp32(shape, groups, silu):
    x, scale, bias = _inputs(shape)
    want = np.asarray(jax_groupnorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                    num_groups=groups, eps=1e-6, silu=silu, interpret=True))
    got = groupnorm.fused_groupnorm(torch.from_numpy(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias), groups, 1e-6, silu)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("silu", [False, True])
def test_reference_matches_pallas_bf16(silu):
    x, scale, bias = _inputs((2, 8, 32, 320), seed=1)
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(jax_groupnorm(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                    jnp.asarray(scale), jnp.asarray(bias), num_groups=32,
                                    silu=silu, interpret=True), np.float32)
    got = groupnorm.fused_groupnorm(xb, torch.from_numpy(scale), torch.from_numpy(bias), 32,
                                    1e-5, silu)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_function_backward_is_plain_autograd():
    """The Function's CPU backward recomputes the plain version: the same
    ops, so the gradients are bitwise plain autograd's."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 4, 8, 64), seed=2))
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 8, 64))
                            .astype(np.float32))
    grads = []
    for fn in (groupnorm.fused_groupnorm, groupnorm.groupnorm_reference):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        fn(*leaves, 32, 1e-5, True).backward(dout)
        grads.append([t.grad for t in leaves])
    n0 = groupnorm.bwd_calls
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    groupnorm.fused_groupnorm(*leaves, 32, 1e-5, False).sum().backward()
    assert groupnorm.bwd_calls == n0 + 1
    for g, w in zip(*grads):
        assert torch.equal(g, w)


def test_module_runs_the_op_on_the_nhwc_view():
    """GroupNorm32 on an NCHW tensor is the op on its NHWC view; with silu
    the SiLU is applied in fp32."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 5, 7, 64), seed=4))
    norm = GroupNorm32(64, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(scale)
        norm.bias.copy_(bias)
        nchw = x.permute(0, 3, 1, 2)
        for silu in (False, True):
            want = groupnorm.groupnorm_reference(x, scale, bias, 32, 1e-6, silu)
            assert torch.equal(norm(nchw, silu=silu).permute(0, 2, 3, 1), want)


def test_near_equal_group_gives_no_nan():
    """E[x²] - mu² of a group of near-equal large values rounds below 0 in
    fp32 (to -0.19 here, far below -eps): the variance is clamped at 0, as
    flax's GroupNorm does, so every output is finite."""
    g = torch.Generator().manual_seed(0)
    x = 1000 + 0.001 * torch.randn(64, 256, 8, generator=g)
    raw = x.square().mean(dim=1) - x.mean(dim=1).square()  # the formula's variance, per channel
    assert raw.min() < -1e-6
    out = groupnorm.fused_groupnorm(x, torch.ones(8), torch.zeros(8), 8, 1e-6, True)
    assert bool(torch.isfinite(out).all())


def test_unsupported_device_raises():
    x = torch.empty(2, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        groupnorm.fused_groupnorm(x, torch.ones(32, device="meta"),
                                  torch.zeros(32, device="meta"), 32)
