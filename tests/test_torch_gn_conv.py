"""The port's GroupNorm -> SiLU -> conv3x3 (``ops.gn_conv``, kernel B.6)
against the JAX Pallas kernel
``bench_kernels/resblock_pallas.py::fused_gn_silu_conv3x3`` run in
interpret mode, its Function's CPU backward against plain autograd, and
the models' routing through it.

Tolerances: fp32, 1e-5 absolute against the same products in numpy (see
``test_reference_matches_pallas_fp32``); bf16, 2% of max |out| (one bf16
rounding of the activation and of the output, fp32 sums in other
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_kernels.resblock_pallas import fused_gn_silu_conv3x3 as jax_gn_conv
from worddiffusion_tpu_torch.models.layers import Conv2D, GroupNorm32, gn_silu_conv
from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

torch.set_num_threads(1)


def _inputs(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gs = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    gb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)  # HWIO
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gs, gb, wt, bias


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("b,h,w,c,groups", [
    (2, 8, 32, 64, 32),     # the UNet's grouping
    (2, 4, 16, 48, 48),     # one group per channel
    (2, 5, 13, 64, 32),     # an odd image: the halo's zero padding at every edge
    (2, 4, 16, 320, 32),    # the UNet's middle block (five 64-channel chunks)
    (1, 3, 5, 128, 32),     # the VAE's widths at a small image
    (1, 2, 3, 256, 32),
    (2, 1, 9, 64, 32),      # one row: every tap row but the middle one is padding
    (2, 7, 1, 64, 32),      # one column
])
def test_reference_matches_pallas_bf16(b, h, w, c, groups):
    x, gs, gb, wt, bias = _inputs(b, h, w, c)
    xb = _bf16(x)
    want = np.asarray(jax_gn_conv(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(gs),
                                  jnp.asarray(gb), jnp.asarray(wt), jnp.asarray(bias),
                                  num_groups=groups, interpret=True), np.float32)
    got = gn_conv.fused_gn_silu_conv3x3(torch.from_numpy(xb).bfloat16(), torch.from_numpy(gs),
                                        torch.from_numpy(gb), _oihw(wt), torch.from_numpy(bias),
                                        groups, 1e-5)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("b,h,w,c,groups", [(2, 8, 32, 64, 32), (2, 5, 13, 48, 48)])
def test_reference_matches_pallas_fp32(b, h, w, c, groups):
    """fp32 x: the Pallas body still rounds the activation and the weights
    to bf16 for its products; the plain version keeps fp32. So the Pallas
    kernel is held (1e-4) to the products of the plain version's own
    activation rounded to bf16 (which checks the activations agree), and
    the plain version (1e-5) to the same products in fp32."""
    x, gs, gb, wt, bias = _inputs(b, h, w, c, seed=1)
    wt = _bf16(wt)
    act = groupnorm.groupnorm_reference(torch.from_numpy(x), torch.from_numpy(gs),
                                        torch.from_numpy(gb), groups, 1e-5, True).numpy()
    pad = np.pad(_bf16(act), ((0, 0), (1, 1), (1, 1), (0, 0)))
    manual = sum(np.einsum("bhwc,cd->bhwd", pad[:, dy:dy + h, dx:dx + w], wt[dy, dx])
                 for dy in range(3) for dx in range(3)) + bias
    pallas = np.asarray(jax_gn_conv(jnp.asarray(x), jnp.asarray(gs), jnp.asarray(gb),
                                    jnp.asarray(wt), jnp.asarray(bias), num_groups=groups,
                                    interpret=True))
    np.testing.assert_allclose(pallas, manual, rtol=0, atol=1e-4)
    got = gn_conv.fused_gn_silu_conv3x3(torch.from_numpy(x), torch.from_numpy(gs),
                                        torch.from_numpy(gb), _oihw(wt), torch.from_numpy(bias),
                                        groups, 1e-5).numpy()
    # the plain version keeps the fp32 activation: within the activation's bf16 rounding
    assert np.abs(got - pallas).max() <= 1e-2 * np.abs(pallas).max()
    plain_exact = sum(np.einsum("bhwc,cd->bhwd", np.pad(act, ((0, 0), (1, 1), (1, 1), (0, 0)))
                                [:, dy:dy + h, dx:dx + w], wt[dy, dx])
                      for dy in range(3) for dx in range(3)) + bias
    np.testing.assert_allclose(got, plain_exact, rtol=0, atol=1e-5)


def test_function_backward_is_plain_autograd():
    x, gs, gb, wt, bias = (torch.from_numpy(a) for a in _inputs(2, 4, 8, 32, seed=2))
    w = _oihw(wt.numpy())
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 8, 32))
                            .astype(np.float32))
    grads = []
    for fn in (gn_conv.fused_gn_silu_conv3x3, gn_conv.gn_silu_conv3x3_reference):
        leaves = [t.clone().requires_grad_() for t in (x, gs, gb, w, bias)]
        fn(*leaves, 32, 1e-5).backward(dout)
        grads.append([t.grad for t in leaves])
    for g, want in zip(*grads):
        assert g is not None and torch.equal(g, want)


def test_width_changing_conv_raises():
    x, gs, gb, _, bias = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 32))
    with pytest.raises(ValueError, match="changes the width"):
        gn_conv.fused_gn_silu_conv3x3(x, gs, gb, torch.zeros(64, 32, 3, 3), torch.zeros(64), 32)


@pytest.mark.parametrize("in_ch,out_ch,kernel", [(32, 32, 3), (64, 32, 3), (32, 32, 1)])
def test_models_route_through_the_fused_ops(in_ch, out_ch, kernel):
    """``gn_silu_conv`` takes B.6 for a width-keeping 3x3 conv, else B.5 with
    SiLU and the conv; both equal the unfused composition."""
    torch.manual_seed(0)
    norm, conv = GroupNorm32(in_ch), Conv2D(in_ch, out_ch, kernel)
    x = torch.randn(2, in_ch, 5, 9)
    g0, c0 = groupnorm.bwd_calls, gn_conv.bwd_calls
    out = gn_silu_conv(norm, conv, x.requires_grad_())
    out.sum().backward()
    fused = (in_ch, out_ch, kernel) == (32, 32, 3)
    assert (gn_conv.bwd_calls - c0, groupnorm.bwd_calls - g0) == ((1, 0) if fused else (0, 1))
    want = conv(torch.nn.functional.silu(norm(x)))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w", [(1, 9), (7, 1), (3, 5)])
def test_padding_is_after_the_activation(h, w):
    """The plain version pads silu(GroupNorm(x)) with zeros, as the Pallas
    body does (resblock_pallas.py:57); padding x before the activation would
    give silu((0 - mu) * r * g + b) != 0 at the border instead. Both against
    the same products in numpy (fp32), at the images where the halo is
    mostly padding."""
    x, gs, gb, wt, bias = _inputs(2, h, w, 64, seed=4)
    gs, gb = gs + 0.5, gb + 0.5  # a border activation far from 0
    args = (torch.from_numpy(gs), torch.from_numpy(gb), _oihw(wt), torch.from_numpy(bias), 32,
            1e-5)
    got = gn_conv.gn_silu_conv3x3_reference(torch.from_numpy(x), *args).numpy()

    def conv(padded):
        return sum(np.einsum("bhwc,cd->bhwd", padded[:, dy:dy + h, dx:dx + w], wt[dy, dx])
                   for dy in range(3) for dx in range(3)) + bias

    act = groupnorm.groupnorm_reference(torch.from_numpy(x), torch.from_numpy(gs),
                                        torch.from_numpy(gb), 32, 1e-5, True).numpy()
    after = conv(np.pad(act, ((0, 0), (1, 1), (1, 1), (0, 0))))
    np.testing.assert_allclose(got, after, rtol=0, atol=1e-5)
    # the same statistics, with the border taking the activation of a zero pixel
    xf = torch.from_numpy(x).reshape(2, -1, 32, 2)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mu.square()).clamp_min(0.0)
    zero = ((0 - mu) * torch.rsqrt(var + 1e-5)).expand(2, 1, 32, 2).reshape(2, 1, 1, 64)
    zero = zero * args[0] + args[1]
    before = np.broadcast_to(torch.nn.functional.silu(zero).numpy(), (2, h + 2, w + 2, 64)).copy()
    before[:, 1:-1, 1:-1] = act
    assert np.abs(conv(before) - got).max() > 1e-2 * np.abs(got).max()
