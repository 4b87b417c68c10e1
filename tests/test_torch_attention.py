"""The port's fused attention (worddiffusion_tpu_torch/ops/attention.py)
against the JAX package: the model's ``_attend`` and the Pallas kernel
``bench_kernels/attention_pallas.py::fused_attention`` (interpret mode
off the TPU, as tests/test_pallas_ops.py runs it).

On the CPU the Function takes the plain version; the CUDA kernel is
compared with it on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_kernels.attention_pallas import fused_attention as pallas_attention
from worddiffusion_tpu.models.attention import _attend
from worddiffusion_tpu_torch.ops import attention

torch.set_num_threads(1)

# (Nq, Nk): cross-attention over 42 characters; self-attention over the
# middle block's 64 latent tokens; cross-attention over 42 + 769 PHOSC
# tokens; a ragged pair
SHAPES = [(256, 42), (64, 64), (64, 811), (40, 13)]


def _qkv(nq, nk, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk))


@pytest.mark.parametrize("nq,nk", SHAPES)
def test_reference_matches_jax_attend_fp32(nq, nk):
    """fp32: the same math as the UNet's ``_attend`` ([B, N, H, D] there),
    other summation orders -> rtol 1e-5 (atol 1e-6 for outputs near 0)."""
    q, k, v = _qkv(nq, nk)
    scale = q.shape[-1] ** -0.5
    heads_last = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    want = np.asarray(_attend(heads_last(q), heads_last(k), heads_last(v), scale))
    got = attention.attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nq,nk,d", [(40, 13, 16), (64, 42, 80)])
def test_reference_matches_pallas_kernel_bf16(nq, nk, d):
    """bf16 in and out, the kernel's own dtype contract: the two differ in
    the fp32 summation order only, which can move a bf16 rounding of p or
    of the output by one ulp -> within 1e-2 of max |out|."""
    q, k, v = _qkv(nq, nk, b=1, d=d, seed=1)
    scale = d ** -0.5
    want = np.asarray(pallas_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                       scale).astype(jnp.float32))
    got = attention.attention_reference(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                        scale)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, nq, d)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err


def test_function_takes_plain_path_on_cpu():
    t = tuple(torch.from_numpy(a).bfloat16() for a in _qkv(64, 42))
    before = attention.launches
    out = attention.fused_attention(*t, 0.25)
    torch.testing.assert_close(out, attention.attention_reference(*t, 0.25), rtol=0, atol=0)
    assert attention.launches == before == 0


def test_function_refuses_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises."""
    t = tuple(torch.from_numpy(a).to("meta") for a in _qkv(8, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        attention.fused_attention(*t, 0.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_plain_autograd(dtype):
    """The Function's backward recomputes the plain version under autograd:
    its q, k, v gradients equal plain autograd's bit for bit, and each
    backward call is counted once."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _qkv(40, 13, seed=2))
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape)).to(dt)
    grads = []
    for fn in (attention.fused_attention, attention.attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = attention.bwd_calls
        fn(*leaves, 0.25).backward(dout)
        grads.append(([t.grad for t in leaves], attention.bwd_calls - before))
    (got, n_fn), (want, n_plain) = grads
    assert (n_fn, n_plain) == (1, 0)
    for g, w in zip(got, want):
        assert g.dtype == dt and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_transformer_block_grads_reach_qkv_through_the_function():
    """A self-attention block (the PHOSC layout) differentiates through the
    Function: two backward calls per block, and q, k, v weights get
    gradients."""
    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.layers import init_weights_

    blk = init_weights_(BasicTransformerBlock(32, 2, 16, 24, attn1_cross=False,
                                              dtype=torch.float32), seed=0, zero_init=False)
    g = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(2, 12, 32, generator=g), torch.randn(2, 30, 24, generator=g)
    before = attention.bwd_calls
    blk(x, ctx).square().sum().backward()
    assert attention.bwd_calls - before == 2
    for name in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn2.to_q", "attn2.to_k",
                 "attn2.to_v"):
        grad = blk.get_submodule(name).weight.grad
        assert grad is not None and grad.abs().max() > 0, name
