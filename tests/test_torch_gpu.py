"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import pytest
import torch

from worddiffusion_tpu_torch.ops import ffn

pytestmark = pytest.mark.gpu
D, INNER = 320, 1280
GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
# The plain backward rounds dact, dxn and the weight gradients to bf16
# (its matmuls run in bf16); the kernel keeps them fp32. Measured on the
# H100 at these shapes: at most 0.6% of each gradient's max.
BWD_REL_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(
        x=r(m, D).bfloat16(), gamma=1 + 0.1 * r(D), beta=0.1 * r(D),
        w1=(r(D, 2 * INNER) / D ** 0.5).bfloat16(), b1=0.02 * r(2 * INNER),
        w2=(r(INNER, D) / INNER ** 0.5).bfloat16(), b2=0.02 * r(D),
    )
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.parametrize("m", [16 * 256, 16 * 64, 1000, 128 * 256, 128 * 64])
def test_kernel_matches_plain(cuda, m):
    """bf16: the kernel keeps the hidden in fp32, the plain version
    rounds it -> within 1% of max |out| (a few bf16 ulps). M: the
    regeneration batch of 16 and the training batch of 128, at the
    full-resolution and the middle blocks, and a ragged M."""
    t = _inputs(m, cuda)
    before = ffn.launches
    got = ffn.fused_ln_geglu_ffn(**t)
    torch.cuda.synchronize()
    assert ffn.launches == before + 1
    want = ffn.ln_geglu_ffn_reference(**t)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bad", ["fp32_x", "strided_x", "b1_dtype", "narrow_inner"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    """The weights may come in any layout and float dtype (the Function
    casts and lays them out); x, the norms and the biases may not."""
    t = _inputs(64, cuda)
    if bad == "fp32_x":
        t["x"] = t["x"].float()
    elif bad == "strided_x":
        t["x"] = torch.cat([t["x"], t["x"]], dim=1)[:, ::2]
    elif bad == "b1_dtype":
        t["b1"] = t["b1"].bfloat16()
    else:
        t["w1"], t["b1"] = t["w1"][:, :2 * 96].contiguous(), t["b1"][:2 * 96].contiguous()
        t["w2"] = t["w2"][:96].contiguous()
    before = ffn.launches
    with pytest.raises(ValueError):
        ffn.fused_ln_geglu_ffn(**t)
    assert ffn.launches == before


def _bwd_inputs(m, device, seed=0):
    t = _inputs(m, device, seed)
    t.pop("b2")
    g = torch.Generator().manual_seed(seed + 100)
    t["dy"] = (0.1 * torch.randn(m, D, generator=g)).bfloat16().to(device)
    order = ("x", "dy", "gamma", "beta", "w1", "b1", "w2")
    return {k: t[k] for k in order}


@pytest.mark.parametrize("m", [128 * 256, 128 * 64, 1000])
def test_bwd_kernel_matches_plain(cuda, m):
    t = _bwd_inputs(m, cuda)
    before = ffn.bwd_launches
    got = ffn.ln_geglu_ffn_bwd(**t)
    torch.cuda.synchronize()
    assert ffn.bwd_launches == before + 1
    want = ffn.ln_geglu_ffn_bwd_reference(**t)
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_REL_TOL * w.float().abs().max().item(), (name, err)


def test_bwd_kernel_is_bitwise_repeatable(cuda):
    """No atomics: the sums run in a fixed order, so two runs agree bit
    for bit (the trainer's bitwise resume rests on it)."""
    t = _bwd_inputs(128 * 64 + 40, cuda, seed=3)
    first = ffn.ln_geglu_ffn_bwd(**t)
    second = ffn.ln_geglu_ffn_bwd(**t)
    torch.cuda.synchronize()
    for name, a, b in zip(GRADS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("bad", ["fp32_dy", "dy_shape", "w2_dtype", "wide_d"])
def test_bwd_kernel_refuses_what_it_does_not_take(cuda, bad):
    t = _bwd_inputs(64, cuda)
    if bad == "fp32_dy":
        t["dy"] = t["dy"].float()
    elif bad == "dy_shape":
        t["dy"] = t["dy"][:32].contiguous()
    elif bad == "w2_dtype":
        t["w2"] = t["w2"].float()
    else:
        t["x"] = torch.zeros(64, 368, dtype=torch.bfloat16, device=cuda)
    before = ffn.bwd_launches
    with pytest.raises(ValueError):
        ffn.ln_geglu_ffn_bwd(**t)
    assert ffn.bwd_launches == before


def test_block_backward_goes_through_the_kernels(cuda):
    """The fault this guards against: a kernel output without an autograd
    graph. On CUDA the FF sub-layer's output needs a gradient, the
    backward launches the backward kernel, and a transformer block's
    gradients agree with the plain autograd path's."""
    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.layers import init_weights_

    blocks = [init_weights_(BasicTransformerBlock(D, 4, 80, 320, use_pallas_ffn=u),
                            seed=1, zero_init=False).to(cuda) for u in (None, False)]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, D, generator=g).bfloat16().to(cuda)
    ctx = torch.randn(8, 42, 320, generator=g).bfloat16().to(cuda)
    co = torch.randn(8, 256, D, generator=g).to(cuda)
    grads = []
    for blk in blocks:
        xi = x.clone().requires_grad_()
        f0, b0 = ffn.launches, ffn.bwd_launches
        out = blk(xi, ctx)
        assert out.requires_grad and out.grad_fn is not None
        (out.float() * co).sum().backward()
        torch.cuda.synchronize()
        grads.append((ffn.launches - f0, ffn.bwd_launches - b0,
                      {"x": xi.grad, **{n: p.grad for n, p in blk.named_parameters()}}))
    (kf, kb, kern), (pf, pb, plain) = grads
    assert (kf, kb, pf, pb) == (1, 1, 0, 0)
    proj = dict(blocks[0].named_parameters())["ff.net.0.proj.weight"]
    assert proj.grad.dtype == torch.float32 and proj.grad.shape == proj.shape
    for k, w in plain.items():
        err = (kern[k].float() - w.float()).abs().max().item()
        assert err <= 3e-2 * w.float().abs().max().item() + 1e-6, (k, err)


# (B, Nq, Nk) of the attentions the paths run: iam (Nk = 42 characters),
# iam_phosc self-attention (Nk = Nq) and cross-attention (Nk = 42 + 769
# PHOSC tokens), at the regeneration batch of 16 and the training batch of
# 128, and a ragged case; 4 heads of 80.
ATTN_SHAPES = [(16, 256, 42), (16, 64, 42), (16, 256, 256), (16, 64, 64), (16, 256, 811),
               (16, 64, 811), (128, 256, 42), (128, 256, 811), (128, 64, 811), (2, 40, 13)]


def _qkv(b, nq, nk, device, d=80, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, 4, n, d, generator=g).bfloat16().to(device) for n in (nq, nk, nk))


@pytest.mark.parametrize("b,nq,nk", ATTN_SHAPES)
def test_attention_kernel_matches_plain(cuda, b, nq, nk):
    """bf16 out: the two differ in the order of the fp32 sums, which can
    move one bf16 rounding -> within 1% of max |out|; bitwise repeatable."""
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkv(b, nq, nk, cuda)
    before = attention.launches
    got = attention.fused_attention(q, k, v, 80 ** -0.5)
    again = attention.fused_attention(q, k, v, 80 ** -0.5)
    torch.cuda.synchronize()
    assert attention.launches == before + 2
    want = attention.attention_reference(q, k, v, 80 ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bad", ["fp32", "d_72", "non_contiguous", "nk_over_limit"])
def test_attention_refuses_what_it_does_not_take(cuda, bad):
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkv(2, 64, 42, cuda)
    if bad == "fp32":
        q, k, v = q.float(), k.float(), v.float()
    elif bad == "d_72":
        q, k, v = (t[..., :72].contiguous() for t in (q, k, v))
    elif bad == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)  # [B, N, H, D] memory
    else:
        q, k, v = _qkv(1, 16, attention._lib().wd_attention_max_nk() + 1, cuda)
    before = attention.launches
    with pytest.raises(ValueError):
        attention.fused_attention(q, k, v, 0.1)
    assert attention.launches == before


def test_block_backward_reaches_qkv_through_the_attention_kernel(cuda):
    """The PHOSC layout's block (self-attention, then cross-attention over
    811 tokens) on the card: two attention kernel launches forward, two
    Function backward calls, and gradients for every q/k/v weight that
    agree with the all-plain block's (plain attention swapped in)."""
    from unittest import mock

    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import attention

    blk = init_weights_(BasicTransformerBlock(D, 4, 80, 320, attn1_cross=False), seed=2,
                        zero_init=False).to(cuda)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 256, D, generator=g).bfloat16().to(cuda)
    ctx = torch.randn(4, 811, 320, generator=g).bfloat16().to(cuda)
    co = torch.randn(4, 256, D, generator=g).to(cuda)
    grads = []
    for plain in (False, True):
        blk.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        a0, b0 = attention.launches, attention.bwd_calls
        with mock.patch.object(attention, "fused_attention",
                               attention.attention_reference if plain else
                               attention.fused_attention):
            (blk(xi, ctx).float() * co).sum().backward()
        torch.cuda.synchronize()
        grads.append((attention.launches - a0, attention.bwd_calls - b0,
                      {"x": xi.grad, **{n: p.grad for n, p in blk.named_parameters()}}))
    (ka, kb, kern), (pa, pb, plain_g) = grads
    assert (ka, kb, pa, pb) == (2, 2, 0, 0)
    for k, w in plain_g.items():
        assert kern[k] is not None, k
        if ".to_" in k:
            assert kern[k].abs().max() > 0, k
        err = (kern[k].float() - w.float()).abs().max().item()
        assert err <= 3e-2 * w.float().abs().max().item() + 1e-6, (k, err)


# (B, N, L) of the fold path's sub-layers (C = 320, H = 4: every attention of
# the iam UNet with attn_fold_context), at the regeneration batch of 16 and
# the training batch of 128, full-resolution and middle blocks, and a ragged
# case (L = 13 pads to 16, N = 40 ends mid-tile).
FOLD_SHAPES = [(16, 256, 42), (16, 64, 42), (128, 256, 42), (128, 64, 42), (2, 40, 13)]


def _fold_inputs(b, n, l, device, c=D, heads=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(x=r(b, n, c).bfloat16(), wt4=(r(b, heads, c, l) / c ** 0.5).bfloat16(),
             vw4=r(b, heads, l, c).bfloat16(), gamma=1 + 0.1 * r(c), beta=0.1 * r(c),
             b_out=0.02 * r(c))
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.parametrize("layout", ["b7", "b8"])
@pytest.mark.parametrize("b,n,l", FOLD_SHAPES)
def test_fold_kernel_matches_plain(cuda, layout, b, n, l):
    """bf16 out: the two differ in the order of the fp32 sums, which can
    move one bf16 rounding -> within 1% of max |out|; bitwise repeatable.
    B.7's entry takes the folds as [B, C, H*L] and [B, H*L, C]."""
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    t = _fold_inputs(b, n, l, cuda)
    vecs = (t["gamma"], t["beta"], t["b_out"])
    if layout == "b7":
        wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, D, 4 * l).contiguous()
        run = lambda: fa.fold_attention(t["x"], wt, t["vw4"].reshape(b, 4 * l, D), *vecs, 4)
    else:
        run = lambda: fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    before = fa.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    want = fa.fold_attention_reference(t["x"], t["wt4"], t["vw4"], *vecs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bad", ["fp32_x", "c_not_16", "l_over_limit", "heads_l_over_c",
                                 "strided_x", "wt_l_strided"])
def test_fold_kernel_refuses_what_it_does_not_take(cuda, bad):
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    if bad == "c_not_16":
        t = _fold_inputs(2, 64, 13, cuda, c=72)
    elif bad == "l_over_limit":
        t = _fold_inputs(2, 64, fa._lib().wd_fold_attention_max_l() + 1, cuda, heads=1)
    elif bad == "heads_l_over_c":
        t = _fold_inputs(2, 64, 42, cuda, heads=8)
    else:
        t = _fold_inputs(2, 64, 42, cuda)
    if bad == "fp32_x":
        t["x"] = t["x"].float()
    elif bad == "strided_x":
        t["x"] = torch.cat([t["x"], t["x"]], dim=-1)[..., ::2]
    elif bad == "wt_l_strided":
        t["wt4"] = t["wt4"].transpose(-1, -2).contiguous().transpose(-1, -2)
    before = fa.launches
    with pytest.raises(ValueError):
        fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], t["gamma"], t["beta"], t["b_out"])
    assert fa.launches == before


def test_block_backward_reaches_projections_through_the_fold_kernel(cuda):
    """The iam layout's block with the fold (both attentions cross-attend to
    42 tokens) on the card: two fold kernel launches forward, two Function
    backward calls, and gradients for every q/k/v/out weight (through the
    fold functions) that agree with the all-plain block's."""
    from unittest import mock

    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import attention
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    blk = init_weights_(BasicTransformerBlock(D, 4, 80, 320, fold_context=True), seed=3,
                        zero_init=False).to(cuda)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 256, D, generator=g).bfloat16().to(cuda)
    ctx = torch.randn(4, 42, 320, generator=g).bfloat16().to(cuda)
    co = torch.randn(4, 256, D, generator=g).to(cuda)
    grads = []
    for plain in (False, True):
        blk.zero_grad(set_to_none=True)
        xi, ci = x.clone().requires_grad_(), ctx.clone().requires_grad_()
        counts = (fa.launches, fa.bwd_calls, attention.launches)
        with mock.patch.object(fa, "fold_attention_heads",
                               fa.fold_attention_reference if plain else fa.fold_attention_heads):
            (blk(xi, ci).float() * co).sum().backward()
        torch.cuda.synchronize()
        grads.append((fa.launches - counts[0], fa.bwd_calls - counts[1],
                      attention.launches - counts[2],
                      {"x": xi.grad, "context": ci.grad,
                       **{n: p.grad for n, p in blk.named_parameters()}}))
    (kl, kb, ka, kern), (pl, pb, pa, plain_g) = grads
    assert (kl, kb, ka, pl, pb, pa) == (2, 2, 0, 0, 0, 0)
    for k, w in plain_g.items():
        assert kern[k] is not None, k
        if ".to_" in k:
            assert kern[k].abs().max() > 0, k
        err = (kern[k].float() - w.float()).abs().max().item()
        assert err <= 3e-2 * w.float().abs().max().item() + 1e-6, (k, err)
