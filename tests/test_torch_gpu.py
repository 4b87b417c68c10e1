"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import pytest
import torch

import chip_smoke
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


@pytest.mark.parametrize("m", [16 * 256, 128 * 256, 1000])
def test_geglu_kernel_matches_plain(cuda, m):
    """B.2, the bare GEGLU FFN launch mode (no LayerNorm, no residual): the
    kernel keeps the hidden in fp32 as the plain version does; the two differ
    in the order of the fp32 sums -> within 1% of max |out|; bitwise
    repeatable."""
    t = _inputs(m, cuda, seed=5)
    a = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    before = ffn.geglu_launches
    got, again = ffn.fused_geglu_ffn(*a), ffn.fused_geglu_ffn(*a)
    torch.cuda.synchronize()
    assert ffn.geglu_launches == before + 2
    want = ffn.geglu_ffn_reference(*a)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bad", ["fp32_x", "strided_x", "b2_dtype", "narrow_inner", "wide_d"])
def test_geglu_kernel_refuses_what_it_does_not_take(cuda, bad):
    t = _inputs(64, cuda)
    if bad == "fp32_x":
        t["x"] = t["x"].float()
    elif bad == "strided_x":
        t["x"] = torch.cat([t["x"], t["x"]], dim=1)[:, ::2]
    elif bad == "b2_dtype":
        t["b2"] = t["b2"].bfloat16()
    elif bad == "narrow_inner":
        t["w1"], t["b1"] = t["w1"][:, :2 * 96].contiguous(), t["b1"][:2 * 96].contiguous()
        t["w2"] = t["w2"][:96].contiguous()
    else:
        t["x"] = torch.zeros(64, 368, dtype=torch.bfloat16, device=cuda)
        t["w1"] = torch.zeros(368, 2 * INNER, dtype=torch.bfloat16, device=cuda)
        t["w2"] = torch.zeros(INNER, 368, dtype=torch.bfloat16, device=cuda)
        t["b2"] = torch.zeros(368, device=cuda)
    before = ffn.geglu_launches
    with pytest.raises(ValueError):
        ffn.fused_geglu_ffn(t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    assert ffn.geglu_launches == before


def test_geglu_function_grads_are_autograd_of_the_unfused_composition(cuda):
    """The Function's backward is autograd of geglu_ffn_xla_baseline on the
    saved inputs (what JAX's custom_vjp differentiates): bitwise the same
    gradients, each in its input's dtype."""
    t = _inputs(8 * 256, cuda, seed=6)
    names = ("x", "w1", "b1", "w2", "b2")
    dy = (0.1 * torch.randn(8 * 256, D, generator=torch.Generator().manual_seed(7)))
    dy = dy.bfloat16().to(cuda)
    grads = []
    for fn in (ffn.fused_geglu_ffn, ffn.geglu_ffn_xla_baseline):
        leaves = [t[k].clone().requires_grad_() for k in names]
        fn(*leaves).backward(dy)
        grads.append([v.grad for v in leaves])
    torch.cuda.synchronize()
    for name, a, b in zip(names, *grads):
        assert a.dtype == t[name].dtype and torch.equal(a, b), name


@pytest.mark.parametrize("m", [64, 65, 1000, 1024, 4096, 32768])
def test_ffn_kernels_are_bitwise_repeatable(cuda, m):
    """B.1 and B.2 (one cluster launch each; the cluster size follows M) at
    the small, ragged, main-path and training M: within 1% of max |out| of
    their plain versions, and two calls give the same bits (no atomics, the
    cluster's partial sums in rank order)."""
    t = _inputs(m, cuda, seed=11)
    a = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    n0, g0 = ffn.launches, ffn.geglu_launches
    for fused, plain, args in ((ffn.fused_ln_geglu_ffn, ffn.ln_geglu_ffn_reference, t),
                               (ffn.fused_geglu_ffn, ffn.geglu_ffn_reference, a)):
        call = (lambda f: f(**args)) if isinstance(args, dict) else (lambda f: f(*args))
        got, again = call(fused), call(fused)
        torch.cuda.synchronize()
        want = call(plain)
        assert got.dtype == torch.bfloat16 and torch.equal(got, again), fused.__name__
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), (fused.__name__, err)
    assert (ffn.launches - n0, ffn.geglu_launches - g0) == (2, 2)


def test_sublayer_on_bf16_parameters_runs_both_kernels(cuda):
    """LnGegluFFN with bf16 parameters in parameter layout (a model kept in
    bf16): the forward kernel reads them as they are, the backward kernel
    gets contiguous transposes; both launch, and the output and gradients
    agree with plain autograd. (It raised before the cast helper kept bf16
    weights contiguous.)"""
    t = _inputs(1024, cuda, seed=15)
    w1, w2 = t["w1"].t().contiguous(), t["w2"].t().contiguous()  # bf16 [2*inner, d], [d, inner]
    dy = (0.1 * torch.randn(1024, D, generator=torch.Generator().manual_seed(16))).bfloat16()
    dy = dy.to(cuda)
    runs = []
    for kernel in (True, False):
        leaves = [t["x"].clone().requires_grad_(), w1.clone().requires_grad_(),
                  w2.clone().requires_grad_()]
        f0, b0 = ffn.launches, ffn.bwd_launches
        x, a, b = leaves
        if kernel:
            out = ffn.LnGegluFFN.apply(x, t["gamma"], t["beta"], a, t["b1"], b, t["b2"], 1e-5)
        else:
            out = ffn.ln_geglu_ffn_reference(x, t["gamma"], t["beta"], a.t(), t["b1"], b.t(),
                                             t["b2"])
        out.backward(dy)
        torch.cuda.synchronize()
        runs.append((ffn.launches - f0, ffn.bwd_launches - b0, [out.detach()] +
                     [v.grad for v in leaves]))
    (kf, kb, got), (pf, pb, want) = runs
    assert (kf, kb, pf, pb) == (1, 1, 0, 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_REL_TOL * w.float().abs().max().item(), err


@pytest.mark.parametrize("m", [16 * 256, 128 * 256])
def test_sublayer_on_parameter_layout_weights_matches_plain_autograd(cuda, m):
    """LnGegluFFN as the block calls it: fp32 master weights in parameter
    layout (proj.weight [2*inner, d], out.weight [d, inner]), which the
    forward kernel reads after one cast each. Output within 1% and every
    gradient within BWD_REL_TOL of plain autograd of the plain forward; the
    weight gradients come back fp32 in parameter layout."""
    t = _inputs(m, cuda, seed=12)
    p = {k: t[k].float() for k in ("gamma", "beta", "b1", "b2")}
    p["w1"] = t["w1"].float().t().contiguous()
    p["w2"] = t["w2"].float().t().contiguous()
    dy = (0.1 * torch.randn(m, D, generator=torch.Generator().manual_seed(13))).bfloat16()
    dy = dy.to(cuda)
    order = ("gamma", "beta", "w1", "b1", "w2", "b2")
    runs = []
    for kernel in (True, False):
        x = t["x"].clone().requires_grad_()
        lv = {k: p[k].clone().requires_grad_() for k in order}
        f0 = ffn.launches
        if kernel:
            out = ffn.ffn_sublayer(x, lv["gamma"], lv["beta"], lv["w1"], lv["b1"], lv["w2"],
                                   lv["b2"], 1e-5)
        else:
            out = ffn.ln_geglu_ffn_reference(x, lv["gamma"], lv["beta"], lv["w1"].t(), lv["b1"],
                                             lv["w2"].t(), lv["b2"])
        out.backward(dy)
        torch.cuda.synchronize()
        runs.append((ffn.launches - f0, out.detach(), [x.grad] + [lv[k].grad for k in order]))
    (kn, out_k, gk), (pn, out_p, gp) = runs
    assert (kn, pn) == (1, 0)
    err = (out_k.float() - out_p.float()).abs().max().item()
    assert err <= 1e-2 * out_p.float().abs().max().item(), err
    for name, a, b in zip(("x",) + order, gk, gp):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_REL_TOL * b.float().abs().max().item(), (name, err)


def _bwd_inputs(m, device, seed=0):
    t = _inputs(m, device, seed)
    t.pop("b2")
    g = torch.Generator().manual_seed(seed + 100)
    t["dy"] = (0.1 * torch.randn(m, D, generator=g)).bfloat16().to(device)
    order = ("x", "dy", "gamma", "beta", "w1", "b1", "w2")
    return {k: t[k] for k in order}


@pytest.mark.parametrize("m", [128 * 256, 128 * 64, 1000, 64, 65])
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


@pytest.mark.parametrize("bad", ["fp32_dy", "dy_shape", "w2_dtype", "wide_d", "narrow_d"])
def test_bwd_kernel_refuses_what_it_does_not_take(cuda, bad):
    """Only d = 320 (as the forward kernel); other widths take the plain
    path (use_pallas_ffn=False)."""
    t = _bwd_inputs(64, cuda)
    if bad == "fp32_dy":
        t["dy"] = t["dy"].float()
    elif bad == "dy_shape":
        t["dy"] = t["dy"][:32].contiguous()
    elif bad == "w2_dtype":
        t["w2"] = t["w2"].float()
    elif bad == "wide_d":
        t["x"] = torch.zeros(64, 368, dtype=torch.bfloat16, device=cuda)
    else:
        t = _bwd_inputs(64, "cpu")
        d = 256
        t = dict(t, x=t["x"][:, :d], dy=t["dy"][:, :d], gamma=t["gamma"][:d], beta=t["beta"][:d],
                 w1=t["w1"][:d], w2=t["w2"][:, :d])
        t = {k: v.contiguous().to(cuda) for k, v in t.items()}
    before = ffn.bwd_launches
    with pytest.raises(ValueError):
        ffn.ln_geglu_ffn_bwd(**t)
    assert ffn.bwd_launches == before


def test_bwd_gradients_come_back_contiguous_in_parameter_layout(cuda):
    """The backward kernels write dW1 [2*inner, d] and dW2 [d, inner], the
    parameters' layout, so LnGegluFFN returns them as they are: contiguous
    fp32 tensors of the parameters' shapes, equal to the JAX-layout entry's
    gradients transposed, bit for bit."""
    t = _bwd_inputs(1000, cuda, seed=7)
    w1, w2 = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    got = ffn._bwd_params(t["x"], t["dy"], t["gamma"], t["beta"], w1, t["b1"], w2, 1e-5)
    jax_layout = ffn.ln_geglu_ffn_bwd(**t)
    torch.cuda.synchronize()
    assert got[3].shape == (2 * INNER, D) and got[5].shape == (D, INNER)
    assert got[3].is_contiguous() and got[5].is_contiguous()
    for name, a, b in zip(GRADS, got, jax_layout):
        assert torch.equal(a, b.t() if name in ("dw1", "dw2") else b), name
    p = {k: v.float().t().contiguous().requires_grad_() for k, v in (("w1", t["w1"]),
                                                                     ("w2", t["w2"]))}
    b2 = torch.zeros(D, device=cuda)
    out = ffn.LnGegluFFN.apply(t["x"], t["gamma"], t["beta"], p["w1"], t["b1"], p["w2"], b2,
                               1e-5)
    out.backward(t["dy"])
    for k in ("w1", "w2"):
        g = p[k].grad
        assert g.dtype == torch.float32 and g.shape == p[k].shape and g.is_contiguous(), k


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
               (16, 64, 811), (128, 256, 42), (128, 64, 42), (128, 256, 256), (128, 64, 64),
               (128, 256, 811), (128, 64, 811), (2, 40, 13)]


def _qkv(b, nq, nk, device, d=80, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, 4, n, d, generator=g).bfloat16().to(device) for n in (nq, nk, nk))


@pytest.mark.parametrize("b,nq,nk", ATTN_SHAPES)
def test_attention_kernel_matches_plain(cuda, b, nq, nk):
    """bf16 out: the two differ in the order of the fp32 sums, and the
    one-pass kernel rounds exp(s - running max) to bf16 before it
    normalises, where the plain version rounds the normalised p: each can
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


@pytest.mark.parametrize("nq,nk", [(256, 2048), (100, 1500)])
def test_attention_kernel_takes_long_contexts(cuda, nq, nk):
    """The one-pass kernel has no limit on Nk: 2048 keys (and a ragged
    1500 under a ragged Nq), within 1% of plain, bitwise repeatable."""
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkv(4, nq, nk, cuda, seed=1)
    got = attention.fused_attention(q, k, v, 80 ** -0.5)
    again = attention.fused_attention(q, k, v, 80 ** -0.5)
    torch.cuda.synchronize()
    want = attention.attention_reference(q, k, v, 80 ** -0.5)
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bad", ["fp32", "d_72", "non_contiguous", "nk_zero"])
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
        q, k, v = _qkv(1, 16, 0, cuda)
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
FOLD_SHAPES = [(16, 256, 42), (16, 64, 42), (128, 256, 42), (128, 64, 42), (2, 40, 13),
               (2, 64, 80), (2, 40, 42)]


def _fold_inputs(b, n, l, device, c=D, heads=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(x=r(b, n, c).bfloat16(), wt4=(r(b, heads, c, l) / c ** 0.5).bfloat16(),
             vw4=r(b, heads, l, c).bfloat16(), gamma=1 + 0.1 * r(c), beta=0.1 * r(c),
             b_out=0.02 * r(c))
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.parametrize("layout", ["b7", "b8", "b8_padded"])
@pytest.mark.parametrize("b,n,l", FOLD_SHAPES)
def test_fold_kernel_matches_plain(cuda, layout, b, n, l):
    """bf16 out: the two differ in the order of the fp32 sums, which can
    move one bf16 rounding -> within 1% of max |out|; bitwise repeatable,
    and bitwise the contiguous per-head layout's result whatever the
    layout, as the copy route never changes the arithmetic. B.7's entry
    takes the folds as [B, C, H*L] and [B, H*L, C]; "b8_padded" is wt4 as
    the [..., :L] view of an L stride rounded up to 8. L=42 copies wt's rows
    16 bytes (padded), 4 bytes (B.7's and the contiguous layout) at a time,
    L=13 element by element."""
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    t = _fold_inputs(b, n, l, cuda)
    vecs = (t["gamma"], t["beta"], t["b_out"])
    if layout == "b7":
        wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, D, 4 * l).contiguous()
        run = lambda: fa.fold_attention(t["x"], wt, t["vw4"].reshape(b, 4 * l, D), *vecs, 4)
    elif layout == "b8_padded":
        lp = -(-l // 8) * 8
        wt4 = torch.nn.functional.pad(t["wt4"], (0, lp - l))[..., :l]
        assert fa.wt_route(wt4) == "16-byte"
        run = lambda: fa.fold_attention_heads(t["x"], wt4, t["vw4"], *vecs)
    else:
        run = lambda: fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    before = fa.launches
    got, again = run(), run()
    contiguous = fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    torch.cuda.synchronize()
    assert fa.launches == before + 3
    want = fa.fold_attention_reference(t["x"], t["wt4"], t["vw4"], *vecs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again) and torch.equal(got, contiguous)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


def test_fold_routes_fill_the_card_and_copy_rows_as_they_lie(cuda):
    """At B=16 the heads split across a cluster (and 32-row tiles at N=64),
    so that the small batch still gives 90% of the SMs a CTA; at B=128 one
    CTA takes a tile's four heads. wt's rows are copied 4 bytes at a time in
    build_folds' layout (L=42) and B.7's, 16 bytes at a time where the L
    stride is padded to a multiple of 8, element by element for an odd L."""
    from worddiffusion_tpu_torch.models.attention import build_folds
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    assert fa.route(16, 256, 4) == (64, 2) and fa.route(16, 64, 4) == (32, 4)
    assert fa.route(128, 256, 4) == (64, 1) and fa.route(128, 64, 4) == (64, 1)
    g = torch.Generator().manual_seed(0)
    ctx = torch.randn(2, 42, 320, generator=g).bfloat16().to(cuda)
    ws = [(torch.randn(320, 320, generator=g) / 320 ** 0.5).to(cuda) for _ in range(4)]
    wt4, _ = build_folds(ctx, *ws, 4, 80, torch.bfloat16)
    assert wt4.is_contiguous() and fa.wt_route(wt4) == "4-byte"
    padded = torch.nn.functional.pad(wt4, (0, 6))[..., :42]
    assert fa.wt_route(padded) == "16-byte"
    flat = wt4.permute(0, 2, 1, 3).reshape(2, 320, 168)
    assert fa.wt_route(flat.view(2, 320, 4, 42).permute(0, 2, 1, 3)) == "4-byte"
    odd = torch.zeros(2, 4, 320, 13, dtype=torch.bfloat16, device=cuda)
    assert fa.wt_route(odd) == "element"


@pytest.mark.parametrize("case,route", [("tail_short", "4-byte"), ("tail_room", "16-byte"),
                                        ("expanded_short", "4-byte"),
                                        ("expanded_room", "16-byte")])
def test_fold_kernel_reads_wt_inside_its_allocation(cuda, case, route):
    """wt4 with an L stride of 48 at L=42: its rows may be copied 16 bytes at
    a time (48 elements) only where the last row's 48 lie inside the
    allocation. "short" ends the storage at the last row's L (as_strided),
    "room" leaves the stride's 6; "expanded" is one sample's folds expanded
    over the batch (sample stride 0). Bitwise the contiguous folds' result."""
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    b, n, l, h = 2, 64, 42, 4
    t = _fold_inputs(b, n, l, cuda)
    vecs = (t["gamma"], t["beta"], t["b_out"])
    nb = 1 if case.startswith("expanded") else b
    size = nb * h * D * 48 - (6 if case.endswith("short") else 0)
    buf = torch.empty(size, dtype=torch.bfloat16, device=cuda)
    wt4 = buf.as_strided((nb, h, D, l), (h * D * 48, D * 48, 48, 1))
    wt4.copy_(t["wt4"][:nb])
    if nb == 1:
        wt4 = wt4.expand(b, -1, -1, -1)
    assert fa.wt_route(wt4) == route
    got = fa.fold_attention_heads(t["x"], wt4, t["vw4"], *vecs)
    want = fa.fold_attention_heads(t["x"], wt4.contiguous(), t["vw4"], *vecs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


# GroupNorm (+ SiLU), B.5: (B, H, W, C, groups, silu) of the paths' sites: the
# UNet's 640-channel output ResBlocks and its 320-channel norms at B=16 and
# 128, the VAE's four levels (one GN per channel group of 4, 8, 16 channels),
# a ragged C=48 with one group per channel, and tokens [B, S, C].
GN_SHAPES = [(16, 8, 32, 640, 32, True), (128, 4, 16, 640, 32, True), (16, 8, 32, 320, 32, False),
             (16, 64, 256, 128, 32, True), (16, 32, 128, 256, 32, True),
             (16, 8, 32, 512, 32, False), (2, 5, 13, 48, 48, False), (2, 40, None, 96, 32, True),
             (128, 8, 32, 256, 32, False),  # the CTC aux head's norms (eps 1e-6, no SiLU)
             # the writer-style encoder's widest site (C = 2048, B.5's widest, at S = 16)
             # and its narrowest (C = 64 in 32 groups of 2)
             (48, 2, 8, 2048, 32, False), (48, 16, 64, 64, 32, False)]


def _gn_inputs(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (2 * torch.randn(*shape, generator=g) + 0.5).bfloat16()
    return (x.to(device), (1 + 0.1 * torch.randn(c, generator=g)).to(device),
            (0.1 * torch.randn(c, generator=g)).to(device))


@pytest.mark.parametrize("b,h,w,c,groups,silu", GN_SHAPES)
def test_groupnorm_kernel_matches_plain(cuda, b, h, w, c, groups, silu):
    """bf16 out after fp32 arithmetic in other orders: within 1% of max
    |out|; bitwise repeatable (no atomics)."""
    from worddiffusion_tpu_torch.ops import groupnorm

    shape = (b, h, c) if w is None else (b, h, w, c)
    x, scale, bias = _gn_inputs(shape, cuda)
    before = groupnorm.launches
    got = groupnorm.fused_groupnorm(x, scale, bias, groups, 1e-6, silu)
    again = groupnorm.fused_groupnorm(x, scale, bias, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 2
    want = groupnorm.groupnorm_reference(x, scale, bias, groups, 1e-6, silu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


# GN -> SiLU -> conv3x3, B.6: chip_smoke.py's sites (the UNet's two resolutions
# at B=16 and 128, the VAE decoder's levels at B=16 and the encoder's at B=128),
# the VAE's levels at B=4, a ragged image (5 x 13) and a ragged width (C=48).
# They take every tile the kernel has: 256 and 128 pixels (wgmma) and 64 pixels
# (mma.sync), 128, 160 and 64 channels.
CONV_SHAPES = [(16, 8, 32, 320, 32), (16, 4, 16, 320, 32), (128, 8, 32, 320, 32),
               (128, 4, 16, 320, 32), (16, 8, 32, 512, 32), (16, 16, 64, 512, 32),
               (16, 32, 128, 256, 32), (16, 64, 256, 128, 32), (128, 64, 256, 128, 32),
               (128, 32, 128, 256, 32), (128, 16, 64, 512, 32), (128, 8, 32, 512, 32),
               (4, 64, 256, 128, 32), (4, 32, 128, 256, 32), (4, 16, 64, 512, 32),
               (2, 5, 13, 64, 32), (2, 5, 13, 48, 48)]


def _conv_inputs(b, h, w, c, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = dict(x=torch.randn(b, h, w, c, generator=g).bfloat16(),
             gn_scale=1 + 0.1 * torch.randn(c, generator=g), gn_bias=0.1 * torch.randn(c, generator=g),
             w=torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5,
             b=0.1 * torch.randn(c, generator=g))
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.parametrize("b,h,w,c,groups", CONV_SHAPES)
def test_gn_conv_kernel_matches_plain(cuda, b, h, w, c, groups):
    """bf16 out: one bf16 rounding of the activation and of the output, fp32
    sums in other orders -> within 1% of max |out|; bitwise repeatable."""
    from worddiffusion_tpu_torch.ops import gn_conv

    torch.backends.cudnn.allow_tf32 = False
    t = _conv_inputs(b, h, w, c, cuda)
    before = gn_conv.launches
    got = gn_conv.fused_gn_silu_conv3x3(**t, groups=groups)
    again = gn_conv.fused_gn_silu_conv3x3(**t, groups=groups)
    torch.cuda.synchronize()
    assert gn_conv.launches == before + 2
    want = gn_conv.gn_silu_conv3x3_reference(**t, groups=groups)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


# B.5 at every site chip_smoke.py drives: the UNet's at B=16 and 128, the VAE
# encoder's and decoder's, a ragged C=48, and the two sides of the size where a
# CTA's range of x stops fitting in shared memory (it is then read twice).
GN_SITES = list(chip_smoke.GN_SHAPES)


@pytest.mark.parametrize("b,h,w,c,groups,silu", GN_SITES)
def test_groupnorm_one_launch_at_every_site(cuda, b, h, w, c, groups, silu):
    """One cluster launch a call, within 1% of max |out| of the plain
    version and bitwise repeatable, whichever route the shape takes (x kept
    in shared memory or read twice; clusters of 1 to 8)."""
    from worddiffusion_tpu_torch.ops import groupnorm

    x, scale, bias = _gn_inputs((b, h, w, c), cuda, seed=3)
    before = groupnorm.launches
    got = groupnorm.fused_groupnorm(x, scale, bias, groups, 1e-6, silu)
    again = groupnorm.fused_groupnorm(x, scale, bias, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 2
    want = groupnorm.groupnorm_reference(x, scale, bias, groups, 1e-6, silu)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


def test_groupnorm_routes_around_the_fit_boundaries(cuda):
    """The route follows the shape: clusters of 8 CTAs at B = 2 and 16, of 2
    at B = 128; a CTA's range of x kept in shared memory up to its limit
    (95 rows of 512 channels a CTA, 76 of 640), read twice past it."""
    from worddiffusion_tpu_torch.ops import groupnorm

    def route(b, s, c):
        return groupnorm.route(torch.empty(b, s, c, device="meta"), 32)

    assert [route(2, 760, 512), route(2, 768, 512), route(16, 256, 640),
            route(128, 152, 640), route(128, 160, 640), route(128, 256, 320)] == [
        (8, True), (8, False), (8, True), (2, True), (2, False), (2, True)]


@pytest.mark.parametrize("bad", ["fp32_x", "nchw_x", "c_not_8", "fp16_scale", "width_change"])
def test_norm_kernels_refuse_what_they_do_not_take(cuda, bad):
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    t = _conv_inputs(2, 8, 8, 64, cuda)
    if bad == "fp32_x":
        t["x"] = t["x"].float()
    elif bad == "nchw_x":
        t["x"] = t["x"].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "c_not_8":
        t = _conv_inputs(2, 8, 8, 20, cuda)
    elif bad == "fp16_scale":
        t["gn_scale"] = t["gn_scale"].half()
    else:
        t["w"] = t["w"][:32].contiguous()
    groups = 4
    n0, c0 = groupnorm.launches, gn_conv.launches
    with pytest.raises(ValueError):
        gn_conv.fused_gn_silu_conv3x3(**t, groups=groups)
    if bad != "width_change":
        with pytest.raises(ValueError):
            groupnorm.fused_groupnorm(t["x"], t["gn_scale"], t["gn_bias"], groups)
    assert (groupnorm.launches, gn_conv.launches) == (n0, c0)


def test_norm_functions_grads_match_plain_autograd(cuda):
    """Both Functions (kernel forward, plain-recompute backward) at the
    UNet's training shape: the output within 1%, the gradients bitwise
    plain autograd's (the same plain computation)."""
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    t = _conv_inputs(128, 8, 32, 320, cuda, seed=1)
    dy = (0.1 * torch.randn(128, 8, 32, 320, generator=torch.Generator().manual_seed(2)))
    dy = dy.bfloat16().to(cuda)
    for fused, plain, names in (
            (gn_conv.fused_gn_silu_conv3x3, gn_conv.gn_silu_conv3x3_reference,
             ("x", "gn_scale", "gn_bias", "w", "b")),
            (lambda x, s, b, groups: groupnorm.fused_groupnorm(x, s, b, groups, 1e-5, True),
             lambda x, s, b, groups: groupnorm.groupnorm_reference(x, s, b, groups, 1e-5, True),
             ("x", "gn_scale", "gn_bias"))):
        outs = []
        for fn in (fused, plain):
            leaves = [t[k].clone().requires_grad_() for k in names]
            out = fn(*leaves, groups=32)
            out.backward(dy)
            outs.append([out.detach()] + [v.grad for v in leaves])
        torch.cuda.synchronize()
        (out_k, *gk), (out_p, *gp) = outs
        err = (out_k.float() - out_p.float()).abs().max().item()
        assert err <= 1e-2 * out_p.float().abs().max().item(), err
        for name, a, b in zip(names, gk, gp):
            assert torch.equal(a, b), name


def test_vae_encoder_runs_the_kernels(cuda):
    """The full-width SD encoder (seeded random weights) at B=2: 18 B.6 and 4
    B.5 launches per call, latents [2, 8, 32, 4] within 3% of the all-plain
    encoder's."""
    from unittest import mock

    from worddiffusion_tpu_torch.configs.config import VAEConfig
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.vae import AutoencoderKL, encode_to_latent
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    torch.backends.cudnn.allow_tf32 = False
    vae = init_weights_(AutoencoderKL(VAEConfig(), with_encoder=True), seed=0).to(cuda).eval()
    x = torch.rand(2, 64, 256, 3, generator=torch.Generator().manual_seed(0)).to(cuda) * 2 - 1
    with torch.no_grad():
        n0, c0 = groupnorm.launches, gn_conv.launches
        got = encode_to_latent(vae, x, sample=False)
        torch.cuda.synchronize()
        assert (groupnorm.launches - n0, gn_conv.launches - c0) == (4, 18)
        with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference), \
                mock.patch.object(gn_conv, "fused_gn_silu_conv3x3",
                                  gn_conv.gn_silu_conv3x3_reference):
            want = encode_to_latent(vae, x, sample=False)
    assert got.shape == (2, 8, 32, 4) and bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= 3e-2 * want.abs().max().item(), err


# FiLM -> (B.5, B.6) launches of one decoder ResBlock (640 -> 320): the
# concat form runs B.5 + a stock conv in and B.6 out; FiLM's out half is B.5
# without SiLU then a stock conv.
RESBLOCK_LAUNCHES = {False: (1, 1), True: (2, 0)}


@pytest.mark.parametrize("film", sorted(RESBLOCK_LAUNCHES))
def test_resblock_variants_run_the_norm_kernels(cuda, film):
    """One iam decoder ResBlock (640 -> 320 channels, 8 x 32, B=16, bf16,
    seeded weights, the zero-initialised out conv too), with and without
    FiLM: its B.5 / B.6 launches, and its output within 2% of max |out| of
    the same block with the plain norms (two bf16 roundings of the
    activations in another order)."""
    from unittest import mock

    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import ResBlock
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    torch.backends.cudnn.allow_tf32 = False
    blk = init_weights_(ResBlock(640, 320, 1280, scale_shift=film), seed=0,
                        zero_init=False).to(cuda)
    g = torch.Generator().manual_seed(1)
    x, skip = (torch.randn(16, 320, 8, 32, generator=g).bfloat16().to(
        cuda, memory_format=torch.channels_last) for _ in range(2))
    emb = torch.randn(16, 1280, generator=g).bfloat16().to(cuda)

    def run():
        return blk(torch.cat([x, skip], dim=1), emb)

    with torch.no_grad():
        n0, c0 = groupnorm.launches, gn_conv.launches
        got = run()
        torch.cuda.synchronize()
        assert (groupnorm.launches - n0, gn_conv.launches - c0) == RESBLOCK_LAUNCHES[film]
        with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference), \
                mock.patch.object(gn_conv, "fused_gn_silu_conv3x3",
                                  gn_conv.gn_silu_conv3x3_reference):
            want = run()
    assert got.shape == (16, 320, 8, 32) and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


def test_ctc_head_and_loss_on_the_card(cuda):
    """The CTC aux head at the training shape (B=128, bf16 eps [128, 4, 8,
    32]): 4 B.5 launches (32 groups, eps 1e-6, no SiLU), logits within 2% of
    max |logits| of the plain norms'; the CTC loss and its gradient through
    the head bitwise equal in two runs (no atomics in its backward)."""
    from unittest import mock

    from worddiffusion_tpu_torch.models.ctc_head import CTCHead
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import groupnorm
    from worddiffusion_tpu_torch.ops.ctc import ctc_loss

    head = init_weights_(CTCHead(nclasses=80), seed=0).to(cuda)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(128, 4, 8, 32, generator=g).bfloat16().to(
        cuda, memory_format=torch.channels_last)
    labels = torch.randint(1, 54, (128, 42), generator=g).to(cuda)
    lens = torch.randint(1, 12, (128,), generator=g).to(cuda)
    n0 = groupnorm.launches
    with torch.no_grad():
        logits = head(x)
        torch.cuda.synchronize()
        assert groupnorm.launches - n0 == 4
        with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference):
            want = head(x)
    assert logits.shape == (256, 128, 80) and logits.dtype == torch.float32
    err = (logits - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err

    def loss_and_grads():
        head.zero_grad(set_to_none=True)
        loss = ctc_loss(head(x).transpose(0, 1), labels, lens, blank_id=0).mean()
        loss.backward()
        return [loss.detach()] + [p.grad.clone() for p in head.parameters()]

    first, second = loss_and_grads(), loss_and_grads()
    assert bool(torch.isfinite(first[0]))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_phoscnet_runs_every_groupnorm_through_the_kernel(cuda):
    """PHOSCNet(trunk="resnet18") at its full width (bf16, B=16 of 50x250):
    16 B.5 launches a forward, outputs within chip_smoke's PHOSC_REL_TOL of
    the plain norms'; one train step (dropout from a generator on the card)
    makes 16 more and 16 GroupNormFn backward calls, and its loss and the
    phoc output layer's gradients agree with the plain norms' step on the
    same weights."""
    from unittest import mock

    from worddiffusion_tpu_torch.cli.train_phosc import dev_norm
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.phoscnet import PHOSCNet, phosc_loss
    from worddiffusion_tpu_torch.ops import groupnorm

    model = init_weights_(PHOSCNet(trunk="resnet18"), seed=0).to(
        cuda, memory_format=torch.channels_last)
    x = dev_norm(chip_smoke.phosc_images(16, seed=5), cuda)
    g = torch.Generator().manual_seed(6)
    tp = torch.randint(0, 3, (16, 165), generator=g).float().to(cuda)
    tc = (torch.rand(16, 604, generator=g) < 0.1).float().to(cuda)
    n0 = groupnorm.launches
    with torch.no_grad():
        out = model(x, return_features=True)
        torch.cuda.synchronize()
        assert groupnorm.launches - n0 == 16
        with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference):
            want = model(x, return_features=True)
    for k in want:
        err = (out[k] - want[k]).abs().max().item()
        assert err <= chip_smoke.PHOSC_REL_TOL * want[k].abs().max().item(), (k, err)

    def step():
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=cuda).manual_seed(0)
        loss = phosc_loss(model(x, deterministic=False, generator=gen), tp, tc)
        loss.backward()
        # the phoc output layer's: no ReLU lies between it and the loss. Deeper
        # gradients are not compared element by element: where a pre-ReLU
        # value lies within the forwards' bf16 difference of 0, one step
        # passes a row of gradient that the other stops
        return loss.item(), [p.grad.clone() for p in model.phoc_out.parameters()]

    n0, b0 = groupnorm.launches, groupnorm.bwd_calls
    loss, grads = step()
    assert groupnorm.launches - n0 == 16 and groupnorm.bwd_calls - b0 == 16
    with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference):
        plain_loss, plain_grads = step()
    assert abs(loss - plain_loss) <= chip_smoke.PHOSC_REL_TOL * abs(plain_loss)
    for a, b in zip(grads, plain_grads):
        assert (a - b).abs().max().item() <= chip_smoke.PHOSC_REL_TOL * b.abs().max().item()


def test_style_encoder_runs_every_groupnorm_through_the_kernel(cuda):
    """StyleEncoder(out_dim=4096) at its full width (bf16, B=8 of 64x256): 48
    B.5 launches a forward, the output within chip_smoke's STYLE_REL_TOL of
    the plain norms'; one triplet step (three forwards) makes 144 more and
    144 GroupNormFn backward calls, its loss finite. (The hinge loss itself
    is not compared: it is a small difference of two squared distances
    near 10^3, which the forwards' bf16 difference can move past 0.)"""
    from unittest import mock

    from worddiffusion_tpu_torch.cli.train_style import make_optimizer, train_step
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.style import StyleEncoder
    from worddiffusion_tpu_torch.ops import groupnorm

    enc = init_weights_(StyleEncoder(out_dim=4096), seed=0).to(
        cuda, memory_format=torch.channels_last)
    x = chip_smoke.style_batch(8)
    n0 = groupnorm.launches
    with torch.no_grad():
        out = enc(x)
        torch.cuda.synchronize()
        assert groupnorm.launches - n0 == 48
        with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference):
            want = enc(x)
    err = (out - want).abs().max().item()
    assert err <= chip_smoke.STYLE_REL_TOL * want.abs().max().item(), err

    n0, b0 = groupnorm.launches, groupnorm.bwd_calls
    loss = train_step(enc, make_optimizer(enc, 1e-4), x[:2], x[2:4], x[4:6], 0.2)
    torch.cuda.synchronize()
    assert groupnorm.launches - n0 == 144 and groupnorm.bwd_calls - b0 == 144
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(p).all()) for p in enc.parameters())


def test_ocr_train_step_runs_the_norm_kernels(cuda):
    """The recognizer's training step on the card: 10 B.5 launches and 10
    GroupNormFn backward calls, dropout drawn on the card from a generator
    (the same seed gives the same step), the clip at 1.0."""
    from worddiffusion_tpu_torch.cli import train_ocr
    from worddiffusion_tpu_torch.data.alphabets import OCR_ENG, OCR_ENG_BLANK
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.ocr import CTCRecognizer
    from worddiffusion_tpu_torch.ops import groupnorm
    from worddiffusion_tpu_torch.ops.ctc import encode_ocr_labels

    words = ["the", "of", "and", "word"]
    labels, lens = (torch.from_numpy(a).to(cuda) for a in encode_ocr_labels(words, OCR_ENG, 42))
    x = chip_smoke.style_batch(4)[..., :1].contiguous()

    def run():
        model = init_weights_(CTCRecognizer(num_classes=len(OCR_ENG)), seed=0).to(
            cuda, memory_format=torch.channels_last)
        gen = torch.Generator(device=cuda).manual_seed(0)
        n0, b0 = groupnorm.launches, groupnorm.bwd_calls
        loss = train_ocr.train_step(model, train_ocr.make_optimizer(model, 3e-4), x, labels,
                                    lens, OCR_ENG_BLANK, gen)
        torch.cuda.synchronize()
        assert groupnorm.launches - n0 == 10 and groupnorm.bwd_calls - b0 == 10
        return loss, [p.detach().clone() for p in model.parameters()]

    (l1, p1), (l2, p2) = run(), run()
    assert bool(torch.isfinite(l1)) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_vae_train_step_runs_the_norm_kernels(cuda):
    """The SD VAE's training step at its full width (B=2 of 64x256): 8 B.5
    and 44 B.6 launches (encode 4 + 18, decode 4 + 26) and as many
    Function backward calls; the loss finite."""
    from worddiffusion_tpu_torch.cli import train_vae
    from worddiffusion_tpu_torch.configs.config import VAEConfig
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.vae import AutoencoderKL
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    vae = init_weights_(AutoencoderKL(VAEConfig(), with_encoder=True), seed=0).to(
        cuda, memory_format=torch.channels_last)
    x = chip_smoke.style_batch(2)
    before = (groupnorm.launches, gn_conv.launches, groupnorm.bwd_calls, gn_conv.bwd_calls)
    loss, mse, kl = train_vae.train_step(vae, train_vae.make_optimizer(vae, 1e-4), x, 1e-6,
                                         generator=torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    after = (groupnorm.launches, gn_conv.launches, groupnorm.bwd_calls, gn_conv.bwd_calls)
    assert tuple(b - a for a, b in zip(before, after)) == (8, 44, 8, 44)
    assert all(bool(torch.isfinite(v)) for v in (loss, mse, kl))


def test_inception_on_the_card_matches_the_host(cuda, tmp_path):
    """The Inception featurizer (fp32 convs, TF32 off) on seeded
    torchvision-layout weights: the card's features within chip_smoke's
    INCEPTION_TOL of the host's, on a 64x256 batch resized up to 299."""
    from worddiffusion_tpu_torch.eval.inception import (load_inception_featurizer,
                                                        seeded_torchvision_state_dict)

    torch.save(seeded_torchvision_state_dict(0), tmp_path / "inception.pt")
    x = chip_smoke.style_batch(4).cpu().numpy()
    on_card = load_inception_featurizer(str(tmp_path / "inception.pt"), cuda)(x)
    on_host = load_inception_featurizer(str(tmp_path / "inception.pt"), "cpu")(x)
    assert on_card.shape == (4, 2048)
    assert abs(on_card - on_host).max() <= chip_smoke.INCEPTION_TOL * abs(on_host).max()
