"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import ctypes

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


@pytest.mark.parametrize("inner", [INNER // 2, INNER // 4])
def test_geglu_kernel_takes_the_tensor_parallel_widths(cuda, inner):
    """B.2 at the local inner widths of the tensor-parallel FF (a model axis
    of 2 and 4 over the 1280-wide FF) and the training M: within 1% of max
    |out| of the plain version, bitwise repeatable."""
    t = chip_smoke.ffn_inputs(128 * 256, seed=6, inner=inner)
    a = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    got, again = ffn.fused_geglu_ffn(*a), ffn.fused_geglu_ffn(*a)
    want = ffn.geglu_ffn_reference(*a)
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


def test_tp_ffn_sublayer_raises_on_a_width_b2_does_not_take(cuda):
    """A model axis of 8 leaves each rank 160 of the 1280 inner columns, not
    a multiple of B.2's 64-column chunk: the tensor-parallel FF sub-layer
    raises (before any collective) instead of running a plain FFN."""
    from worddiffusion_tpu_torch.parallel.mesh import Mesh

    t = _inputs(64, cuda)
    w1 = t["w1"].t().float().reshape(2, 8, INNER // 8, D)[:, 0].reshape(-1, D)
    w2 = t["w2"].t().float()[:, :INNER // 8].contiguous()
    before = ffn.geglu_launches
    with pytest.raises(ValueError, match="inner % 64 == 0"):
        ffn.ffn_sublayer_tp(t["x"], t["gamma"], t["beta"], w1, t["b1"], w2, t["b2"],
                            Mesh(data=1, model=8))
    assert ffn.geglu_launches == before


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


def _bwd_inputs(m, device, seed=0, d=D):
    if d == D:
        t = _inputs(m, device, seed)
    else:
        g = torch.Generator().manual_seed(seed)
        r = lambda *s: torch.randn(*s, generator=g)
        t = dict(x=r(m, d).bfloat16(), gamma=1 + 0.1 * r(d), beta=0.1 * r(d),
                 w1=(r(d, 8 * d) / d ** 0.5).bfloat16(), b1=0.02 * r(8 * d),
                 w2=(r(4 * d, d) / (4 * d) ** 0.5).bfloat16(), b2=0.02 * r(d))
        t = {k: v.to(device) for k, v in t.items()}
    t.pop("b2")
    g = torch.Generator().manual_seed(seed + 100)
    t["dy"] = (0.1 * torch.randn(m, d, generator=g)).bfloat16().to(device)
    order = ("x", "dy", "gamma", "beta", "w1", "b1", "w2")
    return {k: t[k] for k in order}


# B.3's M: the training step's two sites (B=128 at 256 and 64 tokens), a ragged
# M, one tile and one tile and a row (the clusters that share a tile), and a
# pixel-space site (B=16 at 64 x 256 tokens: 4096 tiles)
BWD_M = [128 * 256, 128 * 64, 1000, 64, 65, 16 * 64 * 256]
# (M, d): those at the presets' 320, every other width the forward takes at
# M = 1024 (the fused route up to 320, the split one above), and channel_mult
# (1, 2)'s middle block at the training batch (d = 640, M = 128 * 64) and a
# ragged M at 768
BWD_CASES = ([(m, D) for m in BWD_M] + [(1024, d) for d in range(64, 769, 64) if d != D]
             + [(128 * 64, 640), (1000, 768)])


@pytest.mark.parametrize("m,d", BWD_CASES)
def test_bwd_kernel_matches_plain(cuda, m, d):
    t = _bwd_inputs(m, cuda, d=d)
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


@pytest.mark.parametrize("m,d", [(128 * 64 + 40, D), (65, D), (128 * 256, D), (1000, 192),
                                 (128 * 64, 640), (65, 640), (1000, 768)])
def test_bwd_kernel_is_bitwise_repeatable(cuda, m, d):
    """No atomics: the sums run in a fixed order, so two runs agree bit
    for bit (the trainer's bitwise resume rests on it), with one CTA a tile
    (a ragged last tile) and with clusters that share a tile, on the fused
    route (d <= 320) and on the split one."""
    t = _bwd_inputs(m, cuda, seed=3, d=d)
    first = ffn.ln_geglu_ffn_bwd(**t)
    second = ffn.ln_geglu_ffn_bwd(**t)
    torch.cuda.synchronize()
    for name, a, b in zip(GRADS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("bad", ["fp32_dy", "dy_shape", "w2_dtype", "odd_d", "wide_d",
                                 "narrow_d"])
def test_bwd_kernel_refuses_what_it_does_not_take(cuda, bad):
    """B.3 takes the forward's widths, d = 64k from 64 to 768: d = 368 (not a
    multiple of 64), 832 (past 768) and 32 raise, as do operands of another
    dtype or shape."""
    t = _bwd_inputs(64, cuda)
    if bad == "fp32_dy":
        t["dy"] = t["dy"].float()
    elif bad == "dy_shape":
        t["dy"] = t["dy"][:32].contiguous()
    elif bad == "w2_dtype":
        t["w2"] = t["w2"].float()
    else:
        d = {"odd_d": 368, "wide_d": 832, "narrow_d": 32}[bad]
        t = _bwd_inputs(64, cuda, d=d)
    before = ffn.bwd_launches
    with pytest.raises(ValueError):
        ffn.ln_geglu_ffn_bwd(**t)
    assert ffn.bwd_launches == before


@pytest.mark.parametrize("d", [D, 640])
def test_bwd_gradients_come_back_contiguous_in_parameter_layout(cuda, d):
    """The backward kernels write dW1 [2*inner, d] and dW2 [d, inner], the
    parameters' layout, so LnGegluFFN returns them as they are: contiguous
    fp32 tensors of the parameters' shapes, equal to the JAX-layout entry's
    gradients transposed, bit for bit, on either route."""
    t = _bwd_inputs(1000, cuda, seed=7, d=d)
    w1, w2 = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    got = ffn._bwd_params(t["x"], t["dy"], t["gamma"], t["beta"], w1, t["b1"], w2, 1e-5)
    jax_layout = ffn.ln_geglu_ffn_bwd(**t)
    torch.cuda.synchronize()
    assert got[3].shape == (8 * d, d) and got[5].shape == (d, 4 * d)
    assert got[3].is_contiguous() and got[5].is_contiguous()
    for name, a, b in zip(GRADS, got, jax_layout):
        assert torch.equal(a, b.t() if name in ("dw1", "dw2") else b), name
    p = {k: v.float().t().contiguous().requires_grad_() for k, v in (("w1", t["w1"]),
                                                                     ("w2", t["w2"]))}
    b2 = torch.zeros(d, device=cuda)
    out = ffn.LnGegluFFN.apply(t["x"], t["gamma"], t["beta"], p["w1"], t["b1"], p["w2"], b2,
                               1e-5)
    out.backward(t["dy"])
    for k in ("w1", "w2"):
        g = p[k].grad
        assert g.dtype == torch.float32 and g.shape == p[k].shape and g.is_contiguous(), k


@pytest.mark.parametrize("dim,n", [(D, 256), (640, 64)])
def test_block_backward_goes_through_the_kernels(cuda, dim, n):
    """The fault this guards against: a kernel output without an autograd
    graph. On CUDA the FF sub-layer's output needs a gradient, the
    backward launches the backward kernel, and a transformer block's
    gradients agree with the plain autograd path's: the presets' block and
    channel_mult (1, 2)'s middle block (640 wide, 4 heads of 160, 64 tokens:
    B.3's split route)."""
    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.layers import init_weights_

    blocks = [init_weights_(BasicTransformerBlock(dim, 4, dim // 4, 320, use_pallas_ffn=u),
                            seed=1, zero_init=False).to(cuda) for u in (None, False)]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, n, dim, generator=g).bfloat16().to(cuda)
    ctx = torch.randn(8, 42, 320, generator=g).bfloat16().to(cuda)
    co = torch.randn(8, n, dim, generator=g).to(cuda)
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


def _qkvh(b, h, nq, nk, d, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, n, d, generator=g).bfloat16().to(device) for n in (nq, nk, nk))


def _check_attention(q, k, v, fast=False):
    """The kernel against ``attention_reference`` (in its mode) within
    ATTN_REL_TOL of max |plain|, bitwise repeatable, both launches counted."""
    from worddiffusion_tpu_torch.ops import attention

    scale = q.shape[-1] ** -0.5
    before = attention.launches
    got = attention.fused_attention(q, k, v, scale, fast)
    again = attention.fused_attention(q, k, v, scale, fast)
    torch.cuda.synchronize()
    assert attention.launches == before + 2
    want = attention.attention_reference(q, k, v, scale, fast).float()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, again)
    err = (got.float() - want).abs().max().item()
    assert err <= chip_smoke.ATTN_REL_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_attention_kernel_takes_every_head_width(cuda, d, fast):
    """Every D the kernel takes loads as 16-column panels with the 32-byte
    swizzle (D = 64 and 128 fill whole 128-byte rows, 80 does not), in both
    modes and every instance family: a long ragged context over enough
    pairs for two consumer warpgroups (128-key chunks), the same over few
    pairs (one warpgroup, 64-key chunks), and a short context (one 48-key
    chunk)."""
    from worddiffusion_tpu_torch.ops import attention

    for i, (b, nq, nk, rows, keys) in enumerate(((36, 200, 300, 128, 128), (4, 200, 300, 64, 64),
                                                 (2, 64, 42, 64, 48))):
        p = attention.plan(b * 4, nq, nk, d)
        assert (p["rows"], p["keys"]) == (rows, keys), p
        _check_attention(*_qkvh(b, 4, nq, nk, d, cuda, seed=d + i), fast)


@pytest.mark.parametrize("nk", [1, 42, 48, 65, 811])
@pytest.mark.parametrize("nq", [1, 40, 64, 65, 256])
def test_attention_kernel_over_query_and_key_lengths(cuda, nq, nk):
    """Nk on each side of the chunk widths (1 and 42 round up to 16 and 48,
    48 fills its chunk, 65 spills one key into a second 64-key chunk, 811 is
    13 chunks, the last ragged) against Nq on each side of the 64- and
    128-row tiles; rows past Nq are not stored, keys past Nk score -inf."""
    _check_attention(*_qkvh(2, 4, nq, nk, 80, cuda, seed=nq * 1000 + nk))


def test_attention_kernel_streams_a_long_query_over_few_keys(cuda):
    """The pixel cross-attention's form: 16384 queries over 42 keys, many
    items a persistent CTA, the next q tiles loading while one computes."""
    _check_attention(*_qkvh(2, 4, 16384, 42, 80, cuda, seed=7))


@pytest.mark.parametrize("h", [1, 2])
def test_attention_kernel_at_tensor_parallel_head_counts(cuda, h):
    """A model rank's local heads under tensor parallelism: training at B=128
    and the preview at B=3 (fewer items than SMs: one warpgroup a CTA)."""
    _check_attention(*_qkvh(128, h, 256, 42, 80, cuda, seed=h))
    _check_attention(*_qkvh(3, h, 64, 42, 80, cuda, seed=h + 10))
    _check_attention(*_qkvh(3, h, 256, 42, 80, cuda, seed=h + 20), fast=True)


@pytest.mark.parametrize("nq,nk", [(256, 42), (65, 811)])
def test_attention_lse_is_the_logsumexp_of_the_scores(cuda, nq, nk):
    """B.4's lse (the maps kernel's input): each query row's ln sum exp(s *
    scale) against ``torch.logsumexp`` of the plain fp32 scores, within 1e-4
    of max |lse| (the SFU's exp2 and log2, fp32 sums in another order);
    bitwise repeatable; the output as ``fused_attention`` gives it."""
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkvh(4, 4, nq, nk, 80, cuda, seed=nq + nk)
    scale = 80 ** -0.5
    before = attention.launches
    (out, lse), (out2, lse2) = (attention.attention_lse(q, k, v, scale) for _ in range(2))
    torch.cuda.synchronize()
    assert attention.launches == before + 2
    want = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.equal(lse, lse2) and torch.equal(out, out2)
    assert (lse - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(out, attention.fused_attention(q, k, v, scale))


def test_attention_plan_follows_its_rule(cuda):
    """Two consumer warpgroups (128 query rows) where Nq > 64 and the
    128-row items fill the card, else one (64 rows); keys a chunk: Nk
    rounded up to 16 up to 48, else 64, and 128 with two warpgroups where
    Nk > 256; at most one or two CTAs an SM, never more than the items;
    setmaxnreg only with two warpgroups."""
    from worddiffusion_tpu_torch.ops import attention

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = attention.plan(128 * 4, 256, 811)
    assert (p["rows"], p["keys"], p["ctas"]) == (128, 128, sms)
    assert attention.plan(128 * 4, 256, 256)["keys"] == 64
    assert p["producer_regs"] < p["consumer_regs"]
    p = attention.plan(16 * 4, 64, 42)
    assert (p["rows"], p["keys"], p["ctas"]) == (64, 48, 64)
    assert p["producer_regs"] == p["consumer_regs"] == 0
    assert attention.plan(3 * 2, 256, 42)["rows"] == 64  # 12 items: fewer than SMs
    assert attention.plan(2, 1, 1)["keys"] == 16
    assert attention.plan(16 * 4, 16384, 42)["ctas"] == sms
    assert attention._lib().wd_attention_tile_rows(128 * 4, 256) == 128


@pytest.mark.parametrize("b,nq,nk", ATTN_SHAPES + [(4, 256, 2048)])
def test_attention_fast_mode_matches_plain_fast(cuda, b, nq, nk):
    """``fast=True`` (``UNetConfig.fast_softmax``): the kernel's fast mode
    against the plain fast version (JAX's bf16 order): within 1% of max
    |out| (where each p's bf16 rounding falls, and the order of the fp32
    sums), nearer it on average than the default mode is (the fast mode
    makes two of JAX's three roundings); bitwise repeatable; its launches
    counted apart."""
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkv(b, nq, nk, cuda, seed=2)
    a0, f0 = attention.launches, attention.fast_launches
    got = attention.fused_attention(q, k, v, 80 ** -0.5, True)
    again = attention.fused_attention(q, k, v, 80 ** -0.5, True)
    default = attention.fused_attention(q, k, v, 80 ** -0.5)
    torch.cuda.synchronize()
    assert (attention.launches - a0, attention.fast_launches - f0) == (3, 2)
    want = attention.attention_reference(q, k, v, 80 ** -0.5, True).float()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    top = want.abs().max().item()
    fast_err, default_err = ((o.float() - want).abs() for o in (got, default))
    assert fast_err.max().item() <= 1e-2 * top, fast_err.max().item()
    assert fast_err.mean() < default_err.mean(), (fast_err.mean(), default_err.mean())


def test_remat_block_on_the_card_is_bitwise_and_recomputes_the_kernels(cuda):
    """A full-width SpatialTransformer (B=16, 8x32, 320 channels) with
    ``remat``: output and every gradient bitwise those without it; the
    backward launches B.1 and B.4 once more per block (1 and 2), B.3 as
    often."""
    from worddiffusion_tpu_torch.models.attention import SpatialTransformer
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 320, 8, 32, generator=g).bfloat16().to(cuda).to(
        memory_format=torch.channels_last)
    ctx = torch.randn(16, 42, 320, generator=g).bfloat16().to(cuda)
    runs = []
    for remat in (False, True):
        st = init_weights_(SpatialTransformer(320, 4, 80, context_dim=320, remat=remat), seed=3,
                           zero_init=False).to(cuda)
        xi = x.clone().requires_grad_()
        counts = (ffn.launches, attention.launches, ffn.bwd_launches)
        (st(xi, ctx).float() ** 2).sum().backward()
        torch.cuda.synchronize()
        runs.append((tuple(b - a for a, b in zip(counts, (ffn.launches, attention.launches,
                                                          ffn.bwd_launches))),
                     {"x": xi.grad, **{n: p.grad for n, p in st.named_parameters()}}))
    (n0, g0), (n1, g1) = runs
    assert n0 == (1, 2, 1) and n1 == (2, 4, 1), (n0, n1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


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
# (B, N, L, C): those at the presets' C = 320, then channel_mult (1, 2)'s middle
# block (C = 640, N = 64) at the regeneration and training batches, a ragged
# N with L = 13, and L = 64 and 80 (one ring slot: a head's wt and vw in turn)
FOLD_CASES = [(b, n, l, D) for b, n, l in FOLD_SHAPES] + [
    (16, 64, 42, 640), (128, 64, 42, 640), (2, 40, 13, 640), (2, 64, 64, 640), (2, 64, 80, 640)]


def _fold_inputs(b, n, l, device, c=D, heads=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(x=r(b, n, c).bfloat16(), wt4=(r(b, heads, c, l) / c ** 0.5).bfloat16(),
             vw4=r(b, heads, l, c).bfloat16(), gamma=1 + 0.1 * r(c), beta=0.1 * r(c),
             b_out=0.02 * r(c))
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.parametrize("layout", ["b7", "b8", "b8_padded"])
@pytest.mark.parametrize("b,n,l,c", FOLD_CASES)
def test_fold_kernel_matches_plain(cuda, layout, b, n, l, c):
    """bf16 out: the two differ in the order of the fp32 sums, which can
    move one bf16 rounding -> within 1% of max |out|; bitwise repeatable,
    and bitwise the contiguous per-head layout's result whatever the
    layout, as the route of wt's loads never changes the arithmetic. B.7's
    entry takes the folds as [B, C, H*L] and [B, H*L, C] (wt copied by the
    producer's threads: a head's columns start off 16 bytes); "b8_padded"
    is wt4 as the [..., :L] view of an L stride rounded up to 8, as
    build_folds returns it (TMA); the contiguous layout is copied by the
    producer's threads unless L is a multiple of 8. At C = 640 (the wide
    kernel, TMA only) the wrapper copies those layouts to build_folds' L
    stride first ("padded")."""
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    t = _fold_inputs(b, n, l, cuda, c=c)
    vecs = (t["gamma"], t["beta"], t["b_out"])
    wt4, vw4 = t["wt4"], t["vw4"]
    copy = "copy" if c <= D else "padded"  # the wide kernel's wt arrives by TMA only
    if layout == "b7":
        wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, c, 4 * l).contiguous()
        vw = t["vw4"].reshape(b, 4 * l, c)
        wt4, vw4 = wt.view(b, c, 4, l).permute(0, 2, 1, 3), vw.view(b, 4, l, c)
        assert fa.wt_route(wt4) == copy
        run = lambda: fa.fold_attention(t["x"], wt, vw, *vecs, 4)
    elif layout == "b8_padded":
        lp = -(-l // 8) * 8
        wt4 = torch.nn.functional.pad(t["wt4"], (0, lp - l))[..., :l]
        assert fa.wt_route(wt4) == "tma"
        run = lambda: fa.fold_attention_heads(t["x"], wt4, t["vw4"], *vecs)
    else:
        assert fa.wt_route(wt4) == ("tma" if l % 8 == 0 else copy)
        run = lambda: fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    before = fa.launches
    got, again = run(), run()
    contiguous = fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    torch.cuda.synchronize()
    assert fa.launches == before + 3
    want = fa.fold_attention_reference(t["x"], t["wt4"], t["vw4"], *vecs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again) and torch.equal(got, contiguous)
    tol = 1e-2 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("c,heads,b,n,l", [(64, 4, 2, 40, 13), (128, 1, 2, 64, 80),
                                           (160, 4, 3, 100, 40), (304, 2, 2, 64, 42),
                                           (336, 4, 2, 64, 42), (512, 4, 3, 70, 33),
                                           (576, 8, 2, 64, 72)])
def test_fold_kernel_matches_plain_below_full_width(cuda, c, heads, b, n, l):
    """A width C (C % 16 == 0) runs padded to the register width above it,
    320 or 640, its columns past C zero: within 1% of plain's max |out|,
    bitwise repeatable, wt4 by TMA (L stride padded to 8) and as it lies
    (copied where L % 8) giving the same bits. C = 64, 160 and 336 leave
    whole boxes of x, vw and wt past C."""
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    t = _fold_inputs(b, n, l, cuda, c=c, heads=heads, seed=c)
    vecs = (t["gamma"], t["beta"], t["b_out"])
    wt4p = torch.nn.functional.pad(t["wt4"], (0, -l % 8))[..., :l]
    assert fa.wt_route(wt4p) == "tma"
    assert fa.wt_route(t["wt4"]) == ("tma" if l % 8 == 0 else "copy" if c <= D else "padded")
    before = fa.launches
    got, again = (fa.fold_attention_heads(t["x"], wt4p, t["vw4"], *vecs) for _ in range(2))
    contiguous = fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    torch.cuda.synchronize()
    assert fa.launches == before + 3
    want = fa.fold_attention_reference(t["x"], t["wt4"], t["vw4"], *vecs)
    assert got.shape == want.shape
    assert torch.equal(got, again) and torch.equal(got, contiguous)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


def test_fold_routes_fill_the_card_and_copy_rows_as_they_lie(cuda):
    """One CTA a tile while the tiles are fewer than the SMs (B=16: 64 at
    N=256, 16 at N=64), and at B=128 one persistent CTA an SM (the card's
    shared memory holds one) walking the tiles; a CTA takes all four heads
    of its tiles. build_folds
    pads wt4's L stride to 48, so its wt4 arrives by TMA; the contiguous
    L=42 layout, an odd L and B.7's flat rows are copied."""
    from worddiffusion_tpu_torch.models.attention import build_folds
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.ctas(16, 256, D, 42) == 64 and fa.ctas(16, 64, D, 42) == 16
    assert fa.ctas(128, 256, D, 42) == min(512, sms) and fa.ctas(128, 64, D, 42) == min(128, sms)
    assert fa.ctas(16, 64, 640, 42) == 16 and fa.ctas(128, 64, 640, 42) == min(128, sms)
    g = torch.Generator().manual_seed(0)
    ctx = torch.randn(2, 42, 320, generator=g).bfloat16().to(cuda)
    ws = [(torch.randn(320, 320, generator=g) / 320 ** 0.5).to(cuda) for _ in range(4)]
    wt4, _ = build_folds(ctx, *ws, 4, 80, torch.bfloat16)
    assert wt4.stride() == (4 * 320 * 48, 320 * 48, 48, 1) and fa.wt_route(wt4) == "tma"
    assert fa.wt_route(wt4.contiguous()) == "copy"
    flat = wt4.permute(0, 2, 1, 3).reshape(2, 320, 168)
    assert fa.wt_route(flat.view(2, 320, 4, 42).permute(0, 2, 1, 3)) == "copy"
    odd = torch.zeros(2, 4, 320, 13, dtype=torch.bfloat16, device=cuda)
    assert fa.wt_route(odd) == "copy"


@pytest.mark.parametrize("case,route", [("tail_short", "tma"), ("tail_room", "tma"),
                                        ("expanded_short", "copy"),
                                        ("expanded_room", "copy")])
def test_fold_kernel_reads_wt_inside_its_allocation(cuda, case, route):
    """wt4 with an L stride of 48 at L=42: a tensor map of L columns reads
    no element past a row's L, so the storage may end at the last row's L
    (as_strided: "short") or leave the stride's 6 ("room"); "expanded" is
    one sample's folds expanded over the batch (sample stride 0), which no
    tensor map takes, so the producer's threads copy it. Bitwise the
    contiguous folds' result."""
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


@pytest.mark.parametrize("bad", ["fp32_x", "c_not_16", "c_over_640", "l_over_limit",
                                 "heads_l_over_c", "strided_x", "wt_l_strided"])
def test_fold_kernel_refuses_what_it_does_not_take(cuda, bad):
    from worddiffusion_tpu_torch.ops import fold_attention as fa

    if bad == "c_not_16":
        t = _fold_inputs(2, 64, 13, cuda, c=72)
    elif bad == "c_over_640":
        t = _fold_inputs(2, 64, 13, cuda, c=656)
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
             (48, 2, 8, 2048, 32, False), (48, 16, 64, 64, 32, False),
             # channel_mult (1, 2)'s decoder concats (1280 and 960 at 4 x 16, 960 at 8 x 32)
             (16, 4, 16, 1280, 32, True), (16, 4, 16, 960, 32, True), (16, 8, 32, 960, 32, True)]


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
# the VAE's levels at B=4, a ragged image (5 x 13), a ragged width (C=48), a
# pixel-space ResBlock and images of one row and of one column. They take
# every plan the kernel has: 128 pixels, and 64 with K split across the two
# warpgroups; 128, 160 and 64 channels; the statistics in the kernel (a
# sample's CTAs one cluster) or by B.5's launch first.
CONV_SHAPES = [(16, 8, 32, 320, 32), (16, 4, 16, 320, 32), (128, 8, 32, 320, 32),
               (128, 4, 16, 320, 32), (16, 8, 32, 512, 32), (16, 16, 64, 512, 32),
               (16, 32, 128, 256, 32), (16, 64, 256, 128, 32), (128, 64, 256, 128, 32),
               (128, 32, 128, 256, 32), (128, 16, 64, 512, 32), (128, 8, 32, 512, 32),
               (4, 64, 256, 128, 32), (4, 32, 128, 256, 32), (4, 16, 64, 512, 32),
               (2, 5, 13, 64, 32), (2, 5, 13, 48, 48), (16, 64, 256, 320, 32),
               (2, 1, 9, 64, 32), (2, 7, 1, 64, 32),
               # channel_mult (1, 2)'s 640-wide second level
               (16, 4, 16, 640, 32), (128, 4, 16, 640, 32)]


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


def _kernel_names(fn):
    """The device kernels one call of ``fn`` launches, by name, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [e.name for e in events]


@pytest.mark.parametrize("b,h,w,c,stats_launch", [
    (16, 8, 32, 320, False), (16, 4, 16, 320, False), (128, 8, 32, 320, False),
    (128, 4, 16, 320, False), (2, 5, 13, 48, False), (16, 64, 256, 128, True),
    (4, 32, 128, 256, True), (16, 4, 16, 640, False), (128, 4, 16, 640, False)])
def test_gn_conv_launches_a_call_by_name(cuda, b, h, w, c, stats_launch):
    """One conv launch a call, and before it one launch of B.5's cluster
    kernel for the statistics only where a sample is more CTAs than a
    cluster holds (the VAE's images); the UNet's sites take their
    statistics in the conv kernel. The plan says the same."""
    from worddiffusion_tpu_torch.ops import gn_conv

    groups = 48 if c == 48 else 32
    t = _conv_inputs(b, h, w, c, cuda)
    wk = t["w"].to(torch.bfloat16)  # the weight's cast, outside the profiled call
    names = _kernel_names(lambda: gn_conv._launch(t["x"], t["gn_scale"], t["gn_bias"], wk, t["b"],
                                                  groups, 1e-5))
    names = [n for n in names if "conv_kernel" in n or "gn_" in n]
    assert [("conv_kernel" in n, "gn_cluster_kernel" in n) for n in names] == (
        [(False, True)] if stats_launch else []) + [(True, False)], names
    assert (gn_conv.plan(b, h, w, c, groups)["cluster"] == 0) == stats_launch


@pytest.mark.parametrize("b,h,w,c", [(16, 8, 32, 320), (2, 5, 13, 64), (4, 4, 16, 128)])
def test_gn_conv_every_plan_matches_plain(cuda, b, h, w, c):
    """Every plan the kernel has (128 pixels, or 64 with K split; x 160, 128
    or 64 channels where C takes them), through the measurements' entry
    wd_gn_silu_conv3x3_planned, within 1% of max |out| of the plain version
    and bitwise repeatable."""
    import ctypes

    from worddiffusion_tpu_torch.ops import gn_conv

    torch.backends.cudnn.allow_tf32 = False
    t = _conv_inputs(b, h, w, c, cuda, seed=4)
    want = gn_conv.gn_silu_conv3x3_reference(**t, groups=32).float()
    lib = gn_conv._lib()
    fn = lib.wd_gn_silu_conv3x3_planned
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float] + [i] * 3 + [p]
    fn.restype = i
    wk = gn_conv.kernel_weight(t["w"])
    stats = torch.empty(b * 32 * 2, device=cuda)
    for px, bn, split in ((128, 160, 0), (128, 128, 0), (128, 64, 0), (64, 160, 1), (64, 128, 1),
                          (64, 64, 1)):
        if bn != 64 and c % bn:
            continue
        outs = []
        for _ in range(2):
            out = torch.zeros_like(t["x"])
            err = fn(t["x"].data_ptr(), t["gn_scale"].data_ptr(), t["gn_bias"].data_ptr(),
                     wk.data_ptr(), t["b"].data_ptr(), out.data_ptr(), stats.data_ptr(), b, h, w, c,
                     32, 1e-5, px, bn, split, torch.cuda.current_stream().cuda_stream)
            assert err == 0, (px, bn, split, err)
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), (px, bn, split)
        e = (outs[0].float() - want).abs().max().item()
        assert e <= 1e-2 * want.abs().max().item(), (px, bn, split, e)


def test_b3_and_b6_kernels_are_wgmma_and_tma(cuda):
    """The built library's SASS (cuobjdump -sass): every instance of B.3's
    row and weight-gradient kernels and of B.6's conv kernel issues HGMMA
    (wgmma) and UTMALDG (TMA loads), and none HMMA (mma.sync) or LDGSTS
    (cp.async)."""
    import os
    import re
    import subprocess

    from worddiffusion_tpu_torch.ops import build

    lib = build.build()
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    wanted = ("ffn_bwd_rows_kernel", "ffn_bwd_weights_kernel", "conv_kernel")
    seen = {k: 0 for k in wanted}
    for f in funcs:
        name = f.split("\n", 1)[0]
        for k in wanted:
            if k in name:
                seen[k] += 1
                assert "HGMMA" in f and "UTMALDG" in f, name
                assert not re.search(r"\bHMMA\b|\bLDGSTS\b", f), name
    assert seen["ffn_bwd_rows_kernel"] >= 1 and seen["ffn_bwd_weights_kernel"] >= 1, seen
    assert seen["conv_kernel"] == 6, seen  # 64, 128, 160 channels x 128 px / K split


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


# The maps kernel beside B.4 (return_attn): fp32 probabilities exp(q kᵀ ·
# scale - lse) from B.4's log-sum-exp, against the plain softmax. Measured
# bound: the lse comes from the online softmax's SFU exp2 over bf16 inputs,
# the plain one from an fp32 softmax, so a probability moves by a relative
# 1e-5 or so; within 1e-4 absolute.
MAPS_ABS_TOL = 1e-4


@pytest.mark.parametrize("b,nq,nk", [(16, 256, 42), (16, 64, 42), (2, 16384, 42),
                                     (2, 300, 811), (1, 100, 1)])
def test_attention_maps_kernel_matches_plain(cuda, b, nq, nk):
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkv(b, nq, nk, cuda, seed=5)
    l0, p0 = attention.launches, attention.probs_launches
    out, p = attention.attention_with_probs(q, k, v, 80 ** -0.5)
    torch.cuda.synchronize()
    assert (attention.launches - l0, attention.probs_launches - p0) == (1, 1)
    assert torch.equal(out, attention.fused_attention(q, k, v, 80 ** -0.5))  # B.4's output
    want = attention.attention_probs_reference(q, k, 80 ** -0.5)
    assert p.dtype == torch.float32 and p.shape == (b, 4, nq, nk)
    assert (p - want).abs().max().item() <= MAPS_ABS_TOL
    assert (p.sum(-1) - 1).abs().max().item() <= 1e-3


def test_attention_maps_are_forward_only_on_the_card(cuda):
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = (t.requires_grad_() for t in _qkv(1, 16, 8, cuda))
    with pytest.raises(ValueError, match="forward only"):
        attention.attention_with_probs(q, k, v, 0.1)
    with torch.no_grad():
        assert attention.attention_with_probs(q, k, v, 0.1)[1].shape == (1, 4, 16, 8)


@pytest.mark.parametrize("b,h,w,c,silu", [(2, 64, 256, 640, True), (2, 64, 256, 320, False),
                                          (2, 32, 128, 640, True)])
def test_groupnorm_at_pixel_sites(cuda, b, h, w, c, silu):
    """B.5 at the pixel-space UNet's sites (a group 20 channels x 16384
    positions: more than a CTA's shared memory, so x is read twice)."""
    from worddiffusion_tpu_torch.ops import groupnorm

    t = chip_smoke.norm_inputs((b, h, w, c), seed=7)
    args = (t["x"], t["scale"], t["bias"], 32, 1e-5, silu)
    got = groupnorm.fused_groupnorm(*args)
    want = groupnorm.groupnorm_reference(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= chip_smoke.NORM_REL_TOL * want.float().abs().max().item(), err
    assert not groupnorm.route(t["x"], 32)[1]


def test_gn_conv_and_ffn_at_pixel_shapes(cuda):
    """B.6 at a pixel-space ResBlock ([2, 64, 256, 320]) and B.1 over its
    32768 tokens, against their plain versions."""
    from worddiffusion_tpu_torch.ops import gn_conv

    t = chip_smoke.norm_inputs((2, 64, 256, 320), seed=8)
    g = torch.Generator().manual_seed(9)
    wt = (torch.randn(320, 320, 3, 3, generator=g) / (9 * 320) ** 0.5).to(cuda)
    cb = (0.1 * torch.randn(320, generator=g)).to(cuda)
    args = (t["x"], t["scale"], t["bias"], wt, cb, 32, 1e-5)
    got, want = gn_conv.fused_gn_silu_conv3x3(*args), gn_conv.gn_silu_conv3x3_reference(*args)
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
    a = _inputs(2 * 64 * 256, cuda, seed=3)
    got, want = ffn.fused_ln_geglu_ffn(**a), ffn.ln_geglu_ffn_reference(**a)
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


def test_higan_denoiser_runs_b5_on_the_card(cuda):
    """The HiGAN+ denoiser at ``iam`` width (320 channels, 6 blocks), B=4:
    13 B.5 launches a call (12 without SiLU, then out_norm with it), the
    call within 3% of its max against the plain GroupNorm; the train step's
    13 GroupNormFn backwards."""
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.models.higan import HiGanDenoiserAdapter
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import groupnorm

    cfg = presets.get("iam").unet
    model = init_weights_(HiGanDenoiserAdapter(cfg), seed=0, zero_init=False).to(
        cuda, memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 32, 4, generator=g).to(cuda)
    t = torch.tensor([1, 100, 300, 599], device=cuda)
    ctx = torch.randint(1, 50, (4, 42), generator=g).to(cuda)
    wid = torch.arange(4, device=cuda)
    n0 = groupnorm.launches
    with torch.no_grad():
        got = model(x, t, ctx, wid)
        assert groupnorm.launches - n0 == 13
        with chip_smoke.plain_norms():
            want = model(x, t, ctx, wid)
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
    b0 = groupnorm.bwd_calls
    model(x, t, ctx, wid).square().mean().backward()
    assert groupnorm.bwd_calls - b0 == 13


# ---- widths above 320: channel_mult (1, 2) and the kernels' whole ranges ----

def _wide_ffn(m, d, seed):
    return chip_smoke.ffn_inputs(m, seed=seed, inner=4 * d, d=d)


@pytest.mark.parametrize("d", [64, 128, 256, 320, 512, 640, 768])
def test_kernel_matches_plain_at_every_width(cuda, d):
    """B.1 at widths across its range (each plan: 2 warpgroups with W2's
    slice in a slot, W2 in the ring below 192, 4 warpgroups above 512) at a
    clustered M and the training middle block's: within 1% of max |out| of
    the plain version, bitwise repeatable."""
    for i, m in enumerate((1024, 8192)):
        t = _wide_ffn(m, d, seed=d + i)
        before = ffn.launches
        got, again = ffn.fused_ln_geglu_ffn(**t), ffn.fused_ln_geglu_ffn(**t)
        torch.cuda.synchronize()
        assert ffn.launches == before + 2
        want = ffn.ln_geglu_ffn_reference(**t)
        assert got.shape == want.shape and torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), (m, err)
    assert ffn.plan(d)["warpgroups"] == (4 if d > 512 else 2)


def test_geglu_kernel_matches_plain_at_d640(cuda):
    """B.2 at channel_mult (1, 2)'s middle-block width."""
    t = _wide_ffn(128 * 64, 640, seed=7)
    a = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    before = ffn.geglu_launches
    got, again = ffn.fused_geglu_ffn(*a), ffn.fused_geglu_ffn(*a)
    torch.cuda.synchronize()
    assert ffn.geglu_launches == before + 2 and torch.equal(got, again)
    want = ffn.geglu_ffn_reference(*a)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("d", [144, 160, 192, 256])
def test_attention_kernel_at_wide_heads(cuda, d, fast):
    """B.4 above D = 128 (one plan: one consumer warpgroup, 64-key chunks,
    one CTA an SM) at the (1, 2) middle block's shape and over a long ragged
    context, in both modes, within ATTN_REL_TOL of plain."""
    from worddiffusion_tpu_torch.ops import attention

    for i, (b, nq, nk) in enumerate(((16, 64, 42), (2, 200, 300))):
        p = attention.plan(b * 4, nq, nk, d)
        assert (p["rows"], p["keys"]) == (64, 64), p
        _check_attention(*_qkvh(b, 4, nq, nk, d, cuda, seed=d + i), fast)


@pytest.mark.parametrize("d", [160, 256])
def test_attention_maps_kernel_at_wide_heads(cuda, d):
    """The maps kernel (``return_attn``) takes B.4's head widths: the fp32
    probabilities from B.4's lse against the plain softmax."""
    from worddiffusion_tpu_torch.ops import attention

    q, k, v = _qkv(16, 64, 42, cuda, d=d, seed=8)
    out, p = attention.attention_with_probs(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    want = attention.attention_probs_reference(q, k, d ** -0.5)
    assert p.shape == (16, 4, 64, 42) and torch.equal(out, attention.fused_attention(q, k, v, d ** -0.5))
    assert (p - want).abs().max().item() <= MAPS_ABS_TOL


def test_unet_channel_mult_12_on_the_kernels(cuda):
    """The full-width iam UNet at channel_mult (1, 2), B = 4: every FF
    sub-layer through B.1 (one at d = 640), every attention through B.4 (two
    at D = 160), no plain FF; eps within UNET_REL_TOL of the all-plain UNet
    on the same weights."""
    import dataclasses

    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import attention

    cfg = dataclasses.replace(presets.iam().unet, channel_mult=(1, 2))
    unet = init_weights_(UNet(cfg), seed=0, zero_init=False).cuda().eval()
    plain = UNet(dataclasses.replace(cfg, use_pallas_ffn=False)).cuda().eval()
    plain.load_state_dict(unet.state_dict())
    g = torch.Generator().manual_seed(0)
    b = 4
    x = torch.randn(b, 8, 32, 4, generator=g).cuda()
    t = torch.tensor([599, 400, 200, 10]).cuda()
    ctx = torch.randint(1, 50, (b, cfg.max_seq_len), generator=g).cuda()
    wid = torch.arange(b).cuda()
    f0, a0, p0 = ffn.launches, attention.launches, ffn.plain_calls
    with torch.no_grad():
        got = unet(x, t, ctx, wid)
        assert (ffn.launches - f0, attention.launches - a0, ffn.plain_calls - p0) == (4, 8, 0)
        with chip_smoke.all_plain():
            want = plain(x, t, ctx, wid)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= chip_smoke.UNET_REL_TOL * want.abs().max().item(), err


def test_out_of_range_widths_raise(cuda):
    """No fallback on a CUDA tensor: B.1 raises for a d that is not a
    multiple of 64 or is past 768, B.4 for a head past 256, and the FF
    Function raises at d = 832 where a gradient is wanted (the model runs
    that width plain); at d = 640 it launches B.3, whose widths are B.1's."""
    from worddiffusion_tpu_torch.ops import attention

    for d in (100, 336, 832):
        t = _wide_ffn(64, d, seed=3)
        before = ffn.launches
        with pytest.raises(ValueError, match="64 <= d <= 768"):
            ffn.fused_ln_geglu_ffn(**t)
        assert ffn.launches == before
    q = torch.zeros(1, 2, 8, 272, dtype=torch.bfloat16, device=cuda)
    before = attention.launches
    with pytest.raises(ValueError, match="D <= 256"):
        attention.fused_attention(q, q, q, 0.1)
    assert attention.launches == before
    widths = (ctypes.c_int * 4)()
    ffn._lib().wd_ln_geglu_ffn_bwd_d(widths)
    assert tuple(widths) == (*ffn.BWD_WIDTHS, 320)  # the library's, and the fused route's widest
    t = _wide_ffn(64, 832, seed=4)
    x = t["x"].clone().requires_grad_()
    with pytest.raises(ValueError, match="from 64 to 768"):
        ffn.fused_ln_geglu_ffn(x, t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"])
    t = _wide_ffn(64, 640, seed=4)
    x = t["x"].clone().requires_grad_()
    before = ffn.bwd_launches
    ffn.fused_ln_geglu_ffn(x, t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                           t["b2"]).float().sum().backward()
    torch.cuda.synchronize()
    assert ffn.bwd_launches == before + 1 and bool(torch.isfinite(x.grad.float()).all())
