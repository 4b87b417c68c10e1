"""The context-folded attention (``UNetConfig.attn_fold_context``) in the
port against the JAX package at small sizes, on the CPU.

``ops.fold_attention``'s plain version against the two Pallas kernels it
replaces (run in interpret mode, as the JAX package's own tests run them):
B.7 ``bench_kernels/attn_fold_pallas.py`` on folds [B, C, H·L] and
[B, H·L, C], and B.8 ``bench_kernels/attn_fold_sublayer_pallas.py`` on
per-head folds [B, H, C, L] and [B, H, L, C]; the port's fold functions
against ``fold_weights`` and ``build_folds``; ``FoldAttention``'s gradients
against the kernels' ``custom_vjp``s; the gate; and the UNet and one
training step with the fold against JAX's. Inputs are seeded numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_kernels import attn_fold_pallas as b7
from bench_kernels import attn_fold_sublayer_pallas as b8
from worddiffusion_tpu.configs.config import (
    DataConfig, DiffusionConfig, Experiment, TrainConfig, UNetConfig, VAEConfig,
)
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models import attention as jattn
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.train import step as jstep
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.models import attention
from worddiffusion_tpu_torch.models.convert import jax_unet_to_torch, state_dict_to_torch
from worddiffusion_tpu_torch.models.layers import init_weights_
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.ops import fold_attention
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)

B, C, H = 2, 64, 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sublayer_inputs(n, l, seed=0):
    """x [B, n, C]; LayerNorm affine near identity; folds at the scale of
    the model's (unit scores, unit-scale outputs); biases."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=r(B, n, C), gamma=1 + 0.1 * r(C), beta=0.1 * r(C),
                wt=r(B, C, H * l) / C ** 0.5, vw=r(B, H * l, C), bo=0.1 * r(C))


def _context_inputs(l, seed=1):
    """A context [B, l, C] and q/k/v/out weights in the JAX layout [in, out]."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((C, C)) / C ** 0.5).astype(np.float32) for _ in range(4)]
    return rng.standard_normal((B, l, C)).astype(np.float32), ws


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _check(got, want, dtype_name):
    """fp32: other summation orders only -> 1e-5 relative. bf16: one bf16
    rounding of p or of the output apart (0.4% of a value) -> 2% of max |ref|."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert np.abs(got - want).max() <= 2e-2 * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n,l", [(16, 13), (40, 32), (64, 32)])
def test_plain_matches_b7_kernel(dtype_name, n, l):
    jdt, tdt = DTYPES[dtype_name]
    a = _sublayer_inputs(n, l)
    want = b7._fold_attn_pallas(jnp.asarray(a["x"], jdt), a["gamma"], a["beta"],
                                jnp.asarray(a["wt"], jdt), jnp.asarray(a["vw"], jdt), a["bo"],
                                H, interpret=True)
    got = fold_attention.fold_attention(
        _to_torch(a["x"], tdt), _to_torch(a["wt"], tdt), _to_torch(a["vw"], tdt),
        _to_torch(a["gamma"], torch.float32), _to_torch(a["beta"], torch.float32),
        _to_torch(a["bo"], torch.float32), H)
    assert got.dtype == tdt and got.shape == (B, n, C)
    _check(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n,l", [(16, 13), (64, 32)])
def test_plain_matches_b8_kernel(dtype_name, n, l):
    """Per-head folds from B.8's own ``build_folds``."""
    jdt, tdt = DTYPES[dtype_name]
    a = _sublayer_inputs(n, l, seed=2)
    ctx, (wq, wk, wv, wo) = _context_inputs(l)
    wt4, vw4 = b8.build_folds(jnp.asarray(ctx), wq, wk, wv, wo, H, C // H, jdt)
    x = jnp.asarray(a["x"], jdt)
    want = b8.fused_fold_attention(x, wt4, vw4, a["gamma"], a["beta"], a["bo"], interpret=True)
    got = fold_attention.fold_attention_heads(
        _to_torch(a["x"], tdt), _to_torch(wt4, tdt), _to_torch(vw4, tdt),
        _to_torch(a["gamma"], torch.float32), _to_torch(a["beta"], torch.float32),
        _to_torch(a["bo"], torch.float32))
    _check(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_fold_functions_match_jax(dtype_name):
    """The port's fold functions take weights in parameter layout ([out, in]).
    fp32: 1e-5 relative; bf16: the k/v projections and the folds each
    round once to bf16, at most one bf16 ulp apart -> 1% of max |ref|."""
    jdt, tdt = DTYPES[dtype_name]
    l = 13
    ctx, ws = _context_inputs(l, seed=3)
    jctx = jnp.asarray(ctx, jdt)
    want7 = jattn.fold_weights(jctx, *ws, H, C // H, C, jdt)
    want8 = b8.build_folds(jctx, *ws, H, C // H, jdt)
    tws = [torch.from_numpy(w.T.copy()) for w in ws]
    got7 = attention.fold_weights(_to_torch(jctx, tdt), *tws, H, C // H, tdt)
    got8 = attention.build_folds(_to_torch(jctx, tdt), *tws, H, C // H, tdt)
    for got, want, shape in zip(got7 + got8, want7 + want8,
                                [(B, C, H * l), (B, H * l, C), (B, H, C, l), (B, H, l, C)]):
        assert got.dtype == tdt and tuple(got.shape) == shape == want.shape
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        tol = (1e-5 if dtype_name == "float32" else 1e-2) * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("l", [13, 29])
@pytest.mark.parametrize("stride", ["contiguous", "padded"])
def test_build_folds_match_jax_and_the_b8_kernel_at_either_l_stride(dtype_name, l, stride):
    """build_folds' folds: the same values as JAX's build_folds (1e-5
    relative in fp32, 1% of max in bf16, as test_fold_functions_match_jax),
    and the sub-layer on them, with wt4 as build_folds returns it (the
    [..., :L] view of an L stride rounded up to 8, which the CUDA kernel
    reads through a tensor map) or made contiguous, as B.8's kernel
    (interpret mode) computes it on JAX's folds."""
    jdt, tdt = DTYPES[dtype_name]
    n = 24
    a = _sublayer_inputs(n, l, seed=6)
    ctx, ws = _context_inputs(l, seed=7)
    jctx = jnp.asarray(ctx, jdt)
    jwt4, jvw4 = b8.build_folds(jctx, *ws, H, C // H, jdt)
    tws = [torch.from_numpy(w.T.copy()) for w in ws]
    wt4, vw4 = attention.build_folds(_to_torch(jctx, tdt), *tws, H, C // H, tdt)
    lp = -(-l // 8) * 8
    assert tuple(wt4.shape) == (B, H, C, l) and wt4.stride() == (H * C * lp, C * lp, lp, 1)
    assert vw4.is_contiguous() and wt4.dtype == vw4.dtype == tdt
    if stride == "contiguous":
        wt4 = wt4.contiguous()
    for got, want in ((wt4, jwt4), (vw4, jvw4)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        tol = (1e-5 if dtype_name == "float32" else 1e-2) * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    want = b8.fused_fold_attention(jnp.asarray(a["x"], jdt), jwt4, jvw4, a["gamma"], a["beta"],
                                   a["bo"], interpret=True)
    got = fold_attention.fold_attention_heads(
        _to_torch(a["x"], tdt), wt4, vw4, _to_torch(a["gamma"], torch.float32),
        _to_torch(a["beta"], torch.float32), _to_torch(a["bo"], torch.float32))
    assert got.dtype == tdt and got.shape == (B, n, C)
    _check(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("l", [13, 42, 48])
def test_build_folds_padded_layout_keeps_the_values(dtype_name, l):
    """wt4's padded L stride changes no value: bitwise the folds of the
    contiguous layout build_folds returned before (the fp32 folds rounded
    to the dtype, row-major), and as close to B.8's build_folds as
    test_fold_functions_match_jax allows; gradients flow through the view
    to every projection as through the contiguous folds, bitwise."""
    jdt, tdt = DTYPES[dtype_name]
    ctx, ws = _context_inputs(l, seed=11)
    jwt4, jvw4 = b8.build_folds(jnp.asarray(ctx, jdt), *ws, H, C // H, jdt)
    tctx = _to_torch(ctx, tdt)

    def contiguous_folds(context, wq, wk, wv, wo):
        b, n, _ = context.shape
        kh = (context @ wk.to(tdt).t()).reshape(b, n, H, C // H)
        vh = (context @ wv.to(tdt).t()).reshape(b, n, H, C // H)
        wq3 = wq.to(tdt).t().reshape(-1, H, C // H)
        wo3 = wo.to(tdt).t().reshape(H, C // H, -1)
        wt4 = torch.einsum("chd,blhd->bhcl", wq3.float(), kh.float()) * (C // H) ** -0.5
        vw4 = torch.einsum("blhd,hdf->bhlf", vh.float(), wo3.float())
        return tuple(f.to(tdt, memory_format=torch.contiguous_format).contiguous()
                     for f in (wt4, vw4))

    grads = []
    for fn in (lambda *a: attention.build_folds(*a, H, C // H, tdt), contiguous_folds):
        tws = [torch.from_numpy(w.T.copy()).requires_grad_() for w in ws]
        wt4, vw4 = fn(tctx, *tws)
        co = torch.from_numpy(np.random.default_rng(12).standard_normal(wt4.shape)).float()
        ((wt4.float() * co).sum() + vw4.float().square().sum()).backward()
        grads.append(((wt4, vw4), [w.grad for w in tws]))
    (got, got_g), (before, before_g) = grads
    assert got[0].stride()[-2:] == (-(-l // 8) * 8, 1)
    for a, b in zip(got + tuple(got_g), before + tuple(before_g)):
        assert a.shape == b.shape and torch.equal(a, b)
    for g, want in zip(got, (jwt4, jvw4)):
        g, want = g.float().detach().numpy(), np.asarray(want, np.float32)
        tol = (1e-5 if dtype_name == "float32" else 1e-2) * np.abs(want).max()
        np.testing.assert_allclose(g, want, rtol=0, atol=tol)


@pytest.mark.parametrize("layout", ["b7", "b8"])
def test_fold_function_grads_match_jax(layout):
    """FoldAttention's backward (the plain version recomputed under autograd)
    against the JAX kernel's custom_vjp (XLA recompute), fp32: the gradient
    of sum(y * co) for x, the folds, gamma, beta and b_out, 1e-4 of each
    one's max."""
    n, l = 24, 13
    a = _sublayer_inputs(n, l, seed=4)
    co = np.random.default_rng(5).standard_normal((B, n, C)).astype(np.float32)
    if layout == "b7":
        wt, vw = a["wt"], a["vw"]

        def jfn(x, wt, vw, g, be, bo):
            return b7.fused_fold_attention(x, g, be, wt, vw, bo, H, 1e-5, True)
    else:
        wt = a["wt"].reshape(B, C, H, l).transpose(0, 2, 1, 3).copy()
        vw = a["vw"].reshape(B, H, l, C)

        def jfn(x, wt, vw, g, be, bo):
            return b8.fused_fold_attention(x, wt, vw, g, be, bo, 8, 1e-5, True)

    args = (a["x"], wt, vw, a["gamma"], a["beta"], a["bo"])
    want = jax.grad(lambda *p: jnp.sum(jfn(*p) * co), argnums=tuple(range(6)))(
        *map(jnp.asarray, args))

    leaves = [torch.from_numpy(np.ascontiguousarray(t)).requires_grad_() for t in args]
    x, wt_t, vw_t, g, be, bo = leaves
    before = fold_attention.bwd_calls
    if layout == "b7":
        y = fold_attention.fold_attention(x, wt_t, vw_t, g, be, bo, H)
    else:
        y = fold_attention.fold_attention_heads(x, wt_t, vw_t, g, be, bo)
    (y * torch.from_numpy(co)).sum().backward()
    assert fold_attention.bwd_calls == before + 1
    for name, t, w in zip(("x", "wt", "vw", "gamma", "beta", "b_out"), leaves, want):
        w = np.asarray(w)
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


class _FoldSpy:
    """Counts the blocks' fold sub-layer calls (the CPU's stand-in for the
    kernel's launch count)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = fold_attention.fold_attention_heads

        def spy(*a, **kw):
            self.calls += 1
            return inner(*a, **kw)

        monkeypatch.setattr(fold_attention, "fold_attention_heads", spy)


def _block_pair(attn1_cross, context_dim=C):
    blocks = [init_weights_(attention.BasicTransformerBlock(
        C, H, C // H, context_dim, attn1_cross=attn1_cross, dtype=torch.float32,
        fold_context=fold), seed=1, zero_init=False) for fold in (True, False)]
    return blocks


@pytest.mark.parametrize("case", ["long_context", "self_attention"])
def test_gate_falls_back_bit_equal(monkeypatch, case):
    """The JAX gate (attention.py:178-183): fold only with a context and
    heads * L <= dim. A context of 33 tokens (2 * 33 > 64) and a
    self-attention take the unfolded path, bit for bit."""
    spy = _FoldSpy(monkeypatch)
    fold, plain = _block_pair(attn1_cross=case == "long_context")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((B, 16, C)).astype(np.float32))
    with torch.no_grad():
        if case == "long_context":
            ctx = torch.from_numpy(rng.standard_normal((B, 33, C)).astype(np.float32))
            got, want = fold(x, ctx), plain(x, ctx)
        else:
            got = fold._attend(fold.attn1, fold.norm1, x, None)
            want = plain._attend(plain.attn1, plain.norm1, x, None)
    assert spy.calls == 0
    assert torch.equal(got, want)


def test_block_fold_matches_unfolded(monkeypatch):
    """Where the gate folds (2 heads x 10 tokens <= 64), the block agrees
    with its unfolded self in fp32 (the same math re-associated), in both
    layouts; attn1_cross folds both attentions, the self-attention
    layout its cross-attention only."""
    spy = _FoldSpy(monkeypatch)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, 16, C)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((B, 10, C)).astype(np.float32))
    for attn1_cross, folds in ((True, 2), (False, 1)):
        spy.calls = 0
        fold, plain = _block_pair(attn1_cross)
        with torch.no_grad():
            got, want = fold(x, ctx), plain(x, ctx)
        assert spy.calls == folds
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


# 64 channels: at 32 every channel is its own GroupNorm group, which cancels
# per-channel conditioning outright; 2 heads x 10 characters <= 64: every
# attention folds
CFG = UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                 num_writers=8, max_seq_len=10, dtype="float32", attn_fold_context=True)
T = 40


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 32, 4)).astype(np.float32), np.array([5, 30], np.int32),
            rng.integers(0, 53, (B, 10)).astype(np.int32), np.array([0, 3], np.int32))


def _params(cfg, seed=3):
    """Every parameter random (the zero-initialised output convs too)."""
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), *_inputs())
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _port(cfg, params):
    m = UNet(port_cfg(cfg))
    m.load_state_dict(state_dict_to_torch(jax_unet_to_torch(params, cfg)), strict=True)
    return m


def test_fold_param_tree_is_the_unfolded_one():
    """The JAX _folded declares the same tree, so the export and the port's
    parameter names need no change."""
    fold = jax.eval_shape(JaxUNet(CFG).init, jax.random.PRNGKey(0), *_inputs())
    plain = jax.eval_shape(JaxUNet(dataclasses.replace(CFG, attn_fold_context=None)).init,
                           jax.random.PRNGKey(0), *_inputs())
    assert jax.tree.structure(fold) == jax.tree.structure(plain)
    assert sorted(UNet(port_cfg(CFG)).state_dict()) == sorted(
        UNet(port_cfg(dataclasses.replace(CFG, attn_fold_context=None))).state_dict())


def test_unet_fold_matches_jax_fp32(monkeypatch):
    """fp32, other summation orders through 4 blocks -> rtol 1e-4, atol
    1e-5; 8 fold sub-layers per call (2 in each of the 4 blocks)."""
    params = _params(CFG)
    inp = _inputs()
    want = np.asarray(jax.jit(JaxUNet(CFG).apply)(params, *inp))
    spy = _FoldSpy(monkeypatch)
    with torch.no_grad():
        got = _port(CFG, params).eval()(*(torch.from_numpy(a) for a in inp[:2]),
                                        *(torch.from_numpy(a).long() for a in inp[2:])).numpy()
    assert spy.calls == 8
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_phosc_with_fold_flag_runs_unfolded(monkeypatch):
    """The PHOSC layout: 10 characters + 769 PHOSC tokens exceed the gate,
    so the flag changes nothing: bit-equal to the flag off, 0 fold calls."""
    cfg = dataclasses.replace(CFG, attn1_cross=False, use_phosc=True, phosc_dim=769)
    flagged, plain = UNet(port_cfg(cfg)).eval(), UNet(port_cfg(dataclasses.replace(
        cfg, attn_fold_context=None))).eval()
    init_weights_(flagged, seed=4, zero_init=False)
    plain.load_state_dict(flagged.state_dict())
    x, t, ctx, wid = (torch.from_numpy(a) for a in _inputs(1))
    ph = torch.from_numpy(np.random.default_rng(8).integers(0, 4, (B, 769)))
    spy = _FoldSpy(monkeypatch)
    with torch.no_grad():
        got = flagged(x, t, ctx.long(), wid.long(), ph)
        want = plain(x, t, ctx.long(), wid.long(), ph)
    assert spy.calls == 0
    assert torch.equal(got, want)


def test_train_step_with_fold_matches_jax():
    """One fp32 step with the fold on both sides, JAX's draws handed to the
    port: loss 1e-5 relative; each gradient 1e-4 of its largest entry,
    floored at 1e-2 of the largest gradient anywhere (as
    tests/test_torch_train.py argues); the q/k/v/out weights get theirs
    through FoldAttention's backward, 8 calls."""
    exp = Experiment(
        name="tiny_fold", unet=CFG,
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"),
        diffusion=DiffusionConfig(num_steps=T),
        data=DataConfig(max_chars=10, alphabet="eng_main", batch_size=B),
        train=TrainConfig(lr=1e-3, cfg_drop_prob=0.1, ema_warmup_steps=2),
    )
    sched = NoiseSchedule.linear(T)
    params = _params(CFG, seed=9)
    x, _, ctx, wid = _inputs(2)
    batch = {"latent": x, "context": ctx, "writer": wid}
    step_rng = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    loss_fn = jstep.make_loss_fn(JaxUNet(CFG), sched, exp)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch, step_rng)
    t_rng, n_rng, d_rng = jax.random.split(step_rng, 3)
    t = np.asarray(jforward.sample_timesteps(sched, t_rng, B))
    noise = np.asarray(jax.random.normal(n_rng, (B, 8, 32, 4), jnp.float32))
    keep = float(jax.random.uniform(d_rng, ()) >= 0.1)

    model = _port(CFG, params).train()
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    draws = StepDraws(torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy()),
                      torch.tensor(keep))
    tb = {"latent": torch.from_numpy(x), "context": torch.from_numpy(ctx).long(),
          "writer": torch.from_numpy(wid).long()}
    before = fold_attention.bwd_calls
    metrics = make_train_step(PortSchedule.linear(T), port_cfg(exp))(state, tb, draws)
    assert fold_attention.bwd_calls == before + 8
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-5)

    named = dict(model.named_parameters())
    want_g = jax_unet_to_torch(jgrads, CFG)
    assert set(want_g) == set(named)
    floor = 1e-2 * max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = named[k].grad
        assert g is not None, k
        if ".to_" in k:
            assert g.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), floor),
                                   err_msg=k)
