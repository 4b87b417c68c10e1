"""The port's fused LN + GEGLU FFN (worddiffusion_tpu_torch/ops/ffn.py)
against the JAX package's Pallas kernel (interpret mode off the TPU).

On the CPU the dispatcher takes the plain version; the CUDA kernel is
compared with it on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.ops.ffn_pallas import fused_ln_geglu_ffn as jax_fused
from worddiffusion_tpu_torch.ops import build, ffn

torch.set_num_threads(1)


def _inputs(m, d, inner, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x=f(m, d), gamma=1.0 + 0.1 * f(d), beta=0.1 * f(d),
        w1=f(d, 2 * inner) / np.sqrt(d), b1=0.02 * f(2 * inner),
        w2=f(inner, d) / np.sqrt(inner), b2=0.02 * f(d),
    )


def _torch(a, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype if k in ("x", "w1", "w2") else torch.float32)
            for k, v in a.items()}


@pytest.mark.parametrize("m,d,inner", [(100, 64, 256), (64, 128, 512)])
def test_reference_matches_jax_fused_fp32(m, d, inner):
    """fp32: same math, different summation order -> 1e-5."""
    a = _inputs(m, d, inner)
    want = np.asarray(jax_fused(**{k: jnp.asarray(v) for k, v in a.items()}))
    got = ffn.ln_geglu_ffn_reference(**_torch(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_matches_jax_fused_bf16():
    """bf16 operands: the two round h differently (the JAX kernel keeps
    it fp32, the plain version rounds the matmul output) -> a few bf16
    ulps of the output's magnitude."""
    a = _inputs(100, 64, 256, seed=1)
    ja = {k: jnp.asarray(v, jnp.bfloat16 if k in ("x", "w1", "w2") else jnp.float32)
          for k, v in a.items()}
    want = np.asarray(jax_fused(**ja).astype(jnp.float32))
    got = ffn.ln_geglu_ffn_reference(**_torch(a, torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-2)


def test_dispatcher_takes_plain_path_on_cpu():
    t = _torch(_inputs(100, 64, 256))
    before = ffn.launches
    out = ffn.fused_ln_geglu_ffn(**t)
    torch.testing.assert_close(out, ffn.ln_geglu_ffn_reference(**t), rtol=0, atol=0)
    assert ffn.launches == before == 0


def test_dispatcher_refuses_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises."""
    t = {k: v.to("meta") for k, v in _torch(_inputs(8, 64, 256)).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.fused_ln_geglu_ffn(**t)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(build_root=tmp_path)


def test_build_raises_with_compiler_output(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no such target"):
        build.build(nvcc=str(fake), build_root=tmp_path / "out")
    assert not list((tmp_path / "out").rglob("*.so"))


def _bwd_inputs(m=23, d=32, inner=64, seed=2):
    """The shapes of tests/test_pallas_ops.py's backward-kernel case (m=23
    pads the JAX grid), with a cotangent."""
    a = _inputs(m, d, inner, seed)
    a.pop("b2")
    a["dy"] = np.random.default_rng(seed + 1).standard_normal((m, d))
    return {k: v.astype(np.float32) for k, v in a.items()}


def test_bwd_reference_matches_jax_kernel_fp32():
    """The plain backward against the JAX backward kernel in interpret
    mode, fp32: same arithmetic, other summation order -> 2e-4 abs."""
    from worddiffusion_tpu.ops.ffn_pallas import _ln_ffn_bwd_pallas

    a = _bwd_inputs()
    order = ("x", "dy", "gamma", "beta", "w1", "b1", "w2")
    want = _ln_ffn_bwd_pallas(*(jnp.asarray(a[k]) for k in order), interpret=True)
    got = ffn.ln_geglu_ffn_bwd_reference(*(torch.from_numpy(a[k]) for k in order))
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(tuple(g.shape))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4)


def test_bwd_dispatcher_takes_plain_path_on_cpu_and_refuses_other_devices():
    a = {k: torch.from_numpy(v) for k, v in _bwd_inputs().items()}
    got = ffn.ln_geglu_ffn_bwd(**a)
    want = ffn.ln_geglu_ffn_bwd_reference(**a)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ffn.bwd_launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.ln_geglu_ffn_bwd(**{k: v.to("meta") for k, v in a.items()})


def test_bwd_reference_matches_autograd_fp32():
    """The plain backward against torch autograd of the plain forward:
    1e-5 of each gradient's scale."""
    a = _bwd_inputs(m=40, d=64, inner=128, seed=5)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    dy = t.pop("dy")
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()}
    b2 = torch.zeros(64)
    out = ffn.ln_geglu_ffn_reference(**leaves, b2=b2)
    want = torch.autograd.grad(out, [leaves[k] for k in ("x", "gamma", "beta", "w1", "b1", "w2")],
                               dy)
    got = ffn.ln_geglu_ffn_bwd_reference(t["x"], dy, t["gamma"], t["beta"], t["w1"], t["b1"],
                                         t["w2"])
    for g, w in zip([got[i] for i in (0, 1, 2, 3, 4, 5)], want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * w.abs().max().item())
    torch.testing.assert_close(got[6], dy.sum(0), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_plain_and_reach_master_weights(dtype):
    """Through the LnGegluFFN Function (the block's default FF path) a
    transformer block's gradients equal those of the plain autograd path
    (use_pallas_ffn=False), and the FF weights' gradients land on the
    fp32 masters in parameter layout. fp32: 1e-5 of each gradient's
    scale; bf16: the plain path rounds dact, dxn and the weight
    gradients to bf16, the Function keeps them fp32 -> 2e-2."""
    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.layers import init_weights_

    dt = getattr(torch, dtype)
    blocks = [init_weights_(BasicTransformerBlock(64, 2, 32, 32, dtype=dt, use_pallas_ffn=u),
                            seed=4, zero_init=False) for u in (None, False)]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 24, 64, generator=g).to(dt)
    ctx = torch.randn(2, 7, 32, generator=g).to(dt)
    grads = []
    for blk in blocks:
        xi = x.clone().requires_grad_()
        out = blk(xi, ctx)
        assert out.requires_grad
        (out.float() * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append({"x": xi.grad, **{n: p.grad for n, p in blk.named_parameters()}})
    fn, plain = grads
    proj = dict(blocks[0].named_parameters())["ff.net.0.proj.weight"]
    assert proj.grad is not None and proj.grad.dtype == torch.float32
    assert proj.grad.shape == proj.shape == (512, 64)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for k in plain:
        scale = plain[k].float().abs().max().item()
        torch.testing.assert_close(fn[k].float(), plain[k].float(), rtol=0, atol=tol * scale + 1e-12,
                                   msg=k)


# -- the bare GEGLU FFN (ffn_pallas.py::fused_geglu_ffn, its _ffn_kernel) ---------------

def _geglu_inputs(m, d, inner, seed):
    a = _inputs(m, d, inner, seed)
    return {k: a[k].astype(np.float32) for k in ("x", "w1", "b1", "w2", "b2")}


def test_geglu_reference_matches_jax_kernel_fp32():
    """fp32 at the flagship width (d=320, inner=1280), M = 2*256: the plain
    version against JAX's fused_geglu_ffn, whose Pallas kernel runs in
    interpret mode here; other summation orders -> 2e-4 abs, as
    tests/test_pallas_ops.py allows the kernel against XLA."""
    from worddiffusion_tpu.ops.ffn_pallas import fused_geglu_ffn

    a = _geglu_inputs(2 * 256, 320, 1280, seed=6)
    want = np.asarray(fused_geglu_ffn(*(jnp.asarray(a[k]) for k in a)))
    got = ffn.geglu_ffn_reference(*(torch.from_numpy(a[k]) for k in a)).numpy()
    assert got.shape == want.shape == (512, 320)
    assert np.abs(got - want).max() <= 2e-4


def test_geglu_reference_matches_jax_kernel_bf16_ragged():
    """bf16 x and weights at a ragged M=100 (the JAX kernel pads it to its
    row tile, the port masks): the same dtype contract (fp32 products and
    GEGLU, one bf16 rounding of act and of the output) -> 1% of max |JAX|."""
    from worddiffusion_tpu.ops.ffn_pallas import fused_geglu_ffn

    a = _geglu_inputs(100, 64, 256, seed=7)
    bf = ("x", "w1", "w2")
    want = fused_geglu_ffn(*(jnp.asarray(a[k], jnp.bfloat16 if k in bf else jnp.float32)
                             for k in a), block_m=64)
    want = np.asarray(want.astype(jnp.float32))
    got = ffn.geglu_ffn_reference(*(torch.from_numpy(a[k]).to(
        torch.bfloat16 if k in bf else torch.float32) for k in a))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_geglu_function_grads_match_jax_fp32():
    """The GegluFFN Function's gradients on the CPU against
    jax.grad(fused_geglu_ffn) (its custom_vjp differentiates _xla_baseline)
    at d=32, inner=64, fp32: 1e-4 abs, as tests/test_pallas_ops.py."""
    import jax

    from worddiffusion_tpu.ops.ffn_pallas import fused_geglu_ffn

    a = _geglu_inputs(8, 32, 64, seed=8)
    names = tuple(a)
    want = jax.grad(lambda *t: jnp.sum(fused_geglu_ffn(*t)), argnums=tuple(range(5)))(
        *(jnp.asarray(a[k]) for k in names))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in names]
    ffn.fused_geglu_ffn(*leaves).sum().backward()
    for name, t, w in zip(names, leaves, want):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_geglu_takes_plain_path_on_cpu_and_refuses_other_devices():
    t = [torch.from_numpy(v) for v in _geglu_inputs(100, 64, 256, seed=9).values()]
    out = ffn.fused_geglu_ffn(*t)
    torch.testing.assert_close(out, ffn.geglu_ffn_reference(*t), rtol=0, atol=0)
    assert ffn.geglu_launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.fused_geglu_ffn(*(v.to("meta") for v in t))
