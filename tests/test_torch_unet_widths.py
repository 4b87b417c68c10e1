"""The port at the widths the JAX package runs beyond the presets' 320: a
UNet with ``channel_mult=(1, 2)`` (its second level and middle block twice
as wide), the FF sub-layer at d = 640, the attention at head widths 160 and
256, and the width rule that sends a transformer block's FF to the fused
kernel (``ops.ffn.kernel_takes``, the port's copy of JAX's ``fits_vmem``).

On the CPU each dispatcher takes the plain version; the CUDA kernels are
held against it on the card by tests/test_torch_gpu.py. Inputs are drawn
from numpy seeds and handed to both packages. Tolerances: fp32 UNet 1e-4
relative, 1e-5 absolute (as tests/test_torch_unet.py); the plain FF and
attention in fp32 1e-5 (summation order); bf16 attention against the Pallas
kernel within 1e-2 of max |out| (one bf16 rounding of p or of the output).
"""



import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_kernels.attention_pallas import fused_attention as pallas_attention
from test_torch_copies import port_cfg
from worddiffusion_tpu.configs.config import UNetConfig
from worddiffusion_tpu.models import convert as jconvert
from worddiffusion_tpu.models.attention import _attend
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.ops.ffn_pallas import _ln_ffn_reference, fits_vmem
from worddiffusion_tpu.ops.ffn_pallas import fused_ln_geglu_ffn as jax_fused
from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
from worddiffusion_tpu_torch.models.convert import (jax_unet_to_torch, port_unet_to_reference,
                                                    reference_unet_to_port, state_dict_to_torch)
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.ops import attention, ffn

torch.set_num_threads(2)

CFG = UNetConfig(
    model_channels=32, context_dim=32, num_heads=2, vocab_size=54, num_writers=8,
    max_seq_len=10, attn1_cross=True, dtype="float32", channel_mult=(1, 2),
)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, 8, 32, 4)).astype(np.float32),
        np.array([5, 50], np.int32)[:b],
        rng.integers(0, 53, (b, 10)).astype(np.int32),
        np.array([0, 3], np.int32)[:b],
    )


def _params(cfg, seed=3):
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), *_inputs())
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def test_unet_channel_mult_12_matches_jax_fp32():
    """The whole UNet at channel_mult (1, 2): the second level's ResBlocks
    widen 32 -> 64, its transformer and the middle block run at 64 wide (2
    heads of 32), the decoder's concats narrow back; eps against JAX's on the
    same converted parameters."""
    params = _params(CFG)
    inp = _inputs()
    want = np.asarray(jax.jit(JaxUNet(CFG).apply)(params, *inp))
    model = UNet(port_cfg(CFG))
    model.load_state_dict(state_dict_to_torch(jax_unet_to_torch(params, CFG)), strict=True)
    x, t, ctx, wid = inp
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx).long(),
                           torch.from_numpy(wid).long()).numpy()
    assert got.shape == (2, 8, 32, 4) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_jax_unet_to_torch_at_channel_mult_12():
    """The converter fills every tensor of the port's (1, 2) UNet, at its
    shape, with JAX's leaf (a Dense kernel transposed, a conv kernel HWIO ->
    OIHW): the second level's tensors are twice the first's width."""
    params = _params(CFG, seed=5)
    sd = jax_unet_to_torch(params, CFG)
    port = UNet(port_cfg(CFG)).state_dict()
    assert sorted(sd) == sorted(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    widths = {tuple(v.shape)[0] for k, v in sd.items() if k.endswith("norm3.weight")}
    assert widths == {32, 64}
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    converted = np.sort(np.concatenate([np.ravel(v) for v in sd.values()]))
    originals = np.sort(np.concatenate([np.ravel(v) for v in flat.values()]))
    # every converted value is one of JAX's (the converter moves, never computes)
    assert np.isin(converted, originals).all()


def test_reference_layout_at_channel_mult_12():
    """The reference (research PyTorch) layout at (1, 2): the port's
    ``port_unet_to_reference`` writes JAX's ``export_reference_unet`` keys and
    values, and ``reference_unet_to_port`` reads them back to the port's
    tensors, as JAX's ``convert_reference_unet`` reads them to its params."""
    params = _params(CFG, seed=6)
    port_sd = jax_unet_to_torch(params, CFG)
    want = jconvert.export_reference_unet(params, CFG)
    got = port_unet_to_reference(port_sd, CFG)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    back = reference_unet_to_port(got, CFG)
    assert sorted(back) == sorted(port_sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v, port_sd[k], err_msg=k)
    again = jax_unet_to_torch(jconvert.convert_reference_unet(want, CFG), CFG)
    for k, v in again.items():
        np.testing.assert_array_equal(v, port_sd[k], err_msg=k)


def _ffn_inputs(m, d, inner, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(m, d), gamma=1.0 + 0.1 * f(d), beta=0.1 * f(d),
                w1=f(d, 2 * inner) / np.sqrt(d), b1=0.02 * f(2 * inner),
                w2=f(inner, d) / np.sqrt(inner), b2=0.02 * f(d))


def test_plain_ffn_at_d640_matches_jax_fused_bf16():
    """d = 640, inner 2560, M = 64: the (1, 2) middle block's FF sub-layer,
    plain, against JAX's Pallas kernel in interpret mode, as JAX's own CPU
    tests run it, in bf16 (JAX's guard counts bf16 bytes: fp32 weights of
    this width do not fit its VMEM budget). The two round the hidden at
    different places -> a few bf16 ulps of the output (tests/test_torch_ffn.py)."""
    a = _ffn_inputs(64, 640, 2560)
    ja = {k: jnp.asarray(v, jnp.bfloat16 if k in ("x", "w1", "w2") else jnp.float32)
          for k, v in a.items()}
    want = np.asarray(jax_fused(**ja).astype(jnp.float32))
    got = ffn.ln_geglu_ffn_reference(**{
        k: torch.from_numpy(v).to(torch.bfloat16 if k in ("x", "w1", "w2") else torch.float32)
        for k, v in a.items()}).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-2)


def test_plain_ffn_at_d640_matches_jax_reference_fp32():
    """The same sub-layer in fp32 against JAX's plain ``_ln_ffn_reference``
    (the function the Pallas kernel's custom_vjp is held to): summation
    order only -> 1e-5."""
    a = _ffn_inputs(64, 640, 2560, seed=1)
    want = np.asarray(_ln_ffn_reference(**{k: jnp.asarray(v) for k, v in a.items()}))
    got = ffn.ln_geglu_ffn_reference(**{k: torch.from_numpy(v) for k, v in a.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", range(64, 1025, 64))
def test_kernel_takes_equals_jax_fits_vmem(d):
    """The port's width rule is JAX's guard: true for d = 64k up to 768,
    false from 832 on."""
    assert ffn.kernel_takes(d, 4 * d) == fits_vmem(d, 4 * d) == (d <= 768)


def test_ffn_kernel_width_check():
    """The forward kernel's operand check (the same on any device) takes
    d = 64k from 64 to 768 and refuses every other d, naming the range; it
    no longer points the user at use_pallas_ffn=False."""
    widths = (64, 768, 64)

    def operands(d, inner):
        bf, f32 = torch.bfloat16, torch.float32
        return (torch.zeros(4, d, dtype=bf), torch.zeros(d, dtype=f32), torch.zeros(d, dtype=f32),
                torch.zeros(2 * inner, d, dtype=bf), torch.zeros(2 * inner, dtype=f32),
                torch.zeros(d, inner, dtype=bf))

    for d in (64, 320, 640, 768):
        assert ffn._check_operands(*operands(d, 4 * d), widths) == (d, 4 * d)
    for d in (32, 100, 336, 700, 832):
        with pytest.raises(ValueError, match="64 <= d <= 768") as e:
            ffn._check_operands(*operands(d, 256), widths)
        assert "use_pallas_ffn" not in str(e.value)


@pytest.mark.parametrize("d,takes", [(64, True), (320, True), (640, True), (768, True),
                                     (32, False), (100, False), (336, False), (832, False)])
def test_backward_width_takes_the_forward_widths(d, takes):
    """B.3 takes every d = 64k from 64 to 768, the forward kernel's widths, so
    training at (1, 2) reaches it at d = 640; any other d raises, naming the
    range."""
    if takes:
        ffn.check_backward_width(d)
    else:
        with pytest.raises(ValueError, match=r"d = 64k from 64 to 768, got d = " + str(d)):
            ffn.check_backward_width(d)


@pytest.mark.parametrize("dim", [64, 832])
def test_block_routes_ff_by_the_width_rule(dim):
    """A block whose FF the kernel does not take (d >= 832, JAX's unfused
    path) runs the plain FF and counts it in ``ffn.plain_calls``; a block at
    d = 64 goes to ``ffn_sublayer`` (the plain version on the CPU, uncounted).
    Both give the plain sub-layer's numbers."""
    torch.manual_seed(0)
    block = BasicTransformerBlock(dim, 2, dim // 2, context_dim=16, dtype=torch.float32).eval()
    x = torch.randn(1, 6, dim)
    ctx = torch.randn(1, 5, 16)
    before = ffn.plain_calls
    with torch.no_grad():
        out = block(x, ctx)
        block.use_pallas_ffn = False
        plain = block(x, ctx)
    assert ffn.plain_calls - before == (1 if dim == 832 else 0)
    if dim == 832:  # the same plain function
        torch.testing.assert_close(out, plain, rtol=0, atol=0)
    else:  # the dispatcher's plain version reads contiguous weight copies
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-6)


def _qkv(nq, nk, d, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk))


@pytest.mark.parametrize("d", [160, 256])
def test_attention_wide_heads_match_jax_attend_fp32(d):
    """Head widths 160 (the (1, 2) middle block's 4 heads of 640) and 256:
    the plain attention against the UNet's ``_attend``."""
    q, k, v = _qkv(64, 42, d)
    scale = d ** -0.5
    heads_last = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    want = np.asarray(_attend(heads_last(q), heads_last(k), heads_last(v), scale))
    got = attention.attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [160, 256])
def test_attention_wide_heads_match_pallas_kernel_bf16(d):
    q, k, v = _qkv(64, 42, d, b=1, seed=1)
    scale = d ** -0.5
    want = np.asarray(pallas_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                       scale).astype(jnp.float32))
    got = attention.attention_reference(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                        scale).float().numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_attention_width_check():
    """The attention kernel's operand check takes D % 16 == 0 up to 256."""
    for d in (16, 80, 144, 160, 256):
        q = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
        attention._check_operands(q, q, q, 256)
    for d in (264, 272, 100):
        q = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="D <= 256"):
            attention._check_operands(q, q, q, 256)
