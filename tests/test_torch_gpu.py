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


@pytest.mark.parametrize("m", [16 * 256, 16 * 64, 1000])
def test_kernel_matches_plain(cuda, m):
    """bf16: the kernel keeps the hidden in fp32, the plain version
    rounds it -> within 1% of max |out| (a few bf16 ulps)."""
    t = _inputs(m, cuda)
    before = ffn.launches
    got = ffn.fused_ln_geglu_ffn(**t)
    torch.cuda.synchronize()
    assert ffn.launches == before + 1
    want = ffn.ln_geglu_ffn_reference(**t)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.parametrize("bad", ["fp32_x", "strided_x", "w1_layout", "narrow_inner"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    t = _inputs(64, cuda)
    if bad == "fp32_x":
        t["x"] = t["x"].float()
    elif bad == "strided_x":
        t["x"] = torch.cat([t["x"], t["x"]], dim=1)[:, ::2]
    elif bad == "w1_layout":
        t["w1"] = t["w1"].t().contiguous().t()
    else:
        t["w1"], t["b1"] = t["w1"][:, :2 * 96].contiguous(), t["b1"][:2 * 96].contiguous()
        t["w2"] = t["w2"][:96].contiguous()
    before = ffn.launches
    with pytest.raises(ValueError):
        ffn.fused_ln_geglu_ffn(**t)
    assert ffn.launches == before
