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
