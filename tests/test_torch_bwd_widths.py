"""The FF backward (B.3) at every width the forward takes, and the fold
(B.7/B.8) at C = 640: the plain versions the CUDA kernels are held to on
the card, against the JAX package at small sizes on the CPU.

B.3's plain backward against JAX's backward kernel ``_ln_ffn_bwd_pallas``
in interpret mode, as the JAX package's own tests run it, at the widths where
that kernel fits its VMEM budget (``pick_block_m_bwd``: d = 64 and 192 in
fp32; d = 512 only with bf16 operands, whose bytes it counts), and against
the backward JAX's model trains with at every width, ``jax.vjp`` of the
unfused ``_ln_ffn_reference`` (``ffn_pallas.py::_ln_ffn_bwd``), at d = 640
and 768. The fold's plain version against B.8's and B.7's Pallas kernels in
interpret mode at channel_mult (1, 2)'s middle-block width, C = 640, with
4 heads over the 42 characters. Inputs are seeded numpy handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_kernels import attn_fold_pallas as b7
from bench_kernels import attn_fold_sublayer_pallas as b8
from worddiffusion_tpu.ops.ffn_pallas import (_ln_ffn_bwd_pallas, _ln_ffn_reference,
                                              pick_block_m_bwd)
from worddiffusion_tpu_torch.ops import ffn, fold_attention

torch.set_num_threads(2)

GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
ORDER = ("x", "dy", "gamma", "beta", "w1", "b1", "w2")


def _bwd_inputs(m, d, seed):
    """x, dy [m, d] and the sub-layer's parameters at inner = 4d, scaled
    as the model's (unit residual stream, lecun weights)."""
    inner = 4 * d
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(m, d), dy=f(m, d), gamma=1.0 + 0.1 * f(d), beta=0.1 * f(d),
                w1=f(d, 2 * inner) / np.sqrt(d), b1=0.02 * f(2 * inner),
                w2=f(inner, d) / np.sqrt(inner))


def _close(got, want, tol):
    """Each gradient within ``tol`` of its largest |JAX| entry."""
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w, np.float32).reshape(tuple(g.shape))
        assert bool(torch.isfinite(g).all()), name
        err = np.abs(g.float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("d,dtype", [(64, "float32"), (192, "float32"), (512, "bfloat16")])
def test_bwd_reference_matches_jax_kernel(d, dtype):
    """M = 23 (JAX pads it to its row tile): fp32, the same arithmetic summed
    in another order -> 1e-4 of each gradient's max; bf16 (d = 512, where
    the kernel fits only with 2-byte operands) rounds dact, dh and dxn at
    other places -> 2%, as tests/test_torch_ffn.py."""
    low = ("x", "dy", "w1", "w2") if dtype == "bfloat16" else ()
    assert pick_block_m_bwd(d, 4 * d, 23, dtype_bytes=2 if low else 4) is not None
    a = _bwd_inputs(23, d, seed=d)
    want = _ln_ffn_bwd_pallas(*(jnp.asarray(a[k], jnp.bfloat16 if k in low else jnp.float32)
                                for k in ORDER), interpret=True)
    got = ffn.ln_geglu_ffn_bwd_reference(*(
        torch.from_numpy(a[k]).to(torch.bfloat16 if k in low else torch.float32) for k in ORDER))
    _close(got, want, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("d", [640, 768])
def test_bwd_reference_matches_jax_recompute_backward(d):
    """d = 640 (channel_mult (1, 2)'s middle block) and 768 (the widest the
    kernels take), where JAX's backward kernel does not fit and its model
    trains through the recompute: fp32, M = 17, 1e-4 of each gradient's max
    (summation order only; the port's plain backward keeps JAX's layout:
    dw1 [d, 2 inner], dw2 [inner, d])."""
    a = _bwd_inputs(17, d, seed=d + 1)
    b2 = np.zeros(d, np.float32)
    args = [jnp.asarray(a[k]) for k in ("x", "gamma", "beta", "w1", "b1", "w2")]
    _, vjp = jax.vjp(functools.partial(_ln_ffn_reference, eps=1e-5), *args, jnp.asarray(b2))
    dx, dg, dbt, dw1, db1, dw2, db2 = vjp(jnp.asarray(a["dy"]))
    got = ffn.ln_geglu_ffn_bwd_reference(*(torch.from_numpy(a[k]) for k in ORDER))
    _close(got, (dx, dg, dbt, dw1, db1, dw2, db2), 1e-4)


@pytest.mark.parametrize("d", list(range(64, 769, 64)))
def test_check_backward_width_takes_every_forward_width(d):
    """The backward takes exactly the forward kernel's widths: d = 64k up to
    768, where ``kernel_takes(d, 4d)`` sends the FF sub-layer to the kernels."""
    assert ffn.kernel_takes(d, 4 * d)
    ffn.check_backward_width(d)


# C = 640, 4 heads over the 42 characters: the (1, 2) middle block's folds
FB, FC, FH, FL = 2, 640, 4, 42
FOLD_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fold_inputs(n, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=r(FB, n, FC), gamma=1 + 0.1 * r(FC), beta=0.1 * r(FC),
                wt4=r(FB, FH, FC, FL) / FC ** 0.5, vw4=r(FB, FH, FL, FC), bo=0.1 * r(FC))


def _fold_check(got, want, dtype_name):
    """fp32: summation order only -> 1e-5 relative; bf16: one bf16 rounding
    of p or of the output apart -> 2% of max |JAX| (tests/test_torch_fold_attention.py)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert np.abs(got - want).max() <= 2e-2 * scale


@pytest.mark.parametrize("dtype_name", sorted(FOLD_DTYPES))
@pytest.mark.parametrize("layout", ["b7", "b8"])
def test_fold_plain_matches_pallas_kernels_at_c640(dtype_name, layout):
    """N = 64 (the middle block's tokens), per-head folds for B.8 and the
    same folds in B.7's [B, C, H*L] / [B, H*L, C] layout."""
    jdt, tdt = FOLD_DTYPES[dtype_name]
    a = _fold_inputs(64, seed=11)
    vecs = [torch.from_numpy(a[k]) for k in ("gamma", "beta", "bo")]
    x = torch.from_numpy(a["x"]).to(tdt)
    if layout == "b8":
        assert b8.pick_block_b(FB, 64, FC, FH, FL, 8) is not None  # the kernel, not its fallback
        want = b8.fused_fold_attention(jnp.asarray(a["x"], jdt), jnp.asarray(a["wt4"], jdt),
                                       jnp.asarray(a["vw4"], jdt), a["gamma"], a["beta"],
                                       a["bo"], interpret=True)
        got = fold_attention.fold_attention_heads(
            x, torch.from_numpy(a["wt4"]).to(tdt), torch.from_numpy(a["vw4"]).to(tdt), *vecs)
    else:
        wt = a["wt4"].transpose(0, 2, 1, 3).reshape(FB, FC, FH * FL)
        vw = a["vw4"].reshape(FB, FH * FL, FC)
        want = b7._fold_attn_pallas(jnp.asarray(a["x"], jdt), a["gamma"], a["beta"],
                                    jnp.asarray(wt, jdt), jnp.asarray(vw, jdt), a["bo"], FH,
                                    interpret=True)
        got = fold_attention.fold_attention(x, torch.from_numpy(wt).to(tdt),
                                            torch.from_numpy(vw).to(tdt), *vecs, FH)
    assert got.dtype == tdt and got.shape == (FB, 64, FC)
    _fold_check(got, want, dtype_name)
