"""``UNetConfig.remat``: each transformer block checkpointed while autograd
records (``models.attention.SpatialTransformer``), against the port without
it and against the JAX package's ``nn.remat`` on the CPU.

- A tiny port UNet (fp32 and bf16; cross-attention, PHOSC's self-attention
  layout and the fold): the output and every parameter gradient bitwise
  equal with remat on and off, since the recompute runs the same
  deterministic arithmetic on the same inputs and non-reentrant checkpoint
  keeps autograd's graph. The recompute runs each block's attention and FF
  (or fold) forward a second time in the backward; without a gradient (under
  ``torch.no_grad``, as sampling runs) nothing is checkpointed.
- The port with remat against JAX's UNet with remat (jitted ``jax.grad``,
  as ``tests/test_misc_paths.py::test_remat_forward_and_grad_match``) in
  fp32: the output within 1e-4 relative and 1e-5 absolute, as
  ``test_torch_unet.py::test_unet_matches_jax_fp32``; each gradient within
  1e-4 of its largest entry, floored at 1e-2 of the largest anywhere, as
  ``test_torch_train.py::test_train_step_matches_jax``.
- Two Trainer steps with remat bitwise equal to two without: parameters,
  EMA and AdamW's moments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.models.unet import UNet as JaxUNet
from test_torch_copies import port_cfg
from test_torch_train import _dataset, _state_equal, tiny_exp
from test_torch_unet import CFG, _inputs, _params, _port
from worddiffusion_tpu_torch.models import attention as models_attention
from worddiffusion_tpu_torch.models.convert import jax_unet_to_torch
from worddiffusion_tpu_torch.models.layers import init_weights_
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention
from worddiffusion_tpu_torch.train import loop
from worddiffusion_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

CASES = {
    "fp32": dict(),
    "bf16": dict(dtype="bfloat16"),
    "self_attention": dict(dtype="bfloat16", attn1_cross=False),
    "fold": dict(dtype="bfloat16", attn_fold_context=True),
}


def _tensors(inp):
    x, t, ctx, wid = inp
    return (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx).long(),
            torch.from_numpy(wid).long())


class _Counts:
    """Forward calls of the block's sub-layers (the Functions' CPU bodies)
    and of the checkpoint, from when it is made."""

    def __init__(self, mp):
        self.n = dict(attention=0, ffn=0, fold=0, checkpoint=0)
        for key, module, name in ((("attention", attention, "_attend"), ("ffn", ffn, "_sublayer"),
                                   ("fold", fold_attention, "_fold"),
                                   ("checkpoint", models_attention, "checkpoint"))):
            mp.setattr(module, name, self._counted(key, getattr(module, name)))

    def _counted(self, key, fn):
        def counted(*a, **k):
            self.n[key] += 1
            return fn(*a, **k)
        return counted


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_forward_and_gradients_bitwise(case):
    cfg = dataclasses.replace(CFG, **CASES[case])
    inp = _tensors(_inputs())
    runs = {}
    for remat in (False, True):
        model = init_weights_(UNet(port_cfg(dataclasses.replace(cfg, remat=remat))), seed=1,
                              zero_init=False)
        with pytest.MonkeyPatch.context() as mp:
            counts = _Counts(mp)
            out = model(*inp)
            forward = dict(counts.n)
            out.float().square().sum().backward()
            backward = {k: v - forward[k] for k, v in counts.n.items()}
        with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
            counts = _Counts(mp)
            sampled = model(*inp)
        assert torch.equal(sampled, out.detach()) and counts.n["checkpoint"] == 0
        runs[remat] = (out.detach(), {k: p.grad for k, p in model.named_parameters()},
                       forward, backward)
    (out0, g0, fwd0, bwd0), (out1, g1, fwd1, bwd1) = runs[False], runs[True]
    assert torch.equal(out0, out1)
    assert g0.keys() == g1.keys() and all(g0[k] is not None for k in g0)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert any(g0[k].abs().max() > 0 for k in g0 if "transformer_blocks" in k)
    # 4 blocks of the tiny UNet: 2 attentions (or folds) and 1 FF each
    sub = "fold" if cfg.attn_fold_context else "attention"
    assert (fwd0[sub], fwd0["ffn"], fwd0["checkpoint"]) == (8, 4, 0)
    assert (fwd1[sub], fwd1["ffn"], fwd1["checkpoint"]) == (8, 4, 4)
    # the backward recomputes every block's sub-layers once, and only with remat
    assert (bwd0[sub], bwd0["ffn"]) == (0, 0)
    assert (bwd1[sub], bwd1["ffn"], bwd1["checkpoint"]) == (8, 4, 0)


def test_remat_matches_jax_remat():
    cfg = dataclasses.replace(CFG, remat=True)
    params = _params(cfg)
    x, t, ctx, wid = _inputs()
    jmodel = JaxUNet(cfg)

    def loss(p):
        return jnp.sum(jmodel.apply(p, x, t, ctx, wid) ** 2)

    want_out = np.asarray(jax.jit(jmodel.apply)(params, x, t, ctx, wid))
    want = jax_unet_to_torch(jax.jit(jax.grad(loss))(params), cfg)
    model = _port(cfg, params).train()
    out = model(*_tensors((x, t, ctx, wid)))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-4, atol=1e-5)
    out.square().sum().backward()
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 1e-2 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(named[k].grad.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


def test_trainer_steps_with_remat_are_bitwise(tmp_path, monkeypatch):
    """Every layer random (the zero-initialised output convs too), so that
    the first step's gradient reaches every block."""
    monkeypatch.setattr(loop, "init_weights_",
                        lambda m, seed=0, zero_init=True: init_weights_(m, seed, zero_init=False))
    ds = _dataset()
    states = []
    for remat in (False, True):
        exp = port_cfg(tiny_exp(tmp_path / f"remat{int(remat)}"))
        exp = exp.replace(unet=dataclasses.replace(exp.unet, remat=remat))
        states.append(Trainer(exp, ds, device="cpu").run(epochs=1, max_steps=2))
    assert states[0].step == states[1].step == 2
    assert _state_equal(states[0], states[1])
    init = Trainer(port_cfg(tiny_exp(tmp_path / "init")), ds, device="cpu").init_state()
    moved = [not torch.equal(a, b) for (n, a), b in
             zip(states[0].model.named_parameters(), init.model.parameters())
             if "transformer_blocks" in n]
    assert all(moved), "a block parameter did not move"
