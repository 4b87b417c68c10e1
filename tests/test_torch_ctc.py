"""The port's CTC loss and CTC aux head against the JAX package's:
``ops.ctc.ctc_loss`` (value and d/dlogits) against ``optax.ctc_loss``
with blank 0 (the aux head's) and blank 1 (the recognizer's), padded
labels and repeated characters; against ``F.ctc_loss`` on the CPU; what
each gives on labels no alignment can produce; and
``models.ctc_head.CTCHead`` against the JAX ``CTCHead`` with both norms,
on the same weights through ``jax_unet_extras_to_torch``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from worddiffusion_tpu.configs.config import UNetConfig
from worddiffusion_tpu.models.ctc_head import CTCHead as JaxCTCHead
from worddiffusion_tpu_torch.models.convert import jax_unet_extras_to_torch, state_dict_to_torch
from worddiffusion_tpu_torch.models.ctc_head import CTCHead
from worddiffusion_tpu_torch.ops.ctc import LOG_EPSILON, ctc_loss

torch.set_num_threads(1)


def _case(blank: int, seed: int = 0, b: int = 5, t: int = 40, k: int = 14, n: int = 7):
    """Seeded logits and labels right-padded to n: lengths n, a middle
    one, 0 and 1, one row with repeated characters; no label is the blank."""
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, t, k))).astype(np.float32)
    labels = rng.integers(0, k - 1, (b, n)).astype(np.int32)
    labels = np.where(labels >= blank, labels + 1, labels)  # skip the blank id
    labels[1, 1:4] = labels[1, 0]  # "aaaa"
    lens = np.array([n, 4, 0, 1, 5], np.int32)[:b]
    labels[np.arange(n)[None] >= lens[:, None]] = 0  # padding holds 0, as encode_ocr_labels'
    return logits, labels, lens


def _optax(logits, labels, lens, blank):
    pad = (np.arange(labels.shape[1])[None] >= lens[:, None]).astype(np.float32)
    return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), labels, pad, blank_id=blank)


@pytest.mark.parametrize("blank", [0, 1])
def test_ctc_loss_and_grad_match_optax(blank):
    """Per-sequence loss within 1e-5 relative; d(sum of losses)/dlogits
    within 5e-5 absolute: the gradient is a softmax minus a posterior
    (entries in [-1, 1]), and the posterior is exp(alpha + beta - loss)
    of log-space values near 100, each known to an fp32 ulp (8e-6) in
    each framework's summation order. Two backward passes bitwise equal."""
    logits, labels, lens = _case(blank)
    want = np.asarray(_optax(logits, labels, lens, blank))
    want_g = np.asarray(jax.grad(lambda lg: _optax(lg, labels, lens, blank).sum())(logits))

    def loss_and_grad():
        lt = torch.from_numpy(logits).requires_grad_()
        loss = ctc_loss(lt, torch.from_numpy(labels), torch.from_numpy(lens), blank)
        loss.sum().backward()
        return loss.detach(), lt.grad

    got, got_g = loss_and_grad()
    assert got.shape == (5,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=5e-5)
    again, again_g = loss_and_grad()
    assert torch.equal(got, again) and torch.equal(got_g, again_g)


@pytest.mark.parametrize("blank", [0, 1])
def test_ctc_loss_matches_torch_ctc_loss(blank):
    """F.ctc_loss with reduction="none" on the log-softmax (the plain
    PyTorch version, CPU): the same per-sequence values, 1e-5 relative. Its
    default reduction "mean" divides each by its label length, which the
    JAX step does not."""
    logits, labels, lens = _case(blank, seed=1)
    lt = torch.from_numpy(logits)
    got = ctc_loss(lt, torch.from_numpy(labels), torch.from_numpy(lens), blank)
    want = F.ctc_loss(lt.log_softmax(-1).transpose(0, 1), torch.from_numpy(labels).long(),
                      torch.full((5,), 40), torch.from_numpy(lens).long(), blank=blank,
                      reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    mean = F.ctc_loss(lt.log_softmax(-1).transpose(0, 1), torch.from_numpy(labels).long(),
                      torch.full((5,), 40), torch.from_numpy(lens).long(), blank=blank)
    assert abs(mean.item() - got.mean().item()) > 1.0


def test_ctc_loss_on_labels_no_alignment_produces():
    """Five frames for "abbb" (a blank is needed between repeats: 6 frames):
    optax and the port give a large finite loss (of the order of
    -LOG_EPSILON) and finite gradients, F.ctc_loss gives inf."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((1, 5, 6)).astype(np.float32)
    labels, lens = np.array([[1, 2, 2, 2]], np.int32), np.array([4], np.int32)
    want = float(_optax(logits, labels, lens, 0)[0])
    lt = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(lt, torch.from_numpy(labels), torch.from_numpy(lens), 0)
    got.sum().backward()
    assert -LOG_EPSILON / 2 < want < -10 * LOG_EPSILON
    assert -LOG_EPSILON / 2 < got.item() < -10 * LOG_EPSILON
    assert bool(torch.isfinite(lt.grad).all())
    ref = F.ctc_loss(lt.detach().log_softmax(-1).transpose(0, 1), torch.from_numpy(labels).long(),
                     torch.tensor([5]), torch.from_numpy(lens).long(), blank=0, reduction="none")
    assert torch.isinf(ref).all()


@pytest.mark.parametrize("norm", ["group", "none"])
def test_ctc_head_matches_jax(norm):
    """The head alone on eps-shaped input [B, 8, 32, 4], fp32: logits [256,
    B, K] within 1e-4 relative + 1e-5 of their max. The keys are the
    reference CTCtopC's (the JAX converter reads them)."""
    x = np.random.default_rng(3).standard_normal((2, 8, 32, 4)).astype(np.float32)
    head = JaxCTCHead(hidden=64, layers=3, nclasses=20, norm=norm, dtype=jnp.float32)
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape) + (s.shape == (64,))).astype(np.float32),
        shapes)
    want = np.asarray(head.apply(params, x))

    cfg = UNetConfig(ocr_head=True, ocr_hidden=64, ocr_classes=20, ocr_norm=norm)
    sd = jax_unet_extras_to_torch({"params": {"aux_head": params["params"]}}, cfg)
    port = CTCHead(4, 64, 3, 20, norm)
    port.load_state_dict(state_dict_to_torch({k[len("auxhead."):]: v for k, v in sd.items()}),
                         strict=True)
    keys = {"temporal_i.0", "temporal_m.0.0", "temporal_m.1.0", "temporal_m.2.0",
            "temporal_o", "lin1", "lin2"}
    if norm == "group":
        keys |= {"temporal_i.1", "temporal_m.0.1", "temporal_m.1.1", "temporal_m.2.1"}
    assert {k.rsplit(".", 1)[0] for k in port.state_dict()} == keys
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (256, 2, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
