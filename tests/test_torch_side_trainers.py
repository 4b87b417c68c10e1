"""The side-model trainers against the JAX ones, and their files read back
by the CLIs that consume them, on the CPU at narrow widths.

- OCR (``cli/train_ocr.train_step``): one step of the narrow recognizer,
  fp32, with JAX's dropout mask handed in, against the JAX CLI's step
  (``optax.chain(clip_by_global_norm(1.0), adam(lr))``, jitted): the loss
  within 1e-5, every gradient within 1e-3 of its leaf's largest, the
  parameters as Adam's first step allows (a gradient clear of the
  tolerance moves within 1e-3 lr of JAX's; any within 2 lr).
- VAE (``cli/train_vae.train_step``): one step of a narrow AutoencoderKL,
  fp32, with JAX's posterior noise handed in, against
  ``optax.adamw(lr, weight_decay=1e-5)`` on L1 + MSE + kl_weight x KL: the
  same tolerances.
- The CLIs: ``train_ocr``'s ``ocr.pt`` loads in the regeneration and
  evaluation CLIs; ``train_vae``'s ``vae.pt`` in the cache and train CLIs,
  its ``recon_grid.png`` decodes; ``train_style``'s ``style_dict.npz``
  conditions the train CLI and its ``best_params.pkl`` is the JAX
  encoder's (the JAX ``StyleEncoder`` applies it and gives the port's style
  vectors within 1e-4). ``metrics.json`` has the JAX CLIs' keys
  (``worddiffusion_tpu/cli/train_ocr.py:153-162``, ``train_vae.py:327-336``).
"""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from worddiffusion_tpu.models import ocr as jocr
from worddiffusion_tpu.models import style as jstyle
from worddiffusion_tpu.models import vae as jvae
from worddiffusion_tpu.ops.ctc import ctc_loss as jctc_loss
from test_torch_copies import port_cfg
from test_torch_train import tiny_exp
from test_torch_vae_ocr import OCR_WIDTHS, PORT_VAE_CFG, VAE_CFG, _random_tree, _vae_params
from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
from worddiffusion_tpu_torch.cli import evaluate as eval_cli
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.cli import train_ocr, train_style, train_vae
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data.alphabets import OCR_ENG, OCR_ENG_BLANK
from worddiffusion_tpu_torch.data.png import read_png
from worddiffusion_tpu_torch.models import ocr, style
from worddiffusion_tpu_torch.models.convert import (jax_ocr_to_torch, jax_vae_to_torch,
                                                    read_params_pickle, state_dict_to_torch)
from worddiffusion_tpu_torch.models.vae import AutoencoderKL
from worddiffusion_tpu_torch.ops.ctc import encode_ocr_labels

torch.set_num_threads(2)
FP32_TOL = 1e-3


def _check_step(port_grads, port_after, grads, after, lr):
    """Gradients within FP32_TOL of each leaf's largest (at least 1e-3 of the
    largest gradient of any leaf: a conv bias that a one-channel group's
    GroupNorm follows has an exact zero gradient, which both sides give
    as fp32 noise); the updated parameters within 1e-3 lr where the
    gradient is clear of that tolerance, within 2 lr anywhere (Adam's first
    step is about lr x sign(g))."""
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in grads)
    for gp, g, a, b in zip(port_grads, grads, port_after, after):
        g, b = np.asarray(g), np.asarray(b)
        scale = max(float(np.abs(g).max()), 1e-3 * gmax)
        assert float(np.abs(np.asarray(gp) - g).max()) <= FP32_TOL * scale
        clear = np.abs(g) >= 10 * FP32_TOL * scale
        assert np.abs(a - b).max() <= 2 * lr
        if clear.any():
            assert np.abs(a - b)[clear].max() <= 1e-3 * lr


def test_ocr_train_step_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 64, 32, 1)).astype(np.float32)
    words = ["the", "of", "and"]
    labels, lens = encode_ocr_labels(words, OCR_ENG, 42)
    jm = jocr.CTCRecognizer(num_classes=len(OCR_ENG), widths=OCR_WIDTHS, dtype=jnp.float32)
    params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 4, scale=0.2)
    drng = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    masks = []
    bernoulli = jax.random.bernoulli
    with pytest.MonkeyPatch.context() as mp:  # JAX's dropout mask, drawn op by op
        mp.setattr(jax.random, "bernoulli",
                   lambda *a, **k: masks.append(bernoulli(*a, **k)) or masks[-1])
        jm.apply(params, x, deterministic=False, rngs={"dropout": drng})
    assert len(masks) == 1 and masks[0].shape == (3, 8, OCR_WIDTHS[-1])
    lr = 3e-4
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))

    @jax.jit
    def step(p):
        def loss_fn(q):
            logits = jm.apply(q, x, deterministic=False, rngs={"dropout": drng})
            return jnp.mean(jctc_loss(logits, labels, lens, blank_id=OCR_ENG_BLANK))
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates), optax.global_norm(grads)

    loss, grads, after, norm = jax.device_get(step(params))
    assert float(norm) > 1.0  # the clip engages
    m = ocr.CTCRecognizer(num_classes=len(OCR_ENG), widths=OCR_WIDTHS, dtype=torch.float32)
    m.load_state_dict(state_dict_to_torch(jax_ocr_to_torch(params)), strict=True)
    opt = train_ocr.make_optimizer(m, lr)
    got = train_ocr.train_step(m, opt, torch.from_numpy(x), torch.from_numpy(labels),
                               torch.from_numpy(lens), OCR_ENG_BLANK,
                               keep=torch.from_numpy(np.asarray(masks[0])))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    grads_sd = jax_ocr_to_torch(grads)
    after_sd = jax_ocr_to_torch(after)
    named = dict(m.named_parameters())
    assert sorted(named) == sorted(grads_sd)
    # the step leaves the clipped gradients (g / norm): unclip with JAX's norm
    _check_step([named[k].grad.numpy() * float(norm) for k in grads_sd],
                [named[k].detach().numpy() for k in grads_sd],
                [grads_sd[k] for k in grads_sd], [after_sd[k] for k in grads_sd], lr)


def test_ocr_dropout_is_training_only():
    m = ocr.CTCRecognizer(widths=OCR_WIDTHS, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 64, 32, 1))
                         .astype(np.float32))
    with torch.no_grad():
        a, b = m(x), m(x, deterministic=True)
        c = m(x, deterministic=False, generator=torch.Generator().manual_seed(0))
        d = m(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        m(x, deterministic=False)


def test_clip_matches_optax():
    """optax's rule: unchanged below the norm, scaled to it above; no
    epsilon on the norm."""
    rng = np.random.default_rng(2)
    for scale in (0.01, 10.0):
        gs = [scale * rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update(gs, None)
        ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = train_ocr.clip_by_global_norm_(ps, 1.0)
        assert np.isclose(float(norm), float(optax.global_norm(gs)), rtol=1e-6)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_vae_train_step_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    params = _vae_params(seed=6)
    jm = jvae.AutoencoderKL(VAE_CFG)
    srng = jax.random.PRNGKey(9)
    lr, kl_w = 1e-4, 1e-2
    tx = optax.adamw(lr, weight_decay=1e-5)

    @jax.jit
    def step(p):
        def loss_fn(q):
            recon, mean, logvar = jm.apply(q, x, srng)
            recon = recon.astype(jnp.float32)
            l1 = jnp.mean(jnp.abs(recon - x))
            mse = jnp.mean((recon - x) ** 2)
            kl = -0.5 * jnp.mean(1 + logvar - mean ** 2 - jnp.exp(logvar))
            return l1 + mse + kl_w * kl, (mse, kl, mean)
        (loss, (mse, kl, mean)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, mse, kl, mean, grads, optax.apply_updates(p, updates)

    loss, mse, kl, mean, grads, after = jax.device_get(step(params))
    noise = np.asarray(jax.random.normal(srng, mean.shape, jnp.float32))
    vae = AutoencoderKL(PORT_VAE_CFG, with_encoder=True)
    vae.load_state_dict(state_dict_to_torch(jax_vae_to_torch(params, PORT_VAE_CFG)), strict=True)
    opt = train_vae.make_optimizer(vae, lr)
    got = train_vae.train_step(vae, opt, torch.from_numpy(x), kl_w, noise=torch.from_numpy(noise))
    for ours, theirs in zip(got, (loss, mse, kl)):
        assert abs(float(ours) - float(theirs)) <= 1e-5 * abs(float(theirs))
    grads_sd = jax_vae_to_torch(grads, PORT_VAE_CFG)
    after_sd = jax_vae_to_torch(after, PORT_VAE_CFG)
    named = dict(vae.named_parameters())
    assert sorted(named) == sorted(grads_sd)
    _check_step([named[k].grad.numpy() for k in grads_sd],
                [named[k].detach().numpy() for k in grads_sd],
                [grads_sd[k] for k in grads_sd], [after_sd[k] for k in grads_sd], lr)


def _narrow_ocr(mp):
    mp.setattr(ocr, "CTCRecognizer", functools.partial(ocr.CTCRecognizer, widths=OCR_WIDTHS,
                                                       dtype=torch.float32))


def test_train_ocr_cli_writes_what_regenerate_and_evaluate_read(tmp_path, monkeypatch):
    _narrow_ocr(monkeypatch)
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    out = train_ocr.main(["--synthetic", "1", "--vocab_size", "3", "--samples_per_word", "2",
                          "--batch_size", "2", "--epochs", "2", "--eval_renders", "1",
                          "--save_dir", str(tmp_path / "ocr"), "--device", "cpu"])
    assert [h["steps"] for h in out["history"]] == [3, 3]
    metrics = json.loads((tmp_path / "ocr" / "metrics.json").read_text())
    assert sorted(metrics) == sorted(["heldout_exact_match", "eval_images", "vocab_size",
                                      "epochs", "train_samples"])
    assert metrics["eval_images"] == 3 and metrics["train_samples"] == 6
    pt = str(tmp_path / "ocr" / "ocr.pt")
    gt = tmp_path / "g.filter27"
    gt.write_text("000,a01-000u-00 the\n")
    regen, _ = regen_cli.build(regen_cli.build_parser().parse_args([
        "--preset", "tiny", "--gt_file", str(gt), "--ocr_pt", pt, "--device", "cpu"]))
    sd = torch.load(pt, weights_only=True)
    assert all(torch.equal(p, sd[k]) for k, p in regen.sampler.ocr_apply.state_dict().items())
    # the evaluation CLI reads it too (generated words parsed from the names)
    from worddiffusion_tpu_torch.data.synthetic import render_word
    from worddiffusion_tpu_torch.utils.images import encode_png

    for d in ("real", "fake"):
        (tmp_path / d).mkdir()
        for i, w in enumerate(["the", "of"]):
            (tmp_path / d / f"{i:05d}_3_{w}.png").write_bytes(encode_png(render_word(w, seed=i)))
    res = eval_cli.main(["--real_dir", str(tmp_path / "real"), "--fake_dir",
                         str(tmp_path / "fake"), "--ocr_pt", pt, "--device", "cpu"])
    assert set(res) == {"fid_style_encoder", "ocr_exact_match"}
    assert 0.0 <= res["ocr_exact_match"] <= 1.0


def test_train_vae_cli_writes_what_cache_and_train_read(tmp_path, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    out = train_vae.main(["--preset", "tiny", "--synthetic", "1", "--vocab_size", "2",
                          "--samples_per_word", "2", "--batch_size", "2", "--epochs", "1",
                          "--log_every", "1", "--save_dir", str(tmp_path / "vae"),
                          "--device", "cpu"])
    metrics = json.loads((tmp_path / "vae" / "metrics.json").read_text())
    assert sorted(metrics) == sorted(["train_mse_last", "heldout_mse", "heldout_psnr_db",
                                      "steps", "train_images"])
    assert metrics["steps"] == 2 and np.isfinite(metrics["heldout_psnr_db"])
    grid = read_png(str(tmp_path / "vae" / "recon_grid.png"))
    assert grid.shape == (8 * 64, 2 * 256, 3)
    pt = str(tmp_path / "vae" / "vae.pt")
    cache = cache_cli.main(["--preset", "tiny", "--synthetic", "1", "--vocab_size", "2",
                            "--samples_per_word", "1", "--vae_pt", pt, "--out",
                            str(tmp_path / "lat.npz"), "--device", "cpu"])
    assert len(cache) == 2
    trainer = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "tiny", "--synthetic", "1", "--vocab_size", "2", "--samples_per_word", "1",
        "--vae_pt", pt, "--batch_size", "2", "--save_path", str(tmp_path / "run"),
        "--device", "cpu"]))
    assert trainer.encode_fn is not None
    sd = torch.load(pt, weights_only=True)
    assert all(torch.equal(p.cpu(), out["vae"].state_dict()[k].cpu()) for k, p in sd.items())


def test_train_style_cli_writes_what_train_and_jax_read(tmp_path, monkeypatch):
    monkeypatch.setattr(style, "StyleEncoder",
                        functools.partial(style.StyleEncoder, dtype=torch.float32))
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    out = train_style.main(["--synthetic", "1", "--writers", "8", "--samples_per_writer", "2",
                            "--img_size", "32,64", "--epochs", "2", "--batch_size", "4",
                            "--save_dir", str(tmp_path / "style"), "--device", "cpu"])
    assert [h["steps"] for h in out["history"]] == [4, 4]
    with np.load(tmp_path / "style" / "style_dict.npz") as z:
        styles = {k: z[k] for k in z.files}
    assert sorted(styles) == [str(i) for i in range(8)]
    assert {v.shape for v in styles.values()} == {(4096,)}
    # the JAX encoder applies the pickle and gives the same vectors
    params = read_params_pickle(str(tmp_path / "style" / "best_params.pkl"))
    crops = np.stack(train_style.corpus(train_style.build_parser().parse_args(
        ["--synthetic", "1", "--writers", "8", "--samples_per_writer", "2", "--img_size",
         "32,64"]))["3"])
    want = np.asarray(jax.jit(jstyle.StyleEncoder(out_dim=4096, dtype=jnp.float32).apply)(
        params, crops)).mean(axis=0)
    assert np.abs(styles["3"] - want).max() <= 1e-4 * np.abs(want).max()
    trainer = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "tiny", "--synthetic", "1", "--vocab_size", "2", "--samples_per_word", "4",
        "--wrdChrWrStyl", "1", "--style_dict", str(tmp_path / "style" / "style_dict.npz"),
        "--batch_size", "2", "--save_path", str(tmp_path / "run"), "--device", "cpu"]))
    rec = trainer.dataset[5]
    assert np.array_equal(rec["style_vec"], styles[trainer.dataset.samples[5].writer])
    assert trainer.dataset.writer_styled
    with open(tmp_path / "style" / "best_params.pkl", "rb") as f:
        assert "proj" in pickle.load(f)["params"]


@pytest.mark.parametrize("cli,argv", [
    (train_ocr, []), (train_vae, []), (train_style, []),
    (eval_cli, ["--real_dir", "r", "--fake_dir", "f"])])
def test_side_clis_refuse_cpu_fallback(cli, argv, monkeypatch):
    """Without CUDA they exit saying so; the CPU is taken only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(argv)
