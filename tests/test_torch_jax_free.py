"""The port imports no JAX and nothing of the JAX package: every module of
worddiffusion_tpu_torch is imported, and the regeneration CLI (the iam,
the context-folded iam and the PHOSC layout), the train CLI (from a latent
cache, with the CTC aux loss and reference latents, and from PNGs), the
sampling CLI and the latent-cache CLI run a tiny slice on the CPU, in a
fresh interpreter, with tiny presets registered in the port's own
``presets.PRESETS``, the recognizer CLIs train and test a narrow
PHOSCNet, and the renderer, the side-model trainers, the evaluation CLI and
the masked sampler run; then jax, flax, optax, PIL, safetensors, OpenCV (cv2)
and every ``worddiffusion_tpu`` module must be absent. A static scan of the port's
sources and ``chip_smoke.py`` finds no import of ``worddiffusion_tpu``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
import torch
torch.set_num_threads(1)
import worddiffusion_tpu_torch
for mod in pkgutil.walk_packages(worddiffusion_tpu_torch.__path__, "worddiffusion_tpu_torch."):
    importlib.import_module(mod.name)

from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.configs.config import (
    DataConfig, DiffusionConfig, Experiment, UNetConfig, VAEConfig)
from worddiffusion_tpu_torch.cli import regenerate as cli

presets.PRESETS["tiny"] = lambda: Experiment(
    unet=UNetConfig(model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
                    num_writers=8, max_seq_len=10, dtype="float32"),
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                  dtype="float32"),
    diffusion=DiffusionConfig(num_steps=12),
    data=DataConfig(max_chars=10, alphabet="eng_main"),
)
out = tempfile.mkdtemp()
gt = os.path.join(out, "words.filter27")
with open(gt, "w") as f:
    f.write("000,a01-000u-00 Hello\n001,a01-000u-01 word\n000,a01-000u-02 test\n")
dump = os.path.join(out, "regen")
cli.main(["--preset", "tiny", "--gt_file", gt, "--dump_path", dump, "--batch_size", "2",
          "--keep_rejected", "1", "--device", "cpu"])
written = [f for f in os.listdir(dump) if f.endswith(".png")]
rejected = os.listdir(os.path.join(dump, "rejected")) if os.path.isdir(
    os.path.join(dump, "rejected")) else []
assert len(written) + len(rejected) == 3, (written, rejected)

# the context-folded attention: 2 heads x 10 tokens <= 32 channels, so every
# attention folds (the plain fold version on the CPU)
presets.PRESETS["tiny_fold"] = lambda: Experiment(
    unet=UNetConfig(model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
                    num_writers=8, max_seq_len=10, attn_fold_context=True, dtype="float32"),
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                  dtype="float32"),
    diffusion=DiffusionConfig(num_steps=12),
    data=DataConfig(max_chars=10, alphabet="eng_main"),
)
stats = cli.main(["--preset", "tiny_fold", "--gt_file", gt, "--dump_path", dump + "_fold",
                  "--batch_size", "2", "--no_ocr_filter", "1", "--device", "cpu"])
assert stats.generated == stats.accepted == 3, stats

# the PHOSC model (the iam_phosc layout at the tiny width) and its descriptors
presets.PRESETS["tiny_phosc"] = lambda: Experiment(
    unet=UNetConfig(model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
                    num_writers=8, max_seq_len=10, attn1_cross=False, use_phosc=True,
                    phosc_dim=769, dtype="float32"),
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                  dtype="float32"),
    diffusion=DiffusionConfig(num_steps=12),
    data=DataConfig(max_chars=10, alphabet="eng_main"),
)
stats = cli.main(["--preset", "tiny_phosc", "--gt_file", gt, "--dump_path", dump + "_phosc",
                  "--batch_size", "2", "--no_ocr_filter", "1", "--device", "cpu"])
assert stats.generated == stats.accepted == 3, stats

# the sampling CLI: CFG, a writer mix, DDIM
from worddiffusion_tpu_torch.cli import sample as sample_cli
names = sample_cli.main(["--preset", "tiny", "--words", "Hello,word", "--writer", "1",
                         "--writer2", "2", "--mix_rate", "0.5", "--cfg_scale", "2", "--ddim", "2",
                         "--save_path", os.path.join(out, "samples"), "--device", "cpu"])
assert names == ["00000_1_Hello_mix0.500.png", "00001_1_word_mix0.500.png"], names
print("LOADED", sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "PIL",
                                                      "safetensors", "cv2")
                     or m.split(".")[0] == "worddiffusion_tpu"))
"""


TRAIN_SCRIPT = r"""
import importlib, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
for name in ("train.state", "train.step", "train.checkpoint", "train.loop", "data.dataset",
             "data.loader", "data.png", "data.latent_cache", "diffusion.forward", "cli.train",
             "cli.build_latent_cache", "ops.attention", "ops.groupnorm", "ops.gn_conv",
             "utils.safetensors"):
    importlib.import_module("worddiffusion_tpu_torch." + name)

from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.configs.config import (
    DataConfig, DiffusionConfig, Experiment, TrainConfig, UNetConfig, VAEConfig)
from worddiffusion_tpu_torch.cli import train as cli

presets.PRESETS["tiny"] = lambda: Experiment(
    unet=UNetConfig(model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
                    num_writers=8, max_seq_len=10, dtype="float32"),
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                  dtype="float32"),
    diffusion=DiffusionConfig(num_steps=12),
    data=DataConfig(max_chars=10, alphabet="eng_main"),
    train=TrainConfig(ckpt_every_epochs=1),
)
out = tempfile.mkdtemp()
gt = os.path.join(out, "words.filter27")
rng = np.random.default_rng(0)
lat = {}
with open(gt, "w") as f:
    for i, w in enumerate(["Hello", "word", "test", "the"]):
        f.write(f"{i % 2:03d},a01-000u-{i:02d} {w}\n")
        lat[f"a01-000u-{i:02d}.png"] = rng.standard_normal((8, 32, 4)).astype(np.float32)
np.savez(os.path.join(out, "lat.npz"), **lat)
state = cli.main(["--preset", "tiny", "--gt_train", gt, "--latent_cache",
                  os.path.join(out, "lat.npz"), "--batch_size", "2", "--epochs", "1",
                  "--preview_ddim", "2", "--save_path", os.path.join(out, "run"),
                  "--device", "cpu"])
assert state.step == 2, state.step
assert os.listdir(os.path.join(out, "run", "ckpt")) == ["2"]
state = cli.main(["--preset", "tiny", "--gt_train", gt, "--latent_cache",
                  os.path.join(out, "lat.npz"), "--batch_size", "2", "--epochs", "1",
                  "--preview_ddim", "2", "--save_path", os.path.join(out, "run_ocr"),
                  "--ocrTraining", "1", "--imgConditioned", "1", "--device", "cpu"])
assert state.step == 2, state.step

# building a latent cache and training from images, on PNGs the port writes
from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
from worddiffusion_tpu_torch.utils.images import encode_png
crops = os.path.join(out, "crops")
os.makedirs(crops)
for i in range(4):
    img = np.full((40 + 10 * i, 90 + 40 * i), 250, np.uint8)
    img[10:20, 5:60] = 20
    with open(os.path.join(crops, f"a01-000u-{i:02d}.png"), "wb") as f:
        f.write(encode_png(img))
cache = cache_cli.main(["--preset", "tiny", "--gt_train", gt, "--iam_path", crops, "--out",
                        os.path.join(out, "built.npz"), "--batch_size", "3", "--device", "cpu"])
assert len(cache) == 4 and cache["a01-000u-03.png"].shape == (8, 32, 4)
state = cli.main(["--preset", "tiny", "--gt_train", gt, "--iam_path", crops, "--batch_size", "2",
                  "--epochs", "1", "--preview_ddim", "2", "--save_path",
                  os.path.join(out, "run_img"), "--device", "cpu"])
assert state.step == 2, state.step
print("LOADED", sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "PIL",
                                                      "safetensors", "cv2")
                     or m.split(".")[0] == "worddiffusion_tpu"))
"""


RECOGNIZER_SCRIPT = r"""
import functools, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from worddiffusion_tpu_torch.cli import train_charcounter, train_phosc
from worddiffusion_tpu_torch.eval import fid, zsl
from worddiffusion_tpu_torch.models import phoscnet
from worddiffusion_tpu_torch.utils.images import encode_png

# the CLIs' recognizer at hidden 32 (its trunk keeps its widths)
phoscnet.PHOSCNet = functools.partial(phoscnet.PHOSCNet, hidden=32)
out = tempfile.mkdtemp()
gt = os.path.join(out, "words.filter27")
with open(gt, "w") as f:
    for i, w in enumerate(["the", "of", "and", "to"]):
        img = np.full((40, 60 + 30 * i), 250, np.uint8)
        img[10:30, 5:40] = 30
        with open(os.path.join(out, f"a01-000u-{i:02d}.png"), "wb") as png:
            png.write(encode_png(img))
        f.write(f"000,a01-000u-{i:02d} {w}\n")
common = ["--image_dir", out, "--batch_size", "2", "--device", "cpu"]
run = train_phosc.main(["--train_csv", gt, "--valid_csv", gt, "--model", "resnet18",
                        "--epochs", "1", "--save_dir", os.path.join(out, "phosc"), *common])
assert run["history"][0]["steps"] == 2
train_charcounter.main(["--gt_train", gt, "--epochs", "1", "--save_dir",
                        os.path.join(out, "counter"), *common])
res = train_phosc.main(["--mode", "test", "--train_csv", gt, "--test_csv", gt, "--model",
                        "resnet18", "--save_dir", os.path.join(out, "phosc"), "--len_counter",
                        os.path.join(out, "counter", "params.pkl"), *common])
assert set(res["with_length"]) == {"zsl", "gzsl", "length_accuracy", "length_fuzzy_accuracy"}
feats = fid.phosc_featurizer(os.path.join(out, "phosc", "best_params.pkl"), trunk="resnet18",
                             device="cpu")(np.zeros((2, 50, 250, 3), np.float32))
assert feats.shape == (2, 4096)
print("LOADED", sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "PIL",
                                                      "safetensors", "cv2")
                     or m.split(".")[0] == "worddiffusion_tpu"))
"""


SIDE_SCRIPT = r"""
import functools, hashlib, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from worddiffusion_tpu_torch.cli import evaluate, train_ocr, train_style, train_vae
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.configs.config import DataConfig, Experiment, VAEConfig
from worddiffusion_tpu_torch.data import make_glyph_table, synthetic
from worddiffusion_tpu_torch.diffusion import masking
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu_torch.eval import inception
from worddiffusion_tpu_torch.models import ocr, style
from worddiffusion_tpu_torch.utils.images import encode_png

# the renderer draws the committed check renders of one setting without PIL
check = np.load(make_glyph_table.CHECK_FILE)
digest = hashlib.sha256()
for si, wi, word, h, w, jitter, st in make_glyph_table.render_settings():
    if si == 2:
        digest.update(synthetic.render_word(word, h, w, seed=wi, jitter=jitter,
                                            style=st)[..., 0].tobytes())
assert digest.hexdigest() == str(check["sha256"][2])

out = tempfile.mkdtemp()
ocr.CTCRecognizer = functools.partial(ocr.CTCRecognizer, widths=(8, 16, 16, 16, 32),
                                      dtype=torch.float32)
train_ocr.main(["--synthetic", "1", "--vocab_size", "2", "--samples_per_word", "1",
                "--batch_size", "2", "--epochs", "1", "--eval_renders", "1", "--save_dir",
                os.path.join(out, "ocr"), "--device", "cpu"])
presets.PRESETS["tiny"] = lambda: Experiment(
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                  dtype="float32"), data=DataConfig(max_chars=10, alphabet="eng_main"))
train_vae.main(["--preset", "tiny", "--synthetic", "1", "--vocab_size", "2",
                "--samples_per_word", "1", "--batch_size", "2", "--epochs", "1", "--save_dir",
                os.path.join(out, "vae"), "--device", "cpu"])
style.StyleEncoder = functools.partial(style.StyleEncoder, dtype=torch.float32)
train_style.main(["--synthetic", "1", "--writers", "2", "--samples_per_writer", "2",
                  "--img_size", "32,64", "--out_dim", "8", "--epochs", "1", "--batch_size", "2",
                  "--save_dir", os.path.join(out, "style"), "--device", "cpu"])
for d in ("real", "fake"):
    os.makedirs(os.path.join(out, d))
    for i, w in enumerate(["the", "of"]):
        with open(os.path.join(out, d, f"{i:05d}_1_{w}.png"), "wb") as f:
            f.write(encode_png(synthetic.render_word(w, seed=i)))
torch.save(inception.seeded_torchvision_state_dict(0), os.path.join(out, "inc.pt"))
res = evaluate.main(["--real_dir", os.path.join(out, "real"), "--fake_dir",
                     os.path.join(out, "fake"), "--inception_weights",
                     os.path.join(out, "inc.pt"), "--ocr_pt",
                     os.path.join(out, "ocr", "ocr.pt"), "--device", "cpu"])
assert set(res) == {"fid_inception", "ocr_exact_match"}, res
x, _ = masking.masked_ddpm_sample(NoiseSchedule.linear(6), lambda x, t: 0.1 * x,
                                  torch.zeros(1, 8, 32, 4),
                                  generator=torch.Generator().manual_seed(0))
assert torch.isfinite(x).all()
print("LOADED", sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "PIL",
                                                      "safetensors", "cv2")
                     or m.split(".")[0] == "worddiffusion_tpu"))
"""


def _run_jax_free(script):
    env = {k: v for k, v in os.environ.items() if k != "WD_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_port_runs_without_jax():
    _run_jax_free(SCRIPT)


def test_train_cli_runs_without_jax():
    """The training slice (train/, data/, cli/train, diffusion/forward), the
    latent-cache CLI and training from PNGs import and run with no
    jax, flax, optax, PIL, safetensors or JAX-package module."""
    _run_jax_free(TRAIN_SCRIPT)


def test_recognizer_runs_without_jax():
    """The PHOSC recognizer's slice (models/phoscnet, models/charcounter,
    eval/zsl, eval/fid, train/plateau, the train_phosc CLI in both modes and
    the train_charcounter CLI) runs with no jax, flax, optax, PIL, OpenCV or
    JAX-package module."""
    _run_jax_free(RECOGNIZER_SCRIPT)


def test_side_models_run_without_jax():
    """The PIL-free renderer (one setting of the committed check renders,
    bitwise), the OCR, VAE and style trainers, the evaluation CLI (Inception
    and OCR) and the masked sampler run with no jax, flax, optax, PIL,
    OpenCV or JAX-package module."""
    _run_jax_free(SIDE_SCRIPT)


def _imported_modules(path: Path) -> set[str]:
    """Every module an ``import`` or ``from`` statement of the file names,
    relative imports resolved against the file's package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package = path.relative_to(REPO).with_suffix("").parts[:-1]
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = list(package[:len(package) - node.level + 1]) if node.level else []
            names.add(".".join(base + ([node.module] if node.module else [])))
    return names


def test_no_source_imports_the_jax_package():
    files = sorted((REPO / "worddiffusion_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    offenders = {
        str(f.relative_to(REPO)): sorted(m for m in _imported_modules(f)
                                         if m.split(".")[0] == "worddiffusion_tpu")
        for f in files
    }
    assert not {f: m for f, m in offenders.items() if m}, offenders
    # the scan sees imports: the port's own relative imports resolve into the port
    assert "worddiffusion_tpu_torch.configs.config" in _imported_modules(
        REPO / "worddiffusion_tpu_torch" / "models" / "unet.py")


def test_cli_refuses_cpu_fallback(monkeypatch, tmp_path):
    import torch

    from worddiffusion_tpu_torch.cli import regenerate as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--gt_file", str(tmp_path / "none.txt")])
