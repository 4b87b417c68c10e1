"""The port imports no JAX and nothing of the JAX package: every module of
worddiffusion_tpu_torch is imported, and the regeneration CLI (the iam,
the context-folded iam and the PHOSC layout) and the train CLI run a tiny
slice on the CPU, in a fresh interpreter, with tiny presets registered in
the port's own ``presets.PRESETS``; then jax, flax, optax, PIL and every
``worddiffusion_tpu`` module must be absent. A static scan of the port's
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
print("LOADED", sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "PIL")
                     or m.split(".")[0] == "worddiffusion_tpu"))
"""


TRAIN_SCRIPT = r"""
import importlib, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
for name in ("train.state", "train.step", "train.checkpoint", "train.loop", "data.dataset",
             "data.loader", "diffusion.forward", "cli.train", "ops.attention"):
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
print("LOADED", sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "PIL")
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
    """The training slice (train/, data/, cli/train, diffusion/forward)
    imports and runs with no jax, flax, optax, PIL or JAX-package module."""
    _run_jax_free(TRAIN_SCRIPT)


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
