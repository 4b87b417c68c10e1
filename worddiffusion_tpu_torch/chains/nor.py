"""The Norwegian chain (``scripts/nor_chain.sh``): a recognizer of the nor
alphabet, then the norwegian-preset DDPM, regenerated through it.

A hazard of the script, not copied silently: it reads
``runs/vae_syn_v2/ckpt`` (``nor_chain.sh:18,23,40``), which no script
makes. The port's chain stops before its first stage where that directory
holds no weights (an orbax checkpoint, or the port's ``vae.pt`` beside it:
``python -m worddiffusion_tpu_torch.cli.train_vae ... --save_dir
<runs_dir>/vae_syn_v2`` writes one). Every stage runs each time in the
script; the port's markers are under ``.chains/nor/``.
"""

from __future__ import annotations

from .blocks import write_gt
from .run import Py, Stage, cli

REQUIRES = (("runs/vae_syn_v2/ckpt", "vae.pt"),)


def stages() -> list[Stage]:
    return [
        Stage("ocr", cli("train_ocr", "--synthetic 1 --lang nor --vocab_size 90 "  # :10-13
                                      "--samples_per_word 24 --eval_renders 4 --epochs 60 "
                                      "--batch_size 64 --lr 1e-3 --save_dir runs/ocr_nor")),
        Stage("cache", cli("build_latent_cache", "--synthetic 1 --preset norwegian "  # :15-18
                                                 "--vocab_size 10 --samples_per_word 96 "
                                                 "--vae_ckpt runs/vae_syn_v2/ckpt "
                                                 "--out runs/latents_nor.npz")),
        Stage("ddpm", cli("train", "--preset norwegian --synthetic 1 --vocab_size 10 "  # :20-25
                                   "--samples_per_word 96 --latent 1 --latent_cache "
                                   "runs/latents_nor.npz --vae_ckpt runs/vae_syn_v2/ckpt "
                                   "--epochs 800 --batch_size 120 --ckpt_every_epochs 200 "
                                   "--save_path runs/demo_nor")),
        Stage("gt", Py(write_gt, dict(out="runs/nor_gt.csv", vocab_size=10,  # :27-35
                                      samples_per_word=96, lang="nor"))),
        Stage("regen", cli("regenerate", "--preset norwegian --ckpt_dir runs/demo_nor/ckpt "  # :37-41
                                         "--gt_file runs/nor_gt.csv --vae_ckpt "
                                         "runs/vae_syn_v2/ckpt --ocr_ckpt runs/ocr_nor/ckpt "
                                         "--dump_path runs/regen_nor --batch_size 120 "
                                         "--fullSampling 1")),
    ]
