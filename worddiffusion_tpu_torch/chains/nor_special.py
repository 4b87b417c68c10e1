"""The Norwegian ÆØÅ chain (``scripts/nor_special_chain.sh``): the
norwegian-preset DDPM on the full 90-word vocabulary, then only the words
with æ, ø or å regenerated through the nor chain's recognizer
(``runs/ocr_nor``, which this chain reads and does not make: run the nor
chain first).

A hazard of the script, not copied silently: it reads
``runs/vae_syn_v2/ckpt`` (``nor_special_chain.sh:14,19,38``), which no
script makes. The port's chain stops before its first stage where that
directory holds no weights (as the nor chain's docstring says). Every stage
runs each time in the script; the port's markers are under
``.chains/nor_special/``.
"""

from __future__ import annotations

from .blocks import write_gt
from .run import Py, Stage, cli

REQUIRES = (("runs/vae_syn_v2/ckpt", "vae.pt"),)


def stages() -> list[Stage]:
    return [
        Stage("cache", cli("build_latent_cache", "--synthetic 1 --preset norwegian "  # :11-14
                                                 "--vocab_size 90 --samples_per_word 24 "
                                                 "--vae_ckpt runs/vae_syn_v2/ckpt "
                                                 "--out runs/latents_nor90.npz")),
        Stage("ddpm", cli("train", "--preset norwegian --synthetic 1 --vocab_size 90 "  # :16-21
                                   "--samples_per_word 24 --latent 1 --latent_cache "
                                   "runs/latents_nor90.npz --vae_ckpt runs/vae_syn_v2/ckpt "
                                   "--epochs 400 --batch_size 120 --ckpt_every_epochs 100 "
                                   "--save_path runs/demo_nor90")),
        Stage("gt", Py(write_gt, dict(out="runs/nor_special_gt.csv", vocab_size=90,  # :23-33
                                      samples_per_word=48, lang="nor", special_only=True))),
        Stage("regen", cli("regenerate", "--preset norwegian --ckpt_dir runs/demo_nor90/ckpt "  # :35-39
                                         "--gt_file runs/nor_special_gt.csv --vae_ckpt "
                                         "runs/vae_syn_v2/ckpt --ocr_ckpt runs/ocr_nor/ckpt "
                                         "--dump_path runs/regen_nor_special --batch_size 120 "
                                         "--fullSampling 1")),
    ]
