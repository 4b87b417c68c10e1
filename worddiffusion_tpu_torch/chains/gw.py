"""The George-Washington-preset chain (``scripts/gw_chain.sh``): MAX_CHARS
16, the PHOSC-conditioned UNet, phos version ``gw``, trained and regenerated
through the OCR gate.

Stages 1-2 are the iam chain's recognizer and codec, skipped where that
chain made them: the script's guard there is the ``ckpt/`` directory, which
an interrupted run leaves behind; the port keeps ``iam_chain.sh``'s
``.done`` markers. The stages the script runs every time have markers under
``.chains/gw/``.
"""

from __future__ import annotations

from .blocks import write_gt
from .iam import ocr_stage, vae_stage
from .run import Py, Stage, cli


def stages() -> list[Stage]:
    return [
        ocr_stage(),  # :16-21
        vae_stage(),  # :23-28
        Stage("cache", cli("build_latent_cache", "--synthetic 1 --preset gw --vocab_size 10 "  # :30-33
                                                 "--samples_per_word 96 --vae_ckpt "
                                                 "runs/vae_syn/ckpt --out runs/latents_gw.npz")),
        Stage("ddpm", cli("train", "--preset gw --synthetic 1 --vocab_size 10 "  # :35-40
                                   "--samples_per_word 96 --latent 1 --latent_cache "
                                   "runs/latents_gw.npz --vae_ckpt runs/vae_syn/ckpt --epochs 800 "
                                   "--batch_size 120 --ckpt_every_epochs 200 "
                                   "--save_path runs/demo_gw")),
        Stage("gt", Py(write_gt, dict(out="runs/gw_gt.csv", vocab_size=10,  # :42-50
                                      samples_per_word=96, lang="gw"))),
        Stage("regen", cli("regenerate", "--preset gw --ckpt_dir runs/demo_gw/ckpt "  # :52-56
                                         "--gt_file runs/gw_gt.csv --vae_ckpt runs/vae_syn/ckpt "
                                         "--ocr_ckpt runs/ocr_syn/ckpt --dump_path runs/regen_gw "
                                         "--batch_size 120 --fullSampling 1")),
    ]
