"""The CVL-preset chain (``scripts/cvl_chain.sh``): the 73-symbol alphabet
(digits and punctuation), MAX_CHARS 42, 310 writer classes; its own
recognizer (``--lang cvl``) and a codec over the eng and cvl corpora.

The script's guards are a non-empty ``ckpt/``, which an interrupted run
leaves behind; the port's are ``ocr_cvl/.done`` and ``vae_cvl/.done``,
written once the trainer returns. The stages the script runs every time
have markers under ``.chains/cvl/``.
"""

from __future__ import annotations

from .blocks import write_gt
from .run import Py, Stage, cli


def stages() -> list[Stage]:
    return [
        Stage("ocr", cli(  # :15-20
            "train_ocr", "--synthetic 1 --lang cvl --vocab_size 90 --samples_per_word 24 "
                         "--eval_renders 4 --epochs 60 --batch_size 64 --lr 1e-3 "
                         "--save_dir runs/ocr_cvl"), marker="runs/ocr_cvl/.done"),
        Stage("vae", cli(  # :22-27
            "train_vae", "--synthetic 1 --langs eng,cvl --vocab_size 60 --samples_per_word 8 "
                         "--epochs 200 --batch_size 16 --save_every_epochs 50 "
                         "--save_dir runs/vae_cvl"), marker="runs/vae_cvl/.done"),
        Stage("cache", cli("build_latent_cache", "--synthetic 1 --preset cvl --vocab_size 10 "  # :29-32
                                                 "--samples_per_word 96 --vae_ckpt "
                                                 "runs/vae_cvl/ckpt --out runs/latents_cvl.npz")),
        Stage("ddpm", cli("train", "--preset cvl --synthetic 1 --vocab_size 10 "  # :34-39
                                   "--samples_per_word 96 --latent 1 --latent_cache "
                                   "runs/latents_cvl.npz --vae_ckpt runs/vae_cvl/ckpt "
                                   "--epochs 800 --batch_size 120 --ckpt_every_epochs 200 "
                                   "--save_path runs/demo_cvl")),
        Stage("gt", Py(write_gt, dict(out="runs/cvl_gt.csv", vocab_size=10,  # :41-49
                                      samples_per_word=96, lang="cvl"))),
        Stage("regen", cli("regenerate", "--preset cvl --ckpt_dir runs/demo_cvl/ckpt "  # :51-55
                                         "--gt_file runs/cvl_gt.csv --vae_ckpt runs/vae_cvl/ckpt "
                                         "--ocr_ckpt runs/ocr_cvl/ckpt --dump_path "
                                         "runs/regen_cvl --batch_size 120 --fullSampling 1")),
    ]
