"""The writer-style chain (``scripts/style_chain.sh``): the triplet-trained
style encoder and its writer dictionary, a writer-styled latent cache, the
style-replace flagship DDPM (``--wrdChrWrStyl 1``), then per-writer samples.

It reads the iam chain's codec (``runs/vae_syn``), as the script does, and
stops before its first stage where that holds no weights. Every stage runs
each time in the script; the port's markers are under ``.chains/style/``.
"""

from __future__ import annotations

from .run import Stage, cli

REQUIRES = (("runs/vae_syn/ckpt", "vae.pt"),)
SAMPLE = ("--preset iam --ckpt_dir runs/demo_style/ckpt --vae_ckpt runs/vae_syn/ckpt "
          "--wrdChrWrStyl 1 --style_dict runs/style_syn/style_dict.npz --words the,hand")


def stages() -> list[Stage]:
    return [
        Stage("style", cli("train_style", "--synthetic 1 --writers 8 --samples_per_writer 24 "  # :11-14
                                          "--epochs 12 --batch_size 16 --lr 1e-4 "
                                          "--save_dir runs/style_syn")),
        Stage("cache", cli("build_latent_cache", "--synthetic 1 --vocab_size 10 "  # :16-19
                                                 "--samples_per_word 128 --writer_styled 1 "
                                                 "--vae_ckpt runs/vae_syn/ckpt "
                                                 "--out runs/latents_style.npz")),
        Stage("ddpm", cli("train", "--preset iam --synthetic 1 --vocab_size 10 "  # :21-27
                                   "--samples_per_word 128 --latent 1 --latent_cache "
                                   "runs/latents_style.npz --vae_ckpt runs/vae_syn/ckpt "
                                   "--wrdChrWrStyl 1 --style_dict runs/style_syn/style_dict.npz "
                                   "--epochs 600 --batch_size 128 --ckpt_every_epochs 200 "
                                   "--save_path runs/demo_style")),
        Stage("sample_w0", cli("sample", f"{SAMPLE} --writer 0 --n 4 "  # :29-37
                                         f"--save_path runs/style_samples_w0")),
        Stage("sample_w5", cli("sample", f"{SAMPLE} --writer 5 --n 4 "
                                         f"--save_path runs/style_samples_w5")),
    ]
