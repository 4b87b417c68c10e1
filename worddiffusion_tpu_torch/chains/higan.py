"""The HiGAN-generator chain (``scripts/higan_chain.sh``): the BigGAN-style
generator behind the UNet signature (``--hiGanArch 1``) trained on the
latent DDPM objective, OCR-gated regeneration with DDIM 50, and a montage of
accepted crops with the loss curve's ends.

It shares the iam chain's recognizer, codec and latent cache (the same
guards: ``.done`` markers and the cache file itself). The JAX block writes
the montage into ``docs/higan_regen_accepted.png``; the port's lands under
the runs directory (``higan_regen_accepted.png``). The stages the script
runs every time have markers under ``.chains/higan/``.
"""

from __future__ import annotations

from .blocks import montage, write_gt
from .iam import CACHE, ocr_stage, vae_stage
from .run import Py, Stage, cli


def stages() -> list[Stage]:
    return [
        ocr_stage(),  # :14-20
        vae_stage(),  # :22-28
        Stage("cache", cli("build_latent_cache", CACHE),  # :30-35
              marker=lambda steps: steps[0].argv[steps[0].argv.index("--out") + 1]),
        Stage("ddpm", cli(  # :37-46
            "train", "--preset iam --synthetic 1 --hiGanArch 1 --vocab_size 10 "
                     "--samples_per_word 128 --latent 1 --latent_cache runs/latents_demo.npz "
                     "--vae_ckpt runs/vae_syn/ckpt --epochs 1000 --batch_size 128 "
                     "--ckpt_every_epochs 200 --save_path runs/higan_demo"),
              marker="runs/higan_demo/.done"),
        Stage("gt", Py(write_gt, dict(out="runs/demo_gt.csv", vocab_size=10,  # :48-56
                                      samples_per_word=128))),
        Stage("regen", cli("regenerate", "--preset iam --hiGanArch 1 "  # :58-63
                                         "--ckpt_dir runs/higan_demo/ckpt --gt_file "
                                         "runs/demo_gt.csv --vae_ckpt runs/vae_syn/ckpt "
                                         "--ocr_ckpt runs/ocr_syn/ckpt --dump_path "
                                         "runs/regen_higan --batch_size 128 --ddim 50 "
                                         "--writers_dict runs/higan_demo/writers_dict_train.json")),
        Stage("montage", Py(montage, dict(regen_dir="runs/regen_higan",  # :65-84
                                          metrics="runs/higan_demo/metrics.jsonl",
                                          out="runs/higan_regen_accepted.png"))),
    ]
