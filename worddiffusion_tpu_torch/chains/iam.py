"""The IAM-preset OCR-in-the-loop chain (``scripts/iam_chain.sh``):
recognizer -> VAE -> latent cache -> flagship latent DDPM -> OCR-filtered
regeneration in three sampling modes -> the comparison subsets -> the PHOSC
evaluator -> five ``evaluate`` rows (OCR agreement and PHOSC-feature FID).

The script's guards: ``ocr_syn/.done`` and ``vae_syn/.done``, the DDPM's last
checkpoint (``ckpt/10000`` there; the port's layout's last step here), the
PHOSC weights (``best_params.pkl`` there, which the trainer writes at its
best epoch, so an interrupted run passed the guard; ``phosc_syn3/.done``
here, after the test mode returns). The stages the script runs every time
have markers under ``.chains/iam/``.
"""

from __future__ import annotations

from .blocks import comparison_subsets, write_gt, write_real_renders
from .run import Py, Stage, cli, train_checkpoint

OCR = ("--synthetic 1 --vocab_size 100 --samples_per_word 24 --eval_renders 4 "
       "--epochs 60 --batch_size 64 --lr 1e-3 --save_dir runs/ocr_syn")
VAE = ("--synthetic 1 --vocab_size 100 --samples_per_word 8 --epochs 200 "
       "--batch_size 16 --save_every_epochs 50 --save_dir runs/vae_syn")
CACHE = ("--synthetic 1 --vocab_size 10 --samples_per_word 128 "
         "--vae_ckpt runs/vae_syn/ckpt --out runs/latents_demo.npz")
REGEN = ("--preset iam --ckpt_dir runs/demo_latent/ckpt --gt_file runs/demo_gt.csv "
         "--vae_ckpt runs/vae_syn/ckpt --ocr_ckpt runs/ocr_syn/ckpt")
WRITERS = "--writers_dict runs/demo_latent/writers_dict_train.json"
PHOSC = "runs/phosc_syn3/best_params.pkl"
PHOSC_DATA = "--synthetic 1 --n_synth 1600 --renders_per_word 24 --writer_styles 1 --augment 40"


def ocr_stage() -> Stage:
    """Stage 1, the frozen CTC recognizer (``iam_chain.sh:16-22``), shared
    with the higan and gw chains."""
    return Stage("ocr", cli("train_ocr", OCR), marker="runs/ocr_syn/.done")


def vae_stage() -> Stage:
    """Stage 2, the frozen latent codec (``iam_chain.sh:24-30``)."""
    return Stage("vae", cli("train_vae", VAE), marker="runs/vae_syn/.done")


def evaluate(real: str, fake: str, out: str, extra: str = ""):
    return cli("evaluate", f"--phosc_params {PHOSC} --real_dir {real} --fake_dir {fake} "
                           f"{extra} --out {out}")


def stages() -> list[Stage]:
    return [
        ocr_stage(),
        vae_stage(),
        Stage("ddpm",  # :32-42
              cli("build_latent_cache", CACHE),
              cli("train", "--preset iam --synthetic 1 --vocab_size 10 --samples_per_word 128 "
                           "--latent 1 --latent_cache runs/latents_demo.npz "
                           "--vae_ckpt runs/vae_syn/ckpt --epochs 1000 --batch_size 128 "
                           "--ckpt_every_epochs 200 --save_path runs/demo_latent"),
              marker=train_checkpoint),
        Stage("gt", Py(write_gt, dict(out="runs/demo_gt.csv", vocab_size=10,  # :44-59
                                      samples_per_word=128)),
              Py(write_real_renders, dict(out_dir="runs/real_demo", vocab_size=10,
                                          samples_per_word=128))),
        Stage("regen_skip", cli("regenerate", f"{REGEN} --dump_path runs/regen_demo "  # :61-77
                                              f"--batch_size 128 {WRITERS}")),
        Stage("regen_full", cli("regenerate", f"{REGEN} --dump_path runs/regen_full "
                                              f"--batch_size 128 --fullSampling 1 {WRITERS}")),
        Stage("regen_ddim", cli("regenerate", f"{REGEN} --dump_path runs/regen_ddim "
                                              f"--batch_size 128 --ddim 50 --keep_rejected 1 "
                                              f"{WRITERS}")),
        Stage("subsets", Py(comparison_subsets, dict(  # :79-135
            acc_dir="runs/regen_ddim", rej_dir="runs/regen_ddim/rejected",
            real_dir="runs/real_demo", floor_a="runs/fid_floor_a", floor_b="runs/fid_floor_b",
            unfilt="runs/fid_unfilt", acc_bal="runs/fid_acc_bal", rej_bal="runs/fid_rej_bal"))),
        Stage("phosc",  # :137-146
              cli("train_phosc", f"--mode train {PHOSC_DATA} --epochs 80 --batch_size 64 "
                                 f"--lr 3e-4 --save_dir runs/phosc_syn3"),
              cli("train_phosc", f"--mode test {PHOSC_DATA} --batch_size 64 "
                                 f"--save_dir runs/phosc_syn3 --seed 0"),
              marker="runs/phosc_syn3/.done"),
        Stage("eval_realfloor", evaluate("runs/fid_floor_a", "runs/fid_floor_b",  # :148-158
                                         "runs/eval_fid_realfloor.json")),
        Stage("eval_filtered", evaluate("runs/real_demo", "runs/regen_ddim",
                                        "runs/eval_fid_filtered.json",
                                        "--ocr_ckpt runs/ocr_syn/ckpt")),
        Stage("eval_unfilt", evaluate("runs/real_demo", "runs/fid_unfilt",
                                      "runs/eval_fid_unfilt.json")),
        Stage("eval_accbal", evaluate("runs/real_demo", "runs/fid_acc_bal",
                                      "runs/eval_fid_accbal.json")),
        Stage("eval_rejbal", evaluate("runs/real_demo", "runs/fid_rej_bal",
                                      "runs/eval_fid_rejbal.json")),
    ]
