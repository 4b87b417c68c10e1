"""The GZSL calibration run at full strength (``scripts/phosc_syn5_gzsl.sh``):
the PHOSC recognizer trained with augmentation, writer styles and a 20%
train-vocabulary calibration holdout, then tested, for seeds 0 and 1 (the
script's ``for SEED in 0 1`` loop; seed 0 in ``runs/phosc_syn5``, seed 1 in
``runs/phosc_syn5_s1``). The script has no guards; the port's markers are
under ``.chains/phosc_gzsl/``.
"""

from __future__ import annotations

from .run import Stage, cli

DATA = "--synthetic 1 --n_synth 2000 --renders_per_word 24 --writer_styles 1 --augment 40"
SEEDS = (0, 1)


def stages() -> list[Stage]:
    out = []
    for seed in SEEDS:  # :21-30
        save = "runs/phosc_syn5" if seed == 0 else f"runs/phosc_syn5_s{seed}"
        out.append(Stage(
            f"seed{seed}",
            cli("train_phosc", f"--mode train {DATA} --epochs 80 --batch_size 64 --lr 3e-4 "
                               f"--save_dir {save} --plateau_patience 12 "
                               f"--calib_words_fraction 0.2 --seed {seed}"),
            cli("train_phosc", f"--mode test {DATA} --batch_size 64 --save_dir {save} "
                               f"--seed {seed}")))
    return out
