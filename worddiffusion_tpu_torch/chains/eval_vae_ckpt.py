"""The held-out evaluation of a saved VAE (``scripts/eval_vae_ckpt.py``):
for a VAE stage stopped before its ``--epochs``, the reconstruction grid and
``metrics.json`` that ``cli.train_vae`` writes at its end, from the weights
on disk.

    python -m worddiffusion_tpu_torch.chains.eval_vae_ckpt --save_dir runs/vae_syn \\
        [--preset iam_base] [--device cuda]

It reads the port's ``<save_dir>/vae.pt`` or the JAX CLI's orbax
``<save_dir>/ckpt`` (its newest step, through ``train.checkpoint``).
``metrics.json`` has the JAX script's keys; ``steps`` is the orbax step, and
null for the port's ``vae.pt``, which records none.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="held-out PSNR of a saved VAE")
    p.add_argument("--save_dir", default="runs/vae_syn")
    p.add_argument("--preset", default="iam_base")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def main(argv=None) -> dict:
    from ..cli.train_vae import heldout_eval
    from ..configs import presets
    from ..models.convert import jax_vae_to_torch
    from ..models.vae import AutoencoderKL
    from ..train.checkpoint import side_weights
    from ..train.orbax import is_orbax, orbax_step_dir

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    exp = presets.get(args.preset)
    ckpt = os.path.join(args.save_dir, "ckpt")
    sd = side_weights("", ckpt, "--save_dir", "vae.pt", lambda t: jax_vae_to_torch(t, exp.vae))
    step = int(os.path.basename(orbax_step_dir(ckpt))) if is_orbax(ckpt) else None
    vae = AutoencoderKL(exp.vae, with_encoder=True)
    vae.load_state_dict(sd)
    vae = vae.to(device, memory_format=torch.channels_last).eval()
    mse, psnr = heldout_eval(vae, exp.data.img_height, exp.data.img_width, device,
                             args.save_dir)
    metrics = {"heldout_mse": mse, "heldout_psnr_db": psnr, "steps": step}
    with open(os.path.join(args.save_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    print(f"step {step}: held-out recon PSNR {psnr:.1f} dB")
    return metrics


if __name__ == "__main__":
    main()
