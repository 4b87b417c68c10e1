"""Build the VAE latent cache (port of ``worddiffusion_tpu/data/latent_cache.py``):
run the frozen VAE encoder over the dataset once, on the VAE's device,
and store ``image name -> latent [8, 32, 4]`` as a compressed npz, which
``LatentLookup.load`` (here and in the JAX package) reads back for
latent-cache training.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.vae import AutoencoderKL, encode_to_latent
from .dataset import LatentLookup, WordImageDataset
from .loader import batches, prefetch


def batch_generator(seed: int, index: int, device) -> torch.Generator:
    """The posterior-sample generator of batch ``index``: seeded from
    (seed, index), as the JAX ``build_latent_cache`` folds the batch index into its key."""
    mixed = np.random.SeedSequence([seed, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


@torch.no_grad()
def build_latent_cache(
    dataset: WordImageDataset,
    vae: AutoencoderKL,
    batch_size: int = 64,
    seed: int = 0,
    sample_posterior: bool = True,
    out_path: Optional[str] = None,
) -> LatentLookup:
    """One ordered pass over ``dataset`` (image records); the last batch is
    padded by repeating its own samples and the repeats are dropped by
    name. ``sample_posterior=False`` stores the posterior mean. The images
    are decoded and resized on a worker thread while the device encodes
    the previous batch."""
    device = next(vae.parameters()).device
    names: list[str] = []
    lats: list[torch.Tensor] = []
    for i, batch in enumerate(prefetch(batches(dataset, batch_size, shuffle=False,
                                               drop_remainder=False))):
        imgs = torch.from_numpy(batch["image"])
        imgs = imgs.pin_memory().to(device, non_blocking=True) if device.type == "cuda" \
            else imgs.to(device)
        gen = batch_generator(seed, i, device) if sample_posterior else None
        lats.append(encode_to_latent(vae, imgs, gen, sample=sample_posterior))
        names.extend(batch["image_name"])
    all_lat = (torch.cat(lats).cpu().numpy() if lats
               else np.zeros((0, 8, 32, 4), np.float32))
    seen: dict[str, np.ndarray] = {}
    for n, lat in zip(names, all_lat):
        if n not in seen:
            seen[n] = lat
    if out_path:
        np.savez_compressed(out_path, **seen)
    return LatentLookup(seen)
