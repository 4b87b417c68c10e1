# Copy of pixel_space_exp from worddiffusion_tpu/cli/sample.py: the port imports nothing of the JAX package.
"""The pixel-space variant of a preset (``--latent 0``)."""

from __future__ import annotations

import dataclasses

from .config import Experiment


def pixel_space_exp(exp: Experiment) -> Experiment:
    """Pixel-space variant of a preset (``cli.train --latent 0``): the
    denoiser takes and gives 3-channel images, no VAE (JAX
    ``cli/sample.py:82-90``)."""
    return dataclasses.replace(
        exp,
        data=dataclasses.replace(exp.data, latent=False),
        unet=dataclasses.replace(exp.unet, in_channels=3, out_channels=3),
    )
