"""Word sampling (port of ``worddiffusion_tpu/generate/sample.py``):
generate word images for (word, writer) pairs.

encode words -> DDPM or DDIM over the latent -> VAE decode -> uint8
images -> OCR forward + per-frame argmax, all queued on the device; only
the uint8 images and the int32 frame ids cross back to the host, when
the caller reads them.

Ported: the latent path with a VAE, DDIM, the fused OCR argmax, the
training's preview and PHOSC conditioning (``phosc``). Not yet:
pixel-space models, classifier-free guidance, multi-GPU, writer
interpolation and the style, glyph-image and reference-latent
conditioning.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from worddiffusion_tpu.configs.config import Experiment
from worddiffusion_tpu.data.phosc import phosc_vector
from worddiffusion_tpu.data.tokenizer import Tokenizer
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule

from ..diffusion.sampler import ddim_sample, ddpm_sample, latent_to_image
from ..models.unet import UNet
from ..models.vae import AutoencoderKL, decode_from_latent
from ..ops.ctc import greedy_frame_ids


def phosc_ids(words: Sequence[str], version: str) -> np.ndarray:
    """The PHOSC descriptors of ``words`` as token ids [B, P] int64, the
    UNet's ``phosc_ids`` (JAX ``generate/sample.py:242-248``)."""
    return np.stack([phosc_vector(w, version, as_int=True) for w in words]).astype(np.int64)


class WordSampler:
    def __init__(
        self,
        exp: Experiment,
        model: UNet,
        vae: AutoencoderKL,
        call_mask: Optional[np.ndarray] = None,
        stochastic: bool = True,
        ocr_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        ddim_steps: int = 0,
    ):
        """``model``, ``vae`` and ``ocr_apply`` (images [B,H,W,1] in
        [-1,1] -> CTC logits, e.g. a ``CTCRecognizer``) live on one
        device, where sampling runs. With ``ocr_apply`` the OCR forward
        and argmax join the device work and ``sample_async`` returns
        (uint8 images, int32 frame ids). ``ddim_steps`` > 0 samples with
        deterministic DDIM over that many steps instead of the DDPM loop."""
        if not exp.data.latent:
            raise NotImplementedError("pixel-space sampling is not ported yet")
        self.exp = exp
        self.model = model.eval()
        self.vae = vae.eval()
        self.ocr_apply = ocr_apply
        self.device = next(model.parameters()).device
        self.tokenizer = Tokenizer.from_name(exp.data.alphabet, exp.data.max_chars)
        self.schedule = NoiseSchedule.linear(
            exp.diffusion.num_steps, exp.diffusion.beta_start, exp.diffusion.beta_end
        )
        self.call_mask = call_mask
        self.stochastic = stochastic
        self.ddim_steps = ddim_steps
        self.latent_shape = (exp.data.img_height // 8, exp.data.img_width // 8, 4)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy does not wait for the queue
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.no_grad()
    def denoise(self, words: Sequence[str], writer_ids: Sequence[int],
                x_init: torch.Tensor, generator: Optional[torch.Generator] = None,
                phosc: Optional[np.ndarray] = None) -> torch.Tensor:
        """The reverse process from an explicit ``x_init`` -> latents
        [B, h, w, 4] fp32 (``generator`` feeds stochastic steps; ``phosc``
        [B, P] int: the PHOSC ids of a ``use_phosc`` model)."""
        ctx = self._to_device(self.tokenizer.encode_batch(list(words)).astype(np.int64))
        wid = self._to_device(np.asarray(writer_ids, np.int64))
        ph = None if phosc is None else self._to_device(np.asarray(phosc, np.int64))

        def eps_fn(x, t):
            return self.model(x, t, ctx, wid, ph)

        if self.ddim_steps:
            return ddim_sample(self.schedule, eps_fn, x_init.to(self.device),
                               num_steps=self.ddim_steps)
        return ddpm_sample(
            self.schedule, eps_fn, x_init.to(self.device),
            stochastic=self.stochastic, call_mask=self.call_mask, generator=generator,
        )

    @torch.no_grad()
    def decode(self, lat: torch.Tensor):
        """latents -> uint8 images [B, H, W, 3] (+ int32 frame ids [B, T]
        with ``ocr_apply``)."""
        img = latent_to_image(lat, lambda z: decode_from_latent(self.vae, z * 0.18215))
        img = (img * 255.0).to(torch.uint8)  # truncates, as astype does
        if self.ocr_apply is None:
            return img
        gray = img[..., :1].float() / 127.5 - 1.0
        return img, greedy_frame_ids(self.ocr_apply(gray))

    def sample_async(self, words: Sequence[str], writer_ids: Sequence[int],
                     generator: torch.Generator, phosc: Optional[np.ndarray] = None):
        """Queue the whole batch on the device, from x_T ~ N(0, 1) drawn
        with ``generator``, and return its tensors without waiting for
        them; reading them (``.cpu()``) waits."""
        x = torch.randn((len(words),) + self.latent_shape, generator=generator,
                        device=self.device)
        return self.decode(self.denoise(words, writer_ids, x, generator, phosc))

    def sample_preview(self, generator: torch.Generator, words=None, n: int = 3) -> np.ndarray:
        """Fixed-probe-word preview -> uint8 [n, H, W, 3] on the host; the
        writer id is forced to ones like the reference epoch preview
        (``trainModifyCondition.py:574``)."""
        words = list(words or ["text", "getting", "prop"][:n])
        phosc = None
        if self.exp.unet.use_phosc:
            phosc = phosc_ids(words, self.exp.data.phos_version)
        out = self.sample_async(words, [1] * len(words), generator, phosc)
        img = out[0] if isinstance(out, tuple) else out
        return img.cpu().numpy()
