"""Word sampling (port of ``worddiffusion_tpu/generate/sample.py``):
generate word images for (word, writer) pairs.

encode words -> DDPM or DDIM over the latent -> VAE decode -> uint8
images -> OCR forward + per-frame argmax, all queued on the device; only
the uint8 images and the int32 frame ids cross back to the host, when
the caller reads them.

Ported: the latent path with a VAE, DDPM and DDIM (``ddim_eta``), the
fused OCR argmax, the training's preview, PHOSC conditioning (``phosc``),
classifier-free guidance (``cfg_scale``), the interpolation between two
writers (``writer_ids2``, ``mix_rate``) and the style, glyph-image and
reference-latent conditioning, pixel-space models (``exp.data.latent``
False: no VAE, x_T is [B, H, W, 3] and the images come from
``pixel_to_uint8``) and the HiGAN+ denoiser (any module with the UNet's
call signature).

Classifier-free guidance's unconditional call gives PAD character ids,
writer mask 0 and the same PHOSC ids, as the JAX sampler's; unlike it,
the call keeps the style vectors, glyph images and reference latents of
the conditional call. The JAX sampler drops them, which fails at
``conv_in``'s width for a reference-latent model and leaves a
style-replacing model with the PAD context its training never showed it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs.config import Experiment
from ..data.dataset import char_glyphs
from ..data.phosc import phosc_vector
from ..data.tokenizer import PAD_TOKEN, Tokenizer
from ..diffusion.sampler import ddim_sample, ddpm_sample, latent_to_image, pixel_to_uint8
from ..diffusion.schedule import NoiseSchedule
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
        vae: Optional[AutoencoderKL],
        call_mask: Optional[np.ndarray] = None,
        stochastic: bool = True,
        ocr_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        ddim_steps: int = 0,
        cfg_scale: float = 0.0,
        ddim_eta: float = 0.0,
    ):
        """``model``, ``vae`` and ``ocr_apply`` (images [B,H,W,1] in
        [-1,1] -> CTC logits, e.g. a ``CTCRecognizer``) live on one
        device, where sampling runs. With ``ocr_apply`` the OCR forward
        and argmax join the device work and ``sample_async`` returns
        (uint8 images, int32 frame ids). ``ddim_steps`` > 0 samples with
        DDIM over that many steps (``ddim_eta`` 0: deterministic) instead
        of the DDPM loop; ``cfg_scale`` > 0 guides every model call, two
        UNet calls each. A pixel-space ``exp`` (``data.latent`` False) takes
        no ``vae``: the denoiser's output is the image."""
        if exp.data.latent == (vae is None):
            raise ValueError("a latent-space sampler needs the VAE and a pixel-space one "
                             f"takes none (data.latent={exp.data.latent})")
        self.exp = exp
        self.model = model.eval()
        self.vae = None if vae is None else vae.eval()
        self.ocr_apply = ocr_apply
        self.device = next(model.parameters()).device
        self.tokenizer = Tokenizer.from_name(exp.data.alphabet, exp.data.max_chars)
        self.schedule = NoiseSchedule.linear(
            exp.diffusion.num_steps, exp.diffusion.beta_start, exp.diffusion.beta_end
        )
        self.call_mask = call_mask
        self.stochastic = stochastic
        self.ddim_steps = ddim_steps
        self.cfg_scale = cfg_scale
        self.ddim_eta = ddim_eta
        self.latent_shape = ((exp.data.img_height // 8, exp.data.img_width // 8, 4)
                             if exp.data.latent else
                             (exp.data.img_height, exp.data.img_width, 3))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy does not wait for the queue
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.no_grad()
    def denoise(self, words: Sequence[str], writer_ids: Sequence[int],
                x_init: torch.Tensor, generator: Optional[torch.Generator] = None,
                phosc: Optional[np.ndarray] = None, *,
                writer_ids2: Optional[Sequence[int]] = None, mix_rate=None,
                style_vec: Optional[np.ndarray] = None,
                char_images: Optional[np.ndarray] = None,
                cond_latents: Optional[np.ndarray] = None) -> torch.Tensor:
        """The reverse process from an explicit ``x_init`` -> latents
        [B, h, w, 4] fp32 (``generator`` feeds stochastic steps; ``phosc``
        [B, P] int: the PHOSC ids of a ``use_phosc`` model). ``writer_ids2``
        with ``mix_rate`` (a float or one per sample) interpolates towards a
        second writer; ``style_vec`` [B, D], ``char_images`` [B, L, gh, gw,
        1] and ``cond_latents`` [B, h, w, c] (SD-scaled, as
        ``encode_to_latent`` gives them) condition the models trained
        with them."""
        b = len(words)
        ctx = self._to_device(self.tokenizer.encode_batch(list(words)).astype(np.int64))
        wid = self._to_device(np.asarray(writer_ids, np.int64))
        ph = None if phosc is None else self._to_device(np.asarray(phosc, np.int64))
        cond = {
            "style_vec": style_vec, "char_images": char_images, "cond_latents": cond_latents,
        }
        cond = {k: self._to_device(np.asarray(v, np.float32)) for k, v in cond.items()
                if v is not None}
        mix = {}
        if writer_ids2 is not None:
            mix = {"writer_id2": self._to_device(np.asarray(writer_ids2, np.int64)),
                   "mix_rate": self._to_device(np.broadcast_to(
                       np.asarray(mix_rate, np.float32), (b,)).copy())}

        def call(*args, **kw):
            out = self.model(*args, **kw, **cond)
            return out[0] if isinstance(out, tuple) else out  # an aux head's logits go unused

        def eps_fn(x, t):
            return call(x, t, ctx, wid, ph, **mix)

        uncond_fn = None
        if self.cfg_scale > 0:
            pad_ctx = torch.full_like(ctx, PAD_TOKEN)
            no_writer = torch.zeros(b, device=self.device)

            def uncond_fn(x, t):
                return call(x, t, pad_ctx, wid, ph, writer_mask=no_writer)

        x_init = x_init.to(self.device)
        if self.ddim_steps:
            return ddim_sample(self.schedule, eps_fn, x_init, num_steps=self.ddim_steps,
                               eta=self.ddim_eta, cfg_scale=self.cfg_scale,
                               uncond_eps_fn=uncond_fn, generator=generator)
        return ddpm_sample(
            self.schedule, eps_fn, x_init, stochastic=self.stochastic,
            call_mask=self.call_mask, generator=generator, cfg_scale=self.cfg_scale,
            uncond_eps_fn=uncond_fn,
        )

    @torch.no_grad()
    def decode(self, lat: torch.Tensor):
        """latents (or pixel-space images in [-1, 1]) -> uint8 images [B, H,
        W, 3] (+ int32 frame ids [B, T] with ``ocr_apply``)."""
        if self.vae is None:
            img = pixel_to_uint8(lat)
        else:
            img = latent_to_image(lat, lambda z: decode_from_latent(self.vae, z * 0.18215))
            img = (img * 255.0).to(torch.uint8)  # truncates, as astype does
        if self.ocr_apply is None:
            return img
        gray = img[..., :1].float() / 127.5 - 1.0
        return img, greedy_frame_ids(self.ocr_apply(gray))

    def sample_async(self, words: Sequence[str], writer_ids: Sequence[int],
                     generator: torch.Generator, phosc: Optional[np.ndarray] = None, **cond):
        """Queue the whole batch on the device, from x_T ~ N(0, 1) drawn
        with ``generator``, and return its tensors without waiting for
        them; reading them (``.cpu()``) waits. ``cond``: ``denoise``'s
        keyword conditionings."""
        x = torch.randn((len(words),) + self.latent_shape, generator=generator,
                        device=self.device)
        return self.decode(self.denoise(words, writer_ids, x, generator, phosc, **cond))

    def sample_preview(self, generator: torch.Generator, words=None, n: int = 3) -> np.ndarray:
        """Fixed-probe-word preview -> uint8 [n, H, W, 3] on the host; the
        writer id is forced to ones like the reference epoch preview
        (``trainModifyCondition.py:574``). A reference-latent model gets a
        neutral (zero) reference and a glyph model the words' glyph crops, as
        in the JAX preview; a style model's
        preview has no style vector, and its context stays the words'."""
        words = list(words or ["text", "getting", "prop"][:n])
        phosc = None
        if self.exp.unet.use_phosc:
            phosc = phosc_ids(words, self.exp.data.phos_version)
        cond = {}
        if self.exp.unet.use_char_images:
            cond["char_images"] = np.stack([char_glyphs(w, self.exp.data.max_chars,
                                                        self.exp.unet.char_image_size)
                                            for w in words])
        if self.exp.unet.img_conditioned:
            cond["cond_latents"] = np.zeros((len(words),) + self.latent_shape, np.float32)
        out = self.sample_async(words, [1] * len(words), generator, phosc, **cond)
        img = out[0] if isinstance(out, tuple) else out
        return img.cpu().numpy()
