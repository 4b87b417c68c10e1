"""worddiffusion_tpu_torch: the PyTorch / CUDA port of worddiffusion_tpu.

The JAX package ``worddiffusion_tpu`` is the reference; this package
mirrors its layout and names and is tested against it. It imports
torch and never jax. Its jax-free modules (configs, data alphabets,
tokenizer and gt parsing, the noise schedule, the stop flag) are reused
from ``worddiffusion_tpu`` as they are.

Ported so far: the OCR-filtered regeneration path (character encoder,
``iam`` UNet, skip-step DDPM, VAE decode, CTC recognizer, accept filter,
PNG writer) with the fused LayerNorm + GEGLU feed-forward as a CUDA
kernel for Hopper (``csrc/ln_geglu_ffn.cu``).
"""

__version__ = "0.1.0"
