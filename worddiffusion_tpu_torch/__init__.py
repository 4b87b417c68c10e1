"""worddiffusion_tpu_torch: the PyTorch / CUDA port of worddiffusion_tpu.

The JAX package ``worddiffusion_tpu`` is the reference; this package
mirrors its layout and names and is tested against it. It imports
torch and never jax, nor anything of ``worddiffusion_tpu``: the modules it
needs that hold no JAX (configs, data alphabets, tokenizer and gt parsing,
the noise schedule, the stop flag, ...) are copies, each naming its
original on its first line.

The TPU kernels are hand-written CUDA kernels for Hopper under ``csrc/``;
what is ported and what is left is listed in ROADMAP.md (A).
"""

__version__ = "0.1.0"
