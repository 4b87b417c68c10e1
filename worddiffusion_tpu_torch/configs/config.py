# Copy of worddiffusion_tpu/configs/config.py: the port imports nothing of the JAX package.
"""Typed configuration tree.

Replaces the reference's three overlapping config mechanisms — the
``config.py`` list-index switchboard, per-script argparse flags, and the
missing ``utils/dataGeneration*Config`` modules (SURVEY.md §5) — with a
single immutable dataclass tree. Architecture choices are fixed at
construction; no runtime flag-branching ever reaches a jitted forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Denoiser architecture.

    Defaults reproduce the published model (reference
    ``trainModifyCondition.py:1087-1092`` / ``unet.py:1895-1896``):
    320-channel constant-width UNet, channel_mult (1,1), one res-block
    per level, spatial-transformer attention at full latent resolution,
    4 heads, 320-d context, 339 IAM writers, vocab 54.
    """

    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 1
    channel_mult: tuple = (1, 1)
    attention_resolutions: tuple = (1,)
    transformer_depth: int = 1
    num_heads: int = 4
    context_dim: int = 320
    vocab_size: int = 54
    num_writers: int = 339
    max_seq_len: int = 42          # positional-encoding table length
    dropout: float = 0.0
    use_scale_shift_norm: bool = False
    # Research-UNet quirk (``unet.py:337-341``): the first attention in
    # each transformer block ALSO cross-attends to the text context
    # instead of self-attending. The WordStylist/phosc variant
    # (``unetPhosc.py:224-246``) uses standard self->cross; set False.
    attn1_cross: bool = True
    # PHOSC conditioning: embed the integer phosc descriptor through the
    # character encoder and concat along the sequence axis
    # (``unetPhosc.py:1120-1134``).
    use_phosc: bool = False
    phosc_dim: int = 769           # phos 165 + phoc 604 (eng)
    # Writer style feature vector projected into the context
    # (``unet.py:1243`` wrd_proj 4096->320); 0 disables.
    style_vec_dim: int = 0
    # Reference semantics for ``--wrdChrWrStyl 1`` with imgConditioned=0:
    # the projected style vector REPLACES the character context outright
    # (``unet.py:1628-1629`` ``context = wrdChrWrStyl``). False keeps the
    # (beyond-reference) append-as-extra-token behaviour.
    style_replace_context: bool = False
    # Attention-map return (reference ``--attentionMaps``,
    # ``unet.py:1756-1779``): maps are exposed through the flax
    # 'intermediates' collection.
    return_attn: bool = False
    # Image-latent conditioning experiment (``--imgConditioned``,
    # ``unet.py:886-1049`` ResBlockConditional): reference latents are
    # concatenated to x_t on the channel axis at conv_in.
    img_conditioned: bool = False
    # Per-character glyph-image conditioning (``--charImages``,
    # ``unet.py:1517-1541``): glyph crops are conv-encoded into extra
    # context tokens.
    use_char_images: bool = False
    char_image_size: tuple = (16, 16)
    # Auxiliary CTC OCR head on the final feature map
    # (``unet.py:1054-1092`` CTCtopC).
    ocr_head: bool = False
    ocr_classes: int = 80
    ocr_hidden: int = 256
    ocr_layers: int = 3
    # "group": GroupNorm inside the CTC head (TPU-first default, no
    # running stats to sync under SPMD). "none": no norm — used for
    # converted reference checkpoints, whose eval-mode BatchNorm is
    # folded into the preceding convs by ``convert_reference_unet``.
    ocr_norm: str = "group"
    dtype: str = "bfloat16"        # activation/matmul dtype (params fp32)
    remat: bool = False            # jax.checkpoint the transformer blocks
    # Fused GEGLU feed-forward (the one adopted Pallas kernel: keeps the
    # 2560-wide FF intermediate in VMEM; see ops/ffn_pallas.py).
    # None = auto: on when the backend is TPU (sampling/inference wins
    # ~3%), off on CPU (interpret mode) and off inside Trainer (the
    # XLA-recompute backward costs ~3% on the train step — measured in
    # BENCHMARKS.md round 3). Explicit True/False overrides everywhere.
    use_pallas_ffn: bool | None = None
    # Context-folded cross-attention (models/attention.py
    # CrossAttention._folded): associate the q projection into K and
    # the out projection into V so the flagship's tiny 42-token
    # cross-attention runs as full-width matmuls instead of per-head
    # MXU slivers. Same math, fewer MACs — but MEASURED NEGATIVE on
    # the HBM-bound flagship (BENCHMARKS.md round 4: sampler wash,
    # train step +4.6%): the per-sample effective weights it
    # materialises ([B,C,M]+[B,M,C] ~27 MB/layer/call at B=128) cost
    # more HBM traffic than the MACs they save. None = off. Kept as
    # an explicit opt-in for compute-bound shapes; auto-disabled per
    # call site when heads * context_len > query_dim (PHOSC contexts).
    attn_fold_context: bool | None = None
    # bf16 attention probabilities: scores and the max-subtract stay
    # fp32, but exp/normalise/probs run in bf16, halving the softmax
    # intermediates' traffic and the probs matmul operand. ~0.5% max
    # relative output drift per attention (fp32 softmax is the
    # reference's torch default). None = auto: on for TPU inference,
    # forced off inside Trainer (it perturbs gradients) and off on CPU
    # so the torch-parity tests see the reference numerics.
    fast_softmax: bool | None = None
    # Decoder skip concatenation computed split instead of materialised:
    # GroupNorm(concat(h, skip)) -> conv splits exactly into per-half
    # GroupNorms (groups never straddle the halves when each half's
    # width divides the group width) and two half-K convolutions summed.
    # Same math modulo fp32 accumulation order. MEASURED NEUTRAL
    # in-program (round 5): standalone the split form beats the 640-deep
    # conv emission by ~7%, but inside the compiled denoiser XLA's
    # conv+GroupNorm-stats output fusion changes shape and the win
    # vanishes (9.557 vs 9.573 ms/call chained-50). None = off; kept as
    # a tested opt-in for architectures with wider decoder concats.
    split_skip_conv: bool | None = None


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Stable-Diffusion AutoencoderKL shape (frozen codec, scale
    0.18215: ``trainModifyCondition.py:703-706,1130-1139``)."""

    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scaling_factor: float = 0.18215
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    num_steps: int = 600           # main trainer; original uses 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    # Reverse loop runs t = T-1 .. 1 (t=0 skipped), matching
    # ``train.py:221`` / ``trainModifyCondition.py:568``.
    cfg_scale: float = 0.0         # reference CFG is disabled/broken
    # Regeneration skip-step schedule (``regenerateFromtrain2.py:536``):
    # when enabled, the model is called only on selected steps and the
    # last prediction is reused in between.
    skip_steps: bool = False
    deterministic: bool = False    # regen's noise-free update (:615-618)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "iam"
    gt_path: str = ""
    image_dir: str = ""
    img_height: int = 64
    img_width: int = 256
    max_chars: int = 42
    alphabet: str = "eng_main"
    phos_version: str = "eng"
    latent: bool = True            # train in VAE latent space
    style_classes: int = 339
    latent_cache: Optional[str] = None
    batch_size: int = 2


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh. data axis = batch sharding (DP over ICI); model axis
    = optional tensor sharding of attention/FF weights."""

    data: int = -1                 # -1: all remaining devices
    model: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4               # AdamW (``trainModifyCondition.py:1110``)
    weight_decay: float = 0.01
    epochs: int = 1000
    ema_beta: float = 0.995        # ``train.py:140-170``
    ema_warmup_steps: int = 2000
    cfg_drop_prob: float = 0.1     # 10% context drop (``:716-717``)
    ctc_weight: float = 0.0        # aux OCR CTC loss weight
    ckpt_every_epochs: int = 5
    save_path: str = "./runs/default"
    stop_flag_file: Optional[str] = None
    seed: int = 0
    log_every: int = 50


@dataclasses.dataclass(frozen=True)
class Experiment:
    name: str = "iam"
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Experiment":
        return dataclasses.replace(self, **kw)
