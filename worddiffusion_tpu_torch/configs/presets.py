# Copy of worddiffusion_tpu/configs/presets.py: the port imports nothing of the JAX package.
"""Experiment presets for every dataset family the reference supports.

Each preset replaces one of the reference's script forks:
- ``iam``            -> trainModifyCondition.py (MAX_CHARS 42, 339 writers)
- ``iam_base``       -> train.py (original WordStylist, 1000 steps,
                        MAX_CHARS 10, vocab 53, self->cross attention)
- ``iam_phosc``      -> trainModifyCondition.py --phosc=1 (UNetModelPhosc)
- ``gw``             -> trainGWModifyCondition.py (MAX_CHARS 16)
- ``cvl``            -> regenerateFromtrainWord22CVL.py alphabet
- ``norwegian``      -> trainNorModifyCondition.py (MAX_CHARS 25,
                        48 writer styles, nor alphabet, phos 180/phoc 646)
"""

from __future__ import annotations

import dataclasses

from ..data.alphabets import ALPHABETS, phoc_dim, phos_dim
from .config import (
    DataConfig,
    DiffusionConfig,
    Experiment,
    UNetConfig,
)


def _vocab(alphabet: str) -> int:
    return len(ALPHABETS[alphabet]) + 1  # + PAD


def iam() -> Experiment:
    return Experiment(
        name="iam",
        unet=UNetConfig(vocab_size=_vocab("eng_main"), num_writers=339, max_seq_len=42),
        data=DataConfig(dataset="iam", max_chars=42, alphabet="eng_main", style_classes=339),
        diffusion=DiffusionConfig(num_steps=600),
    )


def iam_base() -> Experiment:
    return Experiment(
        name="iam_base",
        unet=UNetConfig(
            vocab_size=_vocab("eng_base"),
            num_writers=339,
            max_seq_len=10,
            attn1_cross=False,
        ),
        data=DataConfig(dataset="iam", max_chars=10, alphabet="eng_base"),
        diffusion=DiffusionConfig(num_steps=1000),
    )


def iam_phosc() -> Experiment:
    dim = phos_dim("eng") + phoc_dim("eng")
    return Experiment(
        name="iam_phosc",
        unet=UNetConfig(
            vocab_size=_vocab("eng_main"),
            num_writers=339,
            max_seq_len=42,
            attn1_cross=False,
            use_phosc=True,
            phosc_dim=dim,
        ),
        data=DataConfig(dataset="iam", max_chars=42, alphabet="eng_main"),
        diffusion=DiffusionConfig(num_steps=600),
    )


def gw() -> Experiment:
    dim = phos_dim("gw") + phoc_dim("gw")
    return Experiment(
        name="gw",
        unet=UNetConfig(
            vocab_size=_vocab("eng_main"),
            num_writers=339,
            max_seq_len=16,
            attn1_cross=False,
            use_phosc=True,
            phosc_dim=dim,
        ),
        data=DataConfig(
            dataset="gw", max_chars=16, alphabet="eng_main", phos_version="gw"
        ),
        diffusion=DiffusionConfig(num_steps=600),
    )


def cvl() -> Experiment:
    return Experiment(
        name="cvl",
        unet=UNetConfig(vocab_size=_vocab("cvl"), num_writers=310, max_seq_len=42),
        data=DataConfig(dataset="cvl", max_chars=42, alphabet="cvl", style_classes=310),
        diffusion=DiffusionConfig(num_steps=600),
    )


def norwegian() -> Experiment:
    return Experiment(
        name="norwegian",
        unet=UNetConfig(
            vocab_size=_vocab("nor"),
            num_writers=48,
            max_seq_len=25,
        ),
        data=DataConfig(
            dataset="norwegian",
            max_chars=25,
            alphabet="nor",
            phos_version="nor",
            style_classes=48,
        ),
        diffusion=DiffusionConfig(num_steps=600),
    )


PRESETS = {
    "iam": iam,
    "iam_base": iam_base,
    "iam_phosc": iam_phosc,
    "gw": gw,
    "cvl": cvl,
    "norwegian": norwegian,
}


def get(name: str, **overrides) -> Experiment:
    exp = PRESETS[name]()
    if overrides:
        exp = dataclasses.replace(exp, **overrides)
    return exp
