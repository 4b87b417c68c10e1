# Copy of worddiffusion_tpu/data/tokenizer.py: the port imports nothing of the JAX package.
"""Character tokenizer with reference-compatible padding semantics.

Reproduces the reference encoding exactly (``trainModifyCondition.py:
167-210`` and ``train.py:42-68``):

- spaces are replaced by ``_`` before lookup,
- character ids are the alphabet index **shifted by num_tokens (= 1)**,
- sequences are right-padded with ``PAD_TOKEN = 52`` to ``max_chars``.

Note the reference quirk we deliberately preserve for checkpoint /
distribution parity: with the shift, letter index 51 ('z' in the main
alphabet) also encodes to 52, colliding with PAD. The model treats both
identically, matching the published behaviour.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .alphabets import ALPHABETS

PAD_TOKEN = 52


@dataclasses.dataclass(frozen=True)
class Tokenizer:
    alphabet: str
    max_chars: int
    num_tokens: int = 1  # {"PAD_TOKEN": 52} -> 1 special token

    @classmethod
    def from_name(cls, name: str, max_chars: int) -> "Tokenizer":
        return cls(alphabet=ALPHABETS[name], max_chars=max_chars)

    @property
    def num_classes(self) -> int:
        return len(self.alphabet)

    @property
    def vocab_size(self) -> int:
        """Embedding-table size: character classes + special tokens."""
        return self.num_classes + self.num_tokens

    @property
    def letter2index(self) -> dict[str, int]:
        return {c: i for i, c in enumerate(self.alphabet)}

    @property
    def index2letter(self) -> dict[int, str]:
        return {i: c for i, c in enumerate(self.alphabet)}

    def encode(self, word: str) -> np.ndarray:
        """Word -> fixed-length int32 id sequence (reference label_padding)."""
        word = word.replace(" ", "_")
        l2i = self.letter2index
        ids = [l2i[c] + self.num_tokens for c in word]
        if len(ids) > self.max_chars:
            ids = ids[: self.max_chars]
        ids = ids + [PAD_TOKEN] * (self.max_chars - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def encode_batch(self, words: list[str]) -> np.ndarray:
        return np.stack([self.encode(w) for w in words])

    def decode(self, ids) -> str:
        """Best-effort inverse (PAD/'z' collision is irreversible: PAD wins
        once the tail starts)."""
        i2l = self.index2letter
        out = []
        ids = list(np.asarray(ids).reshape(-1))
        # strip the PAD tail first so embedded id-52 chars ('z') survive
        while ids and ids[-1] == PAD_TOKEN:
            ids.pop()
        for t in ids:
            t = int(t) - self.num_tokens
            if t in i2l:
                out.append(i2l[t])
        return "".join(out)

    def dump_json(self, directory: str) -> None:
        """Write letter2index.json / index2letter.json like the reference
        (``trainModifyCondition.py:183-196``)."""
        with open(os.path.join(directory, "letter2index.json"), "w") as f:
            json.dump(self.letter2index, f)
        with open(os.path.join(directory, "index2letter.json"), "w") as f:
            json.dump({str(k): v for k, v in self.index2letter.items()}, f)
