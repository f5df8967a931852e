"""Character vocabulary: lowercased text + punctuation -> int ids, pad=0.

The port's own copy of the JAX package's ``data/vocab.py`` (numpy only):
the char->id dict is built from all transcripts, saved beside the data and
reloaded by train/synthesize, so a vocab file from a JAX run loads here.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass

import numpy as np

PAD = 0
_PAD_CHAR = "_"


@dataclass
class Vocab:
    char_to_id: dict[str, int]

    @property
    def id_to_char(self) -> dict[int, str]:
        return {i: c for c, i in self.char_to_id.items()}

    def __len__(self) -> int:
        return len(self.char_to_id)

    @staticmethod
    def build(texts) -> "Vocab":
        chars = sorted({c for t in texts for c in normalize_text(t)})
        mapping = {_PAD_CHAR: PAD}
        for i, c in enumerate(chars, start=1):
            mapping[c] = i
        return Vocab(mapping)

    def encode(self, text: str) -> np.ndarray:
        """Text -> ids. Out-of-vocabulary characters are dropped, with a
        warning: a silent drop would shrink prompts with no explanation."""
        t = normalize_text(text)
        oov = sorted({c for c in t if c not in self.char_to_id})
        if oov:
            warnings.warn(
                f"vocab: dropping {len(oov)} out-of-vocabulary character(s) "
                f"{oov!r} from prompt {t[:40]!r}", stacklevel=2)
        return np.array([self.char_to_id[c] for c in t if c in self.char_to_id],
                        dtype=np.int32)

    def decode(self, ids) -> str:
        inv = self.id_to_char
        return "".join(inv.get(int(i), "") for i in ids if int(i) != PAD)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.char_to_id, f, indent=0, sort_keys=True)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Vocab":
        with open(path) as f:
            return Vocab(json.load(f))


def normalize_text(text: str) -> str:
    """Lowercase and collapse whitespace."""
    return " ".join(text.lower().split())
