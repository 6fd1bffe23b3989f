"""Deterministic hash tokenizer (no external vocab files — offline-safe).

Copied as it is from ``repro.data.tokenizer`` so that token ids match the
reference exactly (the port imports nothing of the JAX package).

Word-level: token id = stable-hash(word) into [N_SPECIAL, vocab). Collisions
are acceptable for a systems reproduction; ids are stable across processes
and machines, so distributed workers agree without a shared vocab file.
Specials: 0=pad, 1=eos, 2=bos, 3=SUPPORTED, 4=REFUTED, 5=NOT_ENOUGH_INFO.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

PAD, EOS, BOS = 0, 1, 2
LABEL_SUPPORTED, LABEL_REFUTED, LABEL_NEI = 3, 4, 5
N_SPECIAL = 8

LABEL_TOKENS = {"SUPPORTED": LABEL_SUPPORTED, "REFUTED": LABEL_REFUTED,
                "NOT ENOUGH INFO": LABEL_NEI}
TOKEN_LABELS = {v: k for k, v in LABEL_TOKENS.items()}


class HashTokenizer:
    def __init__(self, vocab_size: int = 49_152):
        self.vocab_size = vocab_size
        self._reverse: Dict[int, str] = {}

    def token(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.lower().encode()).digest()[:8],
                           "little")
        tid = N_SPECIAL + h % (self.vocab_size - N_SPECIAL)
        self._reverse.setdefault(tid, word.lower())
        return tid

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = [self.token(w) for w in text.split()]
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        words = []
        for t in ids:
            if t == EOS:
                break
            if t in (PAD, BOS):
                continue
            if t in TOKEN_LABELS:
                words.append(TOKEN_LABELS[t])
            else:
                words.append(self._reverse.get(int(t), f"<{int(t)}>"))
        return " ".join(words)
