"""WordPiece tokenizer (the paper's Tokenizer module, §3.1) — a copy of
``repro.data.tokenizer``, which the port keeps as its own so it imports
nothing of the JAX package; it is numpy-only and gives the same ids.

SAMP ships a C++ multi-granularity Chinese tokenizer; the substrate here is
a self-contained WordPiece implementation with the three granularities the
paper lists — character-based, wordpiece (greedy longest-match with ##
continuations) and a whitespace/CJK-aware BERT-style pre-tokenizer — plus a
vocabulary trainer so the synthetic-corpus pipeline needs no external
artifacts. Vectorized batch encoding with padding/truncation feeds the
serving engine directly.
"""
from __future__ import annotations

import collections
import re
import unicodedata
from typing import Iterable, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)

_CJK = re.compile(
    "[一-鿿㐀-䶿豈-﫿]")


def pretokenize(text: str) -> list[str]:
    """BERT-style: lowercase, strip accents, split whitespace/punct, and
    treat every CJK codepoint as its own token (the paper's Chinese setting)."""
    text = unicodedata.normalize("NFD", text.lower())
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out, buf = [], []

    def flush():
        if buf:
            out.append("".join(buf))
            buf.clear()

    for ch in text:
        if _CJK.match(ch):
            flush()
            out.append(ch)
        elif ch.isspace():
            flush()
        elif not ch.isalnum():
            flush()
            out.append(ch)
        else:
            buf.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: Sequence[str],
                 granularity: str = "wordpiece"):
        if granularity not in ("wordpiece", "char"):
            raise ValueError(granularity)
        self.granularity = granularity
        self.vocab = list(vocab)
        self.index = {t: i for i, t in enumerate(self.vocab)}
        for s in SPECIALS:
            if s not in self.index:
                raise ValueError(f"vocab missing special token {s}")

    # -- construction -----------------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 8192,
              granularity: str = "wordpiece") -> "WordPieceTokenizer":
        """Frequency-based vocab: whole words + their prefixes/suffix pieces."""
        counts: collections.Counter = collections.Counter()
        for text in corpus:
            for w in pretokenize(text):
                counts[w] += 1
                if granularity == "wordpiece" and len(w) > 1:
                    for i in range(1, len(w)):
                        counts[w[:i]] += 1
                        counts["##" + w[i:]] += 1
        most = [t for t, _ in counts.most_common(vocab_size - len(SPECIALS))]
        return cls(list(SPECIALS) + most, granularity)

    # -- encoding -----------------------------------------------------------
    def _wordpiece(self, word: str) -> list[int]:
        if self.granularity == "char":
            return [self.index.get(c, self.index[UNK]) for c in word]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.index:
                    cur = self.index[piece]
                    break
                end -= 1
            if cur is None:
                return [self.index[UNK]]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str, *, add_special: bool = True) -> list[int]:
        ids: list[int] = [self.index[CLS]] if add_special else []
        for w in pretokenize(text):
            ids.extend(self._wordpiece(w))
        if add_special:
            ids.append(self.index[SEP])
        return ids

    def encode_pair(self, a: str, b: str) -> tuple[list[int], list[int]]:
        """Text-matching input: [CLS] a [SEP] b [SEP] with segment ids."""
        ia = self.encode(a)
        ib = self.encode(b, add_special=False) + [self.index[SEP]]
        return ia + ib, [0] * len(ia) + [1] * len(ib)

    def encode_batch(self, texts: Sequence[str], max_len: int,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(ids (B, max_len) int32, mask (B, max_len) bool), padded/truncated."""
        out = np.full((len(texts), max_len), self.index[PAD], np.int32)
        mask = np.zeros((len(texts), max_len), bool)
        for i, t in enumerate(texts):
            ids = self.encode(t)[:max_len]
            out[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        return out, mask

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.vocab[i] for i in ids if self.vocab[i] not in SPECIALS]
        words: list[str] = []
        for t in toks:
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
