"""Tokenization (SURVEY.md §2.1): text → (ids, mask) numpy batches.

An in-repo WordPiece tokenizer, so the main path needs no tokenizer
library. The default path trains the vocabulary from the corpus itself
(the environment is offline: no pretrained vocab can be downloaded); a
pretrained BERT/MiniLM ``tokenizer.json`` (HuggingFace format) loads its
WordPiece vocab straight from the JSON, keeping parity with
HF-checkpoint encoders.

  - normalisation (BERT): drop control characters, lowercase, strip
    accents, and split on whitespace and punctuation (each punctuation
    character is its own word);
  - training: word frequencies, then frequency-ranked merges of adjacent
    pieces (continuation pieces carry the ``##`` prefix) until the vocab
    reaches ``vocab_size``;
  - encoding: greedy longest-match-first per word, ``[UNK]`` for words
    with no cover, ``[CLS] … [SEP]``, truncated to ``max_len``.
"""

from __future__ import annotations

import heapq
import json
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"
_SPECIALS = [PAD, UNK, CLS, SEP]
_PREFIX = "##"
_MAX_WORD_CHARS = 100


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def pre_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """BERT normalisation + whitespace/punctuation split."""
    if lowercase:
        text = unicodedata.normalize("NFD", text.lower())
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    words, cur = [], []
    for ch in text:
        cat = unicodedata.category(ch)
        if ch.isspace():
            if cur:
                words.append("".join(cur))
                cur = []
        elif cat.startswith("C") or ord(ch) in (0, 0xFFFD):
            continue  # control / unassigned characters are dropped
        elif _is_punct(ch):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


def _train_vocab(word_freq: Counter, vocab_size: int) -> list[str]:
    """Specials + alphabet, then merges of the most frequent adjacent
    piece pair (ties broken lexicographically, so training is
    deterministic) until vocab_size or no pair is left."""
    vocab = list(_SPECIALS)
    seen = set(vocab)
    words = []
    for w, f in word_freq.items():
        if len(w) > _MAX_WORD_CHARS:
            continue
        syms = [w[0]] + [_PREFIX + c for c in w[1:]]
        words.append([syms, f])
        for s in syms:
            if s not in seen:
                seen.add(s)
                vocab.append(s)
    vocab = vocab[:4] + sorted(vocab[4:])
    pairs: Counter = Counter()
    where: dict[tuple[str, str], set[int]] = {}
    for wi, (syms, f) in enumerate(words):
        for a, b in zip(syms, syms[1:]):
            pairs[(a, b)] += f
            where.setdefault((a, b), set()).add(wi)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    while len(vocab) < vocab_size and heap:
        negc, pair = heapq.heappop(heap)
        if pairs.get(pair, 0) != -negc or negc == 0:
            continue  # stale heap entry
        a, b = pair
        merged = a + b[len(_PREFIX):]
        touched: Counter = Counter()
        for wi in where.pop(pair, ()):
            syms, f = words[wi]
            i, out = 0, []
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            for p in zip(syms, syms[1:]):
                touched[p] -= f
            for p in zip(out, out[1:]):
                touched[p] += f
                where.setdefault(p, set()).add(wi)
            words[wi][0] = out
        for p, d in touched.items():
            if d:
                pairs[p] += d
                if pairs[p] > 0:
                    heapq.heappush(heap, (-pairs[p], p))
        pairs.pop(pair, None)
        if merged not in seen:
            seen.add(merged)
            vocab.append(merged)
    return vocab


class TextTokenizer:
    def __init__(self, vocab: list[str] | dict[str, int], max_len: int = 256,
                 lowercase: bool = True):
        if isinstance(vocab, dict):
            self._vocab = dict(vocab)
        else:
            self._vocab = {t: i for i, t in enumerate(vocab)}
        self.max_len = max_len
        self.lowercase = lowercase
        self.pad_id = self._vocab.get(PAD, 0)
        self._unk = self._vocab[UNK]
        self._cls = self._vocab.get(CLS)
        self._sep = self._vocab.get(SEP)
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def train(
        cls,
        corpus: Iterable[str] | Iterator[str],
        vocab_size: int = 30522,
        max_len: int = 256,
    ) -> "TextTokenizer":
        freq: Counter = Counter()
        for text in corpus:
            freq.update(pre_tokenize(text))
        return cls(_train_vocab(freq, vocab_size), max_len)

    @classmethod
    def load(cls, path: str | Path, max_len: int = 256) -> "TextTokenizer":
        """Read a HuggingFace-format ``tokenizer.json`` (WordPiece model)."""
        spec = json.loads(Path(path).read_text())
        model = spec["model"]
        assert model.get("type", "WordPiece") == "WordPiece", model.get("type")
        assert model.get("continuing_subword_prefix", _PREFIX) == _PREFIX
        norm = spec.get("normalizer") or {}
        return cls(model["vocab"], max_len,
                   lowercase=bool(norm.get("lowercase", True)))

    def save(self, path: str | Path) -> None:
        """Write the vocab as a HuggingFace-format ``tokenizer.json``."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        specials = [{"id": self._vocab[t], "content": t, "single_word": False,
                     "lstrip": False, "rstrip": False, "normalized": False,
                     "special": True} for t in _SPECIALS if t in self._vocab]
        spec = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": specials,
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": True,
                           "strip_accents": None,
                           "lowercase": self.lowercase},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {
                "type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": CLS, "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}},
                           {"SpecialToken": {"id": SEP, "type_id": 0}}],
                "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                         {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {
                    t: {"id": t, "ids": [self._vocab[t]], "tokens": [t]}
                    for t in (CLS, SEP) if t in self._vocab},
            },
            "decoder": {"type": "WordPiece", "prefix": _PREFIX,
                        "cleanup": True},
            "model": {"type": "WordPiece", "unk_token": UNK,
                      "continuing_subword_prefix": _PREFIX,
                      "max_input_chars_per_word": _MAX_WORD_CHARS,
                      "vocab": self._vocab},
        }
        path.write_text(json.dumps(spec, ensure_ascii=False))

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def _word_ids(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        out: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while end > start:
                sub = word[start:end] if not start else _PREFIX + word[start:end]
                piece = self._vocab.get(sub)
                if piece is not None:
                    break
                end -= 1
            if piece is None:  # no cover: the whole word is unknown
                out = [self._unk]
                break
            out.append(piece)
            start = end
        if len(word) > _MAX_WORD_CHARS:
            out = [self._unk]
        if len(self._cache) < 1 << 20:
            self._cache[word] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids of one text with [CLS]/[SEP], untruncated."""
        ids = [self._cls] if self._cls is not None else []
        for w in pre_tokenize(text, self.lowercase):
            ids.extend(self._word_ids(w))
        if self._sep is not None:
            ids.append(self._sep)
        return ids

    def decode(self, ids) -> str:
        inv = {i: t for t, i in self._vocab.items()}
        out: list[str] = []
        for i in ids:
            t = inv.get(int(i), UNK)
            if t in (PAD, CLS, SEP):
                continue
            if t.startswith(_PREFIX) and out:
                out[-1] += t[len(_PREFIX):]
            else:
                out.append(t)
        return " ".join(out)

    def encode_batch(self, texts: list[str], max_len: int | None = None):
        """→ (ids (B, L) int32, mask (B, L) int32), truncated + padded."""
        max_len = max_len or self.max_len
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for r, t in enumerate(texts):
            e = self.encode(t)[:max_len]
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1
        return ids, mask
