"""CLIP byte-pair-encoding tokenizer in pure Python.

Counterpart of distrifuser_tpu/native/bpe.py (``NativeCLIPTokenizer``),
which runs the merge loop in C++ (clip_bpe.cc) and pre-tokenizes with the
``regex`` package.  This one needs neither; it gives the same ids:

* normalisation: NFC, runs of whitespace to one space, lower case;
* special tokens (<|startoftext|>, <|endoftext|> and the snapshot's pad
  token) split out of the text first, each one id;
* pre-tokenization as CLIP's pattern ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|
  [\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-insensitive) finds its words.
  Python's ``re`` has no ``\\p{L}`` or ``\\p{N}`` (``[^\\W\\d_]`` also takes
  the numeric categories Nl and No), so ``_words`` scans the text and
  classifies each character by ``unicodedata.category``: a letter is a
  category L*, a number N*, whitespace the Unicode White_Space set that
  ``\\s`` matches.  Under the pattern's case-insensitivity U+017F (long s)
  is the ``s`` of ``'s``, and U+0345 (combining ypogegrammeni, whose case
  fold is a letter) matches no alternative and is dropped;
* each word's UTF-8 bytes through the GPT-2 byte-to-unicode table, the last
  symbol marked ``</w>``, merged pair by pair, lowest merge rank first,
  every occurrence of the pair left to right; a symbol not in the vocab is
  the unknown id, which for CLIP is <|endoftext|>;
* framing: <|startoftext|>, at most 75 ids, <|endoftext|>, padded with the
  pad token (<|endoftext|> unless the snapshot names another) to 77.

Construction raises when ``vocab.json`` or ``merges.txt`` is missing.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

# what \s matches in Unicode text (the White_Space property)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_WHITESPACE_RUN = re.compile("[" + "".join(sorted(_WHITESPACE)) + "]+")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # after an apostrophe
_CASE_VARIANTS = {"\u017f": "s"}  # long s is s under case folding
_UNMATCHED = frozenset("\u0345")  # matches none of the pattern's classes
_MAX_WORD_IDS = 4096  # a longer word encodes as the unknown id


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _normalize(text: str) -> str:
    """NFC, whitespace runs to one space, lower case."""
    return _WHITESPACE_RUN.sub(" ", unicodedata.normalize("NFC", text)).lower()


def _kind(ch: str) -> str:
    """"L" letter, "N" number, " " whitespace or unmatched, "O" other."""
    if ch in _WHITESPACE or ch in _UNMATCHED:
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _contraction(text: str, i: int) -> int:
    """Length of the contraction starting at ``text[i]`` ("'s", "'ll", ...),
    0 if there is none."""
    if text[i] != "'":
        return 0
    for suffix in _CONTRACTIONS:
        part = text[i + 1:i + 1 + len(suffix)]
        if "".join(_CASE_VARIANTS.get(c, c) for c in part) == suffix:
            return 1 + len(suffix)
    return 0


def _words(text: str) -> List[str]:
    """The words CLIP's pre-tokenization pattern finds in ``text``, in
    order: at each position the first alternative that matches, else the
    character is skipped."""
    words, i, n = [], 0, len(text)
    while i < n:
        k = _contraction(text, i)
        if k:
            words.append(text[i:i + k])
            i += k
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and others run; a number is one character
            while j < n and _kind(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


class CLIPTokenizer:
    """The call surface pipelines._tokenize uses:
    ``tok(texts, padding="max_length", max_length=tok.model_max_length,
    truncation=True, return_tensors="np")["input_ids"]``."""

    model_max_length = 77

    def __init__(self, tokenizer_dir: str):
        with open(os.path.join(tokenizer_dir, "vocab.json"), encoding="utf-8") as f:
            self._vocab: Dict[str, int] = json.load(f)
        merges = []
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 2 and not line.strip().startswith("#version"):
                    merges.append((parts[0], parts[1]))
        self._ranks: Dict[Tuple[str, str], int] = {}
        for rank, pair in enumerate(merges):  # a repeated pair keeps its first rank
            self._ranks.setdefault(pair, rank)
        self.bos_token_id = self._vocab["<|startoftext|>"]
        self.eos_token_id = self._vocab["<|endoftext|>"]
        # the pad token comes from the snapshot: SD's tokenizer pads with
        # eos, SDXL's tokenizer_2 with "!" (id 0)
        self.pad_token_id = self.eos_token_id
        self._special = {"<|startoftext|>": self.bos_token_id,
                         "<|endoftext|>": self.eos_token_id}
        pad = self._read_pad_token(tokenizer_dir)
        if pad is not None and pad in self._vocab:
            self.pad_token_id = self._vocab[pad]
            self._special[pad] = self.pad_token_id
        self._special_re = re.compile("|".join(
            re.escape(s) for s in sorted(self._special, key=len, reverse=True)))
        self._byte_map = _bytes_to_unicode()
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def _read_pad_token(tokenizer_dir: str):
        """The pad token's string from special_tokens_map.json or
        tokenizer_config.json (a string or an AddedToken dict)."""
        for fname in ("special_tokens_map.json", "tokenizer_config.json"):
            path = os.path.join(tokenizer_dir, fname)
            if not os.path.exists(path):
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    entry = json.load(f).get("pad_token")
            except (OSError, ValueError):
                continue
            if isinstance(entry, dict):
                entry = entry.get("content")
            if isinstance(entry, str):
                return entry
        return None

    def _encode_word(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        mapped = "".join(self._byte_map[b] for b in word.encode("utf-8"))
        syms = list(mapped[:-1]) + [mapped[-1] + "</w>"]
        while len(syms) > 1:
            ranked = [(self._ranks[pair], i) for i, pair in enumerate(zip(syms, syms[1:]))
                      if pair in self._ranks]
            if not ranked:
                break
            best = min(ranked)[1]  # the lowest rank, leftmost among equals
            left, right = syms[best], syms[best + 1]
            merged, i = [], 0
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == left and syms[i + 1] == right:
                    merged.append(left + right)
                    i += 2
                else:
                    merged.append(syms[i])
                    i += 1
            syms = merged
        ids = [self._vocab.get(s, self.eos_token_id) for s in syms]
        if len(ids) > _MAX_WORD_IDS:
            ids = [self.eos_token_id]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """BPE ids of one prompt, without BOS/EOS framing."""
        text = _normalize(text)
        ids: List[int] = []
        pos = 0
        for m in self._special_re.finditer(text):
            for word in _words(text[pos:m.start()]):
                ids.extend(self._encode_word(word))
            ids.append(self._special[m.group(0)])
            pos = m.end()
        for word in _words(text[pos:]):
            ids.extend(self._encode_word(word))
        return ids

    def __call__(self, texts, padding="max_length", max_length=None, truncation=True,
                 return_tensors="np"):
        max_length = max_length or self.model_max_length
        rows = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            row += [self.pad_token_id] * (max_length - len(row))
            rows.append(row[:max_length])
        return {"input_ids": np.asarray(rows, np.int64)}
