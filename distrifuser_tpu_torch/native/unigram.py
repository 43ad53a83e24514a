"""T5's Unigram tokenizer, read from a snapshot's ``tokenizer/tokenizer.json``,
in pure Python.

The JAX package loads this file through transformers' ``AutoTokenizer``
(distrifuser_tpu/pipelines.py ``_t5_tokenizer_or_fallback``); the port
reads it itself, as it reads the CLIP vocab (native/bpe.py), and gives the
ids and attention mask that the ``tokenizers`` library gives for it:

* special tokens (the file's ``added_tokens``) are split out of the text
  first, each one id;
* the normalizer the file declares: ``Sequence`` of ``Precompiled`` (a
  SentencePiece character map: a double-array trie over UTF-8 bytes and a
  blob of replacement strings), ``Replace`` (string or regex), ``Strip``
  and the Unicode ``NFC`` / ``NFD`` / ``NFKC`` / ``NFKD``.
  ``Precompiled`` goes by grapheme cluster, as the library does: a cluster
  of fewer than 6 bytes that the map knows is replaced whole, else each of
  its characters is looked up alone.  Clusters are approximated as a
  character with the combining marks (categories M*), zero-width-joined
  characters and variation selectors after it, CR LF and regional
  indicator pairs; Hangul jamo sequences and other rules of UAX #29 are
  not followed;
* the pre-tokenizer: ``Sequence`` of ``WhitespaceSplit`` and ``Metaspace``
  (spaces to the replacement "▁", prepended to each piece, the text split
  before each "▁");
* the Unigram model: the best-scoring segmentation of each piece (Viterbi
  over the vocab's log-probabilities, ties to the first path found,
  shorter pieces first); a character no piece starts with is the unknown
  id at the lowest score minus 10, consecutive unknowns fused into one;
* the ``TemplateProcessing`` post-processor's single-sequence template (for
  T5: the ids, then EOS), truncated to ``max_length`` with room left for
  the template's special tokens, then padded with the pad token (mask 0).

Construction raises when the file is missing or declares a model,
normalizer or pre-tokenizer outside this list.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

_UNK_PENALTY = 10.0  # the library's score of an unknown character: min - 10
_ZWJ = "‍"


def _is_regional(ch: str) -> bool:
    return "\U0001f1e6" <= ch <= "\U0001f1ff"


def _graphemes(text: str) -> List[str]:
    """Approximate extended grapheme clusters (module docstring)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        if text[i] == "\r" and j < n and text[j] == "\n":
            j += 1
        elif _is_regional(text[i]) and j < n and _is_regional(text[j]):
            j += 1
        while j < n:
            if unicodedata.category(text[j]).startswith("M"):  # marks, selectors
                j += 1
            elif text[j] == _ZWJ:
                j += 2 if j + 1 < n else 1
            else:
                break
        out.append(text[i:j])
        i = j
    return out


class _Precompiled:
    """SentencePiece's precompiled character map: a little-endian u32 size of
    the trie in bytes, the Darts double array, then the replacement strings,
    each ended by a NUL."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.array = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.strings = blob[4 + size:]

    def _prefix_values(self, key: bytes) -> List[int]:
        array = self.array
        unit = array[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        found = []
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(array):
                break
            unit = array[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                found.append(array[pos] & ((1 << 31) - 1))
        return found

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of ``chunk``: the string of the shortest key that
        prefixes it (the library's rule), or None."""
        found = self._prefix_values(chunk.encode("utf-8"))
        if not found:
            return None
        start = found[0]
        end = self.strings.find(b"\0", start)
        return self.strings[start:end if end >= 0 else None].decode("utf-8")

    def __call__(self, text: str) -> str:
        out = []
        for g in _graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def _normalizer(spec):
    """A str -> str function for the file's ``normalizer`` entry."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(p) for p in spec["normalizers"]]

        def run(s):
            for p in parts:
                s = p(s)
            return s
        return run
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        return _Precompiled(base64.b64decode(blob)) if blob else (lambda s: s)
    if kind == "Replace":
        pattern, content = spec["pattern"], spec["content"]
        if "Regex" in pattern:
            rx = re.compile(pattern["Regex"])
            return lambda s: rx.sub(lambda _: content, s)
        return lambda s: s.replace(pattern["String"], content)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            s = s.lstrip() if left else s
            return s.rstrip() if right else s
        return strip
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    raise ValueError(f"tokenizer.json normalizer {kind!r} is not supported")


def _pre_tokenizer(spec):
    """A str -> [pieces] function for the file's ``pre_tokenizer`` entry."""
    if spec is None:
        return lambda s: [s]
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(s):
            pieces = [s]
            for p in parts:
                pieces = [q for piece in pieces for q in p(piece)]
            return pieces
        return run
    if kind == "WhitespaceSplit":
        return str.split
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme",
                          "always" if spec.get("add_prefix_space", True) else "never")
        split = spec.get("split", True)
        if scheme not in ("always", "never"):
            raise ValueError(f"Metaspace prepend_scheme {scheme!r} is not supported")

        def meta(s):
            if not s:
                return []
            s = s.replace(" ", rep)
            if scheme == "always" and not s.startswith(rep):
                s = rep + s
            if not split:
                return [s]
            # split before each replacement character (merged with the next)
            pieces, start = [], 0
            for i in range(1, len(s)):
                if s[i] == rep:
                    pieces.append(s[start:i])
                    start = i
            pieces.append(s[start:])
            return [p for p in pieces if p]
        return meta
    raise ValueError(f"tokenizer.json pre_tokenizer {kind!r} is not supported")


class UnigramTokenizer:
    """The tokenizer of ``tokenizer_dir/tokenizer.json`` (a Unigram model);
    ``__call__(texts, padding="max_length", max_length, truncation=True,
    return_tensors="np")`` gives ``{"input_ids", "attention_mask"}`` int64
    arrays, as a transformers tokenizer does."""

    model_max_length = 512

    def __init__(self, tokenizer_dir: str):
        path = os.path.join(tokenizer_dir, "tokenizer.json")
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"{path}: model {model.get('type')!r}, expected Unigram")
        self.pieces: Dict[str, Tuple[int, float]] = {}
        for i, (piece, score) in enumerate(model["vocab"]):
            self.pieces.setdefault(piece, (i, float(score)))
        self.unk_id = model.get("unk_id")
        self.unk_score = min(s for _, s in model["vocab"]) - _UNK_PENALTY
        self.max_piece = max(len(p) for p in self.pieces)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.special = {t["content"]: t["id"] for t in spec.get("added_tokens", [])
                        if t.get("special")}
        self._special_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.special, key=len, reverse=True)))
            if self.special else None)
        self._template = self._read_template(spec.get("post_processor"))
        self.pad_token_id = self._read_pad_id(tokenizer_dir)

    def _read_template(self, spec) -> List[Optional[int]]:
        """The single-sequence template: None for the sequence, else a
        special token's id (no post-processor: the sequence alone)."""
        if spec is None:
            return [None]
        if spec["type"] != "TemplateProcessing":
            raise ValueError(f"post_processor {spec['type']!r} is not supported")
        out = []
        for item in spec["single"]:
            if "Sequence" in item:
                out.append(None)
            else:
                name = item["SpecialToken"]["id"]
                out.extend(spec["special_tokens"][name]["ids"])
        return out

    def _read_pad_id(self, tokenizer_dir: str) -> int:
        pad = "<pad>"
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(tokenizer_dir, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    tok = json.load(f).get("pad_token")
                if tok:
                    pad = tok["content"] if isinstance(tok, dict) else tok
                    break
        if pad in self.special:
            return self.special[pad]
        if pad in self.pieces:
            return self.pieces[pad][0]
        raise ValueError(f"pad token {pad!r} is not in the vocab")

    def _viterbi(self, piece: str) -> List[int]:
        """The ids of the best segmentation of one pre-token."""
        n = len(piece)
        best_score = [0.0] + [None] * n
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        for start in range(n):
            base = best_score[start]
            if base is None:
                continue
            single = False
            for end in range(start + 1, min(n, start + self.max_piece) + 1):
                hit = self.pieces.get(piece[start:end])
                if hit is None:
                    continue
                score = base + hit[1]
                if best_score[end] is None or score > best_score[end]:
                    best_score[end], back[end] = score, (start, hit[0])
                single = single or end == start + 1
            if not single:
                score = base + self.unk_score
                if best_score[start + 1] is None or score > best_score[start + 1]:
                    best_score[start + 1], back[start + 1] = score, (start, self.unk_id)
        ids, end = [], n
        while end > 0:
            start, tid = back[end]
            # consecutive unknown characters fuse into one unknown token
            if not (tid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(tid)
            end = start
        return ids[::-1]

    def encode(self, text: str) -> List[int]:
        """The ids of one prompt, without the template's special tokens."""
        ids: List[int] = []
        pos = 0
        chunks = []
        if self._special_re is not None:
            for m in self._special_re.finditer(text):
                chunks.append((text[pos:m.start()], None))
                chunks.append((None, self.special[m.group(0)]))
                pos = m.end()
        chunks.append((text[pos:], None))
        for chunk, special in chunks:
            if special is not None:
                ids.append(special)
                continue
            for piece in self.pre_tokenize(self.normalize(chunk)):
                ids.extend(self._viterbi(piece))
        return ids

    def __call__(self, texts, padding="max_length", max_length=None, truncation=True,
                 return_tensors="np"):
        max_length = max_length or self.model_max_length
        n_special = sum(t is not None for t in self._template)
        rows, masks = [], []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[:max(max_length - n_special, 0)]
            row = []
            for item in self._template:
                row.extend(ids if item is None else [item])
            mask = [1] * len(row)
            pad = max(max_length - len(row), 0)
            rows.append(row + [self.pad_token_id] * pad)
            masks.append(mask + [0] * pad)
        return {"input_ids": np.asarray(rows, np.int64),
                "attention_mask": np.asarray(masks, np.int64)}
