"""PyTorch port: the pure-Python CLIP BPE tokenizer against the JAX package's.

The port's ``native.bpe.CLIPTokenizer`` (``unicodedata`` classes, no
``regex``, no compiled merge loop) and the JAX package's
``NativeCLIPTokenizer`` (``regex`` pre-tokenization, C++ merges) read the
same fabricated CLIP vocab and must give the same ids: on fixed prompts
(merges, contractions, case, whitespace runs, digits, punctuation, special
tokens, truncation), with an SDXL-style "!" pad token, and over a
``hypothesis`` sweep of Unicode text drawn from letters, decimal, letter
and other numbers (Nd, Nl, No), marks, punctuation, symbols, apostrophes
and runs of whitespace (characters assigned in this Python's Unicode
database, which is the one the port classifies with).
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from distrifuser_tpu.native.bpe import NativeCLIPTokenizer
from distrifuser_tpu_torch.native import bpe
from test_torch_port_snapshots import write_vocab

PROMPTS = [
    "Astronaut in a jungle, cold color palette, muted colors, detailed, 8k",
    "THE THEATER and the colors",
    "  multiple   spaces\tand\nnewlines　and nbsp  ",
    "it's the cat's color, we'll see; they'd've 'S 'LL",
    "",
    "punctuation!!! (nested), [brackets]; #hash été naïve",
    "digits 123 456 ٣٤ Ⅷ ½",
    "word " * 120,
    "literal <|endoftext|> inside <|startoftext|>a prompt",
    "long s: cat'ſ hat, ypogegrammeni aͅb, ! pad !",
    "Ｆｕｌｌｗｉｄｔｈ ＡＢＣ and café (NFC)",
]


@pytest.fixture(scope="module", params=[None, "!"], ids=["eos_pad", "bang_pad"])
def tokenizers(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("tokenizer")
    write_vocab(d, pad=request.param)
    return bpe.CLIPTokenizer(str(d)), NativeCLIPTokenizer(str(d))


def _ids(tok, texts):
    return tok(texts, padding="max_length", max_length=77, truncation=True,
               return_tensors="np")["input_ids"]


def test_prompts_match_jax(tokenizers):
    port, ref = tokenizers
    np.testing.assert_array_equal(_ids(port, PROMPTS), _ids(ref, PROMPTS))
    assert port.pad_token_id == ref.pad_token_id
    assert port.bos_token_id == ref.bos_token_id and port.eos_token_id == ref.eos_token_id


def test_encode_matches_jax_untruncated(tokenizers):
    port, ref = tokenizers
    for text in PROMPTS:
        assert port.encode(text) == ref.encode(text)


TEXT = st.text(
    alphabet=st.one_of(
        st.characters(categories=["Lu", "Ll", "Lt", "Lm", "Lo", "Nd", "Nl", "No", "Mn",
                                  "Mc", "Me", "Pc", "Pd", "Ps", "Pe", "Pi", "Po", "Pf",
                                  "Sm", "Sc", "Sk", "So", "Zs"]),
        st.sampled_from(list("'sStTdDmMlLrReEvV \t\n\r\x0b\x0c\x1c\x85 　ſ"
                             "ͅ!")),
    ),
    max_size=60)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_unicode_sweep_matches_jax(tokenizers, text):
    port, ref = tokenizers
    assert port.encode(text) == ref.encode(text)


def test_missing_vocab_raises(tmp_path):
    with pytest.raises(OSError):
        bpe.CLIPTokenizer(str(tmp_path))


def test_words_follow_clip_pattern():
    assert bpe._words("it's 12 cats!! don't") == ["it", "'s", "1", "2", "cats", "!!",
                                                  "don", "'t"]
    assert bpe._words("''s Ⅷx ͅ") == ["''", "s", "Ⅷ", "x"]
