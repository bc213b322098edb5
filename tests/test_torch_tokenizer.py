"""The port's CLIP tokenizer (``gligen_tpu_torch/data/tokenizer.py``, a
scanner over ``unicodedata``) against the JAX package's (the ``regex``
module's pattern), token for token, and the hash fallback bit for bit.

Vocabularies, each written in ``tmp_path``: a small HF-format vocab with
real merges (``tests/test_data.py``'s recipe), the byte-level vocab with
no merges (every text encodes: one token a byte) and the OpenAI ``.gz``
format.  Inputs: ASCII, Unicode letters and marks, numbers of every kind,
contractions, the special tokens, whitespace runs, truncation at 77, and
a property over text drawn from the characters Python's ``unicodedata``
assigns, with the scanner's special cases (U+017F, U+0345, U+001C-U+001F)
and the pattern's literals mixed in.
"""

import gzip
import json
import sys
import unicodedata

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gligen_tpu.data import tokenizer as jtok

from gligen_tpu_torch.data import tokenizer as tok

TEXTS = [
    "hello hello!", "Hello  WORLD", "a b c hello", "", "   ", "hell o hellos",
    "a teddy bear sitting next to a bird", "A Humanoid Robot Designed for Companionship",
    "café naïve résumé", "straße STRASSE", "中文 测试 日本語テキスト", "Ⅻ chapter ² ³ ½ 12345",
    "é combining acute", "it's they're we've I'm you'll he'd don't", "IT'S THEY'RE",
    "<|startoftext|>hi<|endoftext|>", "<|STARTOFTEXT|> x <|endoftext|", "tab\there\nnew\r\nline",
    "punct!!!... ,,;; --> (x)", "ſtart 'ſ long s", "ᾳ iota subscript ͅ alone",
    "\x1c\x1dfile sep\x1e\x1f", " nbsp em　ideo", "emoji 🙂 🎉🎉 ok",
    "مرحبا بالعالم", "Привет, мир", "한국어 텍스트", " ".join(["word"] * 100),
]


def tiny_vocab(tmp_path, merges=True):
    """An HF-format vocab: every byte symbol and its end-of-word form, the
    merges of tests/test_data.py (or none), the two special tokens."""
    base = list(tok._bytes_to_unicode().values())
    vocab = {v: i for i, v in enumerate(base + [v + "</w>" for v in base])}
    pairs = [("h", "e"), ("l", "l"), ("he", "ll"), ("ll", "o</w>"), ("he", "llo</w>")]
    pairs = pairs if merges else []
    for m in pairs:
        vocab["".join(m)] = len(vocab)
    for special in tok.SPECIAL_TOKENS:
        vocab[special] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in pairs))
    return str(tmp_path)


def openai_vocab(tmp_path):
    """OpenAI's bpe_simple_vocab_16e6.txt.gz layout: a header line, then the
    merges (here a few)."""
    merges = ["h e", "l l", "he ll", "ll o</w>", "t h", "th e</w>", "a n", "an d</w>"]
    with gzip.open(tmp_path / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + merges))
    return str(tmp_path)


def assert_same(jt, pt, texts, max_length=tok.MAX_LENGTH):
    for text in texts:
        try:
            want = jt([text], max_length=max_length)
        except KeyError as e:  # a piece the vocab lacks: both must refuse it
            with pytest.raises(KeyError, match=str(e)):
                pt([text], max_length=max_length)
            continue
        got = pt([text], max_length=max_length)
        assert got.dtype == want.dtype and got.tolist() == want.tolist(), text


@pytest.mark.parametrize("kind", ["merges", "bytes", "openai"])
def test_clip_tokenizer_matches_jax(tmp_path, kind):
    path = openai_vocab(tmp_path) if kind == "openai" else tiny_vocab(tmp_path, kind == "merges")
    jt, pt = jtok.CLIPTokenizer.from_pretrained(path), tok.CLIPTokenizer.from_pretrained(path)
    assert pt.encoder == jt.encoder and pt.bpe_ranks == jt.bpe_ranks
    assert (pt.bos, pt.eos) == (jt.bos, jt.eos)
    assert_same(jt, pt, TEXTS)
    assert_same(jt, pt, TEXTS, max_length=16)  # truncation below the texts' lengths


def test_pre_tokenize_matches_the_pattern():
    for text in TEXTS:
        clean = jtok._whitespace_clean(text).lower()
        assert tok._whitespace_clean(text).lower() == clean
        assert tok.pre_tokenize(clean) == jtok.re.findall(jtok._PAT, clean), text


def test_truncation_keeps_the_end_token(tmp_path):
    pt = tok.CLIPTokenizer.from_pretrained(tiny_vocab(tmp_path, merges=False))
    ids = pt([" ".join(["hello"] * 200)])
    assert ids.shape == (1, 77) and ids[0, 0] == pt.bos and ids[0, -1] == pt.eos
    assert (ids[0, 1:-1] != pt.eos).all()


_ASSIGNED = [chr(c) for c in range(sys.maxunicode + 1)
             if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
_PIECES = st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'ſ", "ſ",
                           "ͅ", "\x1c", "\x1f", " ", "  ", "\t", "\n", "<|startoftext|>",
                           "<|endoftext|>", "<|ſtartoftext|>", "hello", "1", "²", "é"])
_TEXT = st.lists(st.one_of(st.sampled_from(_ASSIGNED), _PIECES), max_size=24).map("".join)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=_TEXT)
def test_property_bytes_vocab_matches_jax(text):
    """Over assigned characters, with the literals and special cases mixed
    in: the same pieces, and with the byte-level vocab the same ids."""
    clean = jtok._whitespace_clean(text).lower()
    assert tok._whitespace_clean(text).lower() == clean
    assert tok.pre_tokenize(clean) == jtok.re.findall(jtok._PAT, clean)
    base = list(tok._bytes_to_unicode().values())
    vocab = {v: i for i, v in enumerate(base + [v + "</w>" for v in base] + list(tok.SPECIAL_TOKENS))}
    assert tok.CLIPTokenizer(vocab, [])([text]).tolist() == \
        jtok.CLIPTokenizer(vocab, [])([text]).tolist()


def test_hash_tokenizer_matches_jax():
    texts = TEXTS + ["", "a", "x " * 100]
    want = jtok.HashTokenizer()(texts)
    got = tok.HashTokenizer()(texts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tok.HashTokenizer()(texts, max_length=8),
                          jtok.HashTokenizer()(texts, max_length=8))


def test_load_tokenizer_reads_the_assets_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GLIGEN_TPU_ASSETS", tiny_vocab(tmp_path))
    assert isinstance(tok.load_tokenizer(), tok.CLIPTokenizer)
    monkeypatch.setenv("GLIGEN_TPU_ASSETS", str(tmp_path / "missing"))
    assert isinstance(tok.load_tokenizer(), tok.HashTokenizer)
    with pytest.raises(FileNotFoundError, match="GLIGEN_TPU_ASSETS"):
        tok.load_tokenizer(allow_fallback=False)
