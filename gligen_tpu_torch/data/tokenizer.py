"""Host-side CLIP BPE tokenizer (counterpart of ``gligen_tpu/data/tokenizer.py``).

The tokenizer behind FrozenCLIPEmbedder (HF CLIPTokenizer for
openai/clip-vit-large-patch14): byte-level BPE with the ``</w>``
end-of-word marker, whitespace cleanup, lowercasing, 77 ids a text wrapped
in <|startoftext|> / <|endoftext|>, truncated, padded with the end token.

Vocab files are not bundled: ``vocab_path`` or $GLIGEN_TPU_ASSETS names a
directory holding HF-format ``vocab.json`` + ``merges.txt`` (or the OpenAI
``bpe_simple_vocab_16e6.txt.gz``).  A deterministic hash fallback serves
smoke runs and benchmarks where real text conditioning is not needed.

The JAX package splits text with the ``regex`` module's pattern

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE, and cleans whitespace with its ``\\s+``.  ``regex`` is not
everywhere (the standard ``re`` has no ``\\p{..}``), so this module scans the
text itself over ``unicodedata``'s categories, to the same tokens:

  * at each position the first alternative that matches wins: a special
    token, a contraction, a maximal run of letters (category L*), one
    number character (N*), or a maximal run of characters that are none of
    whitespace, letter or number; a character that starts none of them is
    skipped;
  * whitespace is ``regex``'s ``\\s``: ``str.isspace`` less U+001C..U+001F;
  * IGNORECASE, on text already lowercased, changes two things: U+017F
    (long s, its own lowercase) matches the literal ``s`` of a contraction
    or special token, and U+0345 (combining ypogegrammeni, Mn, whose
    uppercase is a letter) matches none of the three classes, so it is
    skipped and ends any run.
"""

from __future__ import annotations

import gzip
import json
import os
import unicodedata
import zlib
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_LENGTH = 77
SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
_LITERALS = SPECIAL_TOKENS + ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")  # str.isspace, not regex's \s
_LONG_S = "\u017f"  # long s: matches "s" under IGNORECASE
_NO_CLASS = "\u0345"  # matches no class under IGNORECASE


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_space(ch: str) -> bool:
    return ch.isspace() and ch not in _NOT_SPACE


def _whitespace_clean(text: str) -> str:
    """Each run of whitespace as one space, then stripped (``re.sub(r"\\s+",
    " ", text).strip()`` with ``regex``'s ``\\s``; ``strip`` is Python's)."""
    out: List[str] = []
    for ch in text:
        if not _is_space(ch):
            out.append(ch)
        elif not out or out[-1] != " ":
            out.append(" ")
    return "".join(out).strip()


def _kind(ch: str) -> str:
    """"L" (letter), "N" (number), "O" (neither, nor whitespace) or "" (a
    character no class matches: whitespace, U+0345)."""
    if ch == _NO_CLASS or _is_space(ch):
        return ""
    cat = unicodedata.category(ch)
    return cat[0] if cat[0] in "LN" else "O"


def _literal_at(text: str, i: int, lit: str) -> bool:
    if i + len(lit) > len(text):
        return False
    return all(t == c or (c == "s" and t == _LONG_S) for t, c in zip(text[i:i + len(lit)], lit))


def pre_tokenize(text: str) -> List[str]:
    """The pieces ``regex.findall(_PAT, text)`` gives (module docstring)."""
    pieces: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((lit for lit in _LITERALS if _literal_at(text, i, lit)), None)
        if lit is not None:
            pieces.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind in ("L", "O"):
            while j < n and _kind(text[j]) == kind:
                j += 1
        if kind:
            pieces.append(text[i:j])
        i = j
    return pieces


class CLIPTokenizer:
    """BPE tokenizer; ``__call__(texts)`` -> (B, 77) int32 ids."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, str] = {t: t for t in SPECIAL_TOKENS}

    @classmethod
    def from_pretrained(cls, path: Optional[str] = None) -> "CLIPTokenizer":
        """From ``path`` (else $GLIGEN_TPU_ASSETS): HF ``vocab.json`` +
        ``merges.txt``, or OpenAI's ``bpe_simple_vocab_16e6.txt.gz``."""
        path = path or os.environ.get("GLIGEN_TPU_ASSETS", "")
        vocab_json = os.path.join(path, "vocab.json")
        merges_txt = os.path.join(path, "merges.txt")
        openai_gz = os.path.join(path, "bpe_simple_vocab_16e6.txt.gz")
        if os.path.exists(vocab_json) and os.path.exists(merges_txt):
            with open(vocab_json) as f:
                vocab = json.load(f)
            with open(merges_txt) as f:
                lines = f.read().split("\n")
            merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
            return cls(vocab, merges)  # type: ignore[arg-type]
        if os.path.exists(openai_gz):
            with gzip.open(openai_gz) as f:
                merges_raw = f.read().decode("utf-8").split("\n")[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges_raw]
            vocab_list = list(_bytes_to_unicode().values())
            vocab_list = vocab_list + [v + "</w>" for v in vocab_list]
            vocab_list += ["".join(m) for m in merges]
            vocab_list += list(SPECIAL_TOKENS)
            return cls({v: i for i, v in enumerate(vocab_list)}, merges)  # type: ignore[arg-type]
        raise FileNotFoundError(
            f"No CLIP vocab found under {path!r}. Provide vocab.json+merges.txt "
            "(HF format) or bpe_simple_vocab_16e6.txt.gz (OpenAI format), or "
            "set $GLIGEN_TPU_ASSETS."
        )

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in pre_tokenize(_whitespace_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LENGTH) -> np.ndarray:
        """Batch-encode with the start/end wrap, truncation and end-token
        padding (HF's padding='max_length', truncation=True)."""
        out = np.full((len(texts), max_length), self.eos, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos] + self.encode(text)[: max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in when no vocab is available (smoke runs and
    benchmarks only: NOT the real CLIP vocabulary)."""

    vocab_size = 49408
    bos, eos = 49406, 49407

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LENGTH) -> np.ndarray:
        out = np.full((len(texts), max_length), self.eos, dtype=np.int32)
        for i, text in enumerate(texts):
            words = _whitespace_clean(text).lower().split(" ")
            # crc32, not hash(): str hash() is salted per process, so two
            # processes would tokenize the same text differently
            ids = [zlib.crc32(w.encode()) % (self.vocab_size - 1000) for w in words if w]
            row = [self.bos] + ids[: max_length - 2] + [self.eos]
            out[i, : len(row)] = row
        return out


def load_tokenizer(path: Optional[str] = None, allow_fallback: bool = True):
    """The CLIP tokenizer of ``path`` (or $GLIGEN_TPU_ASSETS); without a
    vocab the hash fallback when ``allow_fallback``, else FileNotFoundError."""
    try:
        return CLIPTokenizer.from_pretrained(path)
    except FileNotFoundError:
        if allow_fallback:
            return HashTokenizer()
        raise
