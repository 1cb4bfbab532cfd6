"""CLIP byte-pair-encoding tokenizer — host-side, pure Python.

The reference calls `clip.tokenize(labels)` (OpenAI CLIP's
SimpleTokenizer) at model init and per custom label set
(reference: modules/models/lseg_net.py:158-164). Tokenization is
host-side there too, so a Python implementation is the right layer; the
token ids feed the jit'd `CLIPTextEncoder`.

This is a from-scratch implementation of the standard byte-level BPE
algorithm with CLIP's conventions:

- text is mojibake-repaired (a minimal ftfy.fix_text equivalent for
  the UTF-8-as-cp1252/latin-1 case, see `_fix_mojibake`), lowercased,
  html-unescaped and whitespace-collapsed;
- words are split with CLIP's regex (contractions, letter runs, digit
  singletons, punctuation runs);
- each word's bytes map through a reversible byte→unicode table, the
  final character gets a '</w>' suffix, then merges apply lowest-rank
  first;
- vocab = 256 byte symbols + 256 '</w>' byte symbols + the merge list
  + <|startoftext|> / <|endoftext|> (49408 total for the released CLIP
  vocab);
- encoded sequences are '<sot> ids <eot>' padded with zeros to
  context_length=77, truncating overlong inputs with eot kept at the end
  (clip.tokenize(truncate=True) semantics).

The merge table is learned data (`bpe_simple_vocab_16e6.txt.gz`, shipped
with OpenAI CLIP) and must be supplied via `vocab_path` — it cannot be
synthesized. `ClipBPETokenizer.for_tests()` builds a tiny deterministic
vocab for unit tests.
"""

from __future__ import annotations

import functools
import gzip
import html
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

try:
    import regex as _re
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is in the image
    import re as _re
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
        _re.IGNORECASE,
    )

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@functools.lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-char table (GPT-2 convention):
    printable ASCII/latin bytes map to themselves, the rest to a private
    range starting at U+0100."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    table = {}
    extra = 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(0x100 + extra)
            extra += 1
    return table


def _fix_mojibake(text: str) -> str:
    """Minimal ftfy.fix_text equivalent for the case that matters:
    UTF-8 bytes mis-decoded as cp1252/latin-1 ('cafÃ©' -> 'café'),
    including the double-encoded form ('cafÃƒÂ©', two passes).

    The reference pipeline runs ftfy.fix_text before html.unescape
    (reference: clip/clip.py basic_clean via modules/models/
    lseg_net.py:158-164's clip.tokenize). ftfy's core heuristic is the
    same round-trip used here: re-encode with a legacy single-byte
    codec and accept the result only if it is strict, valid UTF-8 that
    actually changed the string — genuine accented/CJK text survives
    untouched because its legacy re-encoding either fails or is not
    valid UTF-8 (e.g. 'café'.encode('cp1252') = b'caf\\xe9', an
    invalid UTF-8 continuation). ftfy's long tail (curly-quote
    repair across other codec pairs, encoding-detection scoring) is
    out of scope: label strings never trip it."""
    for _ in range(2):
        if text.isascii():
            return text
        for codec in ("cp1252", "latin-1"):
            try:
                fixed = text.encode(codec).decode("utf-8")
                break
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
        else:
            return text
        if fixed == text:
            return text
        text = fixed
    return text


def _clean(text: str) -> str:
    text = _fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


class ClipBPETokenizer:
    """CLIP-compatible BPE tokenizer built from a merges file."""

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 context_length: int = 77):
        self.context_length = context_length
        btab = byte_unicode_table()
        self.byte_encoder = btab
        base = list(btab.values())
        vocab: List[str] = base + [c + "</w>" for c in base]
        for a, b in merges:
            vocab.append(a + b)
        vocab.extend([SOT, EOT])
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self.ranks: Dict[Tuple[str, str], int] = {
            tuple(m): i for i, m in enumerate(merges)
        }
        self.sot = self.encoder[SOT]
        self.eot = self.encoder[EOT]
        self._bpe_cache: Dict[str, List[str]] = {}

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_file(cls, vocab_path: str,
                  context_length: int = 77) -> "ClipBPETokenizer":
        """Load from CLIP's `bpe_simple_vocab_16e6.txt.gz` (or a plain-text
        merges file: one 'left right' pair per line; the CLIP file has a
        header line and is truncated to 48894+1 entries)."""
        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # CLIP convention: drop version header, keep merges 1..48894.
        lines = lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        return cls(merges, context_length)

    @classmethod
    def for_tests(cls, context_length: int = 16) -> "ClipBPETokenizer":
        """Tiny deterministic vocab: merges over a few common letter pairs
        so unit tests exercise the real merge loop."""
        merges = [
            ("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"),
            ("a", "t</w>"), ("d", "o"), ("do", "g</w>"), ("e", "r</w>"),
            ("o", "t"), ("h", "er</w>"), ("ot", "her</w>"),
        ]
        return cls(merges, context_length)

    # -- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        if len(word) == 1:
            self._bpe_cache[token] = word
            return word
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(
                pairs, key=lambda p: self.ranks.get(p, float("inf"))
            )
            if best not in self.ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and (word[i], word[i + 1]) == best
                ):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._bpe_cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_clean(text)):
            if tok == SOT:
                ids.append(self.sot)
                continue
            if tok == EOT:
                ids.append(self.eot)
                continue
            mapped = "".join(
                self.byte_encoder[b] for b in tok.encode("utf-8")
            )
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(
            self.decoder[i] for i in ids
            if i not in (self.sot, self.eot, 0)
        )
        rev = {v: k for k, v in self.byte_encoder.items()}
        raw = bytes(rev[c] for c in text)
        return (
            raw.decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )

    def __call__(self, texts) -> np.ndarray:
        """clip.tokenize semantics: (K, context_length) int32, rows
        '<sot> ids <eot> 0...', truncate-with-eot when overlong."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            out[r, : len(ids)] = ids
        return out


@functools.lru_cache(maxsize=4)
def _default_tokenizer(vocab_path: str) -> ClipBPETokenizer:
    return ClipBPETokenizer.from_file(vocab_path)


def tokenize(texts, vocab_path: str) -> np.ndarray:
    """Module-level convenience mirroring `clip.tokenize`."""
    return _default_tokenizer(vocab_path)(texts)
