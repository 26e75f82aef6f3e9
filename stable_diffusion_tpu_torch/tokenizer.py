"""The CLIP BPE tokenizer on a ``vocab.json`` + ``merges.txt`` pair, giving
the ids that ``transformers.CLIPTokenizer`` gives where ``ftfy`` is absent
(its ``BasicTokenizer`` fallback, which the JAX pipeline gets without
``ftfy``), without ``transformers`` or ``regex``.

The steps, as that tokenizer takes them: split the prompt on the special
(added) tokens, which map to their ids as they are; clean each other piece
as its ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``
does (control characters dropped, whitespace to spaces, a space around
each CJK ideograph, NFC, lower case, words joined by single spaces); cut it
with CLIP's pattern; map each piece's UTF-8 bytes to the printable symbols
of ``bytes_to_unicode``; merge by BPE rank (the file's merges ``[1 : 49152
- 256 - 2 + 1]``); look each symbol up, unknown ones as the unk token.
``__call__`` and ``batch_encode_plus`` add bos and eos, truncate to
``max_length`` and pad with the pad token (SD1.5's files pad with ``<|endoftext|>``,
SD2.1's with ``!``, id 0).

CLIP's pattern needs ``\\p{L}`` and ``\\p{N}``, which the standard ``re``
lacks: both classes are built once from ``unicodedata``.  The text is
lower case by then, and the ``regex`` package's case-insensitive match
differs from a plain one on it only where case folding reaches past it: a
character that is no letter but whose one-character upper or lower case
is one (U+0345) matches neither ``[\\p{L}]`` nor ``[^\\s\\p{L}\\p{N}]``, and
``'s`` also takes the long s (U+017F).
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import types
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MAX_LENGTH = 77
_MERGES_KEPT = 49152 - 256 - 2 + 1


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """Each byte -> a printable character: the printable Latin-1 bytes map
    to themselves, the rest to 256 + n in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _ranges(pred) -> str:
    """A character-class body of the code points where ``pred`` holds."""
    out, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = cp <= sys.maxunicode and pred(chr(cp))
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            out.append(f"\\U{start:08x}" if start == cp - 1 else f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    return "".join(out)


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _folds_to_letter(c: str) -> bool:
    return not _is_letter(c) and any(len(v) == 1 and _is_letter(v) for v in (c.upper(), c.lower()))


@functools.lru_cache(maxsize=None)
def clip_pattern() -> "re.Pattern":
    """CLIP's pattern: the two special tokens, the English contractions, a
    run of letters, one number, a run of anything else but whitespace."""
    letters = _ranges(_is_letter)
    numbers = _ranges(lambda c: unicodedata.category(c).startswith("N"))
    neither = _ranges(_folds_to_letter)
    return re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'[s\u017f]|'t|'re|'ve|'m|'ll|'d"
                      rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}{neither}]+")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """The BasicTokenizer's clean-up: NUL, U+FFFD and control characters
    dropped (tab, newline and carriage return count as whitespace), every
    whitespace character a space, CJK ideographs spaced apart, NFC, each
    word lower-cased, the words joined by single spaces."""
    out = []
    for c in text:
        cp = ord(c)
        if c in " \t\n\r" or unicodedata.category(c) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(c).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {c} ")
        else:
            out.append(c)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def _token_content(value) -> Optional[str]:
    return value.get("content") if isinstance(value, dict) else value


class CLIPTokenizer:
    """The CLIP tokenizer of one vocabulary; ``tokenize``, ``encode``,
    ``__call__``, ``pad`` and ``batch_encode_plus`` as
    ``transformers.CLIPTokenizer``'s for what the pipeline and the trainer's
    dataset ask of it (ids only, no attention mask)."""

    def __init__(self, vocab_file: str, merges_file: str, *, bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>", unk_token: str = "<|endoftext|>",
                 pad_token: str = "<|endoftext|>", added_tokens: Optional[Dict[int, str]] = None):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:_MERGES_KEPT]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token, self.pad_token = unk_token, pad_token
        # added tokens: those the config lists with their ids, then each
        # special token, at its vocabulary id or appended after the rest
        self.added: Dict[str, int] = {tok: int(i) for i, tok in (added_tokens or {}).items()}
        for tok in (bos_token, eos_token, unk_token, pad_token):
            if tok not in self.added:
                known = self.encoder.get(tok)
                self.added[tok] = known if known is not None else len(
                    set(self.encoder) | set(self.added))
        order = sorted(self.added, key=len, reverse=True)  # the longest match first
        self._split = re.compile("(" + "|".join(map(re.escape, order)) + ")")
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    @property
    def bos_token_id(self) -> int:
        return self.added[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.added[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.added[self.pad_token]

    def bpe(self, token: str) -> str:
        """The BPE symbols of one piece, space-separated, the last ending in
        ``</w>``: the lowest-ranked adjacent pair merged until none is
        ranked."""
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word, word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word, word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _tokenize(self, text: str) -> List[str]:
        symbols = []
        for piece in clip_pattern().findall(basic_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            symbols.extend(self.bpe(mapped).split(" "))
        return symbols

    def tokenize(self, text: str) -> List[str]:
        """The symbols of ``text``: the added tokens split out as they are,
        the pieces between them cleaned, cut and merged."""
        out = []
        for piece in self._split.split(text):
            if piece in self.added:
                out.append(piece)
            elif piece:
                out.extend(self._tokenize(piece))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.encoder.get(self.unk_token)
        return [self.added[t] if t in self.added else self.encoder.get(t, unk) for t in tokens]

    def encode(self, text: str, *, max_length: Optional[int] = None) -> List[int]:
        """bos, the ids of ``text`` (the first ``max_length - 2`` when given),
        eos."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if max_length is not None:
            ids = ids[:max(max_length - 2, 0)]
        return [self.bos_token_id, *ids, self.eos_token_id]

    def __call__(self, text: Union[str, Sequence[str]], *, padding: Union[bool, str] = False,
                 truncation: bool = False,
                 max_length: int = MAX_LENGTH) -> types.SimpleNamespace:
        """``.input_ids`` of one prompt (a list of ids) or of each of a list
        of prompts: bos, the ids, eos; cut to ``max_length`` with
        ``truncation``; padded to it on the right with the pad token under
        ``padding="max_length"`` ("do_not_pad" and False leave it)."""
        if padding not in (False, "do_not_pad", "max_length"):
            raise ValueError(f"padding={padding!r}: only 'max_length' and 'do_not_pad' are ported")
        rows = [self.encode(t, max_length=max_length if truncation else None)
                for t in ([text] if isinstance(text, str) else text)]
        if padding == "max_length":
            rows = [ids + [self.pad_token_id] * max(max_length - len(ids), 0) for ids in rows]
        return types.SimpleNamespace(input_ids=rows[0] if isinstance(text, str) else rows)

    def pad(self, encoded, *, padding: str = "max_length", max_length: int = MAX_LENGTH,
            return_tensors: str = "np") -> dict:
        """``{"input_ids": (rows, max_length) int64 array}``: the rows of
        ``encoded["input_ids"]`` padded on the right with the pad token (the
        call the trainer's dataset makes).  A row longer than
        ``max_length`` raises rather than give a ragged batch."""
        if padding != "max_length" or return_tensors != "np":
            raise ValueError(f"padding={padding!r}, return_tensors={return_tensors!r}: only "
                             "'max_length' and 'np' are ported")
        rows = [list(r) for r in encoded["input_ids"]]
        if any(len(r) > max_length for r in rows):
            raise ValueError(f"a row of {max(map(len, rows))} ids is longer than {max_length}")
        ids = np.full((len(rows), max_length), self.pad_token_id, np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        return {"input_ids": ids}

    def batch_encode_plus(self, prompts: Sequence[str], *, padding: str = "max_length",
                          max_length: int = MAX_LENGTH,
                          truncation: bool = True) -> types.SimpleNamespace:
        """``.input_ids``: each prompt's ``encode``, truncated to
        ``max_length`` and padded to it on the right with the pad token (the
        call the pipeline makes, as JAX's makes it of ``transformers``)."""
        if padding != "max_length":
            raise ValueError(f"padding={padding!r}: only 'max_length' is ported")
        return self(list(prompts), padding=padding, truncation=truncation, max_length=max_length)


def load_tokenizer(directory: str) -> CLIPTokenizer:
    """The tokenizer of a directory holding ``vocab.json`` and ``merges.txt``
    (a diffusers ``tokenizer/`` folder), with its special tokens from
    ``tokenizer_config.json``, overridden by ``special_tokens_map.json``,
    where present."""
    paths = {n: os.path.join(directory, n) for n in ("vocab.json", "merges.txt")}
    for name, p in paths.items():
        if not os.path.isfile(p):
            raise FileNotFoundError(f"no {name} in tokenizer directory {directory!r}")
    kw, added = {}, {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            continue
        with open(p, encoding="utf-8") as f:
            cfg = json.load(f)
        for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
            tok = _token_content(cfg.get(key))
            if tok:
                kw[key] = tok
        for idx, tok in (cfg.get("added_tokens_decoder") or {}).items():
            added[int(idx)] = _token_content(tok)
    return CLIPTokenizer(paths["vocab.json"], paths["merges.txt"], added_tokens=added, **kw)
