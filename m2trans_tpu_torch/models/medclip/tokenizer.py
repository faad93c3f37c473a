"""MedCLIP's text tokenizer without ``transformers``: BERT's WordPiece
tokenizer as ``AutoTokenizer.from_pretrained(dir)`` builds it from a
MedCLIP directory (``vocab.txt`` and ``tokenizer_config.json``).

The steps are those of ``transformers``' ``BertTokenizerFast`` (the
``tokenizers`` library's ``BertNormalizer``, ``BertPreTokenizer`` and
``WordPiece``), which ``AutoTokenizer`` returns:

1. the special tokens of the vocabulary ([CLS], [SEP], [PAD], [UNK],
   [MASK]) written literally in the text are kept whole, before anything
   else;
2. normalisation: NUL, U+FFFD and control characters (category C*, but
   tab, newline and carriage return) are dropped, whitespace becomes a
   space, CJK characters are spaced out, accents are stripped (NFD, then
   category Mn dropped) and the text lower-cased where the config asks;
3. split on whitespace and on punctuation (ASCII 33-47, 58-64, 91-96,
   123-126 and Unicode category P*), each punctuation character a word;
4. greedy longest-match-first WordPiece with the ``##`` prefix; a word of
   more than 100 characters, or one with a piece the vocabulary lacks,
   becomes [UNK];
5. ``[CLS] ... [SEP]``, truncated to ``max_length`` with [SEP] kept, and
   [PAD] to ``max_length``.

Where the slow ``BertTokenizer`` differs from the fast one it follows the
fast one: the slow one composes the text (NFC) before it splits, so a
letter followed by a combining accent is one character there and two here
when accents are kept.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_WORD_CHARS = 100


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or ch.isspace() or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """The tokenizer of a MedCLIP directory.

    Args:
      vocab: the token of each id, in id order (``vocab.txt``'s lines).
      do_lower_case, strip_accents, tokenize_chinese_chars: as
        ``BertTokenizer`` takes them; ``strip_accents`` None follows
        ``do_lower_case``.
    """

    def __init__(self, vocab: Sequence[str], *, do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True):
        self.ids: Dict[str, int] = {}
        for i, tok in enumerate(vocab):
            self.ids[tok] = i  # a token listed twice keeps its last id
        missing = [t for t in SPECIAL[:4] if t not in self.ids]
        if missing:
            raise ValueError(f"the vocabulary lacks the special tokens {missing}")
        self.do_lower_case = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.specials = [t for t in SPECIAL if t in self.ids]

    @classmethod
    def from_dir(cls, path: str) -> "WordPieceTokenizer":
        """From ``path/vocab.txt`` and, where present,
        ``path/tokenizer_config.json`` (absent keys take
        ``BertTokenizer``'s defaults)."""
        vocab_path = os.path.join(path, "vocab.txt")
        if not os.path.isfile(vocab_path):
            raise FileNotFoundError(f"MedCLIP tokenizer: no vocabulary file {vocab_path}")
        with open(vocab_path, encoding="utf-8") as fh:
            vocab = [line.rstrip("\n") for line in fh]
        conf = {}
        conf_path = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(conf_path):
            with open(conf_path, encoding="utf-8") as fh:
                conf = json.load(fh)
        return cls(vocab, do_lower_case=conf.get("do_lower_case", True),
                   strip_accents=conf.get("strip_accents"),
                   tokenize_chinese_chars=conf.get("tokenize_chinese_chars", True))

    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return text.lower() if self.do_lower_case else text

    @staticmethod
    def _words(text: str) -> List[str]:
        words, cur = [], []
        for ch in text:
            if _is_whitespace(ch) or _is_punctuation(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if not _is_whitespace(ch):
                    words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_WORD_CHARS:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.ids:
                    break
                end -= 1
            else:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        """The WordPiece tokens of ``text``, no [CLS] / [SEP]."""
        tokens, rest = [], text
        while rest:
            hits = [(rest.find(s), s) for s in self.specials if s in rest]
            pos, special = min(hits) if hits else (len(rest), None)
            for word in self._words(self._normalize(rest[:pos])):
                tokens += self._wordpiece(word)
            if special is None:
                break
            tokens.append(special)
            rest = rest[pos + len(special):]
        return tokens

    def encode(self, text: str, max_length: int) -> List[int]:
        """``[CLS] tokens [SEP]`` as ids, the tokens truncated so that the
        row holds at most ``max_length`` ids."""
        ids = [self.ids[t] for t in self.tokenize(text)][:max(max_length - 2, 0)]
        return [self.ids["[CLS]"], *ids, self.ids["[SEP]"]]

    def __call__(self, texts: Sequence[str], *, return_tensors: str = "np",
                 padding: str = "max_length", truncation: bool = True,
                 max_length: int = 64) -> Dict[str, np.ndarray]:
        """A batch as ``SemanticLossFn.tokenize`` asks a ``transformers``
        tokenizer for it (``return_tensors="np"``, ``padding="max_length"``,
        ``truncation=True``): int64 arrays ``input_ids``, ``attention_mask``
        and ``token_type_ids`` (zeros), each row [PAD]-padded to
        ``max_length``."""
        if (return_tensors, padding, truncation) != ("np", "max_length", True):
            raise ValueError("only return_tensors='np', padding='max_length', "
                             "truncation=True")
        ids = np.full((len(texts), max_length), self.ids["[PAD]"], np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = self.encode(text, max_length)
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": np.zeros_like(ids)}
