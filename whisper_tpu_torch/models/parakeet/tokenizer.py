"""SentencePiece tokenize/detokenize for Parakeet
(reference: src/parakeet.cpp:536-590 piece handling, :2911-2944 tokenize)."""

from __future__ import annotations

from typing import List

from .load import ParakeetVocab

SPM_SPACE = "▁"  # '▁'
_CONTROL = {"<unk>", "<s>", "</s>", "[BLANK]"}


def is_control(piece: str) -> bool:
    return piece in _CONTROL


def normalize(text: str) -> str:
    """Dummy-prefix + whitespace -> meta space (src/parakeet.cpp:548-563)."""
    out = [SPM_SPACE]
    for ch in text:
        out.append(SPM_SPACE if ch.isspace() else ch)
    return "".join(out)


def piece_to_text(piece: str, is_first_piece: bool) -> str:
    """src/parakeet.cpp:565-590."""
    if is_control(piece):
        return ""
    text = []
    i = 0
    while i < len(piece):
        if piece.startswith(SPM_SPACE, i):
            if not is_first_piece or text:
                text.append(" ")
            i += len(SPM_SPACE)
        else:
            text.append(piece[i])
            i += 1
    return "".join(text)


def detokenize(vocab: ParakeetVocab, tokens: List[int]) -> str:
    out = []
    for k, t in enumerate(tokens):
        out.append(piece_to_text(vocab.id_to_token[t], is_first_piece=(k == 0)))
    return "".join(out)


def tokenize(vocab: ParakeetVocab, text: str) -> List[int]:
    """Greedy longest-match over the normalized text
    (src/parakeet.cpp:2911-2944)."""
    normalized = normalize(text)
    tokens: List[int] = []
    i = 0
    while i < len(normalized):
        max_len = min(vocab.max_token_length, len(normalized) - i)
        for ln in range(max_len, 0, -1):
            piece = normalized[i:i + ln]
            tid = vocab.token_to_id.get(piece)
            if tid is not None and not is_control(piece):
                tokens.append(tid)
                i += ln
                break
        else:
            if vocab.token_unk >= 0:
                tokens.append(vocab.token_unk)
            i += 1
    return tokens


def is_word_start_token(vocab: ParakeetVocab, token_id: int) -> bool:
    s = vocab.id_to_token[token_id]
    return bool(s) and (s.startswith(SPM_SPACE) or s[0] == "_")


_PUNCT = set(".,!?;:'\"-()[]{}")


def is_punctuation_token(vocab: ParakeetVocab, token_id: int) -> bool:
    s = vocab.id_to_token[token_id]
    if not s:
        return False
    if s.startswith(SPM_SPACE):
        s = s[len(SPM_SPACE):]
    elif s[0] == "_":
        s = s[1:]
    return len(s) == 1 and s in _PUNCT
