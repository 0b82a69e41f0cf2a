"""GBNF grammar engine — constrained decoding.

Port of the reference grammar machinery (src/whisper.cpp:5515-5927,
include/whisper.h:162-190): element types, UTF-8 partial decode, stack-based
matcher, candidate rejection, token accept, and logit penalty application.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class GType(enum.IntEnum):
    """whisper_gretype (include/whisper.h:162-190)."""

    END = 0
    ALT = 1
    RULE_REF = 2
    CHAR = 3
    CHAR_NOT = 4
    CHAR_RNG_UPPER = 5
    CHAR_ALT = 6


@dataclass(frozen=True)
class GElement:
    type: GType
    value: int  # codepoint or rule id


Rule = List[GElement]


@dataclass
class Grammar:
    """whisper_grammar: rules + stacks of dotted positions (rule_id, pos)."""

    rules: List[Rule]
    stacks: List[List[Tuple[int, int]]] = field(default_factory=list)
    # partial UTF-8 sequence carried between tokens
    partial_utf8: Tuple[int, int] = (0, 0)  # (value, n_remain)


def _is_end_of_sequence(el: GElement) -> bool:
    return el.type in (GType.END, GType.ALT)


def decode_utf8(src: bytes, partial: Tuple[int, int]) -> Tuple[List[int], Tuple[int, int]]:
    """Decode UTF-8 allowing a trailing partial sequence (decode_utf8,
    src/whisper.cpp:5530-5595)."""
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]
    value, n_remain = partial
    out: List[int] = []
    i = 0
    n = len(src)
    # continue a partial sequence
    while n_remain > 0 and i < n:
        b = src[i]
        if (b & 0xC0) != 0x80:
            return [0], (0, -1)  # invalid
        value = (value << 6) + (b & 0x3F)
        i += 1
        n_remain -= 1
        if n_remain == 0:
            out.append(value)
    while i < n:
        b = src[i]
        ln = lookup[b >> 4]
        mask = (1 << (8 - ln)) - 1
        value = b & mask
        i += 1
        rem = ln - 1
        while rem > 0 and i < n:
            b2 = src[i]
            if (b2 & 0xC0) != 0x80:
                return [0], (0, -1)
            value = (value << 6) + (b2 & 0x3F)
            i += 1
            rem -= 1
        if rem == 0:
            out.append(value)
        else:
            return out, (value, rem)
    return out, (0, 0)


def _match_char(rule: Rule, pos: int, chr_: int) -> Tuple[bool, int]:
    """Match a codepoint against the char/charset element at `pos`;
    returns (matched, next_pos_after_charset)."""
    el = rule[pos]
    found = False
    is_positive = el.type == GType.CHAR
    i = pos
    while True:
        el = rule[i]
        if i + 1 < len(rule) and rule[i + 1].type == GType.CHAR_RNG_UPPER:
            if el.value <= chr_ <= rule[i + 1].value:
                found = True
            i += 2
        else:
            if el.value == chr_:
                found = True
            i += 1
        if i >= len(rule) or rule[i].type != GType.CHAR_ALT:
            break
    return (found == is_positive), i


def _advance_stack(rules: List[Rule], stack: List[Tuple[int, int]],
                   out: List[List[Tuple[int, int]]]) -> None:
    """Expand rule refs / alternates until the top of stack is a char
    (whisper_grammar_advance_stack)."""
    if not stack:
        out.append(stack)
        return
    rid, pos = stack[-1]
    el = rules[rid][pos]
    if el.type == GType.RULE_REF:
        sub_id = el.value
        sub = rules[sub_id]
        # skip past the ref in the current frame
        next_stack = stack[:-1]
        nxt = pos + 1
        if not _is_end_of_sequence(rules[rid][nxt]):
            next_stack = next_stack + [(rid, nxt)]
        # each alternate of the sub-rule spawns a stack
        i = 0
        while True:
            # an empty alternate (`x?`, `(a | )`) adds no frame, as in the
            # reference; the JAX package's copy pushes its END and raises
            ns = next_stack + ([] if _is_end_of_sequence(sub[i]) else [(sub_id, i)])
            _advance_stack(rules, ns, out)
            # find next alternate
            while not _is_end_of_sequence(sub[i]):
                i += 1
            if sub[i].type == GType.ALT:
                i += 1
            else:
                break
    elif el.type in (GType.CHAR, GType.CHAR_NOT):
        if stack not in out:
            out.append(stack)
    else:
        raise ValueError("unexpected grammar element")


def grammar_copy(g: Grammar) -> Grammar:
    """Value-semantics copy, like C++ `decoder.grammar = cur.grammar`
    (src/whisper.cpp:7336) and the beam-candidate construction: each decoder
    must own its stacks so accept_token on one beam cannot corrupt another.
    Rules are immutable and shared; stacks/partial_utf8 are copied."""
    return Grammar(rules=g.rules, stacks=[list(s) for s in g.stacks],
                   partial_utf8=g.partial_utf8)


def grammar_init(rules: Sequence[Sequence[GElement]], start_rule: int) -> Grammar:
    """whisper_grammar_init: build initial stacks from the start rule."""
    rules = [list(r) for r in rules]
    g = Grammar(rules=rules)
    stacks: List[List[Tuple[int, int]]] = []
    rule = rules[start_rule]
    i = 0
    while True:
        _advance_stack(rules, [] if _is_end_of_sequence(rule[i]) else [(start_rule, i)],
                       stacks)
        while not _is_end_of_sequence(rule[i]):
            i += 1
        if rule[i].type == GType.ALT:
            i += 1
        else:
            break
    g.stacks = stacks
    return g


def _accept_char(rules: List[Rule], stacks: List[List[Tuple[int, int]]],
                 chr_: int) -> List[List[Tuple[int, int]]]:
    new_stacks: List[List[Tuple[int, int]]] = []
    for stack in stacks:
        if not stack:
            continue
        rid, pos = stack[-1]
        matched, next_pos = _match_char(rules[rid], pos, chr_)
        if matched:
            ns = stack[:-1]
            if not _is_end_of_sequence(rules[rid][next_pos]):
                ns = ns + [(rid, next_pos)]
            _advance_stack(rules, ns, new_stacks)
    return new_stacks


def _reject_candidate(rules: List[Rule], stacks: List[List[Tuple[int, int]]],
                      codepoints: List[int], partial_ok: bool) -> bool:
    """True if the codepoint sequence cannot continue any stack."""
    if not codepoints:
        return not partial_ok
    cur = stacks
    for cp in codepoints:
        cur = _accept_char(rules, cur, cp)
        if not cur:
            return True
    return False


def suppress_invalid(vocab, params, logits, grammar: Grammar) -> None:
    """whisper_suppress_invalid_grammar: subtract grammar_penalty from logits
    of tokens that cannot extend the grammar (src/whisper.cpp:5831-5860)."""
    if not grammar.rules or not grammar.stacks:
        return
    # an EOT is allowed only when some stack is empty (i.e. grammar complete)
    allow_eot = any(not s for s in grammar.stacks)
    import numpy as np

    for tid, tok in vocab.id_to_token.items():
        if tid >= len(logits):
            continue
        if tid == vocab.token_eot:
            if not allow_eot:
                logits[tid] -= params.grammar_penalty
            continue
        if tid >= vocab.token_beg or tid == vocab.token_sot:
            continue
        if not tok:
            continue
        cps, partial = decode_utf8(tok, grammar.partial_utf8)
        if partial[1] == -1 or _reject_candidate(grammar.rules, grammar.stacks,
                                                 cps, partial[1] > 0):
            logits[tid] -= params.grammar_penalty


def accept_token(vocab, grammar: Grammar, token_id: int) -> None:
    """whisper_grammar_accept_token (src/whisper.cpp:5895-5927)."""
    if not grammar.rules or not grammar.stacks:
        return
    if token_id >= vocab.token_beg or token_id == vocab.token_sot:
        return
    if token_id == vocab.token_eot:
        return
    tok = vocab.token_bytes(token_id)
    cps, partial = decode_utf8(tok, grammar.partial_utf8)
    if partial[1] == -1:
        return
    stacks = grammar.stacks
    for cp in cps:
        stacks = _accept_char(grammar.rules, stacks, cp)
        if not stacks:
            break
    grammar.stacks = stacks
    grammar.partial_utf8 = partial
