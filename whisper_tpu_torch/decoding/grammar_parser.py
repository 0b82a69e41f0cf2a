"""GBNF grammar text parser (port of examples/grammar-parser.cpp).

Parses GBNF text into the rule/element representation consumed by the
grammar engine (decoding/grammar.py).  Repetitions rewrite into synthesized
recursive rules exactly like the reference:
  S*  -->  S' ::= S S' |
  S+  -->  S' ::= S S' | S
  S?  -->  S' ::= S |
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .grammar import GElement, GType, Rule

_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


class GrammarParseError(ValueError):
    pass


@dataclass
class ParseState:
    """grammar_parser::parse_state."""

    symbol_ids: Dict[str, int] = field(default_factory=dict)
    rules: List[Rule] = field(default_factory=list)

    def start_rule_id(self, name: str = "root") -> int:
        if name not in self.symbol_ids:
            raise GrammarParseError(f"grammar has no '{name}' rule")
        return self.symbol_ids[name]


def _decode_utf8(src: str, i: int) -> Tuple[int, int]:
    # python strings are already decoded; one char = one codepoint
    return ord(src[i]), i + 1


def _get_symbol_id(state: ParseState, name: str) -> int:
    return state.symbol_ids.setdefault(name, len(state.symbol_ids))


def _generate_symbol_id(state: ParseState, base: str) -> int:
    next_id = len(state.symbol_ids)
    state.symbol_ids[f"{base}_{next_id}"] = next_id
    return next_id


def _add_rule(state: ParseState, rule_id: int, rule: Rule) -> None:
    while len(state.rules) <= rule_id:
        state.rules.append([])
    state.rules[rule_id] = rule


def _is_word_char(c: str) -> bool:
    return c.isascii() and (c.isalnum() or c == "-")


def _parse_hex(src: str, i: int, size: int) -> Tuple[int, int]:
    chunk = src[i:i + size]
    if len(chunk) != size or not all(c in "0123456789abcdefABCDEF"
                                     for c in chunk):
        raise GrammarParseError(
            f"expecting {size} hex chars at {src[i:i + 16]!r}")
    return int(chunk, 16), i + size


def _parse_space(src: str, i: int, newline_ok: bool) -> int:
    n = len(src)
    while i < n and (src[i] in " \t#" or
                     (newline_ok and src[i] in "\r\n")):
        if src[i] == "#":
            while i < n and src[i] not in "\r\n":
                i += 1
        else:
            i += 1
    return i


def _parse_name(src: str, i: int) -> int:
    start = i
    while i < len(src) and _is_word_char(src[i]):
        i += 1
    if i == start:
        raise GrammarParseError(f"expecting name at {src[start:start + 16]!r}")
    return i


_ESCAPES = {"t": ord("\t"), "r": ord("\r"), "n": ord("\n"),
            "\\": ord("\\"), '"': ord('"'), "[": ord("["), "]": ord("]")}


def _parse_char(src: str, i: int) -> Tuple[int, int]:
    if i >= len(src):
        raise GrammarParseError("unexpected end of input")
    if src[i] == "\\":
        if i + 1 >= len(src):
            raise GrammarParseError("unexpected end of input after backslash")
        e = src[i + 1]
        if e == "x":
            return _parse_hex(src, i + 2, 2)
        if e == "u":
            return _parse_hex(src, i + 2, 4)
        if e == "U":
            return _parse_hex(src, i + 2, 8)
        if e in _ESCAPES:
            return _ESCAPES[e], i + 2
        raise GrammarParseError(f"unknown escape at {src[i:i + 8]!r}")
    return _decode_utf8(src, i)


def _parse_sequence(state: ParseState, src: str, i: int, rule_name: str,
                    out: List[GElement], is_nested: bool) -> int:
    last_sym_start = len(out)
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':  # literal string
            i += 1
            last_sym_start = len(out)
            while i < n and src[i] != '"':
                cp, i = _parse_char(src, i)
                out.append(GElement(GType.CHAR, cp))
            if i >= n:
                raise GrammarParseError("unterminated string literal")
            i = _parse_space(src, i + 1, is_nested)
        elif c == "[":  # char range(s)
            i += 1
            start_type = GType.CHAR
            if i < n and src[i] == "^":
                i += 1
                start_type = GType.CHAR_NOT
            last_sym_start = len(out)
            while i < n and src[i] != "]":
                cp, i = _parse_char(src, i)
                t = GType.CHAR_ALT if len(out) > last_sym_start else start_type
                out.append(GElement(t, cp))
                if i + 1 < n and src[i] == "-" and src[i + 1] != "]":
                    cp2, i = _parse_char(src, i + 1)
                    out.append(GElement(GType.CHAR_RNG_UPPER, cp2))
            if i >= n:
                raise GrammarParseError("unterminated char class")
            i = _parse_space(src, i + 1, is_nested)
        elif _is_word_char(c):  # rule reference
            name_end = _parse_name(src, i)
            ref_id = _get_symbol_id(state, src[i:name_end])
            i = _parse_space(src, name_end, is_nested)
            last_sym_start = len(out)
            out.append(GElement(GType.RULE_REF, ref_id))
        elif c == "(":  # grouping
            i = _parse_space(src, i + 1, True)
            sub_id = _generate_symbol_id(state, rule_name)
            i = _parse_alternates(state, src, i, rule_name, sub_id, True)
            last_sym_start = len(out)
            out.append(GElement(GType.RULE_REF, sub_id))
            if i >= n or src[i] != ")":
                raise GrammarParseError(f"expecting ')' at {src[i:i + 16]!r}")
            i = _parse_space(src, i + 1, is_nested)
        elif c in "*+?":  # repetition
            if last_sym_start == len(out):
                raise GrammarParseError(
                    f"expecting preceding item to */+/? at {src[i:i + 16]!r}")
            sub_id = _generate_symbol_id(state, rule_name)
            sub_rule: Rule = list(out[last_sym_start:])
            if c in "*+":
                sub_rule.append(GElement(GType.RULE_REF, sub_id))
            sub_rule.append(GElement(GType.ALT, 0))
            if c == "+":
                sub_rule.extend(out[last_sym_start:])
            sub_rule.append(GElement(GType.END, 0))
            _add_rule(state, sub_id, sub_rule)
            del out[last_sym_start:]
            out.append(GElement(GType.RULE_REF, sub_id))
            i = _parse_space(src, i + 1, is_nested)
        else:
            break
    return i


def _parse_alternates(state: ParseState, src: str, i: int, rule_name: str,
                      rule_id: int, is_nested: bool) -> int:
    rule: Rule = []
    i = _parse_sequence(state, src, i, rule_name, rule, is_nested)
    while i < len(src) and src[i] == "|":
        rule.append(GElement(GType.ALT, 0))
        i = _parse_space(src, i + 1, True)
        i = _parse_sequence(state, src, i, rule_name, rule, is_nested)
    rule.append(GElement(GType.END, 0))
    _add_rule(state, rule_id, rule)
    return i


def _parse_rule(state: ParseState, src: str, i: int) -> int:
    name_end = _parse_name(src, i)
    name = src[i:name_end]
    j = _parse_space(src, name_end, False)
    rule_id = _get_symbol_id(state, name)

    if src[j:j + 3] != "::=":
        raise GrammarParseError(f"expecting ::= at {src[j:j + 16]!r}")
    j = _parse_space(src, j + 3, True)
    j = _parse_alternates(state, src, j, name, rule_id, False)

    if j < len(src):
        if src[j] == "\r":
            j += 2 if src[j:j + 2] == "\r\n" else 1
        elif src[j] == "\n":
            j += 1
        else:
            raise GrammarParseError(
                f"expecting newline or end at {src[j:j + 16]!r}")
    return _parse_space(src, j, True)


def parse(src: str) -> ParseState:
    """grammar_parser::parse — raises GrammarParseError on malformed input
    (the reference prints and returns an empty state; callers here should
    handle the exception)."""
    state = ParseState()
    i = _parse_space(src, 0, True)
    while i < len(src):
        i = _parse_rule(state, src, i)
    # undefined rule references (referenced but never defined) are empty
    for name, rid in state.symbol_ids.items():
        if rid >= len(state.rules) or not state.rules[rid]:
            raise GrammarParseError(f"undefined rule '{name}'")
    return state
