"""Regular expressions of tokenizer.json files on the standard ``re``.

Tokenizer files write their splits in the syntax of the third-party
``regex`` package (GPT-2's ``\\p{L}``/``\\p{N}`` split, the Digits and
Punctuation pre-tokenizers' ``\\p{N}``/``\\p{P}``), which ``re`` cannot
compile, and the machine with the card is not promised ``regex``. So the
port never imports it: :func:`compile_pattern` rewrites each Unicode class
escape as an explicit ``re`` character class, built once from the general
categories of ``unicodedata``, and compiles the result with ``re``.

The classes are those of ``regex``, so a rewritten pattern splits as the
JAX package's ``regex`` pattern does:

* ``\\p{X}`` / ``\\P{X}`` (and ``\\pX``): general category or major class
  X (``L``, ``Lu``, ``N``, ``Nd``, ``P``, ...) or its complement;
* ``\\s`` / ``\\S``: Unicode White_Space (the separators Z, U+0009-U+000D
  and U+0085), which is ``re``'s ``\\s`` less U+001C-U+001F;
* ``\\w`` / ``\\W``: letters, marks, decimal and letter numbers, connector
  punctuation, the joiners U+200C/U+200D and the Other_Alphabetic
  symbols (circled and squared Latin letters), as ``regex`` defines them.

``\\d`` needs no rewrite: in both it is the decimal numbers (Nd).

A code point that this Python's Unicode tables leave unassigned (category
Cn) and a newer table assigns can fall in a different class than under
``regex``'s own tables: such characters are outside every tokenizer's
vocabulary of their time.
"""

from __future__ import annotations

import functools
import itertools
import re
import sys
import unicodedata
from typing import List, Tuple

import numpy as np

# The general categories, and the major classes that gather them.
_CATEGORIES = {"Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd",
               "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc",
               "Cf", "Cs", "Co", "Cn"}
_MAJOR = {c[0] for c in _CATEGORIES}

# regex's \w beyond the categories: the joiners and the Other_Alphabetic
# symbols (circled, squared and negative circled/squared Latin letters).
_WORD_EXTRA = ((0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
               (0x1F170, 0x1F189))
_WORD_CATS = ("L", "M", "Nd", "Nl", "Pc")


@functools.lru_cache(maxsize=1)
def _categories() -> List[Tuple[int, int, str]]:
    """Every code point as runs (first, last, general category)."""
    names = sorted(_CATEGORIES)
    code = {name: i for i, name in enumerate(names)}
    cats = map(unicodedata.category, map(chr, range(sys.maxunicode + 1)))
    arr = np.fromiter(map(code.__getitem__, cats), np.uint8, count=sys.maxunicode + 1)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(arr)) + 1])
    ends = np.concatenate([starts[1:] - 1, [sys.maxunicode]])
    return [(int(a), int(b), names[arr[a]]) for a, b in zip(starts, ends)]


def _merge(ranges) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ranges) -> List[Tuple[int, int]]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= sys.maxunicode:
        out.append((nxt, sys.maxunicode))
    return out


def _in_cats(cats) -> List[Tuple[int, int]]:
    """The code points whose category is one of ``cats`` (a one-letter entry
    takes its whole major class)."""
    return _merge((lo, hi) for lo, hi, cat in _categories() if cat in cats or cat[0] in cats)


@functools.lru_cache(maxsize=None)
def class_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code point ranges of a class escape: ``"s"``, ``"w"``, or a
    general category or major class (``"L"``, ``"Lu"``, ``"N"``...)."""
    if name == "s":  # White_Space: the separators, the C0 spaces and NEL
        return tuple(_merge([*_in_cats(("Z",)), (0x09, 0x0D), (0x85, 0x85)]))
    if name == "w":
        return tuple(_merge([*_in_cats(_WORD_CATS), *_WORD_EXTRA]))
    if name not in _CATEGORIES | _MAJOR:
        raise re.error(f"unknown Unicode class \\p{{{name}}}")
    return tuple(_in_cats((name,)))


def _members(ranges) -> str:
    """``ranges`` as the members of an ``re`` bracket expression."""
    def esc(cp):
        return f"\\U{cp:08x}"

    return "".join(esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}" for lo, hi in ranges)


def _escape_members(name: str, negated: bool) -> str:
    ranges = class_ranges(name)
    return _members(_complement(ranges) if negated else ranges)


def translate(pattern: str) -> str:
    """``pattern`` with every ``\\p{..}``, ``\\P{..}``, ``\\s``, ``\\S``,
    ``\\w`` and ``\\W`` replaced by explicit ranges; the rest is copied as it
    is."""
    out = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            members = None
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.index("}", i + 3)
                    name, i_next = pattern[i + 3:end], end + 1
                else:  # \pL: a one-letter name
                    name, i_next = pattern[i + 2], i + 3
                members = _escape_members(name, e == "P")
            elif e in "sSwW":
                members = _escape_members(e.lower(), e.isupper())
                i_next = i + 2
            if members is None:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            out.append(members if in_class else f"[{members}]")
            i = i_next
            continue
        if in_class:
            if c == "]":
                in_class = False
            out.append(c)
            i += 1
            continue
        if c == "[":
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":  # a literal ] first in the class
                out.append("\\]")
                i += 1
            in_class = True
            continue
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=64)
def compile_pattern(pattern: str, flags: int = 0) -> "re.Pattern":
    """``re.compile`` of :func:`translate`'s rewrite of ``pattern``."""
    return re.compile(translate(pattern), flags)
