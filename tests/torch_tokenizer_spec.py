"""A GPT-2-shaped byte-level BPE ``tokenizer.json`` made from a seed, with no
``tokenizers`` package and nothing of the code under test.

``make_spec(seed)`` gives GPT-2's layout: 50257 entries, the 256 byte
tokens of ``bytes_to_unicode`` (ids 0-255, in GPT-2's order), 50000 merges
(ids 256-50255) and ``<|endoftext|>`` as the special token 50256; a
ByteLevel pre-tokenizer without a prefix space, and ByteLevel
post-processor and decoder.

The first merges are learned by plain BPE training on the English
paragraphs below (each word with and without its leading space, ``Ġ``),
run until every such word is one token, so an English prompt from them
encodes to whole words. The rest, up to 50000, join seeded pairs of
existing tokens whose join is new.

    python tests/torch_tokenizer_spec.py out.json   # writes the spec
"""

from __future__ import annotations

import collections
import json
import re
import sys

import numpy as np

N_VOCAB, N_MERGES, EOT = 50257, 50000, "<|endoftext|>"

PARAGRAPHS = [
    "The quick brown fox jumps over the lazy dog while the farmer watches from the "
    "kitchen window. It is a bright morning in early spring, and the fields are "
    "still wet with dew. Nobody in the village can remember a year when the river "
    "rose so high, but the old bridge has held, as it always has.",
    "A language model reads a sequence of tokens and predicts the next one. It "
    "learns which words tend to follow which, and how sentences are built, from a "
    "large amount of text. When it writes, it samples one token at a time and "
    "feeds each choice back as input, so a small mistake early on can change "
    "everything that comes after it.",
    "The engineers measured the time of every step on the card: how long the "
    "prompt took to fill the cache, how many tokens it produced each second, and "
    "how much of that time the host spent deciding what to launch next. They "
    "wrote the numbers down beside the name of the card and its power limit, "
    "because a slower card would give them different answers.",
    "Rain fell through the night and into the afternoon. The children stayed "
    "inside, reading books and drawing maps of islands that do not exist, with "
    "mountains, harbors, forests and a castle on every hill. When the sun came "
    "out at last, they ran down to the shore to look for shells.",
]

PROMPT = ("The engineers measured the time of every step on the card, and the children "
          "ran down to the shore to look for shells.")

# GPT-2's split, for the ASCII text above only.
_ASCII_SPLIT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")


def bytes_to_unicode():
    """GPT-2's reversible byte -> printable character map, in its order."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _words():
    """{byte-level word: count}: every piece of the paragraphs, and each
    letter word also with and without its leading space."""
    b2u = bytes_to_unicode()
    counts = collections.Counter()
    for para in PARAGRAPHS:
        for piece in _ASCII_SPLIT.findall(para):
            variants = {piece, piece.strip(), " " + piece.strip()} if piece.strip().isalpha() \
                else {piece}
            for v in variants:
                counts["".join(b2u[b] for b in v.encode())] += 1
    return counts


def _train(counts):
    """Plain BPE training: merge the most frequent pair (ties: the pair
    that sorts first) until every word is one token."""
    words = {w: list(w) for w in counts}
    merges = []
    while True:
        pairs = collections.Counter()
        for w, syms in words.items():
            for a, b in zip(syms, syms[1:]):
                pairs[a, b] += counts[w]
        if not pairs:
            return merges
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        joined = best[0] + best[1]
        for w, syms in words.items():
            i, out = 0, []
            while i < len(syms):
                if i + 1 < len(syms) and (syms[i], syms[i + 1]) == best:
                    out.append(joined)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            words[w] = out


def make_spec(seed: int = 0) -> dict:
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    tokens = list(vocab)
    merges = []

    def add(a, b):
        merges.append(f"{a} {b}")
        vocab[a + b] = len(tokens)
        tokens.append(a + b)

    for a, b in _train(_words()):
        add(a, b)
    rng = np.random.default_rng(seed)
    while len(merges) < N_MERGES:
        for i, j in rng.integers(0, len(tokens), (N_MERGES - len(merges), 2)).tolist():
            a, b = tokens[i], tokens[j]
            if a + b not in vocab and len(merges) < N_MERGES:
                add(a, b)
    vocab[EOT] = len(tokens)
    assert len(vocab) == N_VOCAB and vocab[EOT] == N_VOCAB - 1
    byte_level = {"add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [{"id": N_VOCAB - 1, "content": EOT, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": True,
                          "special": True}],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", **byte_level},
        "post_processor": {"type": "ByteLevel", **byte_level, "trim_offsets": False},
        "decoder": {"type": "ByteLevel", **byte_level},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False, "vocab": vocab,
                  "merges": merges},
    }


def write_spec(path, seed: int = 0) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(make_spec(seed), f, ensure_ascii=False)
    return str(path)


def corpus(n_bytes: int, seed: int = 0) -> str:
    """About ``n_bytes`` of text: the paragraphs' sentences in a seeded
    order, with a seeded share of digits, accents, CJK, emoji, tabs and
    newlines between them."""
    rng = np.random.default_rng(seed)
    sentences = [s.strip() + "." for p in PARAGRAPHS for s in p.split(".") if s.strip()]
    extras = ["1234", " 56.7%", " café naïve", " 漢字かな", " 🙂🚀", "\t", "\n", "  ", " don't"]
    out, size = [], 0
    while size < n_bytes:
        s = sentences[int(rng.integers(len(sentences)))]
        if rng.random() < 0.3:
            s += extras[int(rng.integers(len(extras)))]
        out.append(s)
        size += len(s.encode()) + 1
    return " ".join(out)


if __name__ == "__main__":
    print(write_spec(sys.argv[1]))
