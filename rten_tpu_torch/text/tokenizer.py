"""HF `tokenizer.json`-compatible tokenizer (the port of
``rten_tpu/text/tokenizer.py``).

Reference: rten-text (tokenizer.rs:245-772; models/bpe.rs:308 BPE,
models/wordpiece.rs:17 WordPiece; normalizers.rs; pre_tokenizers.rs).
Supported pipeline components (the set used by GPT-2/BERT/Llama-family
tokenizer.json files):

* normalizers: NFC NFD NFKC NFKD Lowercase StripAccents Strip Replace
  Prepend BertNormalizer Sequence
* pre-tokenizers: ByteLevel Whitespace WhitespaceSplit BertPreTokenizer
  Split Digits Punctuation Metaspace Sequence
* models: BPE (merge ranks, byte-level or plain), WordPiece
* post-processors: TemplateProcessing BertProcessing RobertaProcessing
  ByteLevel (passthrough)
* decoders: ByteLevel WordPiece BPEDecoder Metaspace Sequence Replace
  Strip Fuse
* added/special tokens (longest-match split before the pipeline)

Two cores encode each pre-tokenized piece, with equal results: the native
C++ core (``rten_tpu_torch/native/bpe.cpp``), the default, and the Python
core (``BpeModel``/``WordPieceModel``), used only where the caller passes
``native=False``. ``Tokenizer.core`` names the one that runs; a native
core that cannot be built raises with the compiler's log.

Patterns in the ``regex`` package's syntax (GPT-2's ``\\p{L}`` split, the
Digits and Punctuation pre-tokenizers, Split and Replace patterns) compile
on the standard ``re`` through ``text/pattern.py``; the port never imports
``regex``, installed or not.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

from .pattern import compile_pattern


class TokenizerError(Exception):
    pass


@dataclasses.dataclass
class Encoding:
    ids: List[int]
    tokens: List[str]


# --- byte-level alphabet ---------------------------------------------------


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


GPT2_SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


# --- normalizers -----------------------------------------------------------


def _make_normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    t = spec.get("type")
    if t == "Sequence":
        fns = [_make_normalizer(n) for n in spec.get("normalizers", [])]

        def seq(s):
            for f in fns:
                s = f(s)
            return s

        return seq
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, _t=t: unicodedata.normalize(_t, s)
    if t == "Lowercase":
        return lambda s: s.lower()
    if t == "StripAccents":
        return lambda s: "".join(
            c for c in unicodedata.normalize("NFD", s) if unicodedata.category(c) != "Mn"
        )
    if t == "Strip":
        left = spec.get("strip_left", True)
        right = spec.get("strip_right", True)

        def strip(s):
            if left and right:
                return s.strip()
            if left:
                return s.lstrip()
            if right:
                return s.rstrip()
            return s

        return strip
    if t == "Replace":
        pat = spec.get("pattern", {})
        content = spec.get("content", "")
        if "String" in pat:
            return lambda s: s.replace(pat["String"], content)
        if "Regex" in pat:
            rx = compile_pattern(pat["Regex"])
            return lambda s: rx.sub(content, s)
        return lambda s: s
    if t == "Prepend":
        prefix = spec.get("prepend", "")
        return lambda s: (prefix + s) if s else s
    if t == "BertNormalizer":
        lowercase = spec.get("lowercase", True)
        strip_accents = spec.get("strip_accents")
        clean_text = spec.get("clean_text", True)
        handle_chinese = spec.get("handle_chinese_chars", True)

        def bert(s):
            if clean_text:
                out = []
                for c in s:
                    cp = ord(c)
                    if cp == 0 or cp == 0xFFFD or unicodedata.category(c) in ("Cc", "Cf"):
                        if c in "\t\n\r":
                            out.append(c)
                        continue
                    out.append(" " if c.isspace() else c)
                s = "".join(out)
            if handle_chinese:
                out = []
                for c in s:
                    cp = ord(c)
                    if _is_cjk(cp):
                        out.extend([" ", c, " "])
                    else:
                        out.append(c)
                s = "".join(out)
            do_strip = strip_accents if strip_accents is not None else lowercase
            if lowercase:
                s = s.lower()
            if do_strip:
                s = "".join(
                    c
                    for c in unicodedata.normalize("NFD", s)
                    if unicodedata.category(c) != "Mn"
                )
            return s

        return bert
    raise TokenizerError(f"unsupported normalizer {t}")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


# --- pre-tokenizers --------------------------------------------------------


def _make_pre_tokenizer(spec: Optional[dict]):
    """Returns fn(str) -> list[str] pieces."""
    if spec is None:
        return lambda s: [s] if s else []
    t = spec.get("type")
    if t == "Sequence":
        fns = [_make_pre_tokenizer(p) for p in spec.get("pretokenizers", [])]

        def seq(s):
            pieces = [s]
            for f in fns:
                pieces = [q for p in pieces for q in f(p)]
            return pieces

        return seq
    if t == "ByteLevel":
        add_prefix_space = spec.get("add_prefix_space", True)
        use_regex = spec.get("use_regex", True)
        rx = compile_pattern(GPT2_SPLIT_PATTERN)
        b2u = bytes_to_unicode()

        def byte_level(s):
            if add_prefix_space and s and not s.startswith(" "):
                s = " " + s
            words = rx.findall(s) if use_regex else ([s] if s else [])
            return ["".join(b2u[b] for b in w.encode("utf-8")) for w in words]

        return byte_level
    if t == "WhitespaceSplit":
        return lambda s: s.split()
    if t == "Whitespace":
        rx = compile_pattern(r"\w+|[^\w\s]+")
        return lambda s: rx.findall(s)
    if t == "BertPreTokenizer":
        rx = compile_pattern(r"\w+|[^\w\s]")
        return lambda s: rx.findall(s)
    if t == "Digits":
        individual = spec.get("individual_digits", False)
        if individual:
            rx = compile_pattern(r"\p{N}|[^\p{N}]+")
        else:
            rx = compile_pattern(r"\p{N}+|[^\p{N}]+")
        return lambda s: rx.findall(s)
    if t == "Punctuation":
        rx = compile_pattern(r"\p{P}|[^\p{P}]+")
        return lambda s: rx.findall(s)
    if t == "Split":
        pat = spec.get("pattern", {})
        behavior = spec.get("behavior", "Removed")
        invert = spec.get("invert", False)
        if "String" in pat:
            rxs = re.escape(pat["String"])
        else:
            rxs = pat.get("Regex", "")
        rx = compile_pattern(rxs)

        def split(s):
            if invert:
                return rx.findall(s)
            out = []
            last = 0
            for m in rx.finditer(s):
                before = s[last : m.start()]
                if behavior == "Removed":
                    if before:
                        out.append(before)
                elif behavior == "Isolated":
                    if before:
                        out.append(before)
                    out.append(m.group())
                elif behavior == "MergedWithPrevious":
                    out.append(before + m.group())
                elif behavior == "MergedWithNext":
                    if before:
                        out.append(before)
                    # handled by carrying into next; approximate with isolate
                    out.append(m.group())
                else:
                    if before:
                        out.append(before)
                    out.append(m.group())
                last = m.end()
            tail = s[last:]
            if tail:
                out.append(tail)
            return out

        return split
    if t == "Metaspace":
        repl = spec.get("replacement", "▁")
        prepend = spec.get("prepend_scheme", "always")
        add_prefix = spec.get("add_prefix_space", True)
        r = re.escape(repl)
        rx = re.compile(f"{r}[^{r}]*|[^{r}]+")

        def metaspace(s):
            if (prepend in ("always", "first") or add_prefix) and s and not s.startswith(" "):
                s = " " + s
            s = s.replace(" ", repl)
            # split keeping the replacement attached to the next word
            parts = rx.findall(s)
            return [p for p in parts if p]

        return metaspace
    raise TokenizerError(f"unsupported pre_tokenizer {t}")


# --- models ----------------------------------------------------------------


class BpeModel:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 continuing_subword_prefix: str = "",
                 end_of_word_suffix: str = "",
                 unk_token: Optional[str] = None,
                 fuse_unk: bool = False):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.csp = continuing_subword_prefix or ""
        self.eows = end_of_word_suffix or ""
        self.unk_token = unk_token
        self._cache: Dict[str, List[str]] = {}

    def tokenize(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        symbols = list(word)
        if self.eows and symbols:
            symbols[-1] = symbols[-1] + self.eows
        if self.csp:
            symbols = [symbols[0]] + [self.csp + s for s in symbols[1:]] if symbols else []
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            merged = symbols[best] + (
                symbols[best + 1][len(self.csp):] if self.csp else symbols[best + 1]
            )
            symbols = symbols[:best] + [merged] + symbols[best + 2:]
        if len(self._cache) < 65536:
            self._cache[word] = symbols
        return symbols

    def encode_piece(self, piece: str) -> List[Tuple[int, str]]:
        out = []
        for sym in self.tokenize(piece):
            tid = self.vocab.get(sym)
            if tid is None:
                if self.unk_token is not None:
                    out.append((self.vocab[self.unk_token], self.unk_token))
                # else: drop silently (matches HF with no unk)
            else:
                out.append((tid, sym))
        return out


class WordPieceModel:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk = unk_token
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def encode_piece(self, piece: str) -> List[Tuple[int, str]]:
        if len(piece) > self.max_chars:
            return [(self.vocab[self.unk], self.unk)]
        out = []
        start = 0
        n = len(piece)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = piece[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [(self.vocab[self.unk], self.unk)]
            out.append((self.vocab[cur], cur))
            start = end
        return out


# --- decoders --------------------------------------------------------------


def _make_decoder(spec: Optional[dict], model):
    if spec is None:
        return lambda tokens: "".join(tokens)
    t = spec.get("type")
    if t == "Sequence":
        fns = [_make_decoder(d, model) for d in spec.get("decoders", [])]

        def seq(tokens):
            # Each stage maps token list -> token list; final join.
            for f in fns:
                joined = f(tokens)
                tokens = [joined] if isinstance(joined, str) else joined
            return "".join(tokens)

        return seq
    if t == "ByteLevel":
        u2b = unicode_to_bytes()

        def byte_level(tokens):
            data = bytes(u2b[c] for tok in tokens for c in tok if c in u2b)
            return data.decode("utf-8", errors="replace")

        return byte_level
    if t == "WordPiece":
        prefix = spec.get("prefix", "##")
        cleanup = spec.get("cleanup", True)

        def clean(s):
            # Applied per token (as the HF rust decoder's decode_chain does),
            # so multi-token patterns like " ' " intentionally never match.
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                         (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                         (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                s = s.replace(a, b)
            return s

        def wordpiece(tokens):
            parts = []
            for i, tok in enumerate(tokens):
                if tok.startswith(prefix):
                    tok = tok[len(prefix):]
                elif i > 0:
                    tok = " " + tok
                parts.append(clean(tok) if cleanup else tok)
            return "".join(parts)

        return wordpiece
    if t == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: "".join(tokens).replace(suffix, " ").rstrip()
    if t == "Metaspace":
        repl = spec.get("replacement", "▁")

        def metaspace(tokens):
            s = "".join(tokens).replace(repl, " ")
            return s[1:] if s.startswith(" ") else s

        return metaspace
    if t == "Replace":
        pat = spec.get("pattern", {})
        content = spec.get("content", "")
        key = pat.get("String", pat.get("Regex", ""))
        return lambda tokens: "".join(tokens).replace(key, content)
    if t == "Strip":
        content = spec.get("content", " ")
        start = spec.get("start", 0)
        stop = spec.get("stop", 0)

        def strip(tokens):
            out = []
            for tok in tokens:
                s = tok
                for _ in range(start):
                    if s.startswith(content):
                        s = s[len(content):]
                for _ in range(stop):
                    if s.endswith(content):
                        s = s[: -len(content)]
                out.append(s)
            return out

        return strip
    if t == "Fuse":
        return lambda tokens: "".join(tokens)
    raise TokenizerError(f"unsupported decoder {t}")


# --- post-processors -------------------------------------------------------


def _make_post_processor(spec: Optional[dict], vocab: Dict[str, int]):
    """Returns fn(ids, tokens, add_special) -> (ids, tokens) single-sequence."""
    if spec is None or spec.get("type") in ("ByteLevel",):
        return lambda ids, tokens, add_special: (ids, tokens)
    t = spec.get("type")
    if t == "TemplateProcessing":
        single = spec.get("single", [])
        raw_specials = spec.get("special_tokens", {})
        entries = raw_specials.values() if isinstance(raw_specials, dict) else raw_specials
        specials = {
            tok["id"]: tok["ids"][0] if tok.get("ids") else vocab.get(tok["id"])
            for tok in entries
        }

        def template(ids, tokens, add_special):
            if not add_special:
                return ids, tokens
            out_ids: List[int] = []
            out_tokens: List[str] = []
            for item in single:
                if "SpecialToken" in item:
                    name = item["SpecialToken"]["id"]
                    out_ids.append(specials[name])
                    out_tokens.append(name)
                elif "Sequence" in item:
                    out_ids.extend(ids)
                    out_tokens.extend(tokens)
            return out_ids, out_tokens

        return template
    if t in ("BertProcessing", "RobertaProcessing"):
        cls_name, cls_id = spec.get("cls", ["[CLS]", vocab.get("[CLS]", 0)])
        sep_name, sep_id = spec.get("sep", ["[SEP]", vocab.get("[SEP]", 0)])

        def bert(ids, tokens, add_special):
            if not add_special:
                return ids, tokens
            return [cls_id] + ids + [sep_id], [cls_name] + tokens + [sep_name]

        return bert
    raise TokenizerError(f"unsupported post_processor {t}")


# --- tokenizer -------------------------------------------------------------


class Tokenizer:
    """rten-text Tokenizer analog (tokenizer.rs:245). ``native`` picks the
    encode core: the C++ one (default) or, with ``native=False``, Python."""

    def __init__(self, spec: dict, native: bool = True):
        self.spec = spec
        self.normalizer = _make_normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _make_pre_tokenizer(spec.get("pre_tokenizer"))
        model_spec = spec.get("model") or {}
        mtype = model_spec.get("type", "BPE")
        vocab = dict(model_spec.get("vocab", {}))
        merges = []
        if mtype == "BPE":
            merges = [
                tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                for m in model_spec.get("merges", [])
            ]
            self.model = BpeModel(
                vocab,
                merges,
                model_spec.get("continuing_subword_prefix") or "",
                model_spec.get("end_of_word_suffix") or "",
                model_spec.get("unk_token"),
            )
        elif mtype == "WordPiece":
            self.model = WordPieceModel(
                vocab,
                model_spec.get("unk_token", "[UNK]"),
                model_spec.get("continuing_subword_prefix", "##"),
                model_spec.get("max_input_chars_per_word", 100),
            )
        else:
            raise TokenizerError(f"unsupported model type {mtype}")
        self.vocab = vocab
        self.id_to_token_map: Dict[int, str] = {v: k for k, v in vocab.items()}
        self.added_tokens: Dict[str, int] = {}
        self.special_tokens: Dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            self.added_tokens[tok["content"]] = tok["id"]
            self.id_to_token_map[tok["id"]] = tok["content"]
            if tok.get("special"):
                self.special_tokens[tok["content"]] = tok["id"]
        self.post_processor = _make_post_processor(spec.get("post_processor"), vocab)
        self.decoder = _make_decoder(spec.get("decoder"), self.model)
        # The native core unless the caller asks for the Python one; a native
        # core that cannot be built raises (native.NativeLibraryError).
        self.core = "native" if native else "python"
        self._native = None
        if native:
            from .. import native as _native_mod

            if isinstance(self.model, BpeModel):
                unk = self.model.unk_token
                self._native = _native_mod.NativeBpe(
                    vocab, merges, self.model.csp, self.model.eows,
                    vocab.get(unk, -1) if unk else -1,
                )
            else:
                self._native = _native_mod.NativeWordPiece(
                    vocab, self.model.prefix, vocab.get(self.model.unk, 0),
                    self.model.max_chars,
                )
        # Longest-first added-token splitter.
        if self.added_tokens:
            alts = sorted(self.added_tokens, key=len, reverse=True)
            self._added_rx = re.compile("|".join(re.escape(a) for a in alts))
        else:
            self._added_rx = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_file(cls, path: str, native: bool = True) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f), native=native)

    @classmethod
    def from_json(cls, data, native: bool = True) -> "Tokenizer":
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        return cls(data, native=native)

    # -- encoding ------------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        ids: List[int] = []
        tokens: List[str] = []

        def encode_chunk(chunk: str):
            pieces = self.pre_tokenizer(self.normalizer(chunk))
            if self._native is not None:
                new = self._native.encode_pieces(pieces)
                ids.extend(new)
                tokens.extend([self.id_to_token_map.get(tid, "") for tid in new])
                return
            for piece in pieces:
                for tid, tok in self.model.encode_piece(piece):
                    ids.append(tid)
                    tokens.append(tok)

        if self._added_rx is not None:
            last = 0
            for m in self._added_rx.finditer(text):
                if m.start() > last:
                    encode_chunk(text[last : m.start()])
                ids.append(self.added_tokens[m.group()])
                tokens.append(m.group())
                last = m.end()
            if last < len(text):
                encode_chunk(text[last:])
        else:
            encode_chunk(text)

        ids, tokens = self.post_processor(ids, tokens, add_special_tokens)
        return Encoding(ids=ids, tokens=tokens)

    def encode_chunks(
        self, text: str, max_tokens: int, overlap: int = 0,
        add_special_tokens: bool = True,
    ) -> List[Encoding]:
        """Split a long text into encodings of at most ``max_tokens`` ids,
        optionally overlapping (rten-text Tokenizer::encode_chunks)."""
        if max_tokens <= 0:
            raise TokenizerError("max_tokens must be positive")
        if overlap >= max_tokens:
            raise TokenizerError("overlap must be smaller than max_tokens")
        full = self.encode(text, add_special_tokens=False)
        chunks: List[Encoding] = []
        step = max_tokens - overlap
        for start in range(0, max(len(full.ids), 1), step):
            ids = full.ids[start : start + max_tokens]
            toks = full.tokens[start : start + max_tokens]
            if not ids and chunks:
                break
            ids2, toks2 = self.post_processor(ids, toks, add_special_tokens)
            chunks.append(Encoding(ids=ids2, tokens=toks2))
            if start + max_tokens >= len(full.ids):
                break
        return chunks

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        special_ids = set(self.special_tokens.values())
        tokens = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special_ids:
                continue
            tok = self.id_to_token_map.get(i)
            if tok is not None:
                tokens.append(tok)
        out = self.decoder(tokens)
        return out if isinstance(out, str) else "".join(out)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        return self.id_to_token_map.get(int(tid))

    @property
    def vocab_size(self) -> int:
        return max(len(self.vocab), (max(self.id_to_token_map) + 1) if self.id_to_token_map else 0)
