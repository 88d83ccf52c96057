"""The port's tokenizer (``rten_tpu_torch/text``) and its native core
(``rten_tpu_torch/native``) against the JAX package's ``Tokenizer`` and
the HF ``tokenizers`` library: token-exact (ids, tokens and decoded text
equal) on GPT-2-style and BERT-style tokenizers trained on the same corpus
as ``tests/test_tokenizer.py``, on a seeded fuzz corpus, and on the
50257-entry GPT-2-shaped spec of ``tests/torch_tokenizer_spec.py``; the
native core equal to the Python core, past the JAX package's 4096-id
buffer too; the GPT-2 split equal to the JAX package's ``regex`` split in
a process where ``regex`` cannot be imported; a failed native build
raising with its log."""

import json
import os
import pathlib
import random
import subprocess
import sys

import pytest
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import decoders, models, normalizers, pre_tokenizers, processors, trainers

from rten_tpu.text import Tokenizer as JTokenizer
from rten_tpu.text import tokenizer as jtok
from rten_tpu_torch import native
from rten_tpu_torch.text import Tokenizer
from rten_tpu_torch.text import pattern, tokenizer as ttok

sys.path.insert(0, os.path.dirname(__file__))
import torch_tokenizer_spec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORES = ["native", "python"]

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Pack my box with five dozen liquor jugs!",
    "TPUs multiply matrices efficiently, don't they?",
    "Hello world; hello tokens 123 456.",
    "  weird   spacing\tand\nnewlines",
    "naïve café résumé — unicode façade",
    "数字と漢字のテスト 1234",
]

SAMPLES = [
    "Hello world!",
    "The quick brown fox, again — don't stop.",
    "  leading space and 987 numbers",
    "unicode: café naïve 漢字",
    "",
    "a",
]

POOLS = [
    "abcdefghijklmnopqrstuvwxyz", "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
    "0123456789", " \t\n", ".,;:!?'\"-—", "αβγδε", "漢字かなカナ数字",
    "émüñçàÉ", "🙂🚀👍🏽", "​﻿", "'s't're'll", "²½Ⅻ٣",
]


# The JAX package's BertPreTokenizer splits on regex's \w, which leaves out
# symbols and other numbers (emoji, "²", "½") that HF's keeps inside a word;
# the port keeps the JAX package's split, so the BERT fuzz meets HF on the
# other pools only.
BERT_HF_POOLS = [p for p in POOLS if p not in ("🙂🚀👍🏽", "²½Ⅻ٣")]


def fuzz_corpus(n, seed=0, max_len=40, pools=POOLS):
    rng = random.Random(seed)
    return ["".join(rng.choice(rng.choice(pools)) for _ in range(rng.randint(0, max_len)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def gpt2_style(tmp_path_factory):
    """Byte-level BPE with GPT-2's pipeline (tests/test_tokenizer.py's)."""
    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(CORPUS * 4, trainer)
    path = str(tmp_path_factory.mktemp("tok") / "gpt2_style.json")
    tok.save(path)
    return tok, path


@pytest.fixture(scope="module")
def bert_style(tmp_path_factory):
    tok = HFTokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer()
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    trainer = trainers.WordPieceTrainer(
        vocab_size=400, special_tokens=["[UNK]", "[CLS]", "[SEP]"]
    )
    tok.train_from_iterator(CORPUS * 4, trainer)
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")), ("[SEP]", tok.token_to_id("[SEP]"))],
    )
    path = str(tmp_path_factory.mktemp("tok") / "bert_style.json")
    tok.save(path)
    return tok, path


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    """The 50257-entry spec, built once for the module."""
    return torch_tokenizer_spec.write_spec(tmp_path_factory.mktemp("spec") / "gpt2_50257.json")


def _load(path, core):
    tok = Tokenizer.from_file(path, native=core == "native")
    assert tok.core == core
    return tok


def _same(ours, jax_tok, hf, texts):
    """Ids, tokens and decoded text equal to the JAX package's, and ids and
    text to HF's (``hf`` None: the JAX package's only)."""
    for s in texts:
        got, jax_enc = ours.encode(s), jax_tok.encode(s)
        assert (got.ids, got.tokens) == (jax_enc.ids, jax_enc.tokens), s
        assert ours.decode(got.ids) == jax_tok.decode(got.ids), s
        if hf is not None:
            assert got.ids == hf.encode(s).ids, s
            assert ours.decode(got.ids) == hf.decode(got.ids), s


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("style", ["gpt2_style", "bert_style"])
def test_fixture_samples_match_hf_and_jax(request, style, core):
    hf, path = request.getfixturevalue(style)
    _same(_load(path, core), JTokenizer.from_file(path), hf, SAMPLES + CORPUS)


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("style", ["gpt2_style", "bert_style"])
def test_fuzz_matches_hf_and_jax(request, style, core):
    """Seeded strings over CJK, accents, digits, emoji, tabs, newlines,
    zero-width characters and contractions."""
    hf, path = request.getfixturevalue(style)
    ours, jt = _load(path, core), JTokenizer.from_file(path)
    if style == "gpt2_style":
        _same(ours, jt, hf, fuzz_corpus(150, seed=1))
    else:
        _same(ours, jt, None, fuzz_corpus(150, seed=1))
        _same(ours, jt, hf, fuzz_corpus(150, seed=2, pools=BERT_HF_POOLS))


@pytest.mark.parametrize("core", CORES)
def test_special_tokens_and_skip(gpt2_style, core):
    hf, path = gpt2_style
    ours, jt = _load(path, core), JTokenizer.from_file(path)
    s = "Hello<|endoftext|>world<|endoftext|>"
    ids = ours.encode(s).ids
    assert ids == hf.encode(s).ids == jt.encode(s).ids
    eot = ours.token_to_id("<|endoftext|>")
    assert eot == hf.token_to_id("<|endoftext|>") and eot in ids
    assert ours.decode(ids) == jt.decode(ids) == hf.decode(ids)
    assert "<|endoftext|>" not in ours.decode(ids)
    kept = ours.decode(ids, skip_special_tokens=False)
    assert kept == jt.decode(ids, skip_special_tokens=False) == \
        hf.decode(ids, skip_special_tokens=False)
    assert kept.count("<|endoftext|>") == 2
    assert ours.vocab_size == jt.vocab_size and ours.id_to_token(eot) == "<|endoftext|>"


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("style", ["gpt2_style", "bert_style"])
def test_encode_chunks_match_jax(request, style, core):
    _, path = request.getfixturevalue(style)
    ours, jt = _load(path, core), JTokenizer.from_file(path)
    text = " ".join(CORPUS * 3)
    for max_tokens, overlap in ((16, 0), (10, 3), (1000, 0)):
        a = ours.encode_chunks(text, max_tokens, overlap)
        b = jt.encode_chunks(text, max_tokens, overlap)
        assert [(c.ids, c.tokens) for c in a] == [(c.ids, c.tokens) for c in b]
    with pytest.raises(ttok.TokenizerError):
        ours.encode_chunks(text, 4, overlap=4)


def test_spec_has_gpt2s_layout(spec_path):
    spec = json.loads(pathlib.Path(spec_path).read_text(encoding="utf-8"))
    vocab = spec["model"]["vocab"]
    assert len(vocab) == 50257 and len(spec["model"]["merges"]) == 50000
    assert vocab["<|endoftext|>"] == 50256 and spec["added_tokens"][0]["special"]
    assert list(vocab)[:256] == list(ttok.bytes_to_unicode().values())
    assert spec["pre_tokenizer"] == {"type": "ByteLevel", "add_prefix_space": False,
                                     "trim_offsets": True, "use_regex": True}
    assert torch_tokenizer_spec.make_spec(0)["model"]["merges"][-5:] == \
        spec["model"]["merges"][-5:]


@pytest.mark.parametrize("core", CORES)
def test_spec_50257_matches_hf_and_jax(spec_path, core):
    """The prompt encodes to whole words, and a seeded corpus (sentences,
    digits, accents, CJK, emoji, tabs, newlines) token-exact."""
    hf = HFTokenizer.from_file(spec_path)
    ours = _load(spec_path, core)
    prompt = torch_tokenizer_spec.PROMPT
    ids = ours.encode(prompt).ids
    assert len(ids) == len(prompt.split()) + 2  # the comma and the full stop
    _same(ours, JTokenizer.from_file(spec_path), hf,
          [prompt, torch_tokenizer_spec.corpus(20_000, seed=3)] + fuzz_corpus(40, seed=2))


def test_native_equals_python_on_the_spec(spec_path):
    native_tok, python_tok = _load(spec_path, "native"), _load(spec_path, "python")
    text = torch_tokenizer_spec.corpus(60_000, seed=4)
    a, b = native_tok.encode(text), python_tok.encode(text)
    assert a.ids == b.ids and a.tokens == b.tokens


@pytest.mark.parametrize("letter", ["q", "ж", "漢"], ids=["ascii", "cyrillic", "cjk"])
def test_a_10000_letter_piece(gpt2_style, letter):
    """One pre-tokenized piece of 10000 letters (10000 to 30000 byte
    symbols, past the JAX package's native buffer of 4096 ids) encodes in
    both cores as HF encodes it."""
    hf, path = gpt2_style
    piece = letter * 10000
    native_tok, python_tok = _load(path, "native"), _load(path, "python")
    assert len(native_tok.pre_tokenizer(piece)) == 1
    want = hf.encode(piece).ids
    assert len(want) > 4096
    assert native_tok.encode(piece).ids == python_tok.encode(piece).ids == want


def test_native_buffers_grow_to_the_pieces():
    """The native encoders' output buffers grow to each call's bound (ids
    at most the UTF-8 bytes for BPE; chars + 1 for WordPiece, whose one
    unknown id stands for a piece past max_input_chars_per_word): started
    at two ids, every call encodes as the Python core does."""
    vocab = {"[UNK]": 0, "a": 1, "##a": 2, "b": 3, "##b": 4}
    nat = native.NativeWordPiece(vocab, "##", 0, 400)
    py = ttok.WordPieceModel(vocab, "[UNK]", "##", 400)
    for piece in ("ab" * 150, "a" * 300, "abc", "b", "a" * 401, ""):
        nat._buf = nat._buf[:2]
        assert nat.encode_piece(piece) == [t for t, _ in py.encode_piece(piece)], piece[:8]
    nat._buf = nat._buf[:2]
    assert nat.encode_pieces(["ab", "", "ba", "abc"]) == [1, 4, 3, 2, 0]
    bpe_vocab = {"h": 0, "e": 1, "l": 2, "o": 3, "he": 4, "ll": 5, "hell": 6, "hello": 7}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o")]
    nat_bpe, py_bpe = native.NativeBpe(bpe_vocab, merges), ttok.BpeModel(bpe_vocab, merges)
    pieces = ["hello", "olleh", "", "xyz", "hel" * 300, "l" * 500]
    nat_bpe._buf = nat_bpe._buf[:2]
    assert nat_bpe.encode_pieces(pieces) == \
        [t for p in pieces for t, _ in py_bpe.encode_piece(p)]


def test_library_builds_under_build_not_the_package():
    lib = native.get_lib()
    assert lib is native.get_lib()
    path = native.library_path()
    assert path.exists() and (ROOT / "build") in path.parents
    assert not list(pathlib.Path(native.__file__).parent.glob("*.so"))


def test_failed_native_build_raises_with_its_log(tmp_path, monkeypatch, gpt2_style):
    """A compiler that fails: the native core raises with the compiler's
    output; nothing falls back to Python unless the caller asks for it."""
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'bpe.cpp:1: error: no compiler here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeLibraryError, match="no compiler here"):
        native.get_lib()
    _, path = gpt2_style
    with pytest.raises(native.NativeLibraryError, match="exited 3"):
        Tokenizer.from_file(path)
    from rten_tpu_torch import imageproc

    with pytest.raises(native.NativeLibraryError):
        imageproc.find_contours([[1]])
    python_tok = Tokenizer.from_file(path, native=False)
    assert python_tok.core == "python" and python_tok.encode("hello").ids
    assert not list((tmp_path / "build").rglob("*.so"))


SPLITS = [{"type": "ByteLevel", "add_prefix_space": False},
          {"type": "ByteLevel", "add_prefix_space": True},
          {"type": "Digits", "individual_digits": True},
          {"type": "Digits", "individual_digits": False},
          {"type": "Punctuation"}, {"type": "Whitespace"}, {"type": "BertPreTokenizer"},
          {"type": "Split", "pattern": {"Regex": r"\p{Lu}\p{Ll}+|\s+"}, "behavior": "Isolated"}]


def test_split_without_regex_equals_the_jax_packages_regex_split():
    """In a fresh process with ``regex`` blocked from import, the port's
    pre-tokenizers split a seeded corpus exactly as the JAX package's
    ``regex`` patterns do."""
    texts = fuzz_corpus(300, seed=5, max_len=60) + [torch_tokenizer_spec.corpus(5_000)]
    assert jtok._re.__name__ == "regex"
    want = [[jtok._make_pre_tokenizer(s)(t) for t in texts] for s in SPLITS]
    code = (
        "import json, sys\n"
        "sys.modules['regex'] = None\n"
        "from rten_tpu_torch.text import tokenizer as ttok\n"
        "specs, texts = json.loads(sys.stdin.read())\n"
        "print(json.dumps([[ttok._make_pre_tokenizer(s)(t) for t in texts] for s in specs]))\n"
        "assert sys.modules['regex'] is None\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], input=json.dumps([SPLITS, texts]),
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout) == want


def test_unicode_classes_equal_regexs():
    """Every class the rewrite knows, over every code point this Python's
    tables assign, selects what ``regex`` selects."""
    import unicodedata

    import regex

    chars = "".join(chr(c) for c in range(sys.maxunicode + 1)
                    if not 0xD800 <= c < 0xE000 and unicodedata.category(chr(c)) != "Cn")
    for cls in (r"\p{L}", r"\p{N}", r"\p{P}", r"\p{Lu}", r"\pL", r"\P{N}", r"\s", r"\S",
                r"\w", r"\W", r"\d", r"[^\s\p{L}\p{N}]"):
        assert pattern.compile_pattern(cls).findall(chars) == regex.findall(cls, chars), cls
    with pytest.raises(pattern.re.error):
        pattern.compile_pattern(r"\p{Nonsense}")
