"""The port's streaming ``TextDecoder`` against the JAX package's, and the
text path (prompt string -> tokenizer -> Generator -> streamed text) of a
2-layer GPT-2 (E 128) over the fixture tokenizer's vocabulary through the
port's and the JAX package's Generator: the same pieces, token-exact."""

import itertools
import os
import sys

import numpy as np
import pytest
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import decoders, models, pre_tokenizers, trainers

from rten_tpu.generate import Generator as JGenerator, GeneratorConfig as JConfig
from rten_tpu.generate import TextDecoder as JTextDecoder
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.text import Tokenizer as JTokenizer
from rten_tpu_torch.generate import Generator, GeneratorConfig, TextDecoder
from rten_tpu_torch.models import gpt2
from rten_tpu_torch.text import Tokenizer

sys.path.insert(0, os.path.dirname(__file__))
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from test_torch_tokenizer import CORPUS  # noqa: E402

MULTIBYTE = "naïve café 漢字かな 🙂🚀 résumé — done"


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """The GPT-2-style fixture (byte-level BPE, vocab 400): the port's and
    the JAX package's Tokenizer of one file."""
    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS * 4, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    path = str(tmp_path_factory.mktemp("tok") / "gpt2_style.json")
    tok.save(path)
    return Tokenizer.from_file(path), JTokenizer.from_file(path)


def _pieces(decoder, ids):
    return [decoder.push(i) for i in ids]


def test_pieces_equal_the_jax_decoders_on_split_characters(tokenizers):
    """Byte tokens that split accents, CJK and emoji: every push gives the
    JAX decoder's piece, the held-back pushes included."""
    ours, jax_tok = tokenizers
    ids = ours.encode(MULTIBYTE).ids
    assert ids == jax_tok.encode(MULTIBYTE).ids
    pieces = _pieces(TextDecoder(ours), ids)
    assert pieces == _pieces(JTextDecoder(jax_tok), ids)
    assert "".join(pieces) == MULTIBYTE == ours.decode(ids)
    assert pieces.count("") >= 4  # a multi-byte character held back until whole
    assert list(TextDecoder(ours).wrap(ids)) == [p for p in pieces if p]


def test_a_cut_character_is_held_back(tokenizers):
    """Ids that end inside a character: nothing of it is emitted, as the
    JAX decoder holds it back; a special token decodes to nothing."""
    ours, jax_tok = tokenizers
    ids = ours.encode("ok 🙂").ids
    eot = ours.token_to_id("<|endoftext|>")
    for cut in (ids[:-1], ids[:-2], [eot] + ids[:-1] + [eot]):
        a, b = _pieces(TextDecoder(ours), cut), _pieces(JTextDecoder(jax_tok), cut)
        assert a == b and "🙂" not in "".join(a) and "".join(a) == "ok "
        assert not ours.decode(cut).endswith("ok ")


def test_streamed_text_equals_the_jax_packages(tokenizers):
    """A prompt string through each package's tokenizer, 2-layer GPT-2
    (E 128, vocab 400, int8 weights from seed 0 sharpened x4 so the tokens
    depend on the context), Generator (bucket 8, greedy) and TextDecoder:
    the same 16 tokens and the same streamed pieces (the JAX Generator
    traces every step: about 0.5 s a token on the CPU)."""
    ours, jax_tok = tokenizers
    small = dict(vocab_size=ours.vocab_size, n_positions=128, n_embd=128, n_layer=2,
                 n_head=2)
    w = gpt2.random_weights(gpt2.GPT2Config(**small), 0)
    w = {k: v * np.float32(4) if (".attn.c_" in k or ".mlp.c_" in k) and k.endswith(".weight")
         else v for k, v in w.items()}
    prompt = "The quick brown fox jumps over"
    ids = ours.encode(prompt).ids
    assert ids == jax_tok.encode(prompt).ids

    def stream(model, gen_cls, cfg_cls, dec_cls, tok):
        seen = []

        def tokens():
            for t in itertools.islice(gen_cls(model, [ids], cfg_cls(bucket_size=8)), 16):
                seen.append(int(t))
                yield t

        return list(dec_cls(tok).wrap(tokens())), seen

    a, a_ids = stream(gpt2.load(gpt2.GPT2Config(**small), w, quantize="int8", device="cpu"),
                      Generator, GeneratorConfig, TextDecoder, ours)
    b, b_ids = stream(jgpt2.load(jgpt2.GPT2Config(**small), w, quantize="int8"),
                      JGenerator, JConfig, JTextDecoder, jax_tok)
    assert a_ids == b_ids and len(a_ids) == 16
    assert len(set(a_ids)) > 3  # the weights give more than one repeated token
    assert a == b
    text = ours.decode(a_ids)
    assert text.startswith("".join(a)) and (text == "".join(a) or text.endswith("�"))
