"""The port's Generator on an encoder-decoder export (after
``tests/test_encoder_decoder_generate.py``): the Optimum-style merged
decoder of ``tests/merged_decoder_model.py`` (an ONNX ``If`` on
``use_cache_branch``, growing ``past_key_values.N.decoder.*`` caches,
``past_key_values.N.encoder.*`` cross caches computed on the first run and
empty dummy presents after it), exported with torch and loaded by both
packages. The port's greedy tokens equal the JAX Generator's and the torch
module's own greedy decode, with the optimizer off and on; a session file
carries the cross caches."""

import numpy as np
import pytest
import torch

from merged_decoder_model import MergedDecoder, export_merged_decoder
from rten_tpu.generate import Generator as JGenerator
from rten_tpu.generate import GeneratorConfig as JConfig
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.generate import Generator as TGenerator
from rten_tpu_torch.generate import GeneratorConfig as TConfig
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

H, D, E = 4, 8, 32


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("enc_dec") / "merged.onnx")
    return path, export_merged_decoder(path)


def torch_greedy(module: MergedDecoder, enc: torch.Tensor, prompt, n_steps):
    """Greedy decode driving the torch module with real caches (the JAX
    test's reference)."""
    z = torch.zeros(1, H, 0, D, device=enc.device)
    flag = torch.tensor(False)
    ids = torch.tensor([prompt], dtype=torch.int64, device=enc.device)
    caches = [z] * 8
    toks = []
    with torch.no_grad():
        for step in range(n_steps):
            out = module(ids, enc, flag, *caches)
            dk0, dv0, ek0, ev0, dk1, dv1, ek1, ev1 = out[1:]
            if step == 0:
                cross = [ek0, ev0, ek1, ev1]
            caches = [dk0, dv0, cross[0], cross[1], dk1, dv1, cross[2], cross[3]]
            flag = torch.tensor(True)
            tok = int(torch.argmax(out[0][0, -1]))
            toks.append(tok)
            ids = torch.tensor([[tok]], dtype=torch.int64, device=enc.device)
    return toks


def _config(pkg, enc):
    C = TConfig if pkg == "port" else JConfig
    return C(max_seq_len=64, constant_inputs={"encoder_hidden_states": enc})


@pytest.mark.parametrize("opt,seed,prompt,n_new", [
    (False, 3, [1, 7, 2], 8), (True, 3, [1, 7, 2], 8), (True, 4, [4, 9], 6),
], ids=["plain", "optimized", "optimized-2"])
def test_merged_decoder_token_exact(merged, opt, seed, prompt, n_new):
    path, module = merged
    torch.manual_seed(seed)
    enc = torch.randn(1, 5, E)
    want = torch_greedy(module, enc, prompt, n_new)
    tm = TModel.load_file(path, TOptions(optimize=opt), device="cpu")
    assert "If" in {op.op_type for _, op in tm.graph.operators()}
    gen = TGenerator(tm, prompt, _config("port", enc.numpy()))
    # No attention_mask input: the generator runs exact shapes.
    assert gen.config.bucket_size == 1
    assert len(gen.kv) == 4 and len(gen.cross_kv) == 4
    got = [int(t) for t in gen.generate(n_new)[0]]
    jm = JModel.load_file(path, JOptions(optimize=opt))
    jax_tokens = [int(t) for t in JGenerator(jm, prompt, _config("jax", enc.numpy()))
                  .generate(n_new)[0]]
    assert got == jax_tokens == want, (got, jax_tokens, want)
    # The cross caches were computed once, at the encoder's length, and kept.
    for e in gen.cross_kv:
        assert tuple(gen._cross[e.input_name].shape) == (1, H, 5, D)


def test_cross_caches_fetched_on_the_first_run_only(merged, monkeypatch):
    """The first run asks for the encoder presents and feeds
    use_cache_branch False as a static input; later runs feed True and the
    kept cross caches, and ask for no encoder present."""
    path, _ = merged
    tm = TModel.load_file(path, TOptions(optimize=False), device="cpu")
    calls = []
    real = tm.run

    def spy(feed, outputs=None, static_inputs=()):
        calls.append((dict(feed), list(outputs), list(static_inputs)))
        return real(feed, outputs, static_inputs)

    monkeypatch.setattr(tm, "run", spy)
    enc = np.random.default_rng(0).standard_normal((1, 5, E)).astype(np.float32)
    gen = TGenerator(tm, [1, 2], _config("port", enc))
    gen.generate(3)
    (f0, o0, s0), rest = calls[0], calls[1:]
    assert s0 == ["use_cache_branch"] and f0["use_cache_branch"] == np.bool_(False)
    assert sum("encoder" in n for n in o0) == 4
    assert all(tuple(f0[e.input_name].shape) == (1, H, 0, D) for e in gen.cross_kv)
    assert len(rest) == 3  # a decode step after each of the 3 tokens
    for feed, outs, static in rest:
        assert static == ["use_cache_branch"] and feed["use_cache_branch"] == np.bool_(True)
        assert not any("encoder" in n for n in outs)
        for e in gen.cross_kv:
            assert feed[e.input_name] is gen._cross[e.input_name]


def test_session_roundtrip_with_cross_kv(merged, tmp_path):
    path, module = merged
    tm = TModel.load_file(path, TOptions(optimize=False), device="cpu")
    enc = torch.randn(1, 5, E, generator=torch.Generator().manual_seed(5))
    cfg = _config("port", enc.numpy())
    gen = TGenerator(tm, [1, 2], cfg)
    first3 = [int(t) for t in gen.generate(3)[0]]
    sess = str(tmp_path / "sess.safetensors")
    gen.save_session(sess)

    from rten_tpu_torch.serialize import read_safetensors

    saved = read_safetensors(sess)
    assert {f"cross.{i}" for i in range(4)} <= set(saved)
    gen2 = TGenerator(tm, [1, 2], cfg)
    gen2.restore_session(sess)
    for e in gen.cross_kv:
        assert torch.equal(gen2._cross[e.input_name], gen._cross[e.input_name])
    cont = [int(t) for t in gen2.generate(3)[0]]
    assert first3 + cont == torch_greedy(module, enc, [1, 2], 6)
