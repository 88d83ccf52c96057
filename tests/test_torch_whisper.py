"""The port's Whisper (``rten_tpu_torch/models/whisper.py``) against the
JAX package's, at the JAX test's tiny config (n_mels 16, d_model 32, 2 + 2
layers, 4 heads): the mel front end graph, the encoder states, the cross
K/V, prefill logits and greedy tokens, on the same seeded weights
(``tests/whisper_weights.py``, whose names and shapes are checked against
``transformers``' ``WhisperForConditionalGeneration``). JAX runs on the
CPU, the port on the CPU (the kernels' plain versions)."""

import numpy as np
import pytest
import torch

import whisper_weights
from rten_tpu.model import Model as JModel
from rten_tpu.models import whisper as jw
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import whisper as tw
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=100, n_mels=16, d_model=32, encoder_layers=2, decoder_layers=2,
            heads=4, max_source_positions=50, max_target_positions=40)
FFN = 64
SHARPEN = 16.0  # at d_model 32 the greedy tokens then vary with the context


@pytest.fixture(scope="module")
def models():
    w = whisper_weights.random_weights(tw.WhisperConfig(**TINY), seed=0, sharpen=SHARPEN,
                                       ffn_dim=FFN)
    return (tw.WhisperModel(tw.WhisperConfig(**TINY), w, device="cpu"),
            jw.WhisperModel(jw.WhisperConfig(**TINY), w))


def _mel(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, TINY["n_mels"], 2 * TINY["max_source_positions"])).astype(
        np.float32)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "whisper-tiny"])
def test_weights_match_transformers_state_dict(cfg):
    """Every name and shape of the seeded dict is the HF model's (built on
    the meta device, so no weights are made for it): at the tiny config the
    dict itself, at Whisper-tiny's widths its specification."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    c = tw.WhisperConfig(**cfg)
    ffn = FFN if cfg else None
    with torch.device("meta"):
        hf = WhisperForConditionalGeneration(HFConfig(**whisper_weights.hf_config_kwargs(c, ffn)))
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    specs = whisper_weights.weight_specs(c, ffn)
    assert list(specs) == list(want)
    assert {k: shape for k, (shape, _) in specs.items()} == want
    if cfg:
        w = whisper_weights.random_weights(c, seed=0, ffn_dim=ffn)
        assert {k: v.shape for k, v in w.items()} == want
        assert all(v.dtype == np.float32 for v in w.values())


def test_hf_model_loads_the_seeded_weights():
    """The dict loads into the HF module (strict), and the port's encoder
    gives the module's encoder states from it."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    c = tw.WhisperConfig(**TINY)
    w = whisper_weights.random_weights(c, seed=1, ffn_dim=FFN)
    hf = WhisperForConditionalGeneration(HFConfig(**whisper_weights.hf_config_kwargs(c, FFN)))
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()}, strict=True)
    hf.eval()
    mel = _mel(1)
    with torch.no_grad():
        want = hf.model.encoder(torch.from_numpy(mel)).last_hidden_state.numpy()
    _, enc = tw.WhisperModel(c, w, device="cpu").encode(mel)
    assert _rel(enc.numpy(), want) <= 1e-4


@pytest.mark.parametrize("n", [16000, 4000])
def test_mel_frontend_matches_jax(n):
    """The STFT front end graph, port against JAX and against the host
    numpy version, within 1e-5 of max|mel|."""
    rng = np.random.default_rng(n)
    t = np.arange(n, dtype=np.float32) / 16000
    audio = (0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    got = TModel(tw.build_mel_frontend(n), device="cpu").run({"audio": audio[None]})[0].numpy()
    want = np.asarray(JModel(jw.build_mel_frontend(n)).run({"audio": audio[None]})[0])
    assert got.shape == want.shape == (1, 80, n // 160)
    assert _rel(got, want) <= 1e-5
    assert _rel(got[0], tw.log_mel_spectrogram(audio)) <= 1e-5


def test_encoder_and_cross_kv_match_jax(models):
    tm, jm = models
    mel = _mel()
    tcross, tenc = tm.encode(mel)
    jcross, jenc = jm.encode(mel)
    assert tenc.shape == (1, TINY["max_source_positions"], TINY["d_model"])
    assert _rel(tenc.numpy(), jenc) <= 1e-4
    assert tcross.keys() == jcross.keys()
    for k in tcross:
        assert _rel(tcross[k].numpy(), jcross[k]) <= 1e-4, k


def test_decoder_prefill_logits_match_jax(models):
    tm, jm = models
    mel = _mel(2)
    ids = np.array([[7, 3, 11, 19]], np.int32)
    feeds = []
    for m in (tm, jm):
        cross, _ = m.encode(mel)
        feed = {"input_ids": ids, "attention_mask": np.ones((1, 4), np.int32),
                "position_ids": np.arange(4, dtype=np.int32)[None], **cross}
        for i in range(TINY["decoder_layers"]):
            for kv in ("key", "value"):
                feed[f"past_key_values.{i}.decoder.{kv}"] = np.zeros(
                    (1, TINY["heads"], 0, TINY["d_model"] // TINY["heads"]), np.float32)
        feeds.append(feed)
    got = tm.decoder.run(feeds[0], ["logits"])[0].numpy()
    want = np.asarray(jm.decoder.run(feeds[1], ["logits"])[0])
    assert got.shape == (1, 4, TINY["vocab_size"])
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("prompt", [[5, 9], [1, 2, 3, 4]])
def test_greedy_tokens_match_jax(models, prompt):
    tm, jm = models
    mel = _mel(3)
    got = tm.generator(mel, [prompt]).generate(8)
    want = jm.generator(mel, [prompt]).generate(8)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0].tolist())) > 1  # the tokens depend on the context


def test_encoder_attention_reaches_the_mha_dispatch(models, monkeypatch):
    """The encoder's Attention (Tq = 50 >= 8, no mask) goes through the
    port's ``mha`` wrapper, the dispatch that launches kernel row 5 on the
    card, once a layer."""
    from rten_tpu_torch.ops import attention

    calls = []
    real = attention.mha

    def spy(q, k, v, mask=None, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), mask is None, kw.get("causal")))
        return real(q, k, v, mask, **kw)

    monkeypatch.setattr(attention, "mha", spy)
    tm, _ = models
    tm.encode(_mel())
    H, T = TINY["heads"], TINY["max_source_positions"]
    D = TINY["d_model"] // H
    assert calls == [((1, H, T, D), (1, H, T, D), True, False)] * TINY["encoder_layers"]
