"""Paged KV serving in the port against the JAX package: the pool helpers,
the two paged kernels' plain versions, the paged graph builders, and the
engine's block allocator and paged serving, token for token.

Inputs are made with numpy from a seed and handed to both packages. JAX
runs on the CPU (its XLA fallbacks, and the Pallas kernels in interpret
mode); on the CPU the port's kernel wrappers run their plain versions.

Block 0 is the engine's garbage sink: idle slots' table rows are all 0, so
several slots write the same pool row in one step. The reference writes
them in order, the last one winning, before anything reads; the cases
below put different values on colliding targets and hold the pools bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import flash_attention as jfa
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.models import llama as jllama
from rten_tpu.ops import attention as jatt
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.kernels import flash_attention as tfa
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.models import llama as tllama
from rten_tpu_torch.ops import attention as tatt
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- pool helpers (rten_tpu/ops/attention.py:68-196) ---------------------------

NB, BS, MB, B = 12, 8, 4, 6  # cap 32


def _table(rng):
    """Slots 0 and 1 own four shuffled blocks each, slot 2 two (the rest of
    its row is 0), and one block is free; slots 3-5 are idle (rows of 0,
    the garbage sink), so their writes collide in block 0."""
    ids = rng.permutation(np.arange(1, NB))
    bt = np.zeros((B, MB), np.int32)
    bt[:2] = ids[: 2 * MB].reshape(2, MB)
    bt[2, :2] = ids[2 * MB: 2 * MB + 2]
    return bt


def _lens(S):
    """0, BS - 1, BS and past cap on owned rows; idle slots at lengths that
    put several of their rows on one target of block 0."""
    cap = MB * BS
    return np.array([0, BS - 1, cap + 3 - S, 2, 2, BS + 2], np.int32)


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("helper", ["kv", "kv_cat", "scale"])
def test_pool_helpers_match_jax(helper, S):
    """``paged_kv_update``, ``paged_kv_update_cat`` and
    ``paged_scale_update`` against the JAX functions: bit-exact pools,
    including the rows several slots write (the last writer wins) and the
    positions past the table (block 0)."""
    rng = np.random.default_rng(S * 7 + len(helper))
    Hkv, D = 2, 16
    bt, lens = _table(rng), _lens(S)
    if helper == "kv":
        pool = rng.integers(-127, 128, (NB, Hkv, BS, D)).astype(np.int8)
        new = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
        fns = (tatt.paged_kv_update, jatt._paged_kv_update)
    elif helper == "kv_cat":
        pool = rng.standard_normal((NB, BS, Hkv * D)).astype(np.float32)
        new = rng.standard_normal((B, S, Hkv * D)).astype(np.float32)
        fns = (tatt.paged_kv_update_cat, jatt._paged_kv_update_cat)
    else:
        pool = rng.uniform(0.1, 1.0, (NB, Hkv, 1, BS)).astype(np.float32)
        new = rng.uniform(2.0, 3.0, (B, Hkv, S, 1)).astype(np.float32)
        fns = (tatt.paged_scale_update, jatt._paged_scale_update)
    got = fns[0](_t(pool.copy()), _t(new), _t(lens), _t(bt)).numpy()
    want = np.asarray(fns[1](jnp.asarray(pool), jnp.asarray(new), jnp.asarray(lens),
                             jnp.asarray(bt)))
    np.testing.assert_array_equal(got, want)
    # The idle slots wrote block 0, and did not all write the same values.
    assert not np.array_equal(got[0], pool[0])
    # Blocks no slot's table names are untouched.
    free = sorted(set(range(1, NB)) - set(bt.ravel().tolist()))
    np.testing.assert_array_equal(got[free], pool[free])


def test_pool_helpers_last_writer_wins():
    """Two slots write one row with different values: the later slot's row
    stays, as the reference's in-order writes leave it (S 1 and S > 1)."""
    for S in (1, 3):
        pool = torch.zeros((2, 1, BS, 4))
        new = torch.stack([torch.full((1, S, 4), 1.0), torch.full((1, S, 4), 2.0)])
        bt = torch.zeros((2, MB), dtype=torch.int32)
        tatt.paged_kv_update(pool, new, torch.tensor([1, 1], dtype=torch.int32), bt)
        assert (pool[0, 0, 1:1 + S] == 2.0).all() and (pool[0, 0, 1 + S:] == 0).all()


def test_gathers_match_jax():
    rng = np.random.default_rng(3)
    bt = _table(rng)
    pool = rng.standard_normal((NB, BS, 32)).astype(np.float32)
    spool = rng.standard_normal((NB, 2, 1, BS)).astype(np.float32)
    hm = rng.standard_normal((NB, 2, BS, 16)).astype(np.float32)
    pairs = [
        (tatt.paged_gather_cat(_t(pool), _t(bt)), jatt._paged_gather_cat(pool, bt)),
        (tatt.paged_gather_scales_flat(_t(spool), _t(bt)),
         jatt._paged_gather_scales_flat(spool, bt)),
        (tfa.paged_gather_kv(_t(hm), _t(bt)), jfa.paged_gather_kv(hm, bt)),
        (tfa.paged_gather_scales(_t(spool), _t(bt)), jfa.paged_gather_scales(spool, bt)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- paged_decode_mha (rten_tpu/kernels/flash_attention.py:3425) ---------------


def _paged_inputs(seed, quant, B_, H_, Hkv, D, BS_, MB_, NB_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B_, H_, 1, D)).astype(np.float32)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    if quant:
        pk = rng.integers(-127, 128, (NB_, Hkv, BS_, D)).astype(np.int8)
        pv = rng.integers(-127, 128, (NB_, Hkv, BS_, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (NB_, Hkv, 1, BS_)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (NB_, Hkv, 1, BS_)).astype(np.float32)
    else:
        pk = rng.standard_normal((NB_, Hkv, BS_, D)).astype(np.float32)
        pv = rng.standard_normal((NB_, Hkv, BS_, D)).astype(np.float32)
        ks = vs = None
    bt = rng.permutation(np.arange(1, NB_))[: B_ * MB_].reshape(B_, MB_).astype(np.int32)
    return q, pk, pv, bt, ks, vs


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("quant", [True, False])
def test_paged_decode_mha_plain_matches_pallas_interpret(quant, window):
    """Against the Pallas block-table kernel in interpret mode with a
    shuffled table, at cap 128 (the interpreted kernels need cap % 128 ==
    0): rtol 2e-2, atol 5e-3 (its dots round p to bf16; q lies on the bf16
    grid)."""
    q, pk, pv, bt, ks, vs = _paged_inputs(1 + window, quant, 4, 8, 2, 64, 32, 4, 18)
    lens = np.array([0, 31, 32, 127], np.int32)
    sc = (ks, vs) if quant else ()
    got = tfa.paged_decode_mha(_t(q), _t(pk), _t(pv), _t(lens), _t(bt),
                               *map(_t, sc), window=window).numpy()
    want = np.asarray(jfa.paged_decode_mha(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lens),
        jnp.asarray(bt), *map(jnp.asarray, sc), window=window, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("quant", [True, False])
def test_paged_attention_matches_jax_fallback(quant, window):
    """``paged_attention`` against the JAX one with use_flash=False (gather,
    then decode_mha_xla): atol 1e-5, at S 1 (the port's paged_decode_mha)
    and S 6 (gather, then decode_mha), lens past cap included."""
    for S in (1, 6):
        q, pk, pv, bt, ks, vs = _paged_inputs(S + window, quant, 5, 8, 2, 64, 16, 4, 22)
        q = np.random.default_rng(S).standard_normal((5, 8, S, 64)).astype(np.float32)
        lens = np.array([0, 15, 16, 40, 70], np.int32)
        sc = (ks, vs) if quant else ()
        got = tfa.paged_attention(_t(q), _t(pk), _t(pv), _t(lens), _t(bt),
                                  *map(_t, sc), window=window).numpy()
        want = np.asarray(jfa.paged_attention(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lens),
            jnp.asarray(bt), *map(jnp.asarray, sc), window=window, use_flash=False))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_paged_attention_routes_by_shape():
    """S 1 with group <= FOLD_MAX_ROWS goes to paged_decode_mha; an
    admission gathers and goes to decode_mha."""
    pk = torch.zeros(5, 2, 16, 64)
    bt = torch.arange(1, 5, dtype=torch.int32).reshape(2, 2)
    lens = torch.zeros(2, dtype=torch.int32)
    calls = []
    orig = tfa.paged_decode_mha_plain, tfa.decode_mha_plain
    try:
        tfa.paged_decode_mha_plain = lambda *a, **kw: calls.append("paged") or orig[0](*a, **kw)
        tfa.decode_mha_plain = lambda *a, **kw: calls.append("flat") or orig[1](*a, **kw)
        tfa.paged_attention(torch.zeros(2, 8, 1, 64), pk, pk, lens, bt)
        tfa.paged_attention(torch.zeros(2, 8, 8, 64), pk, pk, lens, bt)
    finally:
        tfa.paged_decode_mha_plain, tfa.decode_mha_plain = orig
    assert calls == ["paged", "flat", "flat"]


# --- decode_mha_append_cat with block_table (flash_attention.py:2597) ----------


def _append_inputs(seed, H_, Hkv, D, BS_, MB_, NB_, bt):
    rng = np.random.default_rng(seed)
    B_ = bt.shape[0]
    q = rng.standard_normal((B_, H_, 1, D)).astype(np.float32)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    kn = rng.standard_normal((B_, Hkv, 1, D)).astype(np.float32)
    vn = rng.standard_normal((B_, Hkv, 1, D)).astype(np.float32)
    kn[0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]  # .5 ties
    pk = rng.integers(-127, 128, (NB_, BS_, Hkv * D)).astype(np.int8)
    pv = rng.integers(-127, 128, (NB_, BS_, Hkv * D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (NB_, Hkv, 1, BS_)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (NB_, Hkv, 1, BS_)).astype(np.float32)
    return q, kn, vn, pk, pv, ks, vs


def _port_append(args, lens, bt, window=0):
    q, kn, vn, pk, pv, ks, vs = (_t(a.copy()) for a in args)
    out = tfa.decode_mha_append_cat(q, pk, pv, _t(lens), ks, vs, k_new=kn, v_new=vn,
                                    window=window, block_table=_t(bt))
    return [t.numpy() for t in out]


@pytest.mark.parametrize("H_,Hkv,window", [(4, 4, 0), (8, 2, 0), (8, 2, 20)])
def test_paged_append_plain_matches_jax_fallback(H_, Hkv, window):
    """Against decode_attention_append_cat(use_flash=False, block_table=)
    with idle slots colliding in block 0 and lens at 0, BS - 1, BS and past
    cap: output atol 1e-5, pools bit-exact, scale pools rtol 5e-6, blocks
    no slot owns unchanged."""
    D, BS_, MB_, NB_ = 64, 16, 3, 10
    bt = np.zeros((6, MB_), np.int32)
    bt[:3] = np.random.default_rng(0).permutation(np.arange(1, NB_))[:9].reshape(3, MB_)
    lens = np.array([0, BS_ - 1, 60, 5, 5, 47], np.int32)  # slots 3-5 idle
    args = _append_inputs(H_ + window, H_, Hkv, D, BS_, MB_, NB_, bt)
    got = _port_append(args, lens, bt, window)
    q, kn, vn, pk, pv, ks, vs = map(jnp.asarray, args)
    want = [np.asarray(a) for a in jfa.decode_attention_append_cat(
        q, pk, pv, jnp.asarray(lens), ks, vs, k_new=kn, v_new=vn, window=window,
        use_flash=False, block_table=jnp.asarray(bt))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=5e-6, atol=0)
    np.testing.assert_allclose(got[4], want[4], rtol=5e-6, atol=0)
    # Slots 3 and 4 write the same row of block 0: slot 4's row stays.
    kq = np.clip(np.round(args[1][4, :, 0] / np.maximum(
        np.abs(args[1][4, :, 0]).max(-1, keepdims=True) / 127.0, 1e-8)), -127, 127)
    np.testing.assert_array_equal(got[1][0, 5], kq.reshape(-1).astype(np.int8))
    free = [b for b in range(1, NB_) if b not in bt]
    np.testing.assert_array_equal(got[1][free], args[3][free])
    np.testing.assert_array_equal(got[3][free], args[5][free])


@pytest.mark.parametrize("H_,Hkv", [(4, 4), (8, 2)])
def test_paged_append_plain_matches_pallas_interpret(H_, Hkv):
    """Against the Pallas block-table kernel in interpret mode (cap 128,
    distinct blocks per slot): output rtol 2e-2, atol 5e-3 (bf16 dots; q on
    the bf16 grid); s8 pools within one code (the interpreted kernel may
    divide by the scale as a reciprocal multiply), scale pools rtol 5e-6."""
    D, BS_, MB_, NB_ = 64, 64, 2, 6
    bt = np.array([[1, 2], [3, 4]], np.int32)
    args = _append_inputs(H_, H_, Hkv, D, BS_, MB_, NB_, bt)
    for lens_l in ([0, 100], [63, 64], [30, 127]):
        lens = np.array(lens_l, np.int32)
        got = _port_append(args, lens, bt)
        q, kn, vn, pk, pv, ks, vs = map(jnp.asarray, args)
        want = [np.asarray(a) for a in jfa.decode_mha_append_cat(
            q, pk, pv, jnp.asarray(lens), ks, vs, k_new=kn, v_new=vn, interpret=True,
            block_table=jnp.asarray(bt))]
        np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=5e-3)
        for i in (1, 2):
            assert np.abs(got[i].astype(np.int16) - want[i].astype(np.int16)).max() <= 1
        for i in (3, 4):
            np.testing.assert_allclose(got[i], want[i], rtol=5e-6, atol=0)


# --- builders ------------------------------------------------------------------

GPT2_SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
LLAMA_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=128)
SLOTS, CAP, BUCKET, PBS = 3, 64, 8, 16
# Paged forms: name -> (family, builder options).
FORMS = {
    "gpt2_s8_cat": ("gpt2", dict(kv_quant=True, kernel_append=True)),
    "llama_s8_head_major": ("llama", dict(kv_quant=True)),
    "llama_s8_cat": ("llama", dict(kv_quant=True, kernel_append=True)),
    "llama_f32_head_major": ("llama", dict(kv_quant=False)),
}


def _weights(family):
    """Seeded weights, sharpened so that greedy tokens depend on the
    context (the GPT-2 and Llama serving tests say why)."""
    if family == "gpt2":
        w = tgpt2.random_weights(tgpt2.GPT2Config(**GPT2_SMALL), seed=0)
        return {k: v * np.float32(10.0) if (".attn." in k or ".mlp." in k) else v
                for k, v in w.items()}
    w = tllama.random_weights(tllama.LlamaConfig(**LLAMA_SMALL), seed=0)
    return {k: v * np.float32(2.0) if "_proj." in k else v for k, v in w.items()}


def _graphs(form, paged_blocks, quantize=True):
    family, opts = FORMS[form]
    kw = dict(capacity=CAP, gather_last=True, **opts)
    if paged_blocks:
        kw.update(paged_blocks=paged_blocks, block_size=PBS)
    w = _weights(family)
    if family == "gpt2":
        tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**GPT2_SMALL), w, **kw)
        jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**GPT2_SMALL), w, **kw)
    else:
        tg = tllama.build_graph_static_cache(tllama.LlamaConfig(**LLAMA_SMALL), w, **kw)
        jg = jllama.build_graph_static_cache(jllama.LlamaConfig(**LLAMA_SMALL), w, **kw)
    if quantize:
        tquantize(tg)
        jquantize(jg)
    return tg, jg


@pytest.mark.parametrize("form", list(FORMS))
def test_paged_graph_matches_jax(form):
    """The paged builders issue the JAX builders' calls: the same operators
    with the same ids, attributes, inputs and outputs, and the same inputs
    by name, dtype and shape (the pools' concrete shapes, the table)."""
    tg, jg = _graphs(form, 10, quantize=False)
    assert tg.input_ids == jg.input_ids and tg.output_ids == jg.output_ids
    for (tid, top), (jid, jop) in zip(tg.operators(), jg.operators()):
        assert (tid, top.op_type, top.attrs, top.inputs, top.outputs) == \
            (jid, jop.op_type, jop.attrs, jop.inputs, jop.outputs)
    for nid in tg.input_ids:
        t, j = tg.nodes[nid], jg.nodes[nid]
        assert (t.name, t.dtype.name, tuple(t.shape)) == (j.name, j.dtype.name, tuple(j.shape))
    bt = tg.nodes[tg.find_node("block_table")]
    assert tuple(bt.shape) == ("slots", CAP // PBS)


@pytest.mark.parametrize("family,kwargs,err", [
    ("gpt2", dict(block_size=12), ValueError),            # block_size % 8
    ("gpt2", dict(capacity=56), ValueError),              # capacity % block_size
    ("llama", dict(kv_bits=4), ValueError),               # int4 pools
    ("llama", dict(deferred_kv=True), ValueError),
])
def test_paged_builder_guards(family, kwargs, err):
    opts = dict(capacity=CAP, kv_quant=True, kernel_append=family == "gpt2",
                gather_last=True, paged_blocks=8, block_size=PBS)
    opts.update(kwargs)
    with pytest.raises(err, match="block_size|paged_blocks"):
        if family == "gpt2":
            tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**GPT2_SMALL),
                                           _weights("gpt2"), **opts)
        else:
            tllama.build_graph_static_cache(tllama.LlamaConfig(**LLAMA_SMALL),
                                            _weights("llama"), **opts)


# --- the engine: token-exact against the JAX engine ----------------------------


def _engine(cls, model, form, k, **kw):
    family = FORMS[form][0]
    n_head = GPT2_SMALL["n_head"] if family == "gpt2" else LLAMA_SMALL["num_attention_heads"]
    return cls(model, n_layer=2, n_head=n_head, head_dim=64, slots=SLOTS, capacity=CAP,
               prefill_bucket=BUCKET, greedy_on_device=True, steps_per_dispatch=k, **kw)


def _requests(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
             int(rng.integers(3, 14))) for _ in range(n)]


def _serve(eng, requests):
    """Serve step by step; returns (requests, most slots busy at once,
    admissions the pool refused)."""
    reserve, refused = eng._reserve_blocks, []

    def counted(slot, n):
        ok = reserve(slot, n)
        refused.append(not ok)
        return ok

    if eng.paged:
        eng._reserve_blocks = counted
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    busy = 0
    while eng.has_work():
        eng.step()
        busy = max(busy, sum(r is not None for r in eng.slot_req))
    return reqs, busy, sum(refused)


# "full": every slot can hold a request; "tight": 3 usable blocks of 16
# rows for requests of 1 or 2 blocks, so admissions re-queue.
POOLS = {"full": 40, "tight": 4}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_paged_engine_token_exact(form, k, pool):
    """5 requests on 3 slots, steps_per_dispatch k: every request's tokens
    equal the JAX engine's, in the same order of completion; with the tight
    pool the pool, not the slot count, limits the batch, the same way on
    both sides. Afterwards the free list holds every block but 0.

    As in the flat engine tests, torch and XLA can round a per-tensor
    activation to neighbouring u8 codes, and at a near tie that changes a
    greedy token (tests/test_torch_llama.py says why); the requests come
    from a seed where no such tie is hit (seeds 1 and 6 hit one in the
    tight pool at k 1, where the idle rows differ from the full pool's)."""
    tg, jg = _graphs(form, POOLS[pool])
    teng = _engine(TEngine, TModel(tg, device="cpu"), form, k)
    jeng = _engine(JEngine, JModel(jg, JOptions(optimize=True)), form, k)
    treqs, tbusy, trefused = _serve(teng, _requests(2))
    jreqs, jbusy, jrefused = _serve(jeng, _requests(2))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.request_id for r in teng.finished] == [r.request_id for r in jeng.finished]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in treqs)
    assert (teng.steps, tbusy, trefused) == (jeng.steps, jbusy, jrefused)
    assert (trefused > 0) == (pool == "tight")
    assert sorted(teng._free_blocks) == list(range(1, teng.n_blocks))
    assert all(not b for b in teng._slot_blocks) and not teng.block_table.any()
    # The tokens depend on the context: not one token repeated.
    assert len({t for r in treqs for t in r.generated}) > len(treqs)


# --- the allocator (tests/test_paged_serving.py:78, :132, :515) ----------------


def _port_engine(form, paged_blocks, k=4, **kw):
    tg, _ = _graphs(form, paged_blocks)
    return _engine(TEngine, TModel(tg, device="cpu"), form, k, **kw)


def _full_wave(seed):
    """One request per slot, all with the same budget: they are admitted
    together and finish together, so no slot idles. (An idle slot's
    garbage row feeds the per-tensor activation scale, and paged and flat
    engines put different garbage there: block 0 against the slot's own
    rows.)"""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(), 9)
            for _ in range(SLOTS)]


@pytest.mark.parametrize("form", ["gpt2_s8_cat", "llama_s8_head_major"])
def test_paged_blocks_reused_across_waves(form):
    """A second wave reuses the first wave's freed (dirty) blocks (each wave
    needs all 6 usable blocks): stale rows never reach attention, so the
    tokens equal the flat engine's."""
    flat, paged = _port_engine(form, 0), _port_engine(form, 7)
    for seed in (1, 2):
        wave = _full_wave(seed)
        assert sum(paged._blocks_needed(len(p), n) for p, n in wave) == paged.n_blocks - 1
        want = _serve(flat, wave)[0]
        got = _serve(paged, wave)[0]
        assert [r.generated for r in got] == [r.generated for r in want]
        assert len(paged._free_blocks) == paged.n_blocks - 1


@pytest.mark.parametrize("k", [1, 4])
def test_paged_and_flat_engines_agree(k):
    """Paging changes where rows live, not what is computed: the port's
    paged and flat engines give the same tokens."""
    for form in FORMS:
        want = _serve(_port_engine(form, 0, k), _full_wave(3))[0]
        got = _serve(_port_engine(form, 40, k), _full_wave(3))[0]
        assert [r.generated for r in got] == [r.generated for r in want], form


def test_impossible_reservation_rejected_at_submit():
    eng = _port_engine("llama_s8_head_major", 3)  # 2 usable blocks of 16
    assert eng._blocks_needed(3, 20) == 2
    eng.submit([1, 2, 3], max_new_tokens=20)
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(list(range(1, 30)), max_new_tokens=20)


def test_cancel_and_timeout_release_blocks():
    eng = _port_engine("gpt2_s8_cat", 40)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in _full_wave(4)]
    eng.step()  # admits all three and decodes 4 of their 9 tokens
    held = [list(b) for b in eng._slot_blocks]
    assert all(held) and len(eng._free_blocks) == eng.n_blocks - 1 - sum(map(len, held))
    eng.cancel(reqs[0])
    reqs[1].timeout_s = 0.0
    eng.step()
    assert reqs[0].cancelled and reqs[1].timed_out
    assert not eng._slot_blocks[0] and not eng._slot_blocks[1]
    assert not eng.block_table[:2].any()
    assert set(held[0] + held[1]) <= set(eng._free_blocks)
    eng.run()
    assert sorted(eng._free_blocks) == list(range(1, eng.n_blocks))


def test_paged_engine_checks():
    tg, _ = _graphs("llama_s8_head_major", 10)
    with pytest.raises(ValueError, match="capacity"):
        TEngine(TModel(tg, device="cpu"), n_layer=2, n_head=4, head_dim=64, slots=2,
                capacity=CAP * 2, greedy_on_device=True)
    eng = _port_engine("llama_s8_head_major", 10)
    assert eng.paged and eng.block_size == PBS and eng.max_blocks == CAP // PBS
    assert [tuple(c.shape) for c in eng.caches[:2]] == [(10, 2, PBS, 64), (10, 2, 1, PBS)]
    # A shared prefix shorter than a block: one template block, held until
    # the prefix is cleared (as the JAX engine holds it).
    eng.set_shared_prefix([1, 2, 3])
    assert eng._prefix_shared == [] and eng._prefix_tmpl == 1 and eng._prefix_nblocks == 1
    assert len(eng._free_blocks) == eng.n_blocks - 2
    eng.set_shared_prefix([])
    assert sorted(eng._free_blocks) == list(range(1, eng.n_blocks))
