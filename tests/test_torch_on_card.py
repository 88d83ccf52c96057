"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the edges (ragged tiles, clamped writes, GQA,
windows, strided rows), and the serving engine on the card against the
same engine on the CPU.

Every test here needs an NVIDIA card and carries the ``gpu`` marker; the
``card`` fixture skips it where there is none. This file imports nothing
of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py -q
"""

import numpy as np
import pytest
import torch

from rten_tpu_torch.kernels import argmax as targmax
from rten_tpu_torch.kernels import flash_attention as tfa
from rten_tpu_torch.kernels import int4_matmul as t4
from rten_tpu_torch.kernels import int8_matmul as tmm
from rten_tpu_torch.tools import bench_decode_attn as tbda

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("M,K,N", [(1, 64, 128), (3, 768, 2304), (40, 100, 36),
                                   (130, 3072, 768), (16, 768, 51200),
                                   # every form boundary: stream to 16, rows to 128, tiled
                                   (1, 768, 768), (16, 2048, 256), (17, 768, 768),
                                   (120, 3072, 768), (128, 768, 2304), (129, 768, 768),
                                   (2048, 2048, 256), (2048, 768, 2304), (120, 772, 36)])
@pytest.mark.parametrize("zp", ["u8_colsums", "u8", "s8_both"])
def test_int8_matmul_kernel(card, M, K, N, zp):
    """Every form (``int8_form``: stream to M 16, rows to 128, tiled above)
    against the plain version: the integer part is exact and the f32
    epilogue (acc * sa) * sb rounds the same way in both, so the outputs
    are equal, bit for bit, and a second call gives the same bits; the
    form's counter moves and no other's. K and N not multiples of 16
    (4-byte copies), ragged M and N, and split K (TinyLlama's k/v
    projection at 16 and 2048 rows, GPT-2's K 3072 c_proj at 120)."""
    from rten_tpu_torch.kernels.common import sm_count

    g = _gen(M * 7 + N)
    b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    sb = torch.rand(N, generator=g) * 1e-3 + 1e-4
    if zp == "s8_both":
        a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
        azp = torch.randint(-3, 4, (M,), generator=g, dtype=torch.int32)
        bzp = torch.randint(-2, 3, (N,), generator=g, dtype=torch.int32)
        sa = torch.rand(M, generator=g) * 0.01 + 0.01
        cs = None
    else:
        a = torch.randint(0, 256, (M, K), generator=g, dtype=torch.uint8)
        azp, bzp, sa = torch.tensor(131, dtype=torch.uint8), None, torch.tensor(0.02)
        cs = b.to(torch.int32).sum(0, keepdim=True).to(torch.int32) if zp == "u8_colsums" else None
    args = [t if t is None else t.to(card) for t in (a, b, sa, sb, azp, bzp, cs)]
    form = tmm.int8_form(M)
    assert form == ("stream" if M <= 16 else "rows" if M <= 128 else "tiled")
    splits = tmm.int8_split_plan(M, N, K, sm_count(card.index or 0))[0]
    if (M, K, N) in ((16, 2048, 256), (2048, 2048, 256), (120, 3072, 768)):
        assert splits > 1  # the split route runs
    before = {f: getattr(tmm.int8_matmul_dequant, f"{f}_launches") for f in tmm.FORMS}
    before_all = tmm.int8_matmul_dequant.launches
    got = tmm.int8_matmul_dequant(*args)
    again = tmm.int8_matmul_dequant(*args)
    want = tmm.int8_matmul_dequant_plain(*args)
    torch.cuda.synchronize()
    assert tmm.int8_matmul_dequant.launches == before_all + 2
    assert {f: getattr(tmm.int8_matmul_dequant, f"{f}_launches") - before[f]
            for f in tmm.FORMS} == {f: 2 if f == form else 0 for f in tmm.FORMS}
    assert got.shape == (M, N) and got.device.type == "cuda"
    assert torch.equal(got, want) and torch.equal(got, again)


def test_argmax_kernel(card):
    """The split argmax against its plain version at a ragged slice and at
    the three serve shapes ([120, 50257] through the padded lm_head's
    stride 51200, [16, 32000], [16, 151936]), with ties straddling chunk
    boundaries, the maximum in the first and last column, NaN rows (the
    first NaN wins), an all -inf row (0), M 1, and two calls giving the
    same bits."""
    g = _gen(1)
    full = torch.randn(37, 5000, generator=g)
    full[0, 3] = full[0, 4000] = 99.0   # tie: the lower index wins
    full[1, 4999] = 99.0                # beyond the slice: ignored
    full[2, 4096] = 99.0                # the last column of the slice
    x = full.to(card)[:, :4097]
    got = targmax.argmax_lastdim(x)
    want = targmax.argmax_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[0].item() == 3 and got[2].item() == 4096
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for M, N, padded in ((120, 50257, 51200), (16, 32000, 32000), (16, 151936, 151936),
                         (1, 50257, 50257), (1, 1000, 1003)):
        full = torch.randn(M, padded, generator=_gen(N))
        full[:, N:] = 1e9                           # past the slice: never read
        chunks, L = targmax.chunk_plan(M, N, sms)
        r = full[:, :N]
        r[0, 0] = 50.0                              # the first column
        r[M - 1, N - 1] = 60.0                      # the last column
        if chunks > 2 and M > 4:
            r[1, L - 1] = r[1, L] = 50.0            # a tie over a chunk boundary
            r[2, 2 * L + 3] = r[2, (chunks - 1) * L] = 50.0  # two chunks apart
            r[3, 7] = r[3, L + 7] = float("nan")    # two NaNs: the first wins
            r[3, 3] = 1e30
            r[4] = float("-inf")                    # all -inf: 0
        x = full.to(card)[:, :N]
        before = targmax.argmax_lastdim.launches
        got = targmax.argmax_lastdim(x)
        again = targmax.argmax_lastdim(x)
        want = targmax.argmax_plain(x)
        torch.cuda.synchronize()
        assert targmax.argmax_lastdim.launches == before + 2
        assert torch.equal(got, want) and torch.equal(got, again), (M, N)
        assert got[M - 1].item() == N - 1
        if chunks > 2 and M > 4:
            assert got[1:5].tolist() == [L - 1, 2 * L + 3, 7, 0], (M, N)
        assert torch.equal(got.cpu(), targmax.argmax_plain(full[:, :N])), (M, N)


def _decode_inputs(card, B, H, Hkv, D, cap, lens, seed):
    g = _gen(seed)
    q = torch.randn(B, H, 1, D, generator=g)
    kn = torch.randn(B, Hkv, 1, D, generator=g)
    vn = torch.randn(B, Hkv, 1, D, generator=g)
    kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8)
    ks = torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005
    vs = torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005
    kn[0, 0, 0, :4] = torch.tensor([0.5, 1.5, -2.5, 127.0])  # .5 ties
    lens = torch.tensor(lens, dtype=torch.int32)
    return [t.to(card) for t in (q, kc, vc, lens, ks, vs, kn, vn)]


@pytest.mark.parametrize("H,Hkv,D,window", [(2, 2, 64, 0), (12, 12, 64, 0),
                                            (8, 2, 128, 0), (4, 4, 32, 16)])
def test_decode_append_kernel(card, H, Hkv, D, window):
    """s8 rows bit-exact and rows the kernel does not own untouched;
    scales rtol 5e-6; out atol 1e-4 (summation order differs)."""
    cap = 96
    lens = [0, 31, 32, cap - 1, cap, cap + 7]
    q, kc, vc, lens_t, ks, vs, kn, vn = _decode_inputs(card, 6, H, Hkv, D, cap, lens, H + D)
    a = [t.clone() for t in (kc, vc, ks, vs)]
    p = [t.clone() for t in (kc, vc, ks, vs)]
    got = tfa.decode_mha_append_cat(q, a[0], a[1], lens_t, a[2], a[3], k_new=kn,
                                    v_new=vn, window=window)
    want = tfa.decode_mha_append_cat_plain(q, p[0], p[1], lens_t, p[2], p[3],
                                           k_new=kn, v_new=vn, window=window)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.allclose(got[3], want[3], rtol=5e-6, atol=0)
    assert torch.allclose(got[4], want[4], rtol=5e-6, atol=0)
    wpos = [min(n, cap - 1) for n in lens]
    for bb, w in enumerate(wpos):
        keep = torch.ones(cap, dtype=torch.bool, device=card)
        keep[w] = False
        assert torch.equal(got[1][bb, keep], kc[bb, keep])


def _prefill_launches():
    return tfa.prefill_mha_cat.launches, tfa.prefill_mha_cat.wide_launches


def _check_prefill_form(before, dtype, D, calls):
    """prefill_mha_cat ran ``calls`` times on the tensor-core per-head
    kernel heads_plan names: decode_heads_tc.cuh or (f32 caches)
    decode_heads_tf32.cuh at D <= 128, decode_heads_wide.cuh for D
    129-256, counted by ``wide_launches``."""
    wide = calls if D > 128 else 0
    assert tfa.heads_form(dtype, D) == "tensor_core"
    assert tfa.heads_plan(dtype, D).kernel == ("wide" if D > 128 else "tf32"
                                               if dtype == torch.float32 else "tc")
    assert _prefill_launches() == (before[0] + calls, before[1] + wide)


@pytest.mark.parametrize("H,Hkv,D,S,window", [(2, 2, 64, 8, 0), (12, 12, 64, 45, 0),
                                              (8, 2, 64, 33, 0), (4, 4, 32, 16, 5),
                                              (12, 12, 64, 128, 0)])
def test_prefill_kernel(card, H, Hkv, D, S, window):
    """Row r of slot b attends columns <= lens[b] + r: atol 1e-4 against
    the plain version (summation order differs), on the tensor-core
    per-head kernel through the cat caches' strides (GPT-2's group 1 at D 64
    and S 128 among the shapes, cap 256 there), the same bits on a second
    call."""
    cap, B = (96 if S < 96 else 256), 4
    g = _gen(S)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
    vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
    ks = (torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005).to(card)
    vs = (torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005).to(card)
    lens = torch.tensor([0, 7, cap - S, 31], dtype=torch.int32, device=card)
    before = _prefill_launches()
    got = tfa.prefill_mha_cat(q, kc, vc, lens, ks, vs, window=window)
    again = tfa.prefill_mha_cat(q, kc, vc, lens, ks, vs, window=window)
    want = tfa.prefill_mha_cat_plain(q, kc, vc, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    _check_prefill_form(before, kc.dtype, D, 2)
    assert got.shape == (B, H, S, D) and torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4


def _head_major_inputs(card, B, H, Hkv, S, D, cap, quant, seed):
    g = _gen(seed)
    q = torch.randn(B, H, S, D, generator=g)
    if quant:
        k = torch.randint(-127, 128, (B, Hkv, cap, D), generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, Hkv, cap, D), generator=g, dtype=torch.int8)
        ks = torch.rand(B, Hkv, cap, generator=g) * 0.015 + 0.005
        vs = torch.rand(B, Hkv, cap, generator=g) * 0.015 + 0.005
    else:
        k = torch.randn(B, Hkv, cap, D, generator=g)
        v = torch.randn(B, Hkv, cap, D, generator=g)
        ks = vs = None
    return [t if t is None else t.to(card) for t in (q, k, v, ks, vs)]


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("H,Hkv,S,D,window", [
    (32, 4, 1, 64, 0),     # TinyLlama's decode step: the fold, 8 rows per kv head
    (4, 2, 1, 64, 0),
    (8, 8, 1, 128, 0),     # group 1, D 128
    (8, 2, 4, 128, 0),     # the fold with 16 rows per kv head
    (4, 4, 1, 64, 24),     # window
    (32, 4, 40, 64, 0),    # admission: per head, a ragged 32-row tile
    (8, 2, 16, 128, 0),    # per head (group 4 x S 16 > 16 rows), D 128
    (4, 2, 33, 64, 20),    # per head with a window
])
def test_decode_mha_kernel(card, quant, H, Hkv, S, D, window):
    """Both launch forms against decode_mha_plain: atol 1e-4 (f32
    accumulation on both sides, other summation order). lens cover an
    empty cache, the last row, a clamped chunk and slots past cap. A row
    with no column to attend (a window wholly past cap) gives 0 from the
    kernel, as on the TPU; the plain version, like the JAX package's XLA
    path, gives the mean of V there, so such rows are checked apart."""
    cap, B = 96, 6
    lens = torch.tensor([0, 17, cap - S, cap - 1, cap, cap + 40], dtype=torch.int32,
                        device=card)
    q, k, v, ks, vs = _head_major_inputs(card, B, H, Hkv, S, D, cap, quant, H * S + D)
    form = tfa.decode_mha_folded if (H // Hkv) * S <= tfa.FOLD_MAX_ROWS else tfa.decode_mha_heads
    other = tfa.decode_mha_heads if form is tfa.decode_mha_folded else tfa.decode_mha_folded
    before, before_other = form.launches, other.launches
    got = tfa.decode_mha(q, k, v, lens, ks, vs, window=window)
    want = tfa.decode_mha_plain(q, k, v, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    assert form.launches == before + 1 and other.launches == before_other
    assert got.shape == (B, H, S, D) and torch.isfinite(got).all()
    qpos = lens.long()[:, None] + torch.arange(S, device=card)[None]   # [B, S]
    live = (qpos - window < cap - 1) if window else torch.ones_like(qpos, dtype=torch.bool)
    live = live[:, None, :, None].expand_as(got)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all()


def test_decode_mha_kernel_reads_strided_caches(card):
    """K/V and scales are addressed through strides: head-major views of
    cat-layout [B, cap, Hkv*D] caches give the same result as contiguous
    copies."""
    B, H, Hkv, D, cap = 3, 8, 2, 64, 64
    g = _gen(5)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
    vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
    ks = (torch.rand(B, cap, Hkv, generator=g) * 0.01 + 0.005).to(card).permute(0, 2, 1)
    vs = (torch.rand(B, cap, Hkv, generator=g) * 0.01 + 0.005).to(card).permute(0, 2, 1)
    lens = torch.tensor([3, 40, 63], dtype=torch.int32, device=card)
    kh, vh = tfa.cat_to_heads(kc, Hkv), tfa.cat_to_heads(vc, Hkv)
    got = tfa.decode_mha(q, kh, vh, lens, ks, vs)
    want = tfa.decode_mha(q, kh.contiguous(), vh.contiguous(), lens, ks.contiguous(),
                          vs.contiguous())
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("k", [1, 4])
def test_engine_on_card_matches_cpu(card, k):
    """The small GPT-2 served on the card and on the CPU (the plain
    versions) from the same weights: the same tokens."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_dynamic
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
    weights = gpt2.random_weights(cfg, seed=0)
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = gpt2.build_graph_static_cache(cfg, weights, capacity=64, kv_quant=True,
                                              kernel_append=True, gather_last=True)
        quantize_dynamic(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=2, head_dim=64, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("kv", ["s8_head_major", "f32_head_major", "s8_cat"])
def test_llama_engine_on_card_matches_cpu(card, kv):
    """A small Llama (GQA 4 over 2 heads, rotary) served on the card and on
    the CPU from the same weights, for each supported cache layout: the
    same tokens."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import llama
    from rten_tpu_torch.quantize_pass import quantize_dynamic
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, max_position_embeddings=128)
    weights = llama.random_weights(cfg, seed=0)
    opts = {"s8_head_major": dict(kv_quant=True), "f32_head_major": dict(kv_quant=False),
            "s8_cat": dict(kv_quant=True, kernel_append=True)}[kv]
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = llama.build_graph_static_cache(cfg, weights, capacity=64, gather_last=True,
                                               **opts)
        quantize_dynamic(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=4, head_dim=64, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]


def _table(card, B, MB, NB, owners, seed):
    """Slots < owners hold shuffled distinct blocks; the rest are idle (rows
    of 0: they read and write block 0, the garbage sink)."""
    bt = torch.zeros(B, MB, dtype=torch.int32)
    bt[:owners] = (torch.randperm(NB - 1, generator=_gen(seed))[: owners * MB] + 1).reshape(
        owners, MB).to(torch.int32)
    return bt.to(card)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("H,Hkv,D,BS,window", [
    (32, 4, 64, 64, 0),    # TinyLlama's decode step: 8 rows per kv head, a table entry per 64 rows
    (4, 2, 64, 8, 0),      # BS 8: four table entries in a warp's 32 keys
    (8, 8, 128, 16, 0),    # group 1, D 128
    (16, 1, 64, 24, 20),   # 16 rows per kv head, BS not a power of two, a window
])
def test_paged_decode_mha_kernel(card, quant, H, Hkv, D, BS, window):
    """paged_decode_mha against its plain version (gather, decode_mha_plain)
    with a shuffled table, idle slots on block 0, and lens at 0, BS - 1, BS,
    the last row and past cap: atol 1e-4, and the same bits on a second
    call."""
    B, MB = 6, 4
    NB, cap = 4 * MB + 2, MB * BS
    g = _gen(H * BS + D)
    bt = _table(card, B, MB, NB, 4, H + BS)
    lens = torch.tensor([0, BS - 1, BS, cap - 1, cap + 5, 3], dtype=torch.int32, device=card)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    if quant:
        pk = torch.randint(-127, 128, (NB, Hkv, BS, D), generator=g, dtype=torch.int8).to(card)
        pv = torch.randint(-127, 128, (NB, Hkv, BS, D), generator=g, dtype=torch.int8).to(card)
        sc = [(torch.rand(NB, Hkv, 1, BS, generator=g) * 0.015 + 0.005).to(card)
              for _ in range(2)]
    else:
        pk = torch.randn(NB, Hkv, BS, D, generator=g).to(card)
        pv = torch.randn(NB, Hkv, BS, D, generator=g).to(card)
        sc = []
    before = tfa.paged_decode_mha.launches
    got = tfa.paged_decode_mha(q, pk, pv, lens, bt, *sc, window=window)
    again = tfa.paged_decode_mha(q, pk, pv, lens, bt, *sc, window=window)
    want = tfa.paged_decode_mha_plain(q, pk, pv, lens, bt, *sc, window=window)
    torch.cuda.synchronize()
    assert tfa.paged_decode_mha.launches == before + 2
    assert got.shape == (B, H, 1, D) and torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("H,Hkv,D,window", [(12, 12, 64, 0), (8, 2, 128, 0), (4, 4, 32, 0),
                                            (8, 2, 64, 20)])
def test_paged_append_kernel(card, H, Hkv, D, window):
    """decode_mha_append_cat through a block table against its plain version
    (the reference's write-all-then-attend fallback), with idle slots whose
    rows collide in block 0: out atol 1e-4, s8 pools bit-exact, scale pools
    rtol 5e-6, blocks no slot owns untouched, and the same bits on a second
    run from the same inputs."""
    B, BS, MB = 8, 16, 3
    NB, cap = 5 * MB + 2, MB * BS
    g = _gen(H + D + window)
    bt = _table(card, B, MB, NB, 5, H + D)
    # Slots 5 and 6 (idle) write row 5 of block 0; slot 7 row 4 of it.
    lens = torch.tensor([0, BS - 1, BS, cap - 1, cap + 4, 5, 5, BS + 4], dtype=torch.int32,
                        device=card)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    vn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    pools = [torch.randint(-127, 128, (NB, BS, Hkv * D), generator=g, dtype=torch.int8).to(card)
             for _ in range(2)]
    pools += [(torch.rand(NB, Hkv, 1, BS, generator=g) * 0.015 + 0.005).to(card)
              for _ in range(2)]
    runs = []
    before = tfa.decode_mha_append_cat_paged.launches
    for _ in range(2):
        p = [t.clone() for t in pools]
        runs.append(tfa.decode_mha_append_cat(q, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                              v_new=vn, window=window, block_table=bt))
    p = [t.clone() for t in pools]
    want = tfa.decode_mha_append_cat_paged_plain(q, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                                 v_new=vn, window=window, block_table=bt)
    torch.cuda.synchronize()
    assert tfa.decode_mha_append_cat_paged.launches == before + 2
    got = runs[0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.allclose(got[3], want[3], rtol=5e-6, atol=0)
    assert torch.allclose(got[4], want[4], rtol=5e-6, atol=0)
    owned = set(bt.flatten().tolist())
    free = [b for b in range(1, NB) if b not in owned]
    for i in range(4):
        assert torch.equal(got[i + 1][free], pools[i][free])


@pytest.mark.parametrize("form", ["gpt2_s8_cat", "llama_s8_head_major", "llama_s8_cat",
                                  "llama_f32_head_major"])
def test_paged_engine_on_card_matches_cpu(card, form):
    """A small paged engine served on the card and on the CPU from the same
    weights, with a pool of 3 usable blocks that makes admissions re-queue:
    the same tokens, and every block but 0 free afterwards."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2, llama
    from rten_tpu_torch.quantize_pass import quantize_dynamic
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    paged = dict(capacity=64, gather_last=True, paged_blocks=4, block_size=16)
    if form.startswith("gpt2"):
        cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
        weights, n_head = gpt2.random_weights(cfg, seed=0), 2
        build = lambda: gpt2.build_graph_static_cache(  # noqa: E731
            cfg, weights, kv_quant=True, kernel_append=True, **paged)
    else:
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, max_position_embeddings=128)
        weights, n_head = llama.random_weights(cfg, seed=0), 4
        opts = {"llama_s8_head_major": dict(kv_quant=True),
                "llama_s8_cat": dict(kv_quant=True, kernel_append=True),
                "llama_f32_head_major": dict(kv_quant=False)}[form]
        build = lambda: llama.build_graph_static_cache(cfg, weights, **paged, **opts)  # noqa: E731
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = build()
        quantize_dynamic(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=n_head, head_dim=64, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        assert sorted(eng._free_blocks) == [1, 2, 3]
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]


def _int4_operands(g, N, K, bs, zp):
    """MatMulNBits operands for an [N, K] weight: packed nibbles
    [N, nb, bs/2], scales [N, nb], and zero points (None, u8 packed two to a
    byte per column, or int32)."""
    nb = -(-K // bs)
    packed = torch.randint(0, 256, (N, nb, bs // 2), generator=g, dtype=torch.uint8)
    scales = torch.rand(N, nb, generator=g) * 0.09 + 0.01
    zps = None
    if zp == "u8":
        zps = torch.randint(0, 256, (N * ((nb + 1) // 2),), generator=g, dtype=torch.uint8)
    elif zp == "i32":
        zps = torch.randint(0, 16, (N, nb), generator=g, dtype=torch.int32)
    return packed, scales, zps


@pytest.mark.parametrize("M,K,N,bs", [(1, 768, 2304, 32), (3, 100, 36, 32), (16, 3072, 768, 32),
                                      (17, 768, 50257, 32), (130, 512, 130, 64),
                                      (64, 48, 70, 16), (1, 768, 50257, 32),
                                      (128, 768, 3072, 32), (128, 3072, 768, 32),
                                      (2048, 768, 2304, 32), (2048, 3072, 768, 32),
                                      (2, 768, 768, 32), (4, 3072, 768, 32), (15, 768, 2304, 16),
                                      (16, 768, 50257, 32), (1, 256, 200, 128),
                                      (2, 96, 40, 8), (16, 768, 768, 8), (40, 200, 72, 8),
                                      (5, 48, 70, 16)])
@pytest.mark.parametrize("zp", ["none", "u8", "i32"])
def test_int4_matmul_kernel(card, M, K, N, bs, zp):
    """int4_matmul against int4_matmul_plain (dequantize, then an f32
    product with TF32 off) on the same inputs: within 1e-4 of max|out|
    (three bf16 parts of a on tensor cores, or f32 FMAs for block 8, against
    f32 on both sides, other summation order), K not a multiple of the block
    (zero-padded activations), rows that are no multiple of 16 bytes (4-byte
    copies), ragged M and N, split K (GPT-2's N 768 projections), the form
    int4_form names (its counter moves, the others do not), and the same
    bits on a second call."""
    g = _gen(M * 31 + K + N)
    packed, scales, zps = _int4_operands(g, N, K, bs, None if zp == "none" else zp)
    a = torch.randn(M, K, generator=g)
    args = [t if t is None else t.to(card) for t in (a, packed, scales, zps)]
    form = t4.int4_form(M, bs)
    assert form == ("cuda_core" if bs % 16 else "stream" if M <= 16 else "tiled")
    before = {f: getattr(t4.int4_matmul, f"{f}_launches") for f in t4.FORMS}
    before_all = t4.int4_matmul.launches
    got = t4.int4_matmul(*args, K=K, N=N, block_size=bs)
    again = t4.int4_matmul(*args, K=K, N=N, block_size=bs)
    nb = -(-K // bs)
    want = t4.int4_matmul_plain(args[0], args[1].reshape(N, -1), args[2],
                                t4.unpack_zero_points(args[3], N, nb), K=K, N=N, block_size=bs)
    torch.cuda.synchronize()
    assert t4.int4_matmul.launches == before_all + 2
    assert {f: getattr(t4.int4_matmul, f"{f}_launches") - before[f] for f in t4.FORMS} == {
        f: 2 if f == form else 0 for f in t4.FORMS}
    assert got.shape == (M, N) and torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,softcap,mask", [
    (1, 12, 12, 128, 128, 64, True, 0.0, "left_pad"),    # a Generator prefill, 37 pad columns
    (1, 2, 2, 24, 40, 32, False, 0.0, "random"),         # the reference's mask test
    (1, 4, 2, 40, 56, 32, True, 30.0, None),             # GQA, softcap, causal Tq != Tk
    (2, 8, 2, 33, 70, 128, True, 0.0, None),             # D 128, ragged tiles
    (2, 4, 4, 12, 24, 64, True, 0.0, "row"),             # a [1, Tk] mask on every row
    (1, 4, 1, 64, 64, 64, False, 50.0, "full"),          # a [Tq, Tk] mask, group 4
    (1, 12, 12, 1024, 1024, 64, True, 0.0, "left_pad"),  # GPT-2's longest prompt
    (2, 32, 4, 256, 512, 64, True, 30.0, None),          # the smoke test's GQA and softcap
    (2, 32, 4, 256, 512, 64, False, 30.0, None),
])
def test_mha_kernel(card, dtype, B, Hq, Hkv, Tq, Tk, D, causal, softcap, mask):
    """mha against mha_plain on the same inputs: within 1e-4 (f32; bf16 in
    and out: 2e-2, one bf16 rounding of the output) on rows that have a
    column to attend; rows with none (left padding under causal) are 0 from
    the kernel, as from the TPU kernel, where the plain version gives the
    mean of V. Two calls give the same bits. Every case (D <= 128) runs on
    tensor cores: the CUDA-core counter does not move; the Generator's
    128-token prefill splits each key tile over a block's four warps, the
    1024-token one over two."""
    g = _gen(Hq * Tq + Tk + D)
    q = torch.randn(B, Hq, Tq, D, generator=g)
    k = torch.randn(B, Hkv, Tk, D, generator=g)
    v = torch.randn(B, Hkv, Tk, D, generator=g)
    m = None
    if mask == "left_pad":
        m = torch.where(torch.arange(Tk) < 37, -1e30, 0.0)[None]
    elif mask == "row":
        m = torch.where(torch.arange(Tk) < 5, -1e30, 0.0)[None]
    elif mask in ("random", "full"):
        m = torch.where(torch.rand(Tq, Tk, generator=g) > 0.2, 0.0, -1e30)
    q, k, v = (t.to(card, dtype) for t in (q, k, v))
    m = None if m is None else m.to(card)
    before, before_cc = tfa.mha.launches, tfa.mha.cuda_core_launches
    got = tfa.mha(q, k, v, m, causal=causal, softcap=softcap)
    again = tfa.mha(q, k, v, m, causal=causal, softcap=softcap)
    want = tfa.mha_plain(q, k, v, m, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert tfa.mha.launches == before + 2
    assert tfa.mha.cuda_core_launches == before_cc  # D <= 128: tensor cores
    if (B, Hq, Tq) in ((1, 12, 128), (1, 12, 1024)):  # the key-split routes
        from rten_tpu_torch.kernels.common import sm_count

        assert tfa.mha_key_warps(B, Hq, Tq, causal, sm_count(card.index or 0)) == (
            4 if Tq == 128 else 2)
    assert got.shape == (B, Hq, Tq, D) and got.dtype == dtype and torch.equal(got, again)
    rows = torch.arange(Tq, device=card)[:, None]
    cols = torch.arange(Tk, device=card)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool, device=card)
    if causal:
        live &= cols <= rows + Tk - Tq
    if m is not None:
        live &= m > -1e29
    live = live.any(-1)[None, None, :, None].expand_as(got)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float())[live].abs().max().item() <= tol
    assert (got[~live] == 0).all()


def _sharpened_small_gpt2():
    from rten_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
    w = gpt2.random_weights(cfg, seed=0)
    for name in w:
        if (".attn.c_" in name or ".mlp.c_" in name) and name.endswith(".weight"):
            w[name] = w[name] * np.float32(4.0)
    return cfg, w


@pytest.mark.parametrize("quantize", [None, "int4"])
@pytest.mark.parametrize("B,T", [(1, 5), (1, 8), (2, 11)])
def test_generator_on_card_matches_cpu(card, quantize, B, T):
    """The small GPT-2 Generator (bucket 8, projections sharpened 4x) on the
    card and on the CPU: the same greedy tokens. At batch 1 the prefill
    runs the mha kernel (8 query rows, a [1, 8] mask) and, with int4
    weights, every projection the int4 kernel."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.models import gpt2

    cfg, w = _sharpened_small_gpt2()
    prompt = np.random.default_rng(B * 10 + T).integers(0, 512, (B, T))
    before = (tfa.mha.launches, t4.int4_matmul.launches)
    card_toks = Generator(gpt2.load(cfg, w, quantize=quantize, device=card), prompt,
                          GeneratorConfig(bucket_size=8)).generate(14)
    after = (tfa.mha.launches, t4.int4_matmul.launches)
    cpu_toks = Generator(gpt2.load(cfg, w, quantize=quantize, device="cpu"), prompt,
                         GeneratorConfig(bucket_size=8)).generate(14)
    np.testing.assert_array_equal(card_toks, cpu_toks)
    assert after[0] - before[0] == (2 if B == 1 else 0)          # one prefill, 2 layers
    assert after[1] - before[1] == (9 * 15 if quantize else 0)   # 15 forwards


@pytest.mark.parametrize("k", [1, 4])
def test_int4_engine_on_card_matches_cpu(card, k):
    """The int4 weight-only serving graph behind the engine on the card and
    on the CPU: the same tokens."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_weight_only_int4
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    cfg, w = _sharpened_small_gpt2()
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = gpt2.build_graph_static_cache(cfg, w, capacity=64, kv_quant=True,
                                              kernel_append=True, gather_last=True)
        quantize_weight_only_int4(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=2, head_dim=64, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]


# --- f32 and bf16 KV caches (no scales) --------------------------------------

CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _float_cache(g, shape, dt, card):
    return torch.randn(shape, generator=g).to(CACHE_DTYPES[dt]).to(card)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dt", list(CACHE_DTYPES))
@pytest.mark.parametrize("H,Hkv,D,window", [(2, 2, 64, 0), (12, 12, 64, 0), (8, 2, 128, 0),
                                            (12, 2, 128, 16)])
def test_decode_append_kernel_float_caches(card, dt, H, Hkv, D, window):
    """The f32/bf16 mode against its plain version: cache rows bit-exact
    (the new row rounded to the cache dtype, to nearest even), rows the
    kernel does not own untouched, out atol 1e-4 (summation order differs),
    the same bits on a second call from the same caches."""
    cap, B = 96, 6
    lens = torch.tensor([0, 31, 32, cap - 1, cap, cap + 7], dtype=torch.int32, device=card)
    g = _gen(H + D + window)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn = torch.randn(B, Hkv, 1, D, generator=g)
    kn[0, 0, 0, :3] = torch.tensor([1.00390625, -1.01171875, 3.0])  # bf16 ties
    kn, vn = kn.to(card), torch.randn(B, Hkv, 1, D, generator=g).to(card)
    kc, vc = (_float_cache(g, (B, cap, Hkv * D), dt, card) for _ in range(2))
    runs = []
    for _ in range(2):
        runs.append(tfa.decode_mha_append_cat(q, kc.clone(), vc.clone(), lens, k_new=kn,
                                              v_new=vn, window=window))
    want = tfa.decode_mha_append_cat_plain(q, kc.clone(), vc.clone(), lens, k_new=kn,
                                           v_new=vn, window=window)
    torch.cuda.synchronize()
    got = runs[0]
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    for i, old in ((1, kc), (2, vc)):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
        keep = torch.ones(B, cap, dtype=torch.bool, device=card)
        keep[torch.arange(B, device=card), lens.clamp(max=cap - 1).long()] = False
        assert torch.equal(_bits(got[i][keep]), _bits(old[keep]))


@pytest.mark.parametrize("dt", ["s8", "f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,S,window", [(12, 2, 128, 45, 0), (8, 8, 128, 33, 0),
                                              (4, 2, 64, 16, 5), (12, 12, 64, 40, 0),
                                              (12, 2, 128, 128, 0), (12, 12, 64, 128, 0),
                                              (4, 1, 256, 20, 0)])
def test_prefill_kernel_dtypes_and_d128(card, dt, H, Hkv, D, S, window):
    """prefill_mha_cat on s8, f32 and bf16 caches, group 6 at D 128
    (Qwen2.5-1.5B's attention; at S 128 too) and GPT-2's group 1 at D 64 and
    S 128, D 256, against the plain version: atol 1e-4, the same bits on a
    second call; s8 and bf16 at D <= 128 on the tensor-core per-head kernel
    in bf16 parts, f32 in 3xTF32, D 256 on the wide tensor-core kernel
    (cap 256 at S 128)."""
    cap, B = (96 if S < 96 else 256), 4
    g = _gen(S + D)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    if dt == "s8":
        kc, vc = (torch.randint(-127, 128, (B, cap, Hkv * D), generator=g,
                                dtype=torch.int8).to(card) for _ in range(2))
        sc = [(torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005).to(card)
              for _ in range(2)]
    else:
        kc, vc = (_float_cache(g, (B, cap, Hkv * D), dt, card) for _ in range(2))
        sc = []
    lens = torch.tensor([0, 7, cap - S, 31], dtype=torch.int32, device=card)
    before = _prefill_launches()
    got = tfa.prefill_mha_cat(q, kc, vc, lens, *sc, window=window)
    again = tfa.prefill_mha_cat(q, kc, vc, lens, *sc, window=window)
    want = tfa.prefill_mha_cat_plain(q, kc, vc, lens, *sc, window=window)
    torch.cuda.synchronize()
    _check_prefill_form(before, kc.dtype, D, 2)
    assert got.shape == (B, H, S, D) and torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("H,Hkv,S,D,window", [
    (32, 4, 1, 64, 0),     # TinyLlama's decode step: the fold
    (12, 2, 1, 128, 0),    # group 6 at D 128
    (4, 4, 1, 64, 24),     # window
    (32, 4, 40, 64, 0),    # an admission: per head
    (8, 2, 16, 128, 20),   # per head, D 128, a window
])
def test_decode_mha_kernel_bf16(card, H, Hkv, S, D, window):
    """decode_mha on bf16 head-major caches (csrc/decode_mha_bf16.cu), both
    forms, against decode_mha_plain: atol 1e-4 on rows with a column to
    attend, 0 on the others (a window wholly past cap), the same bits on a
    second call."""
    cap, B = 96, 6
    lens = torch.tensor([0, 17, cap - S, cap - 1, cap, cap + 40], dtype=torch.int32,
                        device=card)
    g = _gen(H * S + D)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    k, v = (_float_cache(g, (B, Hkv, cap, D), "bf16", card) for _ in range(2))
    form = tfa.decode_mha_folded if (H // Hkv) * S <= tfa.FOLD_MAX_ROWS else tfa.decode_mha_heads
    before = form.launches
    got = tfa.decode_mha(q, k, v, lens, window=window)
    again = tfa.decode_mha(q, k, v, lens, window=window)
    want = tfa.decode_mha_plain(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert form.launches == before + 2 and torch.equal(got, again)
    qpos = lens.long()[:, None] + torch.arange(S, device=card)[None]
    live = (qpos - window < cap - 1) if window else torch.ones_like(qpos, dtype=torch.bool)
    live = live[:, None, :, None].expand_as(got)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("H,Hkv,D,BS,window", [(32, 4, 64, 64, 0), (12, 2, 128, 16, 0),
                                               (16, 1, 64, 24, 20)])
def test_paged_decode_mha_kernel_bf16(card, H, Hkv, D, BS, window):
    """paged_decode_mha on bf16 head-major pools through a shuffled table,
    idle slots on block 0: atol 1e-4 against the plain version, the same
    bits on a second call."""
    B, MB = 6, 4
    NB, cap = 4 * MB + 2, MB * BS
    g = _gen(H * BS + D + 1)
    bt = _table(card, B, MB, NB, 4, H + BS)
    lens = torch.tensor([0, BS - 1, BS, cap - 1, cap + 5, 3], dtype=torch.int32, device=card)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    pk, pv = (_float_cache(g, (NB, Hkv, BS, D), "bf16", card) for _ in range(2))
    got = tfa.paged_decode_mha(q, pk, pv, lens, bt, window=window)
    again = tfa.paged_decode_mha(q, pk, pv, lens, bt, window=window)
    want = tfa.paged_decode_mha_plain(q, pk, pv, lens, bt, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dt", list(CACHE_DTYPES))
@pytest.mark.parametrize("H,Hkv,D,window", [(12, 12, 64, 0), (12, 2, 128, 0), (8, 2, 64, 20)])
def test_paged_append_kernel_float_pools(card, dt, H, Hkv, D, window):
    """The block-table append on f32/bf16 cat pools (the write kernel, then
    paged_decode_mha's fold on the cat pools' strides) against its plain
    version, idle slots colliding in block 0: pools bit-exact, blocks no
    slot owns untouched, out atol 1e-4, the same bits on a second run."""
    B, BS, MB = 8, 16, 3
    NB, cap = 5 * MB + 2, MB * BS
    g = _gen(H + D + window + 7)
    bt = _table(card, B, MB, NB, 5, H + D)
    lens = torch.tensor([0, BS - 1, BS, cap - 1, cap + 4, 5, 5, BS + 4], dtype=torch.int32,
                        device=card)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    vn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    pools = [_float_cache(g, (NB, BS, Hkv * D), dt, card) for _ in range(2)]
    runs = []
    before = tfa.decode_mha_append_cat_paged.launches
    for _ in range(2):
        p = [t.clone() for t in pools]
        runs.append(tfa.decode_mha_append_cat(q, p[0], p[1], lens, k_new=kn, v_new=vn,
                                              window=window, block_table=bt))
    p = [t.clone() for t in pools]
    want = tfa.decode_mha_append_cat_paged_plain(q, p[0], p[1], lens, k_new=kn, v_new=vn,
                                                 window=window, block_table=bt)
    torch.cuda.synchronize()
    assert tfa.decode_mha_append_cat_paged.launches == before + 2
    got = runs[0]
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    owned = set(bt.flatten().tolist())
    free = [b for b in range(1, NB) if b not in owned]
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
        assert torch.equal(_bits(got[i][free]), _bits(pools[i - 1][free]))


def test_kernels_refuse_modes_they_do_not_take(card):
    """A CUDA tensor of a dtype or head dim no kernel covers raises, and no
    kernel launches (no plain version, no library call behind it): f16
    caches, bf16 caches at an odd D (33), int8 caches without scales, f32
    caches with scales."""
    B, H, D, cap = 2, 2, 32, 64
    q = torch.zeros(B, H, 1, D, device=card)
    kn = torch.zeros(B, H, 1, D, device=card)
    lens = torch.zeros(B, dtype=torch.int32, device=card)
    sc = torch.ones(B, H, cap, 1, device=card)
    counters = [tfa.decode_mha_append_cat, tfa.prefill_mha_cat, tfa.decode_mha_folded,
                tfa.decode_mha_heads, tfa.paged_decode_mha]
    before = [f.launches for f in counters]

    def cat(dtype, d=D):
        return torch.zeros(B, cap, H * d, dtype=dtype, device=card)

    with pytest.raises(TypeError):
        tfa.decode_mha_append_cat(q, cat(torch.float16), cat(torch.float16), lens, k_new=kn,
                                  v_new=kn)
    q33 = torch.zeros(B, H, 1, 33, device=card)
    kn33 = torch.zeros(B, H, 1, 33, device=card)
    with pytest.raises(ValueError):
        tfa.decode_mha_append_cat(q33, cat(torch.bfloat16, 33), cat(torch.bfloat16, 33), lens,
                                  k_new=kn33, v_new=kn33)
    with pytest.raises(ValueError):
        tfa.prefill_mha_cat(q, cat(torch.int8), cat(torch.int8), lens)
    with pytest.raises(ValueError):
        tfa.prefill_mha_cat(q, cat(torch.float32), cat(torch.float32), lens, sc, sc)
    hm = torch.zeros(B, H, cap, 64, dtype=torch.float16, device=card)
    with pytest.raises(TypeError):
        tfa.decode_mha(torch.zeros(B, H, 1, 64, device=card), hm, hm, lens)
    with pytest.raises(TypeError):
        tfa.paged_decode_mha(torch.zeros(B, H, 1, 64, device=card), hm, hm, lens,
                             torch.zeros(B, 1, dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("form", ["gpt2_bf16_cat", "gpt2_bf16_cat_paged", "gpt2_f32_cat",
                                  "llama_bf16_head_major", "llama_bf16_head_major_paged",
                                  "llama_d128_bf16_cat", "llama_f32_cat_paged"])
def test_kv_dtype_engine_on_card_matches_cpu(card, form):
    """Small models on f32/bf16 caches and pools served on the card and on
    the CPU from the same weights: the same tokens; paged pools of 3 usable
    blocks make admissions wait and end with every block but 0 free."""
    from rten_tpu_torch.dtypes import DataType
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2, llama
    from rten_tpu_torch.quantize_pass import quantize_dynamic
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    opts = dict(capacity=64, gather_last=True, kv_quant=False,
                kernel_append="_cat" in form)
    if "bf16" in form:
        opts["kv_dtype"] = DataType.BFloat16
    if form.endswith("_paged"):
        opts.update(paged_blocks=4, block_size=16)
    if form.startswith("gpt2"):
        cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
        weights, n_head, head_dim = gpt2.random_weights(cfg, seed=0), 2, 64
        build = lambda: gpt2.build_graph_static_cache(cfg, weights, **opts)  # noqa: E731
    else:
        hidden = 512 if "d128" in form else 256
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=hidden, intermediate_size=512,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, max_position_embeddings=128,
                                attention_bias="d128" in form,
                                tie_word_embeddings="d128" in form)
        weights = {k: v * np.float32(2.0) if "_proj." in k else v
                   for k, v in llama.random_weights(cfg, seed=0).items()}
        n_head, head_dim = 4, hidden // 4
        build = lambda: llama.build_graph_static_cache(cfg, weights, **opts)  # noqa: E731
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = build()
        quantize_dynamic(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=n_head, head_dim=head_dim, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        if eng.paged:
            assert sorted(eng._free_blocks) == [1, 2, 3]
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]


# --- int4 caches, deferred KV, the head-major append, head dims -----------------


def _int4_caches(card, g, B, Hkv, cap, D):
    """Random int4 (u8 nibble) caches [B, Hkv, cap, D/2] and their scales."""
    k = torch.randint(0, 256, (B, Hkv, cap, D // 2), generator=g, dtype=torch.uint8)
    v = torch.randint(0, 256, (B, Hkv, cap, D // 2), generator=g, dtype=torch.uint8)
    ks = torch.rand(B, Hkv, cap, generator=g) * 0.3 + 0.05
    vs = torch.rand(B, Hkv, cap, generator=g) * 0.3 + 0.05
    return [t.to(card) for t in (k, v, ks, vs)]


def _caches(card, g, kv, B, Hkv, cap, D):
    if kv == "int4":
        return _int4_caches(card, g, B, Hkv, cap, D)
    if kv == "s8":
        k = torch.randint(-127, 128, (B, Hkv, cap, D), generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, Hkv, cap, D), generator=g, dtype=torch.int8)
        ks = torch.rand(B, Hkv, cap, generator=g) * 0.015 + 0.005
        vs = torch.rand(B, Hkv, cap, generator=g) * 0.015 + 0.005
        return [t.to(card) for t in (k, v, ks, vs)]
    return [_float_cache(g, (B, Hkv, cap, D), kv, card), _float_cache(g, (B, Hkv, cap, D), kv,
                                                                      card), None, None]


@pytest.mark.parametrize("kv", ["int4", "s8", "f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,S,D,window", [
    (32, 4, 1, 64, 0),     # TinyLlama's decode step: the fold
    (8, 8, 1, 128, 0),
    (4, 2, 8, 64, 0),      # the fold's 16-row instance (a small Llama's admission of 8)
    (4, 2, 1, 80, 0),      # masked tails (int4 D 80: 40-byte rows, element loads)
    (4, 2, 1, 96, 16),
    (8, 1, 1, 256, 0),     # D 256 (Gemma's head dim): the fold's 8-row instance
    (4, 2, 1, 512, 0),     # D 512: the fold's 4-row instance
    (32, 4, 40, 64, 0),    # admissions: per head
    (4, 2, 33, 80, 20),
    (8, 1, 17, 256, 0),
    (2, 2, 9, 512, 0),
])
def test_decode_mha_kernel_kinds_and_head_dims(card, kv, H, Hkv, S, D, window):
    """Both launch forms on int4, s8, f32 and bf16 caches, at D 64-512 and
    at D 80 and 96 (a masked tail), against decode_mha_plain: atol 1e-4 on
    rows with a column to attend (0 on the others), the same bits twice."""
    cap, B = 96, 6
    lens = torch.tensor([0, 17, cap - S, cap - 1, cap, cap + 40], dtype=torch.int32,
                        device=card)
    g = _gen(H * S + D)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    k, v, ks, vs = _caches(card, g, kv, B, Hkv, cap, D)
    fold = (H // Hkv) * S <= tfa.fold_max_rows(D)
    form = tfa.decode_mha_folded if fold else tfa.decode_mha_heads
    before = form.launches
    got = tfa.decode_mha(q, k, v, lens, ks, vs, window=window)
    again = tfa.decode_mha(q, k, v, lens, ks, vs, window=window)
    want = tfa.decode_mha_plain(q, k, v, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    assert form.launches == before + 2
    assert got.shape == (B, H, S, D) and torch.equal(got, again)
    qpos = lens.long()[:, None] + torch.arange(S, device=card)[None]
    live = (qpos - window < cap - 1) if window else torch.ones_like(qpos, dtype=torch.bool)
    live = live[:, None, :, None].expand_as(got)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("kv", ["s8", "bf16", "int4", "f32"])
@pytest.mark.parametrize("H,Hkv,S,D,window", [
    (32, 4, 128, 64, 0),   # TinyLlama's admission
    (32, 4, 100, 64, 24),  # a ragged 64-row tile, a window
    (8, 2, 40, 80, 0),     # masked tails: D 80 (int4: 40-byte rows, element copies)
    (8, 2, 70, 96, 16),
    (12, 2, 65, 128, 0),   # Qwen's and Llama-3's D 128, group 6
    (4, 4, 33, 128, 20),
    (8, 1, 24, 256, 0),    # D 256: the wide kernel (two 128-dim slices a row group)
    (8, 2, 70, 160, 16),   # a masked tail in DP 256, a window, past one 64-row block
    (8, 1, 128, 256, 0),   # Gemma's head dim at a full admission of 128 rows
    (12, 2, 65, 256, 20),  # group 6, a window
    (4, 4, 33, 512, 0),    # D 512: four slices, 32 rows a block, past one block
    (8, 2, 40, 512, 24),   # GQA, a window
    (4, 2, 30, 130, 0),    # D 130: element copies (rows not whole 16-byte words)
    (4, 2, 50, 300, 0),    # D 300 in DP 512: a slice wholly past D
])
def test_decode_mha_heads_forms(card, kv, H, Hkv, S, D, window):
    """The per-head form on tensor cores at every head dim (heads_plan: bf16
    parts or, f32 caches, 3xTF32; decode_heads_wide.cuh past D 128, counted
    by ``wide_launches``), against decode_mha_plain within 1e-4 on rows with
    a column to attend, 0 on the others, the same bits twice. lens: 0,
    mid-cache, the last row, past cap (a window then leaves the row no
    column), and the chunk's clamp."""
    cap, B = 256, 6
    lens = torch.tensor([0, 37, cap - 1, cap + 40, cap - S, 5], dtype=torch.int32,
                        device=card)
    g = _gen(H * S + D + len(kv))
    q = torch.randn(B, H, S, D, generator=g).to(card)
    k, v, ks, vs = _caches(card, g, kv, B, Hkv, cap, D)
    assert tfa.heads_form(k.dtype, D) == "tensor_core"
    before = (tfa.decode_mha_heads.launches, tfa.decode_mha_heads.wide_launches)
    got = tfa.decode_mha_heads(q, k, v, lens, ks, vs, window=window)
    again = tfa.decode_mha_heads(q, k, v, lens, ks, vs, window=window)
    want = tfa.decode_mha_plain(q, k, v, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    wide = 2 if D > 128 else 0
    assert (tfa.decode_mha_heads.launches, tfa.decode_mha_heads.wide_launches) == (
        before[0] + 2, before[1] + wide)
    assert got.shape == (B, H, S, D) and torch.equal(got, again)
    qpos = lens.long()[:, None] + torch.arange(S, device=card)[None]
    live = (qpos - window < cap - 1) if window else torch.ones_like(qpos, dtype=torch.bool)
    live = live[:, None, :, None].expand_as(got)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all() and torch.isfinite(got).all()


@pytest.mark.parametrize("kv", ["int4", "s8", "f32", "bf16"])
@pytest.mark.parametrize("rdt", ["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,W,t", [(32, 4, 64, 8, 3), (12, 12, 64, 64, 63),
                                         (8, 2, 128, 8, 0), (4, 2, 80, 8, 5),
                                         (8, 1, 256, 8, 7), (4, 2, 512, 4, 2)])
def test_decode_attention_deferred_kernel(card, kv, rdt, H, Hkv, D, W, t):
    """The deferred fold: the new row written into window row t (rounded to
    the window's dtype) bit-exact against the plain version, every other
    window row untouched, the output within 1e-4; lens0 covers an empty
    cache and a full one."""
    cap, B = 96, 5
    g = _gen(D + W + t)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    k, v, ks, vs = _caches(card, g, kv, B, Hkv, cap, D)
    rk = _float_cache(g, (B, Hkv, W, D), rdt, card)
    rv = _float_cache(g, (B, Hkv, W, D), rdt, card)
    kn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    vn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    lens0 = torch.tensor([0, 1, 40, cap - W, cap], dtype=torch.int32, device=card)
    step = torch.tensor([t], dtype=torch.int32, device=card)
    a = [rk.clone(), rv.clone()]
    p = [rk.clone(), rv.clone()]
    before = tfa.decode_mha_folded.launches
    got = tfa.decode_attention_deferred(q, k, v, lens0, ks, vs, recent_k=a[0], recent_v=a[1],
                                        t=step, k_new=kn, v_new=vn)
    want = tfa.decode_attention_deferred_plain(q, k, v, lens0, ks, vs, recent_k=p[0],
                                               recent_v=p[1], t=step, k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    assert tfa.decode_mha_folded.launches == before + 1
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
    keep = torch.ones(W, dtype=torch.bool, device=card)
    keep[t] = False
    assert torch.equal(_bits(got[1][:, :, keep]), _bits(rk[:, :, keep]))


@pytest.mark.parametrize("dt", ["s8", "f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,window", [(32, 4, 64, 0), (12, 12, 64, 0), (8, 2, 128, 16),
                                            (4, 2, 80, 0), (8, 1, 256, 0), (4, 2, 512, 0)])
def test_decode_mha_append_kernel(card, dt, H, Hkv, D, window):
    """decode_mha_append on head-major caches against its plain version:
    s8 rows bit-exact, scales rtol 5e-6, f32/bf16 rows bit-exact, rows the
    kernel does not own untouched, out atol 1e-4."""
    cap, B = 96, 6
    g = _gen(H + D + window)
    lens = torch.tensor([0, 31, 32, cap - 1, cap, cap + 7], dtype=torch.int32, device=card)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn = torch.randn(B, Hkv, 1, D, generator=g)
    kn[0, 0, 0, :4] = torch.tensor([0.5, 1.5, -2.5, 127.0])  # .5 ties
    kn = kn.to(card)
    vn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    k, v, ks, vs = _caches(card, g, dt, B, Hkv, cap, D)
    if ks is not None:
        ks, vs = ks[..., None], vs[..., None]  # the graph's [B, Hkv, cap, 1]
    a = [None if x is None else x.clone() for x in (k, v, ks, vs)]
    p = [None if x is None else x.clone() for x in (k, v, ks, vs)]
    before = tfa.decode_mha_append.launches
    got = tfa.decode_mha_append(q, *a[:2], lens, *a[2:], k_new=kn, v_new=vn, window=window)
    want = tfa.decode_mha_append_plain(q, *p[:2], lens, *p[2:], k_new=kn, v_new=vn,
                                       window=window)
    torch.cuda.synchronize()
    assert tfa.decode_mha_append.launches == before + 1
    assert got[0].shape == (B, H, 1, D)
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
    if ks is not None:
        for i in (3, 4):
            assert torch.allclose(got[i], want[i], rtol=5e-6, atol=0)
    for bb, n in enumerate(lens.tolist()):
        keep = torch.ones(cap, dtype=torch.bool, device=card)
        keep[min(n, cap - 1)] = False
        assert torch.equal(_bits(got[1][bb, :, keep]), _bits(k[bb, :, keep]))


@pytest.mark.parametrize("dt", ["s8", "bf16"])
@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 80), (4, 4, 96), (8, 1, 256)])
def test_cat_kernels_head_dims(card, dt, H, Hkv, D):
    """The cat-cache append (flat and through a block table) and
    prefill_mha_cat at D 80, 96 and 256 against their plain versions."""
    cap, B, S, BS = 96, 4, 9, 16
    g = _gen(D)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    vn = torch.randn(B, Hkv, 1, D, generator=g).to(card)
    lens = torch.tensor([0, 31, cap - 1, cap + 3], dtype=torch.int32, device=card)
    if dt == "s8":
        kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
        vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
        sc = [(torch.rand(B, Hkv, cap, 1, generator=g) * 0.01 + 0.005).to(card) for _ in "kv"]
    else:
        kc, vc = (_float_cache(g, (B, cap, Hkv * D), dt, card) for _ in "kv")
        sc = [None, None]
    a = [None if x is None else x.clone() for x in (kc, vc, *sc)]
    p = [None if x is None else x.clone() for x in (kc, vc, *sc)]
    got = tfa.decode_mha_append_cat(q, a[0], a[1], lens, a[2], a[3], k_new=kn, v_new=vn)
    want = tfa.decode_mha_append_cat_plain(q, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                           v_new=vn)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(_bits(got[1]), _bits(want[1])) and torch.equal(_bits(got[2]),
                                                                       _bits(want[2]))
    # Through a block table: pools of 1 + B * cap / BS blocks.
    NB, MB = 1 + B * cap // BS, cap // BS
    bt = _table(card, B, MB, NB, B, D)
    if dt == "s8":
        pools = [torch.randint(-127, 128, (NB, BS, Hkv * D), generator=g,
                               dtype=torch.int8).to(card) for _ in "kv"]
        spools = [(torch.rand(NB, Hkv, 1, BS, generator=g) * 0.01 + 0.005).to(card)
                  for _ in "kv"]
    else:
        pools = [_float_cache(g, (NB, BS, Hkv * D), dt, card) for _ in "kv"]
        spools = [None, None]
    a = [None if x is None else x.clone() for x in (*pools, *spools)]
    p = [None if x is None else x.clone() for x in (*pools, *spools)]
    got = tfa.decode_mha_append_cat(q, a[0], a[1], lens, a[2], a[3], k_new=kn, v_new=vn,
                                    block_table=bt)
    want = tfa.decode_mha_append_cat_paged_plain(q, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                                 v_new=vn, block_table=bt)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    # The prefill of S rows per slot.
    qs = torch.randn(B, H, S, D, generator=g).to(card)
    lens_p = torch.tensor([0, 7, cap - S, 40], dtype=torch.int32, device=card)
    got = tfa.prefill_mha_cat(qs, kc, vc, lens_p, *sc)
    want = tfa.prefill_mha_cat_plain(qs, kc, vc, lens_p, *sc)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dt", ["s8", "bf16"])
@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 80), (4, 4, 96), (8, 1, 256), (4, 1, 512)])
def test_paged_decode_mha_head_dims(card, dt, H, Hkv, D):
    """paged_decode_mha at D 80, 96, 256 and 512 against its plain version."""
    B, BS, MB = 4, 16, 6
    NB = 1 + B * MB
    g = _gen(D + 1)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    if dt == "s8":
        pk, pv = (torch.randint(-127, 128, (NB, Hkv, BS, D), generator=g,
                                dtype=torch.int8).to(card) for _ in "kv")
        pks, pvs = ((torch.rand(NB, Hkv, 1, BS, generator=g) * 0.01 + 0.005).to(card)
                    for _ in "kv")
    else:
        pk, pv = (_float_cache(g, (NB, Hkv, BS, D), dt, card) for _ in "kv")
        pks = pvs = None
    bt = _table(card, B, MB, NB, B - 1, D)
    lens = torch.tensor([0, 17, MB * BS - 1, MB * BS + 5], dtype=torch.int32, device=card)
    got = tfa.paged_decode_mha(q, pk, pv, lens, bt, pks, pvs)
    want = tfa.paged_decode_mha_plain(q, pk, pv, lens, bt, pks, pvs)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,causal", [(80, True), (96, False), (256, True)])
def test_mha_kernel_head_dims(card, dtype, D, causal):
    """mha at D 80, 96 and 256 (a masked tail; D 256 in 68 KB of dynamic
    shared memory) against mha_plain, GQA 4 over 2; the form ``mha_form``
    names (tensor cores to D 128, CUDA cores above) runs."""
    g = _gen(D)
    q = torch.randn(2, 4, 40, D, generator=g).to(dtype).to(card)
    k = torch.randn(2, 2, 70, D, generator=g).to(dtype).to(card)
    v = torch.randn(2, 2, 70, D, generator=g).to(dtype).to(card)
    before_cc = tfa.mha.cuda_core_launches
    got = tfa.mha(q, k, v, causal=causal)
    want = tfa.mha_plain(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    # D 80 and 96 on tensor cores, D 256 on CUDA cores.
    assert tfa.mha.cuda_core_launches == before_cc + (D > 128)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("form", ["gpt2_int4", "gpt2_int4_deferred_bf16", "gpt2_s8_deferred",
                                  "llama_f32_deferred", "llama_kernel_append"])
def test_int4_and_deferred_engine_on_card_matches_cpu(card, form):
    """Small models on int4 caches, deferred KV and the head-major append
    served on the card and on the CPU from the same weights: the same
    tokens. (The small Llama on int4 caches is held by
    test_int4_llama_on_card_matches_cpu instead.)"""
    from rten_tpu_torch.dtypes import DataType
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2, llama
    from rten_tpu_torch.quantize_pass import quantize_dynamic
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    opts = {
        "gpt2_int4": dict(kv_quant=True, kv_bits=4),
        "gpt2_int4_deferred_bf16": dict(kv_quant=True, kv_bits=4, deferred_kv=True,
                                        recent_dtype=DataType.BFloat16),
        "gpt2_s8_deferred": dict(kv_quant=True, deferred_kv=True),
        "llama_f32_deferred": dict(kv_quant=False, deferred_kv=True),
        "llama_kernel_append": dict(kv_quant=True),
    }[form]
    if form.startswith("gpt2"):
        cfg, weights = _sharpened_small_gpt2()
        n_head, build = 2, gpt2.build_graph_static_cache
    else:
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, max_position_embeddings=128)
        weights = {k: v * np.float32(2.0) if "_proj." in k else v
                   for k, v in llama.random_weights(cfg, seed=0).items()}
        n_head, build = 4, llama.build_graph_static_cache
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = build(cfg, weights, capacity=64, gather_last=True, **opts)
        if form == "llama_kernel_append":  # no builder emits it on head-major caches
            for _, node in graph.operators():
                if node.op_type == "QuantizedKVAttention":
                    node.attrs = {**node.attrs, "rten_kernel_append": 1}
        quantize_dynamic(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=n_head, head_dim=64, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("head_dim", [64, 128])
def test_int4_llama_engine_on_card_matches_cpu(card, head_dim):
    """The small Llama on int4 head-major caches behind the engine, held
    against the CPU forward by forward (chip_smoke.int4_engine_lockstep:
    a replay of the CPU run on the card, then a free run checked until its
    inputs part): codes equal but for flips on a rounding boundary, logits
    within 1e-4 of max|logit| without a flip. At D 128 the tokens are
    equal; at D 64 they may part, and only after a located flip."""
    import chip_smoke

    small = dict(vocab_size=512, hidden_size=4 * head_dim, intermediate_size=512,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)

    def make(device):
        return chip_smoke.build_llama(2, 64, device, sharpen=2.0, kv="int4", **small)[0]

    toks, flips = chip_smoke.int4_engine_lockstep(card, make, 4, f"D {head_dim}", head_dim)
    assert toks["cuda"] == toks["cpu"] or (head_dim == 64 and flips)


# --- the decode-attention microbenchmark's kernels (rows 10-13) --------------


def _tool_inputs(card, B, H, Hkv, cap, D, seed):
    """The tool's inputs (q, k, v standard normal, lens in [cap // 2, cap -
    2)) with the edges put in: slot 0 lens -1, slot 1 cap - 1, slot 2 0."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((B, H, 1, D)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((B, Hkv, cap, D)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, Hkv, cap, D)), dtype=torch.float32)
    lens = rng.integers(cap // 2, cap - 2, B)
    lens[:3] = [-1, cap - 1, 0]
    return [t.to(card) for t in (q, k, v, torch.as_tensor(lens, dtype=torch.int32))]


def _within(got, want, rtol, atol):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


TOOL_SHAPES = [(32, 12, 256, 64), (4, 4, 384, 128)]  # the tool's; cap 384, D 128


@pytest.mark.parametrize("B,H,cap,D", TOOL_SHAPES)
def test_dma_floor_kernel(card, B, H, cap, D):
    """Sums over up to 2 * Hkv * cap terms in another order: rtol 1e-5,
    atol 1e-4."""
    q, k, v, lens = _tool_inputs(card, B, H, H, cap, D, cap + D)
    before = tbda.dma_floor.launches
    got = tbda.dma_floor(q, k, v, lens)
    torch.cuda.synchronize()
    assert tbda.dma_floor.launches == before + 1 and got.shape == (B, 1, D)
    assert _within(got, tbda.dma_floor_plain(q, k, v, lens), 1e-5, 1e-4)


@pytest.mark.parametrize("B,H,cap,D", TOOL_SHAPES + [
    (128, 12, 256, 64),   # slots 128: 1536 (slot, head) blocks, one split
    (8, 12, 256, 64),     # 96 pairs < 132 SMs: the keys split over blocks
    (3, 2, 200, 32),      # 6 pairs: many splits, ragged ones past lens
    (3, 3, 1000, 256),    # D 256, a cap no score buffer would hold
    (5, 4, 77, 100),      # D 100 in the 128 instance, an odd cap
])
def test_vpu_attn_kernel(card, B, H, cap, D):
    """The one-pass kernel against its plain version: f32 atol 1e-5; lens -1
    gives the mean of V, lens past cap every column; the same bits on a
    second call; the split counter moves where ``vpu_plan`` splits."""
    q, k, v, lens = _tool_inputs(card, B, H, H, cap, D, cap * D)
    if B > 3:
        lens[3] = cap + 5
    scale = 1.0 / np.sqrt(D)
    before = (tbda.vpu_attn.launches, tbda.vpu_attn.split_launches)
    got = tbda.vpu_attn(q, k, v, lens, scale)
    again = tbda.vpu_attn(q, k, v, lens, scale)
    torch.cuda.synchronize()
    from rten_tpu_torch.kernels.common import sm_count

    splits = tbda.vpu_plan(B, H, cap, sm_count(card.index or 0))[0]
    assert (tbda.vpu_attn.launches, tbda.vpu_attn.split_launches) == (
        before[0] + 2, before[1] + 2 * (splits > 1))
    assert torch.equal(got, again)
    assert _within(got, tbda.vpu_attn_plain(q, k, v, lens, scale), 0.0, 1e-5)
    assert _within(got[0, :, 0], v[0].mean(1), 0.0, 1e-5)


FOLD_SHAPES = [
    (32, 12, 12, 256, 64, 256),   # the tool's shape
    (16, 32, 4, 256, 64, 256),    # TinyLlama's attention (group 8): 4 splits
    (16, 12, 2, 256, 128, 256),   # Qwen2.5-1.5B's attention (group 6, D 128)
    (4, 8, 2, 384, 128, 256),     # D 128, the dropped key tail
    (4, 8, 2, 384, 128, 128),
    (3, 20, 2, 200, 80, 64),      # group 10 (two n-tiles), D 80, ragged tiles
    (5, 8, 2, 201, 6, 256),       # D 6 (zero-padded dims), odd cap (bd bf16: 2-byte copies)
    (4, 8, 2, 300, 256, 256),     # D 256
]


def _fold_case(card, form, B, H, Hkv, cap, D, seed):
    """The tool's inputs with slot 3 (where there is one) past cap, the
    kernel and plain version of ``form``, and K in that form's layout."""
    q, k, v, lens = _tool_inputs(card, B, H, Hkv, cap, D, seed)
    if B > 3:
        lens[3] = cap + 5
    kern, plain = ((tbda.bd_decode, tbda.bd_decode_plain) if form == "bd"
                   else (tbda.nt_decode, tbda.nt_decode_plain))
    return q, k, v, lens, kern, plain


def _two_calls(card, kern, q, kx, v, lens, D, bk):
    """Two calls of the kernel: (output, second output), after checking
    their launch and split counters against the plan (TinyLlama's shape
    splits its keys over blocks)."""
    B, H, Hkv, cap = q.shape[0], q.shape[1], v.shape[1], v.shape[2]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = tbda.fold_plan(B, H, Hkv, cap, D, v.dtype, bk, sms)
    if (B, H, Hkv) == (16, 32, 4):
        assert plan.splits > 1 and B * Hkv * plan.row_tiles * plan.splits >= sms, plan
    before, split_before = kern.launches, kern.split_launches
    got = kern(q, kx, v, lens, scale=1.0 / np.sqrt(D), block_k=bk)
    again = kern(q, kx, v, lens, scale=1.0 / np.sqrt(D), block_k=bk)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert kern.split_launches == split_before + 2 * (plan.splits > 1), plan
    return got, again


@pytest.mark.parametrize("form", ["bd", "nt"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,cap,D,bk", FOLD_SHAPES)
def test_bd_nt_decode_kernel(card, form, dt, B, H, Hkv, cap, D, bk):
    """f32 atol 1e-5; bf16 K/V rtol 2e-2, atol 5e-3 (the output is q's
    f32); lens -1 gives 0; a second call gives the same bits."""
    q, k, v, lens, kern, plain = _fold_case(card, form, B, H, Hkv, cap, D, B * H + cap)
    k, v = k.to(dt), v.to(dt)
    kx = k.transpose(2, 3).contiguous() if form == "bd" else k
    got, again = _two_calls(card, kern, q, kx, v, lens, D, bk)
    assert got.shape == (B, H, 1, D) and torch.equal(got, again)
    want = plain(q, kx, v, lens, scale=1.0 / np.sqrt(D), block_k=bk)
    rtol, atol = (0.0, 1e-5) if dt == torch.float32 else (2e-2, 5e-3)
    assert _within(got, want, rtol, atol), (got.float() - want).abs().max().item()
    assert not got[0].any()


@pytest.mark.parametrize("form", ["bd", "nt"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,cap,D,bk", [
    (32, 12, 12, 256, 64, 256),   # the tool's shape
    (16, 32, 4, 256, 64, 256),    # TinyLlama's attention (group 8): 4 splits
    (16, 12, 2, 256, 128, 256),   # Qwen2.5-1.5B's attention (group 6, D 128)
    (3, 20, 2, 200, 80, 64),      # group 10, D 80, ragged tiles
])
def test_bd_nt_decode_kernel_bf16_q(card, form, dt, B, H, Hkv, cap, D, bk):
    """A bf16 q gives a bf16 output: against the plain version, f32 K/V
    within one bf16 rounding of the output (rtol 2^-7, atol 1e-5), bf16 K/V
    at the bf16 rule (rtol 2e-2, atol 5e-3); lens -1 gives 0; a second call
    gives the same bits."""
    q, k, v, lens, kern, plain = _fold_case(card, form, B, H, Hkv, cap, D, B * H + cap + 1)
    q, k, v = q.to(torch.bfloat16), k.to(dt), v.to(dt)
    kx = k.transpose(2, 3).contiguous() if form == "bd" else k
    got, again = _two_calls(card, kern, q, kx, v, lens, D, bk)
    assert got.shape == (B, H, 1, D)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    want = plain(q, kx, v, lens, scale=1.0 / np.sqrt(D), block_k=bk)
    rtol, atol = (2.0 ** -7, 1e-5) if dt == torch.float32 else (2e-2, 5e-3)
    assert _within(got, want, rtol, atol), (got.float() - want.float()).abs().max().item()
    assert not got[0].any()


def test_tool_kernels_refuse_on_the_card(card):
    q, k, v, lens = _tool_inputs(card, 4, 8, 2, 64, 32, 0)
    with pytest.raises(ValueError):  # a non-contiguous K
        tbda.nt_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, lens, scale=1.0)
    with pytest.raises(ValueError):  # tensors on two devices
        tbda.nt_decode(q, k, v, lens.cpu(), scale=1.0)


@pytest.mark.parametrize("form", ["bd", "nt"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_tool_kernels_take_a_long_key_block(card, form, dt):
    """A key block of 8192 keys (which the CUDA-core kernel before the
    split one refused: its scores overflowed shared memory) against the
    plain version, lens -1, 8191, 0 and 5000."""
    q, _, _, _ = _tool_inputs(card, 4, 8, 2, 64, 32, 0)
    g = _gen(8192)
    k = torch.randn(4, 2, 8192, 32, generator=g).to(card, dt)
    v = torch.randn(4, 2, 8192, 32, generator=g).to(card, dt)
    lens = torch.tensor([-1, 8191, 0, 5000], dtype=torch.int32, device=card)
    kern, plain = ((tbda.bd_decode, tbda.bd_decode_plain) if form == "bd"
                   else (tbda.nt_decode, tbda.nt_decode_plain))
    kx = k.transpose(2, 3).contiguous() if form == "bd" else k
    got = kern(q, kx, v, lens, scale=1.0, block_k=8192)
    want = plain(q, kx, v, lens, scale=1.0, block_k=8192)
    torch.cuda.synchronize()
    rtol, atol = (0.0, 1e-5) if dt == torch.float32 else (2e-2, 5e-3)
    assert _within(got, want, rtol, atol), (got.float() - want).abs().max().item()
    assert not got[0].any()


def test_timed_fails_below_the_byte_floor(card):
    """``chip_smoke.timed`` profiles again a call whose device time reads
    below its byte floor, and fails the run when every window does; a call
    whose bytes fit the L2 has no floor."""
    import chip_smoke

    x = torch.zeros(1024, device=card)
    device, wall = chip_smoke.timed(lambda: x.add_(1), iters=3, warmup=1, nbytes=8 * x.numel())
    assert device is not None and device > 0 and wall > 0
    with pytest.raises(SystemExit):  # a floor of about 0.3 s for a microsecond's add
        chip_smoke.timed(lambda: x.add_(1), iters=3, warmup=1, nbytes=1e12)


def test_tinyllama_bf16_reference_repeats(card, capsys):
    """ROADMAP fault 3, a TinyLlama bf16 head-major 2-layer reference that
    failed once on the card: ``RTEN_REFERENCE_REPEATS`` runs of it (default
    1), built as ``chip_smoke.phase_reference_llama`` builds it, every
    attention kernel call held against its plain version (``hold_calls``),
    so that a failing run names the kernel call. Prints each run's
    outcome."""
    import os

    import chip_smoke

    outcomes = []
    for i in range(int(os.environ.get("RTEN_REFERENCE_REPEATS", "1"))):
        try:
            with chip_smoke.hold_calls() as held:
                worst, _ = chip_smoke.logits_card_vs_cpu(
                    card, lambda device: chip_smoke.build_llama(2, 64, device, kv="bf16")[0],
                    chip_smoke.L_VOCAB, f"TinyLlama bf16, run {i}")
            outcomes.append(f"pass: logits {worst:.3e} of max|logit|, attention calls "
                            f"{ {k: f'{len(v)} within {max(v):.2e}' for k, v in held.items()} }")
        except SystemExit:  # chip_smoke.fail: its message is on stderr
            outcomes.append(f"FAIL: {capsys.readouterr().err.strip().splitlines()[-1:]}")
    with capsys.disabled():
        for i, o in enumerate(outcomes):
            print(f"\nTinyLlama bf16 reference, run {i}: {o}", flush=True)
    assert all(o.startswith("pass") for o in outcomes), outcomes


# --- split-K: the append, paged_decode_mha and the block-table append ----------


def _plan(card, B, Hkv, cap):
    """The split plan the wrappers run on this card. The cases take more
    than one split, but for those whose B * Hkv units alone fill the SMs:
    they take one, and the block writes out directly."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap, sms)
    assert (splits == 1) == (B * Hkv >= sms), (B, Hkv, cap, splits)
    return splits, chunk


def _split_lens(card, g, B, cap, chunk, window):
    """Lens at the edges of the split: empty caches (every split but the
    first empty), a chunk's last row and the next, the last row, past cap
    and, with a window, a row whose window lies wholly past cap (no
    column); the rest mid-range."""
    edges = [0, 5, chunk - 1, chunk, cap - 1, cap + 5] + ([cap + window + 3] if window else [])
    rest = torch.randint(cap // 2, cap - 1, (max(0, B - len(edges)),), generator=g).tolist()
    return torch.tensor((edges + rest)[:B], dtype=torch.int32, device=card)


def _live(lens, cap, window, shape):
    """Rows with a column to attend (the others give 0, the plain version
    the mean of V), broadcast to ``shape`` [B, H, 1, D]."""
    live = (lens.long() - window < cap - 1) if window else torch.ones_like(lens, dtype=torch.bool)
    return live[:, None, None, None].expand(shape)


def _check_split_out(got, again, want, lens, cap, window):
    live = _live(lens, cap, window, got.shape)
    assert torch.equal(got, again)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("dt", ["s8", "f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,D,cap,window", [
    (16, 12, 2, 128, 256, 0),    # Qwen2.5-1.5B's decode step: 8 splits of 32
    (16, 12, 2, 128, 256, 40),   # and a window
    (4, 8, 2, 64, 1024, 0),      # cap 1024
    (3, 36, 2, 64, 96, 0),       # group 18: two passes of 16 rows
    (2, 8, 1, 512, 64, 0),       # D 512: two passes of 4 rows
    (4, 3, 3, 80, 256, 0),       # group 1 at few slots, a masked tail
    (40, 32, 4, 64, 256, 0),     # TinyLlama at 40 slots: one split, group 8
    (40, 32, 4, 64, 256, 30),
    (66, 12, 2, 128, 256, 0),    # Qwen2.5-1.5B at 66 slots: one split, group 6
    (40, 4, 4, 64, 256, 0),      # group 1 at one split
])
def test_split_append_kernel(card, dt, B, H, Hkv, D, cap, window):
    """The flat cat append of the split fold (csrc/decode_append*.cu), at
    more than one split and at one, against its plain version: out
    atol 1e-4 on rows with a column, 0 on the others, new rows bit-exact
    (s8 scales rtol 5e-6), other rows untouched, the same bits on a second
    call, splits with no live column included."""
    splits, chunk = _plan(card, B, Hkv, cap)
    g = _gen(H * D + cap + window)
    lens = _split_lens(card, g, B, cap, chunk, window)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn, vn = (torch.randn(B, Hkv, 1, D, generator=g).to(card) for _ in "kv")
    if dt == "s8":
        kc, vc = (torch.randint(-127, 128, (B, cap, Hkv * D), generator=g,
                                dtype=torch.int8).to(card) for _ in "kv")
        sc = [(torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005).to(card) for _ in "kv"]
    else:
        kc, vc = (_float_cache(g, (B, cap, Hkv * D), dt, card) for _ in "kv")
        sc = [None, None]
    before = tfa.decode_mha_append_cat.launches
    runs = []
    for _ in range(2):
        a = [None if x is None else x.clone() for x in (kc, vc, *sc)]
        runs.append(tfa.decode_mha_append_cat(q, a[0], a[1], lens, a[2], a[3], k_new=kn,
                                              v_new=vn, window=window))
    p = [None if x is None else x.clone() for x in (kc, vc, *sc)]
    want = tfa.decode_mha_append_cat_plain(q, p[0], p[1], lens, p[2], p[3], k_new=kn, v_new=vn,
                                           window=window)
    torch.cuda.synchronize()
    assert tfa.decode_mha_append_cat.launches == before + 2
    got = runs[0]
    out = [x[0].reshape(B, 1, H, D).permute(0, 2, 1, 3) for x in (got, runs[1], want)]
    _check_split_out(*out, lens, cap, window)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(runs[0][1:], runs[1][1:]))
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
    if dt == "s8":
        for i in (3, 4):
            assert torch.allclose(got[i], want[i], rtol=5e-6, atol=0)
    keep = torch.ones(B, cap, dtype=torch.bool, device=card)
    keep[torch.arange(B, device=card), lens.clamp(max=cap - 1).long()] = False
    assert torch.equal(_bits(got[1][keep]), _bits(kc[keep]))
    assert torch.equal(_bits(got[2][keep]), _bits(vc[keep]))


@pytest.mark.parametrize("dt", ["s8", "f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,D,cap,window", [
    (16, 32, 4, 64, 256, 0),     # TinyLlama's decode step: 4 splits of 64
    (16, 32, 4, 64, 256, 30),
    (2, 8, 2, 128, 1024, 0),
    (40, 32, 4, 64, 256, 0),     # one split
])
def test_split_head_major_append_kernel(card, dt, B, H, Hkv, D, cap, window):
    """decode_mha_append on head-major caches, at more than one split and
    at one: the same checks as the cat append's."""
    splits, chunk = _plan(card, B, Hkv, cap)
    g = _gen(H * D + cap + window + 1)
    lens = _split_lens(card, g, B, cap, chunk, window)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn, vn = (torch.randn(B, Hkv, 1, D, generator=g).to(card) for _ in "kv")
    k, v, ks, vs = _caches(card, g, dt, B, Hkv, cap, D)
    if ks is not None:
        ks, vs = ks[..., None], vs[..., None]
    runs = []
    for _ in range(2):
        a = [None if x is None else x.clone() for x in (k, v, ks, vs)]
        runs.append(tfa.decode_mha_append(q, *a[:2], lens, *a[2:], k_new=kn, v_new=vn,
                                          window=window))
    p = [None if x is None else x.clone() for x in (k, v, ks, vs)]
    want = tfa.decode_mha_append_plain(q, *p[:2], lens, *p[2:], k_new=kn, v_new=vn,
                                       window=window)
    torch.cuda.synchronize()
    got = runs[0]
    _check_split_out(got[0], runs[1][0], want[0], lens, cap, window)
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
        assert torch.equal(_bits(got[i]), _bits(runs[1][i]))
    if ks is not None:
        for i in (3, 4):
            assert torch.allclose(got[i], want[i], rtol=5e-6, atol=0)
    keep = torch.ones(B, cap, dtype=torch.bool, device=card)
    keep[torch.arange(B, device=card), lens.clamp(max=cap - 1).long()] = False
    assert torch.equal(_bits(got[1]).permute(0, 2, 1, 3)[keep], _bits(k).permute(0, 2, 1, 3)[keep])


def _split_pools(card, g, dt, NB, Hkv, BS, D, cat=False):
    shape = (NB, BS, Hkv * D) if cat else (NB, Hkv, BS, D)
    if dt == "s8":
        pools = [torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(card)
                 for _ in "kv"]
        return pools + [(torch.rand(NB, Hkv, 1, BS, generator=g) * 0.015 + 0.005).to(card)
                        for _ in "kv"]
    return [_float_cache(g, shape, dt, card) for _ in "kv"] + [None, None]


@pytest.mark.parametrize("dt", ["s8", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,D,BS,MB,window", [
    (16, 32, 4, 64, 64, 4, 0),    # TinyLlama's decode step on 65 blocks of 64
    (16, 32, 4, 64, 64, 4, 50),
    (4, 8, 2, 128, 16, 64, 0),    # cap 1024
    (6, 12, 2, 128, 24, 8, 0),    # Qwen's group, BS not a power of two
    (40, 32, 4, 64, 64, 4, 0),    # TinyLlama at 40 slots: one split
    (66, 12, 2, 128, 64, 4, 0),   # Qwen at 66 slots: one split
])
def test_split_paged_decode_mha_kernel(card, dt, B, H, Hkv, D, BS, MB, window):
    """paged_decode_mha, at more than one split and at one, through a
    shuffled table (idle slots' rows 0, the garbage sink) against its plain
    version: atol 1e-4 on rows with a column, 0 on the others, the same
    bits twice."""
    cap = MB * BS
    splits, chunk = _plan(card, B, Hkv, cap)
    NB = 1 + B * MB
    g = _gen(H * BS + D + window)
    bt = _table(card, B, MB, NB, B - 1, D)
    lens = _split_lens(card, g, B, cap, chunk, window)
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    pk, pv, pks, pvs = _split_pools(card, g, dt, NB, Hkv, BS, D)
    got = tfa.paged_decode_mha(q, pk, pv, lens, bt, pks, pvs, window=window)
    again = tfa.paged_decode_mha(q, pk, pv, lens, bt, pks, pvs, window=window)
    want = tfa.paged_decode_mha_plain(q, pk, pv, lens, bt, pks, pvs, window=window)
    torch.cuda.synchronize()
    _check_split_out(got, again, want, lens, cap, window)


@pytest.mark.parametrize("dt", ["s8", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,D,BS,MB,window", [
    (16, 12, 2, 128, 64, 4, 0),   # Qwen's shape on cat pools
    (8, 8, 2, 64, 16, 64, 0),     # cap 1024
    (8, 8, 2, 64, 16, 8, 20),
    (40, 32, 4, 64, 64, 4, 0),    # one split
])
def test_split_paged_append_kernel(card, dt, B, H, Hkv, D, BS, MB, window):
    """The block-table append, at more than one split and at one, idle
    slots colliding in block 0: out atol 1e-4 on rows with a column, 0 on
    the others, pools bit-exact (s8 scale pools rtol 5e-6), blocks no slot
    owns untouched, the same bits on a second run."""
    cap = MB * BS
    splits, chunk = _plan(card, B, Hkv, cap)
    owners = B - 3
    NB = 1 + owners * MB
    g = _gen(H + D + BS + window)
    bt = _table(card, B, MB, NB + 2, owners, H + D)
    lens = _split_lens(card, g, B, cap, chunk, window)
    lens[owners:] = torch.tensor([5, 5, 70], dtype=torch.int32, device=card) % cap
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    kn, vn = (torch.randn(B, Hkv, 1, D, generator=g).to(card) for _ in "kv")
    pools = _split_pools(card, g, dt, NB + 2, Hkv, BS, D, cat=True)
    runs = []
    for _ in range(2):
        p = [None if x is None else x.clone() for x in pools]
        runs.append(tfa.decode_mha_append_cat(q, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                              v_new=vn, window=window, block_table=bt))
    p = [None if x is None else x.clone() for x in pools]
    want = tfa.decode_mha_append_cat_paged_plain(q, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                                 v_new=vn, window=window, block_table=bt)
    torch.cuda.synchronize()
    got = runs[0]
    out = [x[0].reshape(B, 1, H, D).permute(0, 2, 1, 3) for x in (got, runs[1], want)]
    _check_split_out(*out, lens, cap, window)
    n = 4 if dt == "s8" else 2
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(runs[0][1:], runs[1][1:]))
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
    if dt == "s8":
        for i in (3, 4):
            assert torch.allclose(got[i], want[i], rtol=5e-6, atol=0)
    owned = set(bt.flatten().tolist())
    free = [b for b in range(1, NB + 2) if b not in owned]
    assert free
    for i in range(n):
        assert torch.equal(_bits(got[i + 1][free]), _bits(pools[i][free]))


# --- the fold split over blocks on both cores; the f32 per-head form in 3xTF32 --


def _fold_counts():
    return tfa.decode_mha_folded.launches, tfa.decode_mha_folded.cuda_core_launches


@pytest.mark.parametrize("kv", ["s8", "int4", "bf16", "f32"])
@pytest.mark.parametrize("B,H,Hkv,S,D,cap,window", [
    (16, 32, 4, 1, 64, 256, 0),     # TinyLlama's decode step: 4 splits of 64
    (16, 32, 4, 1, 64, 256, 30),    # and a sliding window
    (120, 12, 12, 1, 64, 256, 0),   # GPT-2's step: 1440 units, one split
    (4, 8, 2, 2, 128, 1024, 0),     # S 2 (8 rows a kv head) at cap 1024
    (3, 16, 2, 2, 64, 96, 0),       # 16 rows a kv head: two n-tiles
    (5, 6, 3, 1, 80, 256, 0),       # masked tails (int4 D 80: 40-byte rows)
    (5, 4, 2, 3, 96, 256, 16),
    (6, 8, 1, 1, 256, 256, 0),      # D 256 and 512: the CUDA-core fold, split
    (6, 4, 1, 1, 512, 128, 0),
])
def test_fold_forms_and_splits(card, kv, B, H, Hkv, S, D, cap, window):
    """decode_mha's fold on the form fold_form names (tensor cores for s8,
    int4 and bf16 at D <= 128, CUDA cores for f32 and D 129-512), at more
    than one split and at one, against decode_mha_plain: atol 1e-4 on rows
    with a column (0 on the others), the same bits twice, the counters
    moved for that form alone. lens: the split's edges (empty caches, a
    chunk's last row and the next, past cap)."""
    splits, chunk = _plan(card, B, Hkv, cap)
    g = _gen(B * H + S * D + cap + window + len(kv))
    lens = _split_lens(card, g, B, cap, chunk, window)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    k, v, ks, vs = _caches(card, g, kv, B, Hkv, cap, D)
    form = tfa.fold_form(k.dtype, D)
    assert form == ("tensor_core" if kv != "f32" and D <= 128 else "cuda_core")
    before = _fold_counts()
    got = tfa.decode_mha(q, k, v, lens, ks, vs, window=window)
    again = tfa.decode_mha(q, k, v, lens, ks, vs, window=window)
    want = tfa.decode_mha_plain(q, k, v, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    assert _fold_counts() == (before[0] + 2, before[1] + (2 if form == "cuda_core" else 0))
    assert got.shape == (B, H, S, D) and torch.equal(got, again)
    qpos = lens.long()[:, None] + torch.arange(S, device=card)[None]
    live = (qpos - window < cap - 1) if window else torch.ones_like(qpos, dtype=torch.bool)
    live = live[:, None, :, None].expand_as(got)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all() and torch.isfinite(got).all()


@pytest.mark.parametrize("kv", ["s8", "int4", "bf16", "f32"])
@pytest.mark.parametrize("rdt", ["bf16", "f32"])
@pytest.mark.parametrize("B,H,Hkv,D,W,t", [
    (16, 32, 4, 64, 8, 7),      # TinyLlama's deferred step: 4 splits, the window in the last
    (120, 12, 12, 64, 8, 7),    # GPT-2's: one split
    (120, 12, 12, 64, 64, 63),  # the bench's window of 64
    (6, 8, 2, 128, 40, 0),      # t 0: the new row alone
    (5, 4, 2, 80, 8, 5),        # a masked tail
])
def test_fold_deferred_splits(card, kv, rdt, B, H, Hkv, D, W, t):
    """The deferred fold split over blocks: the last split alone writes the
    new row (bit-exact against the plain version, every other window row
    untouched) and scores the window; out within 1e-4, the same bits twice
    (windows too); the form fold_form names (tensor cores for s8, int4 and
    bf16 caches with a bf16 window)."""
    cap = 256
    splits, chunk = _plan(card, B, Hkv, cap)
    g = _gen(B + D + W + t + len(kv) + len(rdt))
    q = torch.randn(B, H, 1, D, generator=g).to(card)
    k, v, ks, vs = _caches(card, g, kv, B, Hkv, cap, D)
    rk, rv = (_float_cache(g, (B, Hkv, W, D), rdt, card) for _ in "kv")
    kn, vn = (torch.randn(B, Hkv, 1, D, generator=g).to(card) for _ in "kv")
    edges = [0, 1, chunk - 1, chunk, cap - W, cap]
    lens0 = torch.tensor((edges * B)[:B], dtype=torch.int32, device=card)
    step = torch.tensor([t], dtype=torch.int32, device=card)
    form = tfa.fold_form(k.dtype, D, rk.dtype)
    assert form == ("tensor_core" if kv != "f32" and rdt == "bf16" else "cuda_core")
    before = _fold_counts()
    runs = []
    for _ in range(2):
        a = [rk.clone(), rv.clone()]
        runs.append(tfa.decode_attention_deferred(q, k, v, lens0, ks, vs, recent_k=a[0],
                                                  recent_v=a[1], t=step, k_new=kn, v_new=vn))
    p = [rk.clone(), rv.clone()]
    want = tfa.decode_attention_deferred_plain(q, k, v, lens0, ks, vs, recent_k=p[0],
                                               recent_v=p[1], t=step, k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    assert _fold_counts() == (before[0] + 2, before[1] + (2 if form == "cuda_core" else 0))
    got = runs[0]
    assert (got[0] - want[0]).abs().max().item() <= 1e-4 and torch.isfinite(got[0]).all()
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(runs[0], runs[1]))
    for i in (1, 2):
        assert torch.equal(_bits(got[i]), _bits(want[i]))
    keep = torch.ones(W, dtype=torch.bool, device=card)
    keep[t] = False
    assert torch.equal(_bits(got[1][:, :, keep]), _bits(rk[:, :, keep]))


@pytest.mark.parametrize("H,Hkv,S,D,window", [
    (32, 4, 128, 64, 0),    # TinyLlama's admission
    (12, 12, 100, 64, 0),   # GPT-2's, a ragged 64-row tile
    (8, 2, 40, 80, 0),      # a masked tail (4-byte copies)
    (8, 2, 70, 80, 24),
    (12, 2, 65, 128, 0),    # Qwen's D 128, group 6
    (4, 4, 33, 128, 20),
])
def test_heads_tf32_kernel(card, H, Hkv, S, D, window):
    """decode_mha's per-head form on f32 caches at D <= 128 runs in 3xTF32
    on tensor cores (its tf32_launches counter) within 1e-4 of decode_mha_plain
    on rows with a column (0 on the others), the same bits twice; and
    prefill_mha_cat on f32 cat caches (the same kernel through the views'
    strides) likewise."""
    cap, B = 256, 6
    lens = torch.tensor([0, 37, cap - 1, cap + 40, cap - S, 5], dtype=torch.int32,
                        device=card)
    g = _gen(H * S + D + window)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    k, v = (_float_cache(g, (B, Hkv, cap, D), "f32", card) for _ in "kv")
    assert tfa.heads_form(torch.float32, D) == "tensor_core"
    before = (tfa.decode_mha_heads.launches, tfa.decode_mha_heads.tf32_launches)
    got = tfa.decode_mha_heads(q, k, v, lens, window=window)
    again = tfa.decode_mha_heads(q, k, v, lens, window=window)
    want = tfa.decode_mha_plain(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert (tfa.decode_mha_heads.launches, tfa.decode_mha_heads.tf32_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    qpos = lens.long()[:, None] + torch.arange(S, device=card)[None]
    live = (qpos - window < cap - 1) if window else torch.ones_like(qpos, dtype=torch.bool)
    live = live[:, None, :, None].expand_as(got)
    assert (got - want)[live].abs().max().item() <= 1e-4
    assert (got[~live] == 0).all() and torch.isfinite(got).all()
    # The same kernel on cat caches (rows of Hkv * D), lens inside the cache.
    kc, vc = (x.permute(0, 2, 1, 3).reshape(B, cap, Hkv * D).contiguous() for x in (k, v))
    lens = lens.clamp(max=cap - S)
    pre = _prefill_launches()
    got = tfa.prefill_mha_cat(q, kc, vc, lens, window=window)
    want = tfa.prefill_mha_cat_plain(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    _check_prefill_form(pre, torch.float32, D, 1)
    assert (got - want).abs().max().item() <= 1e-4
