"""Each operator lowering of the port's serving path against the JAX
package's lowering of the same one-node graph, on the same inputs.

Both packages build the graph with their own (identical) GraphBuilder; the
inputs are numpy arrays made from a seed. JAX runs on the CPU, where its
kernels take their XLA fallbacks; the port runs on the CPU, where every
kernel wrapper runs its plain PyTorch version. Tolerances are stated per
case with their reason.
"""

import numpy as np
import pytest
import torch

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions


def _run_both(build, feed, outputs):
    """Build the graph in both packages (``build(GraphBuilder, DataType)``),
    run it unoptimized on the same numpy feed, return (port, jax) outputs
    as numpy arrays."""
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    jm = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    got = [t.numpy() for t in tm.run(dict(feed), outputs)]
    want = [np.asarray(a) for a in jm.run(dict(feed), outputs)]
    return got, want


def _single_op(op_type, in_specs, consts=(), attrs=None, n_out=1):
    """A builder of one ``op_type`` node: graph inputs ``in_specs``
    [(name, dtype-name)], then constants ``consts`` [(name, array)],
    outputs y0..y{n_out-1}."""

    def build(GB, DT):
        b = GB()
        ins = [b.input(n, getattr(DT, dt)) for n, dt in in_specs]
        ins += [b.constant(n, a) for n, a in consts]
        outs = b.op(op_type, ins, attrs or {}, n_outputs=n_out,
                    output_names=[f"y{i}" for i in range(n_out)])
        b.output(*(outs if n_out > 1 else (outs,)))
        return b.finish()

    return build


RNG_SEED = 20


def _rng():
    return np.random.default_rng(RNG_SEED)


# --- elementwise, norm, layout, gather: same expressions, f32 ---------------


def test_add_broadcast():
    rng = _rng()
    a = rng.standard_normal((3, 4, 8)).astype(np.float32)
    c = rng.standard_normal((8,)).astype(np.float32)
    got, want = _run_both(
        _single_op("Add", [("a", "Float")], [("c", c)]), {"a": a}, ["y0"]
    )
    np.testing.assert_array_equal(got[0], want[0])  # one f32 add: exact


def test_gelu_tanh():
    """jax.nn.gelu(approximate=True) written out in the same order. The
    two libraries' tanh differ by an ulp; for x << 0 the 1 + tanh(z)
    cancellation turns that into up to ~5e-7 absolute: rtol 1e-6, atol
    1e-6."""
    x = np.linspace(-6, 6, 301, dtype=np.float32).reshape(7, 43)
    got, want = _run_both(
        _single_op("Gelu", [("x", "Float")], attrs={"approximate": "tanh"}),
        {"x": x}, ["y0"],
    )
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_layer_normalization():
    """(x - mean) * rsqrt(var + eps) * scale + bias; reductions sum in a
    different order: rtol 1e-5, atol 1e-6."""
    rng = _rng()
    x = (rng.standard_normal((3, 5, 128)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32)
    got, want = _run_both(
        _single_op("LayerNormalization", [("x", "Float")],
                   [("w", w), ("b", bias)], {"epsilon": 1e-5}),
        {"x": x}, ["y0"],
    )
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("indices", [
    np.array([[0, 3, 511], [7, 7, 2]], np.int32),
    np.array([[-1, 0]], np.int32),
])
def test_gather_rows(indices):
    """The embedding lookup: rows of a [512, 16] table, negative indices
    counted from the end. A copy: exact."""
    table = _rng().standard_normal((512, 16)).astype(np.float32)

    def build(GB, DT):
        b = GB()
        y = b.op("Gather", [b.constant("t", table), b.input("i", DT.Int32)],
                 {"axis": 0}, output_names=["y0"])
        b.output(y)
        return b.finish()

    got, want = _run_both(build, {"i": indices}, ["y0"])
    assert got[0].shape == indices.shape + (16,)
    np.testing.assert_array_equal(got[0], want[0])


def test_gather_nd_batch_dims_1():
    """The serving graph's last-position gather: x [slots, T, E] with
    per-slot indices [slots, 1, 1]. A copy: exact."""
    rng = _rng()
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    idx = np.array([[[7]], [[0]], [[3]]], np.int32)
    got, want = _run_both(
        _single_op("GatherND", [("x", "Float"), ("i", "Int32")],
                   attrs={"batch_dims": 1}),
        {"x": x, "i": idx}, ["y0"],
    )
    assert got[0].shape == (3, 1, 16)
    np.testing.assert_array_equal(got[0], want[0])


def test_rms_normalization():
    """x * rsqrt(mean(x^2) + eps) * scale; the mean sums in a different
    order: rtol 1e-5, atol 1e-6."""
    rng = _rng()
    x = (rng.standard_normal((3, 5, 128)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    got, want = _run_both(
        _single_op("RMSNormalization", [("x", "Float")], [("w", w)], {"epsilon": 1e-5}),
        {"x": x}, ["y0"],
    )
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_silu():
    """x * sigmoid(x); the libraries' sigmoid may differ by an ulp: rtol
    1e-6, atol 1e-7."""
    x = np.linspace(-12, 12, 301, dtype=np.float32).reshape(7, 43)
    got, want = _run_both(_single_op("Silu", [("x", "Float")]), {"x": x}, ["y0"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape_b", [(3, 4, 8), (8,), (4, 1)])
def test_mul_broadcast(shape_b):
    """SwiGLU's gate * up, and broadcasting as Add does. One f32 multiply:
    exact."""
    rng = _rng()
    a = rng.standard_normal((3, 4, 8)).astype(np.float32)
    bb = rng.standard_normal(shape_b).astype(np.float32)
    got, want = _run_both(
        _single_op("Mul", [("a", "Float"), ("b", "Float")]), {"a": a, "b": bb}, ["y0"]
    )
    assert got[0].shape == np.broadcast_shapes(a.shape, bb.shape)
    np.testing.assert_array_equal(got[0], want[0])


def test_reshape_with_zero_dims():
    x = np.arange(3 * 4 * 6, dtype=np.float32).reshape(3, 4, 6)
    got, want = _run_both(
        _single_op("Reshape", [("x", "Float")],
                   [("s", np.array([0, -1, 2], np.int64))]),
        {"x": x}, ["y0"],
    )
    assert got[0].shape == want[0].shape == (3, 12, 2)
    np.testing.assert_array_equal(got[0], want[0])


def test_split_num_outputs():
    """The qkv split: three equal parts of the last axis."""
    x = _rng().standard_normal((2, 5, 24)).astype(np.float32)
    got, want = _run_both(
        _single_op("Split", [("x", "Float")], attrs={"axis": -1, "num_outputs": 3},
                   n_out=3),
        {"x": x}, ["y0", "y1", "y2"],
    )
    for g, w in zip(got, want):
        assert g.shape == (2, 5, 8)
        np.testing.assert_array_equal(g, w)


# --- quantization and the int8 matmul -------------------------------------


def _dql_input_with_ties():
    """An activation whose per-tensor scale is exactly 1.0 (min -1, max
    254) with values on .5 ties, plus a random [slots, T, E] block."""
    rng = _rng()
    x = (rng.standard_normal((3, 8, 64)) * 40).astype(np.float32)
    x = np.clip(x, -1.0, 254.0)
    x[0, 0, :8] = [-1.0, 254.0, 0.5, 1.5, 2.5, -0.5, 100.5, 253.5]
    return x


@pytest.mark.parametrize("case", ["ties", "random", "all_zero"])
def test_dynamic_quantize_linear_bit_exact(case):
    """One per-tensor scale and zero point, round half to even: u8
    output, scale and zero point bit-exact."""
    if case == "ties":
        xs = [_dql_input_with_ties()]
    elif case == "random":
        # Many scales: a true division by 255 would miss most of them.
        rng = _rng()
        xs = [(rng.standard_normal((3, 8, 64)) * rng.uniform(0.05, 20)).astype(np.float32)
              for _ in range(16)]
    else:
        xs = [np.zeros((3, 8, 64), np.float32)]
    build = _single_op("DynamicQuantizeLinear", [("x", "Float")], n_out=3)
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    jm = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    for x in xs:
        got = [t.numpy() for t in tm.run({"x": x}, ["y0", "y1", "y2"])]
        want = [np.asarray(a) for a in jm.run({"x": x}, ["y0", "y1", "y2"])]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if case == "ties":
        assert float(got[1]) == 1.0 and int(got[2]) == 1
        # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0, 100.5 -> 100, 253.5 -> 254; + zp 1
        np.testing.assert_array_equal(got[0][0, 0, :8], [0, 255, 1, 3, 3, 1, 101, 255])


@pytest.mark.parametrize("M", [1, 3, 40])
def test_matmul_integer_to_float_prepacked(M):
    """A prepacked MatMulIntegerToFloat: u8 activations with a zero point,
    s8 weights padded from N=200 to 256 with colsums (input 7), per-column
    scales padded with ones, bias, rten_orig_n=200. Integer part exact;
    the f32 epilogue (acc * sa) * sb rounds in the same order on both
    sides, but XLA may fuse the bias add into a fused multiply-add, which
    rounds once instead of twice: rtol 1e-6 plus atol 1e-6 * max|y| for
    outputs that cancel to near zero."""
    rng = np.random.default_rng(M)
    K, N, Np = 128, 200, 256
    a = rng.integers(0, 256, (M, K)).astype(np.uint8)
    w = np.zeros((K, Np), np.int8)
    w[:, :N] = rng.integers(-127, 128, (K, N))
    ws = np.ones(Np, np.float32)
    ws[:N] = rng.uniform(1e-4, 2e-3, N)
    bias = rng.standard_normal(N).astype(np.float32)
    cs = w.astype(np.int32).sum(0)[None, :]

    def build(GB, DT):
        b = GB()
        xa = b.input("a", DT.UInt8)
        sa = b.input("sa", DT.Float)
        zp = b.input("zp", DT.UInt8)
        y = b.op("MatMulIntegerToFloat",
                 [xa, b.constant("w", w), sa, b.constant("ws", ws), zp, None,
                  b.constant("bias", bias), b.constant("cs", cs)],
                 {"rten_orig_n": N}, output_names=["y0"])
        b.output(y)
        return b.finish()

    feed = {"a": a, "sa": np.float32(0.013), "zp": np.uint8(131)}
    got, want = _run_both(build, feed, ["y0"])
    assert got[0].shape == (M, N)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6,
                               atol=1e-6 * np.abs(want[0]).max())


def test_argmax_last_axis():
    """The greedy head over [slots, 1, V] logits with ties: exact."""
    x = _rng().standard_normal((3, 1, 300)).astype(np.float32)
    x[0, 0, 10] = x[0, 0, 20] = 9.0
    got, want = _run_both(
        _single_op("ArgMax", [("x", "Float")], attrs={"axis": -1, "keepdims": 0}),
        {"x": x}, ["y0"],
    )
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][0, 0] == 10


# --- QuantizedKVAttention on cat-layout int8 caches ------------------------

B, H, D, CAP = 3, 2, 64, 64


def _attn_build(S):
    def build(GB, DT):
        b = GB()
        q = b.input("q", DT.Float)
        k = b.input("k", DT.Float)
        v = b.input("v", DT.Float)
        kc = b.input("kc", DT.Int8)
        ks = b.input("ks", DT.Float)
        vc = b.input("vc", DT.Int8)
        vs = b.input("vs", DT.Float)
        lens = b.input("lens", DT.Int32)
        outs = b.op(
            "QuantizedKVAttention", [q, k, v, kc, ks, vc, vs, lens],
            {"num_heads": H, "bits": 8, "rten_kernel_append": 1}, n_outputs=5,
            output_names=["out", "nkc", "nks", "nvc", "nvs"],
        )
        b.output(*outs)
        return b.finish()

    return build


def _attn_feed(S, lens, seed):
    rng = np.random.default_rng(seed)
    return {
        "q": rng.standard_normal((B, S, H * D)).astype(np.float32),
        "k": rng.standard_normal((B, S, H * D)).astype(np.float32),
        "v": rng.standard_normal((B, S, H * D)).astype(np.float32),
        "kc": rng.integers(-127, 128, (B, CAP, H * D)).astype(np.int8),
        "ks": rng.uniform(0.005, 0.02, (B, H, CAP, 1)).astype(np.float32),
        "vc": rng.integers(-127, 128, (B, CAP, H * D)).astype(np.int8),
        "vs": rng.uniform(0.005, 0.02, (B, H, CAP, 1)).astype(np.float32),
        "lens": np.asarray(lens, np.int32),
    }


@pytest.mark.parametrize("S,lens", [
    (1, [0, 31, CAP - 1]),        # decode: empty cache, mid, last row
    (1, [CAP, CAP + 9, 5]),       # decode past the end: write clamps to cap-1
    (8, [0, 0, 0]),               # admission from empty caches
    (8, [0, 20, CAP - 3]),        # a chunk whose start clamps to cap - S
])
def test_quantized_kv_attention_cat(S, lens):
    """Both cat-layout branches: S == 1 in-kernel append and S > 1 row
    write + prefill. s8 caches bit-exact (same quantizer, IEEE division,
    half-to-even), scales to rtol 5e-6 (XLA may compile x/127 as a
    multiply by 1/127), output atol 1e-5 (same math, other summation
    order)."""
    feed = _attn_feed(S, lens, seed=S + lens[1])
    names = ["out", "nkc", "nks", "nvc", "nvs"]
    got, want = _run_both(_attn_build(S), feed, names)
    assert got[0].shape == (B, S, H * D)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=5e-6, atol=0)
    # The caller's arrays are unchanged, and only the written rows moved.
    starts = np.clip(np.asarray(lens), 0, CAP - S)
    for bb in range(B):
        keep = np.ones(CAP, bool)
        keep[starts[bb]: starts[bb] + S] = False
        np.testing.assert_array_equal(got[1][bb, keep], feed["kc"][bb, keep])


def test_attention_leaves_undonated_caches_unchanged():
    """Without donation the executor copies a cache before the op writes
    it in place, so the caller's tensor is never changed."""
    feed = _attn_feed(1, [3, 4, 5], seed=9)
    kc = torch.from_numpy(feed["kc"].copy())
    feed["kc"] = kc
    tm = TModel(_attn_build(1)(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    out = tm.run(feed, ["nkc"])[0]
    assert torch.equal(kc, torch.from_numpy(_attn_feed(1, [3, 4, 5], seed=9)["kc"]))
    assert not torch.equal(out, kc)


def test_unported_attention_branches_raise():
    """GroupQueryAttention on packed QKV (no key/value inputs) in the
    serving form, which the port once refused: the JAX lowering's output
    and caches on the same inputs, within 1e-5 and 1e-6. (Every
    GroupQueryAttention branch runs; tests/test_torch_ort_genai.py holds
    the ORT form's.)"""

    def build(GB, DT):
        b = GB()
        qkv = b.input("qkv", DT.Float)
        kc, vc, lens = b.input("kc", DT.Float), b.input("vc", DT.Float), b.input("lens", DT.Int32)
        outs = b.op("GroupQueryAttention", [qkv, None, None, kc, vc, lens],
                    {"num_heads": H, "kv_num_heads": H, "rten_past_lens": 1}, n_outputs=3,
                    output_names=["out", "nkc", "nvc"])
        b.output(*outs)
        return b.finish()

    rng = np.random.default_rng(1)
    feed = {"qkv": rng.standard_normal((B, 1, 3 * H * D)).astype(np.float32),
            "kc": np.zeros((B, H, CAP, D), np.float32), "vc": np.zeros((B, H, CAP, D), np.float32),
            "lens": np.zeros(B, np.int32)}
    got, want = _run_both(build, feed, ["out", "nkc", "nvc"])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_argmax_sampler_matches_jax():
    """The host greedy sampler: first occurrence wins, int32 ids."""
    from rten_tpu.generate.sampler import ArgMaxSampler as JSampler
    from rten_tpu_torch.generate.sampler import ArgMaxSampler as TSampler

    logits = _rng().standard_normal((4, 50)).astype(np.float32)
    logits[1, [3, 9]] = 7.0
    got, want = TSampler().sample(logits), JSampler().sample(logits)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[1] == 3


# --- rotary, and attention on head-major caches (the Llama serving ops) -----

HQ, HKV = 4, 2  # GQA: two query heads per kv head


def _rope(max_pos, rot_half, seed=3):
    """cos/sin tables [max_pos, rot_half] of random angles."""
    ang = np.random.default_rng(seed).uniform(0, 6.3, (max_pos, rot_half))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rot_half", [D // 2, D // 4])
def test_rotary_forms(interleaved, rot_half):
    """Both rotary forms, rotating all of D (rot_half D/2) or half of it
    (the rest passes through). Two products and a sum in f32, which XLA
    may fuse into one rounding: atol 1e-6."""
    import jax.numpy as jnp
    from rten_tpu.ops.attention import _rotary as jrotary
    from rten_tpu_torch.ops.attention import rotary

    rng = _rng()
    x = rng.standard_normal((B, HQ, 5, D)).astype(np.float32)
    cos, sin = _rope(96, rot_half)
    pos = rng.integers(0, 96, (B, 5)).astype(np.int32)
    got = rotary(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
                 torch.from_numpy(pos), interleaved).numpy()
    want = np.asarray(jrotary(jnp.asarray(x), cos, sin, jnp.asarray(pos), interleaved))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 2 * rot_half:], x[..., 2 * rot_half:])


def _head_major_build(op, window, interleaved, rope):
    """One GroupQueryAttention (f32 caches) or QuantizedKVAttention (s8
    caches) node on head-major caches [B, HKV, CAP, D] with rotary."""

    def build(GB, DT):
        b = GB()
        q, k, v = (b.input(n, DT.Float) for n in ("q", "k", "v"))
        attrs = {"num_heads": HQ, "kv_num_heads": HKV, "do_rotary": 1,
                 "rotary_interleaved": int(interleaved)}
        if window:
            attrs["local_window_size"] = window
        cos, sin = b.constant("cos", rope[0]), b.constant("sin", rope[1])
        if op == "GroupQueryAttention":
            pk, pv = b.input("kc", DT.Float), b.input("vc", DT.Float)
            outs = b.op(op, [q, k, v, pk, pv, b.input("lens", DT.Int32), None, cos, sin],
                        {**attrs, "rten_past_lens": 1}, n_outputs=3,
                        output_names=["out", "nkc", "nvc"])
        else:
            kc, ks = b.input("kc", DT.Int8), b.input("ks", DT.Float)
            vc, vs = b.input("vc", DT.Int8), b.input("vs", DT.Float)
            outs = b.op(op, [q, k, v, kc, ks, vc, vs, b.input("lens", DT.Int32), cos, sin],
                        {**attrs, "bits": 8}, n_outputs=5,
                        output_names=["out", "nkc", "nks", "nvc", "nvs"])
        b.output(*outs)
        return b.finish()

    return build


def _head_major_feed(S, lens, quant, seed):
    rng = np.random.default_rng(seed)
    feed = {n: rng.standard_normal((B, S, h * D)).astype(np.float32)
            for n, h in (("q", HQ), ("k", HKV), ("v", HKV))}
    if quant:
        for n in ("kc", "vc"):
            feed[n] = rng.integers(-127, 128, (B, HKV, CAP, D)).astype(np.int8)
        for n in ("ks", "vs"):
            feed[n] = rng.uniform(0.005, 0.02, (B, HKV, CAP, 1)).astype(np.float32)
    else:
        for n in ("kc", "vc"):
            feed[n] = rng.standard_normal((B, HKV, CAP, D)).astype(np.float32)
    feed["lens"] = np.asarray(lens, np.int32)
    return feed


HEAD_MAJOR_CASES = [
    # S, lens, window, interleaved
    (1, [0, 31, CAP - 1], 0, False),   # decode: empty cache, mid, last row
    (1, [CAP, CAP + 9, 5], 0, True),   # past the end: the write clamps to cap-1
    (1, [5, 40, CAP - 1], 16, False),  # sliding window
    (8, [0, 0, 0], 0, False),          # admission from empty caches
    (8, [0, 20, CAP - 3], 12, True),   # a chunk whose start clamps to cap - S
]


@pytest.mark.parametrize("S,lens,window,interleaved", HEAD_MAJOR_CASES)
def test_group_query_attention_head_major(S, lens, window, interleaved):
    """The rten_past_lens serving form on f32 caches: rotary at positions
    lens + s (tables of 48 rows, so the clamp is crossed), the rows written
    at each slot's clamped start, decode attention. Output atol 1e-5 and
    caches atol 1e-6 (same math, other rounding of the rotary and the
    sums)."""
    feed = _head_major_feed(S, lens, False, seed=S + lens[1])
    build = _head_major_build("GroupQueryAttention", window, interleaved, _rope(48, D // 2))
    got, want = _run_both(build, feed, ["out", "nkc", "nvc"])
    assert got[0].shape == (B, S, HQ * D)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,lens,window,interleaved", HEAD_MAJOR_CASES)
def test_quantized_kv_attention_head_major_rotary(S, lens, window, interleaved):
    """QuantizedKVAttention on head-major s8 caches with rotary: quantize
    the rotated rows, write them at each slot's clamped start, decode
    attention. The rotary rounds differently by an ulp where XLA fuses a
    multiply-add, which can move x / s across a .5 boundary: s8 rows
    equal but for at most one code in at most 1 % of the written entries;
    scales rtol 1e-6; output atol 1e-5."""
    feed = _head_major_feed(S, lens, True, seed=S + lens[1])
    build = _head_major_build("QuantizedKVAttention", window, interleaved, _rope(48, D // 2))
    names = ["out", "nkc", "nks", "nvc", "nvs"]
    got, want = _run_both(build, feed, names)
    assert got[0].shape == (B, S, HQ * D)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for i in (1, 3):
        diff = np.abs(got[i].astype(np.int32) - want[i].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 0.01 * B * HKV * S * D
    for i in (2, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=0)
    # Only the written rows moved.
    starts = np.clip(np.asarray(lens), 0, CAP - S)
    for bb in range(B):
        keep = np.ones(CAP, bool)
        keep[starts[bb]: starts[bb] + S] = False
        np.testing.assert_array_equal(got[1][bb, :, keep], feed["kc"][bb, :, keep])


@pytest.mark.parametrize("op,attrs,feed_change,item", [
    ("GroupQueryAttention", {"rten_past_lens": 0}, None, 12),     # ORT-compatible form
    ("GroupQueryAttention", {"softcap": 30.0}, None, 12),
    ("GroupQueryAttention", {"rten_past_lens": 0, "rten_kernel_append": 1}, None, 12),
    ("GroupQueryAttention", {"rten_past_lens": 0, "rten_recent_kv": 1}, None, 12),
    ("GroupQueryAttention", {"softcap": 30.0, "rten_kernel_append": 1}, "bf16", 12),
    ("GroupQueryAttention", {"rten_past_lens": 0}, "bf16", 12),
    ("GroupQueryAttention", {"softcap": 30.0, "rten_paged": 1}, None, 12),
    ("GroupQueryAttention", {"softcap": 10.0}, "cat", 12),
    ("GroupQueryAttention", {"rten_past_lens": 0}, "cat", 12),
])
def test_unported_serving_attention_branches_raise(op, attrs, feed_change, item):
    """The branches of GroupQueryAttention that the port once refused (the
    ORT form, and softcap, on each cache form) behave as the JAX lowering's:
    where it runs, the same output and caches (within 1e-5 and 1e-6; bf16
    caches within bf16's rounding of the new rows); where it raises (softcap
    on cat caches or block pools, the ORT form over a cat cache), the port
    raises too. (The f32 and bf16 cat, pool and head-major branches:
    tests/test_torch_kv_dtypes.py; int4, deferred KV and the head-major
    append: tests/test_torch_int4_kv.py, tests/test_torch_deferred_kv.py.)"""
    base = _head_major_build(op, 0, False, _rope(48, D // 2))

    def build(GB, DT):
        g = base(GB, DT)
        for _, node in g.operators():
            node.attrs = {**node.attrs, **attrs}
        return g

    feed = _head_major_feed(1, [3, 4, 5], op == "QuantizedKVAttention", seed=1)
    if feed_change == "bf16":
        feed["kc"], feed["vc"] = (torch.from_numpy(feed[n]).to(torch.bfloat16)
                                  for n in ("kc", "vc"))
    elif feed_change == "cat":
        for n in ("kc", "vc"):
            feed[n] = feed[n].transpose(0, 2, 1, 3).reshape(B, CAP, HKV * D).copy()
    import ml_dtypes

    names = ["out", "nkc", "nvc"]
    jfeed = {n: v.float().numpy().astype(ml_dtypes.bfloat16) if isinstance(v, torch.Tensor)
             else v for n, v in feed.items()}
    try:
        want = [np.asarray(a, np.float32) for a in JModel(
            build(JBuilder, JDataType), JOptions(optimize=False)).run(jfeed, names)]
    except Exception:  # noqa: BLE001 - the JAX lowering refuses this branch
        want = None
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    if want is None:
        with pytest.raises(Exception):
            tm.run(feed, names)
        return
    got = [t.float().numpy() for t in tm.run(feed, names)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# --- the Generator graph's ops ----------------------------------------------------


def test_cast_sub_unsqueeze_transpose():
    """The GPT-2 graph's mask chain, Cast(int32 -> f32), (1 - m) * -1e30 and
    Unsqueeze(axes [1, 2]), and a head Transpose: exact."""
    m = _rng().integers(0, 2, (2, 7)).astype(np.int32)
    x = _rng().standard_normal((2, 5, 3, 4)).astype(np.float32)

    def build(GB, DT):
        b = GB()
        mi = b.input("m", DT.Int32)
        xi = b.input("x", DT.Float)
        mf = b.op("Cast", [mi], {"to": DT.Float})
        add = b.op("Mul", [b.op("Sub", [b.constant(None, np.float32(1.0)), mf]),
                           b.constant(None, np.float32(-1e30))])
        y0 = b.op("Unsqueeze", [add, b.constant(None, np.int32([1, 2]))], output_names=["y0"])
        y1 = b.op("Transpose", [xi], {"perm": [0, 2, 1, 3]}, output_names=["y1"])
        y2 = b.op("Transpose", [xi], output_names=["y2"])
        y3 = b.op("Unsqueeze", [mf, b.constant(None, np.int32([-1]))], output_names=["y3"])
        b.output(y0, y1, y2, y3)
        return b.finish()

    got, want = _run_both(build, {"m": m, "x": x}, ["y0", "y1", "y2", "y3"])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (2, 1, 1, 7) and got[3].shape == (2, 7, 1)


@pytest.mark.parametrize("op", ["MatMul", "MatMulAdd"])
def test_matmul_f32(op):
    """Full-f32 products ([B, T, K] x [K, N] + bias) in another summation
    order than XLA's: rtol 1e-5, atol 1e-5."""
    rng = _rng()
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    consts = [("w", w)] + ([("bias", bias)] if op == "MatMulAdd" else [])
    got, want = _run_both(_single_op(op, [("x", "Float")], consts), {"x": x}, ["y0"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,bs,zp", [(128, 32, None), (100, 32, "u8"), (72, 16, None)])
def test_matmul_nbits(K, bs, zp):
    """MatMulNBits over packed nibbles [N, nb, bs/2], scales [N, nb] and
    optional u8-packed zero points, K not a multiple of the block: rtol
    1e-4, atol 1e-4 (the reference kernel test's tolerance)."""
    rng = _rng()
    N = 48
    nb = -(-K // bs)
    x = rng.standard_normal((3, 4, K)).astype(np.float32)
    packed = rng.integers(0, 256, (N, nb, bs // 2)).astype(np.uint8)
    scales = rng.uniform(0.01, 0.1, (N, nb)).astype(np.float32)
    consts = [("b", packed), ("s", scales)]
    if zp:
        consts.append(("zp", rng.integers(0, 256, N * ((nb + 1) // 2)).astype(np.uint8)))
    build = _single_op("MatMulNBits", [("x", "Float")], consts,
                       {"K": K, "N": N, "bits": 4, "block_size": bs})
    got, want = _run_both(build, {"x": x}, ["y0"])
    assert got[0].shape == (3, 4, N)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)


def _attention_graph(op_type, n_in, attrs, feed, n_out=3):
    """One attention node over inputs i0..i{n_in-1}, None where ``feed``
    leaves an input out."""
    def build(GB, DT):
        b = GB()
        ins = [b.input(f"i{i}") if f"i{i}" in feed else None for i in range(n_in)]
        outs = b.op(op_type, ins, attrs, n_outputs=n_out,
                    output_names=[f"y{i}" for i in range(n_out)])
        b.output(*(outs if n_out > 1 else (outs,)))
        return b.finish()
    return build


@pytest.mark.parametrize("case", ["gpt2_prefill", "gpt2_decode", "gqa_3d_bool", "per_batch",
                                  "softcap"])
def test_attention(case):
    """ONNX Attention against the JAX lowering (its XLA path on the CPU,
    which is also the port's plain path): outputs and presents, rtol 1e-4,
    atol 1e-5. GPT-2's prefill (4-D heads, an additive [B,1,1,S] mask with
    left padding, causal, empty past) and decode step (Tq 1 over a past);
    3-D inputs with q_num_heads over kv_num_heads and a bool mask; a
    per-batch mask; softcap with a scale."""
    rng = _rng()
    B, H, D = 1, 2, 16
    attrs = {"is_causal": 1}
    if case == "gpt2_prefill":
        Tq, P = 12, 0
        mask = np.where(np.arange(Tq) < 3, -1e30, 0.0).astype(np.float32)[None, None, None]
    elif case == "gpt2_decode":
        Tq, P = 1, 9
        mask = np.where(np.arange(P + 1) < 2, -1e30, 0.0).astype(np.float32)[None, None, None]
    elif case == "per_batch":
        B, Tq, P = 2, 10, 3
        mask = np.where(rng.random((B, 1, 1, Tq + P)) > 0.3, 0.0, -1e30).astype(np.float32)
    elif case == "softcap":
        Tq, P, mask = 10, 4, None
        attrs = {"is_causal": 1, "softcap": 2.0, "scale": 0.3}
    else:
        Tq, P = 9, 0
        attrs = {"q_num_heads": 4, "kv_num_heads": 2}
    if case == "gqa_3d_bool":
        q = rng.standard_normal((B, Tq, 4 * D)).astype(np.float32)
        k = rng.standard_normal((B, Tq, 2 * D)).astype(np.float32)
        v = rng.standard_normal((B, Tq, 2 * D)).astype(np.float32)
        feed = {"i0": q, "i1": k, "i2": v, "i3": rng.random((Tq, Tq)) > 0.3}
        n_in = 4
    else:
        q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
        k = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
        v = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
        pk = rng.standard_normal((B, H, P, D)).astype(np.float32)
        pv = rng.standard_normal((B, H, P, D)).astype(np.float32)
        feed = {"i0": q, "i1": k, "i2": v, "i4": pk, "i5": pv}
        if mask is not None:
            feed["i3"] = mask
        n_in = 6
    got, want = _run_both(_attention_graph("Attention", n_in, attrs, feed), feed, ["y0", "y1", "y2"])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["packed_qkv", "bias_masks_past", "pre_split", "plain"])
def test_multi_head_attention(case):
    """MS contrib MultiHeadAttention against the JAX lowering: packed QKV
    [B,S,H,3,D]; bias with a key-padding mask, an attention bias and past
    K/V; pre-split [B,H,Tk,D] key/value; no mask (the flash path, causal).
    rtol 1e-4, atol 1e-5."""
    rng = _rng()
    B, S, H, D = 2, 9, 2, 16
    E = H * D
    attrs = {"num_heads": H}
    if case == "packed_qkv":
        feed = {"i0": rng.standard_normal((B, S, H, 3, D)).astype(np.float32)}
    elif case == "bias_masks_past":
        P = 3
        feed = {"i0": rng.standard_normal((B, S, E)).astype(np.float32),
                "i1": rng.standard_normal((B, S, E)).astype(np.float32),
                "i2": rng.standard_normal((B, S, E)).astype(np.float32),
                "i3": rng.standard_normal(3 * E).astype(np.float32),
                "i4": (rng.random((B, S + P)) > 0.2).astype(np.int32),
                "i5": rng.standard_normal((1, H, S, S + P)).astype(np.float32),
                "i6": rng.standard_normal((B, H, P, D)).astype(np.float32),
                "i7": rng.standard_normal((B, H, P, D)).astype(np.float32)}
    elif case == "pre_split":
        feed = {"i0": rng.standard_normal((B, S, E)).astype(np.float32),
                "i1": rng.standard_normal((B, H, 12, D)).astype(np.float32),
                "i2": rng.standard_normal((B, H, 12, D)).astype(np.float32)}
    else:
        attrs["unidirectional"] = 1
        feed = {"i0": rng.standard_normal((B, S, E)).astype(np.float32),
                "i1": rng.standard_normal((B, S, E)).astype(np.float32),
                "i2": rng.standard_normal((B, S, E)).astype(np.float32)}
    got, want = _run_both(_attention_graph("MultiHeadAttention", 8, attrs, feed), feed,
                          ["y0", "y1", "y2"])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_attention_routes_by_the_reference_rule(monkeypatch):
    """Tq >= 8 with a mask that folds to 2-D goes through the mha wrapper
    (the kernel on the card); a decode step (Tq 1) and a per-batch mask go
    to the plain version, as the reference's mha dispatch routes them."""
    from rten_tpu_torch.ops import attention as tattn

    calls = []
    real = tattn.mha
    monkeypatch.setattr(tattn, "mha", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    q = torch.randn(1, 2, 8, 16)
    tattn._attend(q, q, q, torch.zeros(1, 8), causal=True)
    tattn._attend(q[:, :, :1], q, q, torch.zeros(1, 8))
    tattn._attend(q.expand(2, 2, 8, 16), q.expand(2, 2, 8, 16), q.expand(2, 2, 8, 16),
                  torch.zeros(2, 1, 1, 8))
    assert calls == [(1, 2, 8, 16)]
