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
    """Head-major caches are not on the slice's path: NotImplementedError
    naming the ROADMAP item, never a silent fallback."""
    feed = _attn_feed(1, [0, 0, 0], seed=1)
    feed["kc"] = feed["kc"].reshape(B, CAP, H, D).transpose(0, 2, 1, 3).copy()
    feed["vc"] = feed["vc"].reshape(B, CAP, H, D).transpose(0, 2, 1, 3).copy()
    tm = TModel(_attn_build(1)(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm.run(feed, ["out"])


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
