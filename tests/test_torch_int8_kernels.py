"""Each int8 kernel module of the port against its JAX function on the CPU:
quantization, K3 and K6 (int8_matmul, weight-only and w8a8), K4
(decode_attention_int8) and K5 (scatter_write). On CPU tensors the port's
wrappers run
their plain versions; the JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them. Shapes take the Pallas paths (D % 32 == 0,
O % 512 == 0) except where a ragged O is the point.

Tolerances, by what the two sides share:
  * quantized values and scales: bit-equal (the same fp32 arithmetic);
  * w8a8 products: bit-equal to the JAX function evaluated op by op (an
    exact integer dot, then the same fp32 rescale). The compiled Pallas
    kernel differs slightly: XLA divides x by its row scale as a multiply by
    the reciprocal, which moves a quotient lying within an fp32 ulp of a .5
    tie to the other integer, and one such int8 element moves a bf16 output
    by about one ulp: rtol 2**-7, atol one bf16 ulp of the largest output;
  * weight-only products: at most one bf16 ulp apart (BF16_ULP relative):
    both sum exact bf16 x int8 products in fp32, in another order;
  * decode attention: bf16 output, fp32 softmax sums in another order, and
    p * v_scale rounded to bf16 on both sides: rtol 2**-7, atol 1e-3;
  * cache writes: bit-equal and in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.ops import cache_write as jcw
from grounded_video_llm_tpu.ops import decode_attention_int8 as jda
from grounded_video_llm_tpu.ops import int8_matmul as jmm
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu_torch.ops import cache_write as tcw
from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as tda
from grounded_video_llm_tpu_torch.ops import int8_matmul as tmm
from grounded_video_llm_tpu_torch.serve import quantize as tq

BF16_ULP = 2.0 ** -8


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _bf16_pair(a):
    """(torch bf16, jax bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16), j


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _within_bf16_ulp(t, j):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_bit_equal(dtype):
    w = _normal((3, 64, 1024), 0, 0.02)
    wj = jnp.asarray(w, dtype)
    wt = torch.from_numpy(np.array(wj, np.float32)).to(getattr(torch, dtype))
    qj, sj = jmm.quantize_weights_int8(wj)
    qt, st = tmm.quantize_weights_int8(wt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    q2, s2 = tmm.quantize_weights_int8(wt[1])        # one slice, same scales
    np.testing.assert_array_equal(q2.numpy(), np.asarray(qj[1]))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(sj[1]))


def test_quantize_kv_and_embed_bit_equal():
    xt, xj = _bf16_pair(_normal((2, 5, 4, 64), 1))
    xt[0, 0, 0] = 0                                  # the 1e-8 floor
    xj = xj.at[0, 0, 0].set(0)
    for (qt, st), (qj, sj) in ((tda.quantize_kv(xt), jda.quantize_kv(xj)),):
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    emb = _normal((96, 64), 2, 0.02)
    et = tq.quantize_embed_int8(torch.from_numpy(emb))
    ej = jq.quantize_embed_int8(jnp.asarray(emb))
    np.testing.assert_array_equal(et.q.numpy(), np.asarray(ej["q"]))
    np.testing.assert_array_equal(et.scale.numpy(), np.asarray(ej["scale"]))


def _stacked_weight(L, D, O, seed):
    w = jnp.asarray(_normal((L, D, O), seed, 0.02))
    qj, sj = jmm.quantize_weights_int8(w)
    return (torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(sj)),
            qj, sj)


# (M, w8a8): the weight-only branch at 255 rows is held, at ties, by
# test_int8_gemv_255_rows_weight_only_equal_to_jax_but_at_ties
@pytest.mark.parametrize(
    "M,w8a8", [(1, False), (1, True), (6, False), (6, True), (30, False),
               (30, True), (255, True)],
    ids=["1-weight_only", "1-w8a8", "6-weight_only", "6-w8a8",
         "30-weight_only", "30-w8a8", "255-w8a8"])
def test_int8_gemv_matches_int8_matmul_layer(M, w8a8):
    D, O, layer = 64, 1024, 1
    qt, st, qj, sj = _stacked_weight(3, D, O, 10 + M)
    xt, xj = _bf16_pair(_normal((M, D), 20 + M))
    yj = jmm.int8_matmul_layer(xj, qj, sj, jnp.int32(layer), w8a8=w8a8)
    yt = tmm.int8_matmul(xt, qt[layer], st[layer], w8a8=w8a8)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (M, O)
    if w8a8:
        eager = jmm.dynamic_int8_matmul(xj, qj[layer], sj[layer])
        np.testing.assert_array_equal(_np(yt), np.asarray(eager, np.float32))
        yj = np.asarray(yj, np.float32)
        np.testing.assert_allclose(_np(yt), yj, rtol=2 ** -7,
                                   atol=BF16_ULP * np.abs(yj).max())
    else:
        _within_bf16_ulp(yt, yj)


def test_int8_gemv_255_rows_weight_only_equal_to_jax_but_at_ties():
    """K3's weight-only branch at the 255-row cap against the JAX kernel, on
    the data the test above takes for each M: 261,120 outputs, each 64
    exact products summed in fp32 on both sides, in another order. Every
    output equals JAX's bf16 value, except where a bf16 rounding midpoint
    lies within the two sums' fp32 rounding error of the exact value (the
    sums then round to its two sides): there the two are adjacent bf16
    values around that midpoint."""
    M, D, O, layer = 255, 64, 1024, 1
    qt, st, qj, sj = _stacked_weight(3, D, O, 10 + M)
    xt, xj = _bf16_pair(_normal((M, D), 20 + M))
    yj = np.asarray(jmm.int8_matmul_layer(xj, qj, sj, jnp.int32(layer),
                                          w8a8=False), np.float32)
    yt = _np(tmm.int8_matmul(xt, qt[layer], st[layer]))
    x, w = xt.double().numpy(), qt[layer].double().numpy()
    s = st[layer].double().numpy()
    exact = (x @ w) * s
    # |fl(sum) - sum| <= D u sum|terms| in any order, plus the product's and
    # the sum's own rounding, u = 2^-24
    err = (D * 2.0 ** -24 * (np.abs(x) @ np.abs(w))
           + 2.0 ** -22 * np.abs(x @ w)) * s
    lo, hi = np.minimum(yt, yj), np.maximum(yt, yj)
    top = np.maximum(np.abs(lo), np.abs(hi))
    ulp = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0))) - 7)
    differ = yt != yj
    tie = (hi - lo <= ulp) & (np.abs(exact - (lo + hi) / 2) <= err)
    assert np.all(~differ | tie), np.argwhere(differ & ~tie)[:5]


@pytest.mark.parametrize("M,O", [(1, 1024), (6, 1024), (30, 1024), (40, 1024),
                                 (255, 1024), (6, 1000), (30, 1000)],
                         ids=["M1", "M6", "M30", "M40", "M255", "ragged_O",
                              "ragged_O_M30"])
def test_int8_matmul_matches_jax(M, O):
    """O = 1000 is not a multiple of block_o: JAX takes its XLA branch, the
    same function."""
    D = 64
    qt, st, qj, sj = _stacked_weight(1, D, O, 30 + M)
    xt, xj = _bf16_pair(_normal((M, D), 40 + M))
    yj = jmm.int8_matmul(xj, qj[0], sj[0])
    yt = tmm.int8_matmul(xt, qt[0], st[0])
    assert yt.dtype == torch.bfloat16
    _within_bf16_ulp(yt, yj)


def test_dynamic_int8_matmul_bit_equal_and_matmul_any():
    D, O = 64, 512
    qt, st, qj, sj = _stacked_weight(1, D, O, 50)
    x = _normal((3, 5, D), 51)
    yj = jmm.dynamic_int8_matmul(jnp.asarray(x), qj[0], sj[0])
    yt = tmm.dynamic_int8_matmul(torch.from_numpy(x), qt[0], st[0])
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    w = tmm.Int8Weight(qt[0], st[0], True)
    assert torch.equal(tmm.matmul_any(torch.from_numpy(x), w), yt)


def _attention_inputs(B, H, Hkv, D, L, seed):
    q = _normal((B, 1, H, D), seed)
    kv = _normal((B, L, Hkv, D), seed + 1)
    vv = _normal((B, L, Hkv, D), seed + 2)
    kn = _normal((B, 1, Hkv, D), seed + 3)
    vn = _normal((B, 1, Hkv, D), seed + 4)
    qt, qj = _bf16_pair(q)
    knt, knj = _bf16_pair(kn)
    vnt, vnj = _bf16_pair(vn)
    # quantize the cache once (JAX), lay it out both ways
    k8, ks = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(kv,
                                                                 jnp.bfloat16)))
    v8, vs = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(vv,
                                                                 jnp.bfloat16)))
    valid = np.zeros((B, L), bool)
    valid[0, 3:L - 10] = True            # left-pad holes, unwritten tail
    valid[1, :] = False                  # only the new slot is valid
    valid[2, :7] = True
    valid[2, 40:60] = True
    jax_in = (qj, jnp.asarray(k8.transpose(0, 2, 3, 1)),
              jnp.asarray(ks.transpose(0, 2, 1)[:, :, None, :]),
              jnp.asarray(v8.transpose(0, 2, 3, 1)),
              jnp.asarray(vs.transpose(0, 2, 1)[:, :, None, :]),
              jnp.asarray(valid.astype(np.int32)), knj, vnj)
    t_in = (qt, torch.from_numpy(k8.transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(ks.transpose(0, 2, 1).copy()),
            torch.from_numpy(v8.transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(vs.transpose(0, 2, 1).copy()),
            torch.from_numpy(valid), knt, vnt)
    return jax_in, t_in


@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4)], ids=["gqa_g2", "mha"])
def test_decode_attention_int8_matches_jax(H, Hkv):
    B, D, L = 3, 64, 256
    scale = D ** -0.5
    jax_in, t_in = _attention_inputs(B, H, Hkv, D, L, 60 + H + Hkv)
    oj = jda.decode_attention_int8(*jax_in, scale=scale)
    ot = tda.decode_attention_int8(*t_in, scale=scale)
    assert ot.dtype == torch.bfloat16 and tuple(ot.shape) == (B, 1, H, D)
    np.testing.assert_allclose(_np(ot), np.asarray(oj, np.float32),
                               rtol=2 ** -7, atol=1e-3)
    # the row with only the new slot valid attends exactly v_new
    vn = t_in[7].float().reshape(B, Hkv, 1, D)
    want = vn.expand(B, Hkv, H // Hkv, D).reshape(B, 1, H, D)[1]
    np.testing.assert_allclose(_np(ot[1]), want.numpy(), rtol=BF16_ULP)


def test_decode_attention_int8_layer_view_matches_layer_kernel():
    """A layer of the stacked cache is a view ``cache[l]``: the same result
    as the JAX layer-indexed kernel on the stacked buffer."""
    B, H, Hkv, D, L, layers = 3, 4, 2, 64, 128, 2
    scale = D ** -0.5
    jin0, tin0 = _attention_inputs(B, H, Hkv, D, L, 80)
    jin1, tin1 = _attention_inputs(B, H, Hkv, D, L, 90)
    stack_j = [jnp.stack([a, b]) for a, b in zip(jin0[1:5], jin1[1:5])]
    stack_t = [torch.stack([a, b]) for a, b in zip(tin0[1:5], tin1[1:5])]
    oj = jda.decode_attention_int8_layer(
        jin0[0], *stack_j, jin0[5], jin0[6], jin0[7], jnp.int32(1),
        scale=scale)
    ot = tda.decode_attention_int8(tin0[0], *(s[1] for s in stack_t),
                                   tin0[5], tin0[6], tin0[7], scale=scale)
    np.testing.assert_allclose(_np(ot), np.asarray(oj, np.float32),
                               rtol=2 ** -7, atol=1e-3)


def test_scatter_write_bit_equal_and_in_place():
    L, B, Hkv, D, max_len = 2, 4, 2, 64, 256
    rng = np.random.default_rng(7)
    vals = rng.integers(-127, 128, (L, B, Hkv, max_len, D), dtype=np.int8)
    scales = rng.random((L, B, Hkv, max_len), dtype=np.float32)
    new_v = rng.integers(-127, 128, (L, B, Hkv, D), dtype=np.int8)
    new_s = rng.random((L, B, Hkv), dtype=np.float32)
    idx = np.array([0, 127, 128, max_len - 1], np.int32)

    jv = jcw.scatter_write_kv(jnp.asarray(vals.transpose(0, 1, 2, 4, 3)),
                              jnp.asarray(new_v), jnp.asarray(idx))
    js = jcw.scatter_write_scale(jnp.asarray(scales[:, :, :, None, :]),
                                 jnp.asarray(new_s), jnp.asarray(idx))
    tv, ts = torch.from_numpy(vals.copy()), torch.from_numpy(scales.copy())
    ptrs = (tv.data_ptr(), ts.data_ptr())
    tcw.scatter_write([tv, ts], [torch.from_numpy(new_v),
                                 torch.from_numpy(new_s)],
                      torch.from_numpy(idx))
    assert (tv.data_ptr(), ts.data_ptr()) == ptrs
    np.testing.assert_array_equal(tv.numpy(),
                                  np.asarray(jv).transpose(0, 1, 2, 4, 3))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:, :, :, 0])
    # every slot other than idx[b] is untouched
    keep = np.ones((B, max_len), bool)
    keep[np.arange(B), idx] = False
    def rows_slots(a):                   # [L, Hkv, B, max_len, ...]
        return a.swapaxes(1, 2)[:, :, keep]

    np.testing.assert_array_equal(rows_slots(tv.numpy()), rows_slots(vals))
    np.testing.assert_array_equal(rows_slots(ts.numpy()), rows_slots(scales))
    for b, i in enumerate(idx):
        np.testing.assert_array_equal(tv.numpy()[:, b, :, i], new_v[:, b])


def test_scatter_write_skips_slots_out_of_range():
    cache = torch.zeros(1, 2, 1, 8, 4, dtype=torch.int8)
    new = torch.ones(1, 2, 1, 4, dtype=torch.int8)
    tcw.scatter_write([cache], [new], torch.tensor([8, -1], dtype=torch.int32))
    assert int(cache.abs().sum()) == 0
