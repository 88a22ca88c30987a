"""K3 and K6, the int8 decode products, on the CPU: the launch plan of
csrc/int8_matmul.cu (mirrored by ``int8_matmul_plan``) over every decode and
verify shape of the three LLM families, its refusals with the wrapper's
message, its constants against the source's; the padded rows a ragged O is
stored in (the quantizer, the weight bridge, the >= 256-row route);
chip_smoke's K3 / K6 cases and [sass] rules; the shared int8 -> bf16
conversion's header; nested headers in the build hash.

Tolerances: the plan's numbers are integers (equal); quantized values and
scales bit-equal to JAX's; the >= 256-row route bit-equal between a padded
and a contiguous weight (the same values in the same product).
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.ops import int8_matmul as jmm
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu_torch.core.config import micro_vlm_config
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops import cuda_build
from grounded_video_llm_tpu_torch.ops import int8_matmul as mm
from grounded_video_llm_tpu_torch.serve import quantize as tq

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "grounded_video_llm_tpu_torch" / "csrc"
FAMILIES = ("phi3.5", "llama3", "vicuna")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _decode_shapes(family):
    """{name: (D, O, takes w8a8)} of a family's int8 decode products."""
    L = vlm_config(family, stage="inference").llm
    return {"qkv": (L.hidden_size, L.q_dim + 2 * L.kv_dim, True),
            "o": (L.q_dim, L.hidden_size, True),
            "gate_up": (L.hidden_size, 2 * L.intermediate_size, True),
            "down": (L.intermediate_size, L.hidden_size, True),
            "lm_head": (L.hidden_size, L.padded_vocab_size, False)}


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_accepts_every_decode_shape(family):
    """Every projection (both branches) and the lm_head (weight-only) at
    M 1..255 has a plan, and the plan's numbers hold together: every weight
    row is in exactly one block's slice, the ring fits the slice, one pass
    (one read of the weights) for M <= 32, shared memory for two blocks an
    SM."""
    for name, (D, O, w8a8_too) in _decode_shapes(family).items():
        kst = -(-D // 64)
        for w8a8 in (False, True) if w8a8_too else (False,):
            for M in range(1, 256):
                p = mm.int8_matmul_plan(M, D, O, w8a8)
                assert p is not None, (family, name, M, w8a8)
                assert p.rows == (8 if M <= 8 else 16 if M <= 16 else 32)
                assert p.passes == -(-M // 32) and p.rows * p.passes >= M
                assert p.tiles * 128 >= O > (p.tiles - 1) * 128
                assert 1 <= p.cluster <= 16
                assert p.cluster <= 8 or (w8a8 and M > 8)
                assert (p.cluster - 1) * p.stages_per_block < kst \
                    <= p.cluster * p.stages_per_block
                assert 1 <= p.stages <= p.stages_per_block
                assert p.smem <= 113 * 1024, (family, name, M, p)
            assert mm.int8_matmul_plan(32, D, O, w8a8).passes == 1


def test_plan_at_the_decode_shapes():
    """Phi-3.5's decode plans, pinned: one wave of about two blocks an SM
    where the tiles allow, the ring holding the whole slice where it
    fits."""
    want = {  # (M, D, O, w8a8): (cluster, stages_per_block, stages)
        (6, 3072, 9216, True): (3, 16, 10),
        (6, 3072, 3072, True): (8, 6, 6),
        (6, 3072, 16384, True): (2, 24, 8),
        (6, 8192, 3072, True): (8, 16, 10),
        (1, 3072, 9216, False): (3, 16, 12),
        (6, 3072, 32366, False): (1, 48, 12),
        (30, 3072, 32366, False): (1, 48, 9),
        (30, 3072, 9216, True): (4, 12, 4),
        # x's bf16 and int8 slices push past a portable cluster of 8
        (30, 8192, 3072, True): (10, 13, 3),
    }
    for (M, D, O, w8a8), (C, spb, n) in want.items():
        p = mm.int8_matmul_plan(M, D, O, w8a8)
        assert (p.cluster, p.stages_per_block, p.stages) == (C, spb, n), \
            ((M, D, O, w8a8), p)


@pytest.mark.parametrize("case", ["d_not_8", "w8a8_ragged_o", "w8a8_wide_d"])
def test_plan_refuses_with_the_wrappers_message(case):
    M, D, O, w8a8 = {"d_not_8": (6, 3076, 1024, False),
                     "w8a8_ragged_o": (6, 3072, 1000, True),
                     # 32 rows of a 2,048-row slice leave no two stages
                     "w8a8_wide_d": (32, 32768, 1024, True)}[case]
    assert mm.int8_matmul_plan(M, D, O, w8a8) is None
    x = torch.empty(M, D, dtype=torch.bfloat16, device="meta")
    w = mm.empty_int8_weight((D, O), device="meta")
    s = torch.empty(O, device="meta")
    with pytest.raises(ValueError, match="O % 16|no launch plan"):
        mm._check_launch_args("int8_matmul", x, w, s, w8a8)
    # the weight-only branch takes the wide D
    if case == "w8a8_wide_d":
        assert mm.int8_matmul_plan(M, D, O, False) is not None


def test_plan_constants_match_the_source():
    src = (CSRC / "int8_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1).replace(" * 1024", "")) \
            * (1024 if name == "SMEM_TARGET" else 1)

    assert const("BK") == mm._BK and const("MP") == mm._MP
    assert const("CMAX") == mm._CMAX and const("ALIGN") == mm._ALIGN
    assert const("SMEM_TARGET") == mm._SMEM_TARGET
    assert 16 * const("CONSUMERS") == mm._BO
    assert 132 * const("BLOCKS_PER_SM") == mm._TARGET_BLOCKS
    assert "constexpr int OUT_PITCH = BO + 4;" in src
    assert mm._OUT_PITCH == mm._BO + 4


def test_chip_smoke_reaches_every_instantiation_and_rule():
    """chip_smoke's K3 / K6 cases launch both branches at 8, 16 and 32
    rows (the kernel's six instantiations), more than one pass, the edge
    shapes off the tile and stage grids, and its [sass] rules name both
    branches' kernels."""
    cs = _chip_smoke()
    L = vlm_config("phi3.5", stage="inference").llm
    seen = set()
    for w8a8 in (False, True):
        for M in cs.GEMV_ROWS:
            seen.add((w8a8, mm.int8_matmul_plan(M, L.hidden_size,
                                                9216, w8a8).rows))
    for w8a8, O, D in cs.GEMV_EDGE_CASES:
        for M in cs.GEMV_EDGE_ROWS:
            seen.add((w8a8, mm.int8_matmul_plan(M, D, O, w8a8).rows))
    assert seen == {(w, r) for w in (False, True) for r in (8, 16, 32)}
    assert set(cs.GEMV_ROWS) == {1, 6, 30, 255}
    assert any(M > 32 and M % 32 for M in cs.GEMV_EDGE_ROWS)
    edges = {(w8a8, O % 128 != 0, D % 64 != 0)
             for w8a8, O, D in cs.GEMV_EDGE_CASES}
    assert edges >= {(False, True, False), (True, True, False),
                     (False, True, True), (True, True, True)}
    assert all(O % 16 == 0 for w8a8, O, _ in cs.GEMV_EDGE_CASES if w8a8)
    rules = {frag: (needs, forbid) for lib, frag, needs, forbid
             in cs.SASS_REQUIRED if lib == "libint8_matmul.so"}
    assert rules == {
        "int8_mm_kernelILb1": ((("IMMA",), ("UTMALDG",)),
                               ("HMMA", "HGMMA", "IGMMA")),
        "int8_mm_kernelILb0": ((("HMMA",), ("UTMALDG",)),
                               ("IMMA", "HGMMA", "IGMMA"))}
    name = "14int8_mm_kernelILb1ELi4EEE"
    ok = dict.fromkeys(cs.SASS_OPS, 0) | {"IMMA": 8, "UTMALDG": 2}
    assert cs.sass_ok("libint8_matmul.so", name, ok)
    assert not cs.sass_ok("libint8_matmul.so", name, ok | {"HMMA": 1})


def test_conversion_header_is_shared():
    """The exact int8 -> bf16 conversion (whose numpy mirror
    test_torch_int8_attention.py checks on all 256 bytes) lives in
    int8_mma.cuh, which the attention header and the decode products
    include."""
    head = (CSRC / "int8_mma.cuh").read_text()
    body = head[head.index("void i8x4_to_bf16"):]
    body = body[:body.index("\n}\n")]
    for magic in ("0x43004300u", "0x007F007Fu", "0x00800080u"):
        assert magic in body
    for src in ("int8_attention.cuh", "int8_matmul.cu"):
        text = (CSRC / src).read_text()
        assert '#include "int8_mma.cuh"' in text
        assert "void i8x4_to_bf16" not in text


def test_build_hash_follows_nested_headers(tmp_path):
    """An edit of a header a header includes changes the library's hash,
    so a stale kernel library is never loaded."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    k = cuda_build.CudaKernel("int8_matmul.cu", "none", [])
    cuda_build.REGISTRY.remove(k)
    k.source = tmp_path / "k.cu"
    before = k.library_path()
    (tmp_path / "b.cuh").write_text("// two\n")
    assert k.library_path() != before


def test_ragged_o_is_stored_in_padded_rows_bit_equal_to_jax():
    """A ragged O is quantized into rows padded to 16 bytes (stacked and
    2-D alike), the values and scales JAX's bit for bit, and the wrapper's
    plain version gives what it gives on a contiguous copy."""
    w = np.random.default_rng(0).normal(size=(3, 64, 1000)).astype(
        np.float32) * 0.02
    qj, sj = jmm.quantize_weights_int8(jnp.asarray(w))
    for q, s, want_q, want_s in (
            (*mm.quantize_weights_int8(torch.from_numpy(w)), qj, sj),
            (*mm.quantize_weights_int8(torch.from_numpy(w[1])), qj[1],
             sj[1])):
        assert q.stride()[-2:] == (1008, 1) and not q.is_contiguous()
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    q, s = mm.quantize_weights_int8(torch.from_numpy(w))
    x = torch.randn(30, 64, generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    for w8a8 in (False, True):
        assert torch.equal(mm.int8_matmul(x, q[2], s[2], w8a8),
                           mm.int8_matmul_reference(x, q[2].contiguous(),
                                                    s[2], w8a8))
    # a width that needs no padding stays contiguous
    assert mm.quantize_weights_int8(torch.from_numpy(w[..., :992]))[0] \
        .is_contiguous()


def test_micro_lm_head_padded_by_quantizer_and_bridge_and_prefill_route():
    """The micro config's vocabulary (814) is ragged: quantize_llm_for_serving
    and the weight bridge both store the lm_head in padded rows with JAX's
    values and scales, and the >= 256-row route (dequantize and matmul) and
    the decode route give on it what they give on a contiguous copy."""
    cfg = micro_vlm_config("phi3.5")
    jp = jvlm.init_params(jax.random.key(3), cfg)
    jl = jq.quantize_llm_for_serving(jp["llm"])
    V = cfg.llm.padded_vocab_size
    assert V % 16
    fp32 = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")
    ours = tq.quantize_llm_for_serving(fp32["llm"])["lm_head"]
    bridged = params_from_jax(jax.tree_util.tree_map(
        np.asarray, dict(jp, llm=jl)), cfg, "cpu")["llm"]["lm_head"]
    for head in (ours, bridged):
        assert head.q.shape == (cfg.llm.hidden_size, V)
        assert head.q.stride(0) % 16 == 0 and head.q.stride(1) == 1
        np.testing.assert_array_equal(head.q.numpy(),
                                      np.asarray(jl["lm_head"]["q"]))
        np.testing.assert_array_equal(head.scale.numpy(),
                                      np.asarray(jl["lm_head"]["scale"]))
    flat = mm.Int8Weight(ours.q.contiguous(), ours.scale)
    g = torch.Generator().manual_seed(4)
    for rows in (256, 6):
        h = torch.randn(rows, cfg.llm.hidden_size, generator=g).bfloat16()
        assert torch.equal(tllm._matmul_maybe_int8(h, ours),
                           tllm._matmul_maybe_int8(h, flat))


def _rn32(x):
    """The float32 nearest to the real x (a float64 or Fraction), ties to
    even: RN64 first, and the exact value where RN64 lands on a float32
    midpoint (the only place double rounding can differ)."""
    from fractions import Fraction
    d = float(x)
    f = np.float32(d)
    if Fraction(d) == Fraction(float(f)):
        return f
    lo, hi = sorted((f, np.nextafter(f, np.float32(np.inf if d > float(f)
                                                     else -np.inf))))
    mid = (Fraction(float(lo)) + Fraction(float(hi))) / 2
    if Fraction(d) != mid:
        return f
    exact = Fraction(x) if not isinstance(x, float) else Fraction(x)
    if exact != mid:
        return hi if exact > mid else lo
    return lo if int(lo.view(np.uint32)) % 2 == 0 else hi


def _fma32(a, b, c):
    """fmaf: a * b + c rounded once to float32."""
    from fractions import Fraction
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_quantize8_arithmetic_is_the_true_division():
    """A mirror of csrc/int8_matmul.cu quantize8: t = v * inv, two FMA
    corrections, rounded half to even, equals rint of the correctly rounded
    quotient v / xs (the plain version's torch.round(x / xs)) for every bf16
    value v within a row's absmax, at row maxima whose 1 / xs rounds up,
    down and exactly, and at exact ties v / xs = k + 1/2."""
    src = (CSRC / "int8_matmul.cu").read_text()
    body = src[src.index("uint2 quantize8("):]
    body = body[:body.index("\n}\n")]
    assert "t = v * inv" in body
    assert "fmaf(fmaf(-t, xs, v), inv, t)" in body
    assert "__float2int_rn(fmaf(fmaf(-q1, xs, v), inv, q1))" in body
    bf16 = np.arange(0x3C00, 0x4400, 7, dtype=np.uint32) << 16  # ~2^-7..2^9
    grid = bf16.view(np.float32)
    checked = 0
    for amax in (np.float32(1.0), np.float32(3.1875), np.float32(254.0),
                 np.float32(0.0078125), np.float32(1.9921875),
                 np.float32(127.0)):
        xs = max(np.float32(amax) / np.float32(127.0), np.float32(1e-8))
        inv = np.float32(1.0) / xs
        vs = grid[np.abs(grid) <= amax]
        ties = (np.arange(-127, 127) + np.float32(0.5)) * xs   # v = h * xs
        vs = np.concatenate([vs, -vs, ties[ties.astype(np.float32) / xs
                                           == np.arange(-127, 127) + 0.5]])
        for v in vs.astype(np.float32):
            t = np.float32(v * inv)
            q1 = _fma32(_fma32(-t, xs, v), inv, t)
            got = np.rint(_fma32(_fma32(-q1, xs, v), inv, q1))
            want = np.rint(np.float32(v) / xs)
            assert got == want, (float(amax), float(v))
            checked += 1
    assert checked > 3000


def test_int8_matmul_ab_loads_another_checkout_and_covers_the_cases():
    """microbench/int8_matmul_ab imports another checkout's wrapper as a
    package of its own (here this checkout: on CPU tensors both run the
    plain version, so they agree bit for bit), and times the decode and
    verify shapes: the four projections at M 6 (w8a8), 1 (weight-only) and
    30 (w8a8) and the lm_head at M 6 and 30."""
    from grounded_video_llm_tpu_torch.microbench import int8_matmul_ab as ab

    other = ab.load_other(REPO)
    assert other.__name__ == "gvllm_other.ops.int8_matmul"
    assert other.INT8_MATMUL is not mm.INT8_MATMUL
    g = torch.Generator().manual_seed(5)
    x = torch.randn(6, 64, generator=g).bfloat16()
    w = torch.randint(-127, 128, (64, 128), generator=g, dtype=torch.int8)
    s = torch.rand(128, generator=g)
    for w8a8 in (False, True):
        assert torch.equal(other.int8_matmul(x, w, s, w8a8),
                           mm.int8_matmul(x, w, s, w8a8))
    got = {(w8a8, M, tuple(shapes)) for _, w8a8, M, shapes, _ in
           ab.cases(vlm_config("phi3.5", stage="inference"))}
    proj = ("qkv", "o", "gate_up", "down")
    assert got == {(True, 6, proj), (False, 1, proj), (True, 30, proj),
                   (False, 6, ("lm_head",)), (False, 30, ("lm_head",))}
