"""K4 and K8, the attention over the int8 KV cache, on the CPU: the launch
plan of csrc/int8_attention.cuh (mirrored by ``attention_plan``), the plain
versions against the JAX kernels (interpret mode) past the one-block
design's cap on L, their invariance to the contents of chunks no query sees
(the kernels skip those chunks), the exact int8 -> bf16 conversion the
kernels run, and chip_smoke's K4 / K8 cases and [sass] rules.

Tolerances: the plain versions against JAX rtol 2**-7, atol 1e-3 (bf16
outputs, fp32 sums in another order; the bars of test_torch_int8_kernels.py
and test_torch_spec_decode.py); garbage in masked chunks: bit-equal (a
masked slot adds an exact 0); the conversion: exact.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import vlm_config
from grounded_video_llm_tpu.ops import decode_attention_int8 as jda
from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as tda

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "grounded_video_llm_tpu_torch" / "csrc"
ATTN_RTOL, ATTN_ATOL = 2 ** -7, 1e-3
D_ALL = (32, 64, 96, 128)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# the one-block design's limits (its wrappers' checks), which the new plan
# must not narrow
def _old_k4_fits(G, L):
    return G * L * 4 <= 227 * 1024 - 40 * 1024


def _old_k8_fits(G, S, L, D):
    Q, lanes = G * S, 256 // (D // 4)
    return 4 * (-(-Q * L // 4) * 4 + Q * D + Q * S + lanes * 8 * D) \
        <= 227 * 1024


def _largest(fits, hi=1 << 20):
    """The largest L >= 1 with fits(L) (fits monotone), 0 if none."""
    if not fits(1):
        return 0
    lo = 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("D", D_ALL)
def test_plan_accepts_every_shape_the_one_block_design_did(D):
    """Every (G, S, L) the parent's checks accepted still has a plan, at
    the path's grids and a small one; the plan's numbers are consistent."""
    checked = 0
    for B, Hkv in ((1, 8), (6, 32), (64, 32)):
        for G in (1, 2, 4, 8):
            top = _largest(lambda L: _old_k4_fits(G, L))
            for L in (1, 127, 129, 1000, top // 2, top):
                plan = tda.attention_plan(B, Hkv, G, 1, L, D)
                assert plan is not None, (B, Hkv, G, L, D)
                checked += 1
        for G in (1, 2, 3, 4, 8):
            for S in (1, 2, 3, 4, 5, 8, 16, 33, 64, 130):
                top = _largest(lambda L: _old_k8_fits(G, S, L, D))
                for L in {1, 17, 129, top // 3, top - 1, top} - {0}:
                    if not _old_k8_fits(G, S, L, D):
                        continue
                    plan = tda.attention_plan(B, Hkv, G, S, L, D)
                    assert plan is not None, (B, Hkv, G, S, L, D)
                    assert plan.smem <= 227 * 1024 and plan.stages >= 1
                    assert 1 <= plan.cluster <= tda.ATTN_CMAX
                    assert plan.blocks == B * Hkv * plan.cluster
                    # the clusters cover the row, no block is empty
                    assert (plan.cluster - 1) * plan.slots_per_block < L \
                        <= plan.cluster * plan.slots_per_block
                    checked += 1
    assert checked > 300
    # llama3's G = 4 with four drafts (Q = 20) at 3,000 slots, past the
    # one-block cap (2,363 at D = 128)
    assert not _old_k8_fits(4, 5, 3000, 128)
    assert tda.attention_plan(6, 8, 4, 5, 3000, D) is not None


def test_plan_at_the_paths_shapes():
    """Mode A and path D (B = 6) and path B (B = 1) over 3,840 slots: each
    grid fits one wave of three blocks an SM of 132 where the rows allow,
    each block within the shared memory of three an SM."""
    d = tda.attention_plan(6, 32, 1, 5, 3840, 96)
    a = tda.attention_plan(6, 32, 1, 1, 3840, 96)
    b = tda.attention_plan(1, 32, 1, 1, 3840, 96)
    for plan, heads in ((d, 192), (a, 192), (b, 32)):
        assert plan.blocks == heads * plan.cluster
        assert plan.cluster * plan.slots_per_block >= 3840
        assert plan.smem <= 74 * 1024             # three blocks an SM
        assert plan.blocks <= tda.ATTN_TARGET_BLOCKS         # one wave
    assert b.cluster > a.cluster        # B = 1 splits each row further
    assert b.slots_per_block == tda.ATTN_MIN_CHUNKS * tda.ATTN_CHUNK


@pytest.mark.parametrize("kind,B,Hkv,G,S,D", [
    ("decode", 1, 8, 1, 1, 96), ("decode", 1, 8, 8, 1, 128),
    ("verify", 1, 8, 1, 5, 96), ("verify", 1, 8, 4, 5, 128)],
    ids=["k4_g1", "k4_g8", "k8_q5", "k8_q20"])
def test_plan_refuses_past_its_limit_with_the_wrappers_message(
        kind, B, Hkv, G, S, D):
    """The cap on L rose with the cluster (16 blocks): a block holds 1/16
    of a row's scores and mask bits, so the cap is at least 14 times the
    one-block design's (16.5 to 17.3 times here); past it the wrapper
    refuses with its message."""
    rise = 14
    cap = _largest(lambda L: tda.attention_plan(B, Hkv, G, S, L, D)
                   is not None, hi=1 << 22)
    old = (_largest(lambda L: _old_k4_fits(G, L)) if kind == "decode" else
           _largest(lambda L: _old_k8_fits(G, S, L, D)))
    assert cap >= rise * old, (cap, old)
    assert tda.attention_plan(B, Hkv, G, S, cap + 1, D) is None
    q = torch.zeros(B, S, Hkv * G, D, dtype=torch.bfloat16, device="meta")
    cache = torch.zeros(B, Hkv, cap + 1, D, dtype=torch.int8, device="meta")
    sc = torch.zeros(B, Hkv, cap + 1, device="meta")
    new = torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="shared memory.*too many"):
        if kind == "decode":
            mask = torch.zeros(B, cap + 1, dtype=torch.bool, device="meta")
            tda._check_launch_args(q, cache, sc, cache, sc, mask, new, new)
        else:
            mask = torch.zeros(B, S, cap + 1, dtype=torch.bool,
                               device="meta")
            tda._check_verify_args(q, cache, sc, cache, sc, mask, new, new)


def _bf16_pair(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16), j


def _inputs(B, S, H, Hkv, D, L, mask, seed, k8=None, ks=None, v8=None,
            vs=None):
    """(jax inputs, torch inputs) of K8 (K4: S = 1 and a [B, L] mask
    given as [B, 1, L]) on the same bf16 q / new k, v and int8 cache."""
    rng = np.random.default_rng(seed)
    q, qj = _bf16_pair(rng.normal(size=(B, S, H, D)))
    kn, knj = _bf16_pair(rng.normal(size=(B, S, Hkv, D)))
    vn, vnj = _bf16_pair(rng.normal(size=(B, S, Hkv, D)))
    if k8 is None:
        k8, ks = (np.asarray(a) for a in jda.quantize_kv(
            jnp.asarray(rng.normal(size=(B, L, Hkv, D)), jnp.bfloat16)))
        v8, vs = (np.asarray(a) for a in jda.quantize_kv(
            jnp.asarray(rng.normal(size=(B, L, Hkv, D)), jnp.bfloat16)))
    jax_in = [qj, jnp.asarray(k8.transpose(0, 2, 3, 1)),
              jnp.asarray(ks.transpose(0, 2, 1)[:, :, None, :]),
              jnp.asarray(v8.transpose(0, 2, 3, 1)),
              jnp.asarray(vs.transpose(0, 2, 1)[:, :, None, :]),
              jnp.asarray(mask.astype(np.int32)), knj, vnj]
    t_in = [q, torch.from_numpy(k8.transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(ks.transpose(0, 2, 1).copy()),
            torch.from_numpy(v8.transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(vs.transpose(0, 2, 1).copy()),
            torch.from_numpy(mask), kn, vn]
    return jax_in, t_in, (k8, ks, v8, vs)


def _ragged_mask(B, S, L):
    """Row 0 sees slots 3 .. L - 10; row 1 only a window per query around
    its middle, so whole chunks of 128 slots at both ends are masked."""
    mask = np.zeros((B, S, L), bool)
    mask[0, :, 3:L - 10] = True
    for i in range(S):
        mask[1, i, L // 2 - 200 + 7 * i:L // 2 + 90 + 11 * i] = True
    return mask


def test_decode_plain_matches_jax_past_the_one_block_cap():
    """K4's plain version against the JAX kernel at G = 8 over 6,100 slots
    (the one-block design took at most 5,984 at G = 8)."""
    B, H, Hkv, D, L = 2, 8, 1, 32, 6100
    assert not _old_k4_fits(H // Hkv, L)
    assert tda.attention_plan(B, Hkv, H // Hkv, 1, L, D) is not None
    mask = _ragged_mask(B, 1, L)[:, 0]
    jax_in, t_in, _ = _inputs(B, 1, H, Hkv, D, L, mask, 3)
    oj = jda.decode_attention_int8(*jax_in, scale=D ** -0.5)
    ot = tda.decode_attention_int8(*t_in, scale=D ** -0.5)
    assert ot.dtype == torch.bfloat16 and tuple(ot.shape) == (B, 1, H, D)
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                               rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_verify_plain_matches_jax_past_the_one_block_cap():
    """K8's plain version against the JAX kernel at Q = G * S = 20 over
    2,600 slots (the one-block design took at most 2,459 at D = 32)."""
    B, S, H, Hkv, D, L = 2, 5, 4, 1, 32, 2600
    assert not _old_k8_fits(H // Hkv, S, L, D)
    assert tda.attention_plan(B, Hkv, H // Hkv, S, L, D) is not None
    jax_in, t_in, _ = _inputs(B, S, H, Hkv, D, L, _ragged_mask(B, S, L), 4)
    oj = jda.verify_attention_int8(*jax_in, scale=D ** -0.5)
    ot = tda.verify_attention_int8(*t_in, scale=D ** -0.5)
    assert tuple(ot.shape) == (B, S, H, D)
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                               rtol=ATTN_RTOL, atol=ATTN_ATOL)


def _garbage_in_masked_chunks(mask, cache, seed):
    """The cache with every 128-slot chunk that no query of its row sees
    overwritten: random bytes, finite random scales up to 1e4."""
    rng = np.random.default_rng(seed)
    k8, ks, v8, vs = (a.copy() for a in cache)
    B, _, L = mask.shape
    chunk = tda.ATTN_CHUNK
    hit = 0
    for b in range(B):
        for c0 in range(0, L, chunk):
            if mask[b, :, c0:c0 + chunk].any():
                continue
            hit += 1
            for a in (k8, v8):
                a[b, c0:c0 + chunk] = rng.integers(
                    -128, 128, size=a[b, c0:c0 + chunk].shape)
            for a in (ks, vs):
                a[b, c0:c0 + chunk] = rng.uniform(
                    -1e4, 1e4, size=a[b, c0:c0 + chunk].shape)
    assert hit >= 2
    return k8, ks, v8, vs


@pytest.mark.parametrize("S", [1, 3], ids=["decode", "verify"])
def test_masked_chunks_do_not_matter(S):
    """What the kernels skip: whole chunks no query of the row sees. With
    their bytes and scales replaced by garbage the plain versions give the
    same bits, and so does the JAX kernel."""
    B, H, Hkv, D, L = 2, 4, 2, 32, 1000
    mask = _ragged_mask(B, S, L)
    jax_in, t_in, cache = _inputs(B, S, H, Hkv, D, L, mask, 5)
    dirty = _garbage_in_masked_chunks(mask, cache, 6)
    jax_g, t_g, _ = _inputs(B, S, H, Hkv, D, L, mask, 5, *dirty)
    if S == 1:
        for args in (t_in, t_g):
            args[5] = args[5][:, 0]
        for args in (jax_in, jax_g):
            args[5] = args[5][:, 0]
        plain, jfn = tda.decode_attention_int8, jda.decode_attention_int8
    else:
        plain, jfn = tda.verify_attention_int8, jda.verify_attention_int8
    scale = D ** -0.5
    assert not torch.equal(t_in[1], t_g[1])
    assert torch.equal(plain(*t_in, scale=scale), plain(*t_g, scale=scale))
    np.testing.assert_array_equal(np.asarray(jfn(*jax_in, scale=scale)),
                                  np.asarray(jfn(*jax_g, scale=scale)))


def _bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(x):
    """Round to nearest even, as the card's bf16 subtraction does."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def i8x4_to_bf16(w):
    """numpy mirror of csrc/int8_mma.cuh i8x4_to_bf16: the bytes of
    the uint32 words w as bf16 pairs (b0, b2), (b1, b3)."""
    magic = np.uint32(0x43004300)
    w = np.asarray(w, np.uint32)
    out = []
    for x in (w, w >> np.uint32(8)):
        m = (x & np.uint32(0x007F007F)) | magic
        s = (x & np.uint32(0x00800080)) | magic
        halves = []
        for shift in (0, 16):
            a = _bf16_bits_to_f32((m >> np.uint32(shift)) & np.uint32(0xFFFF))
            b = _bf16_bits_to_f32((s >> np.uint32(shift)) & np.uint32(0xFFFF))
            halves.append(_f32_to_bf16_bits(a - b))
        out.append(halves[0] | (halves[1] << np.uint32(16)))
    return out[0], out[1]


def test_int8_to_bf16_conversion_is_exact_for_every_byte():
    """Every int8 value at each of the four byte positions of a word: the
    magic-number conversion gives exactly the int8's value in bf16."""
    vals = np.arange(-128, 128, dtype=np.int8)
    words = np.concatenate([np.roll(vals, r) for r in range(4)])
    w = words.view(np.uint32)                       # little-endian bytes
    lo, hi = i8x4_to_bf16(w)
    b = words.reshape(-1, 4).astype(np.float32)
    got = np.stack([_bf16_bits_to_f32(lo & np.uint32(0xFFFF)),
                    _bf16_bits_to_f32(hi & np.uint32(0xFFFF)),
                    _bf16_bits_to_f32(lo >> np.uint32(16)),
                    _bf16_bits_to_f32(hi >> np.uint32(16))], axis=1)
    np.testing.assert_array_equal(got, b)
    # and the bf16 bits are torch's own conversion's
    tb = torch.from_numpy(words).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(
        np.stack([lo & 0xFFFF, hi & 0xFFFF, lo >> 16, hi >> 16],
                 axis=1).reshape(-1).astype(np.uint16),
        tb.numpy().view(np.uint16))


def _compiled_attention_instantiations():
    """(C entry, D) of every attention_kernel the two C entries launch: the
    head dims the header's dispatch takes, for each entry's contract."""
    head = (CSRC / "int8_attention.cuh").read_text()
    run = head[head.index("int run(Args a"):]
    run = run[:run.index("\n}\n")]
    dims = {int(d) for d in re.findall(r"launch<(\d+), NORM_FIRST>", run)}
    got = set()
    for entry in ("decode_attention_int8", "verify_attention_int8"):
        src = (CSRC / f"{entry}.cu").read_text()
        assert re.search(r'#include "int8_attention.cuh"', src)
        assert len(re.findall(r"\brun<(?:true|false)>", src)) == 1, entry
        got |= {(entry, D) for D in dims}
    return got


def test_chip_smoke_attention_cases_reach_every_instantiation():
    """chip_smoke's K4 and K8 cases launch every attention_kernel
    instantiation (each head dim under each contract) and every G the
    C entries take, so the card holds each to its plain version."""
    cs = _chip_smoke()
    compiled = _compiled_attention_instantiations()
    assert len(compiled) == 8
    dims, groups = cs.attention_instantiations(
        vlm_config("phi3.5", stage="inference"))
    assert dims == compiled
    assert groups == {"decode_attention_int8": {1, 2, 4, 8},
                      "verify_attention_int8": {1, 2, 4, 8}}
    names = dict(cs.ATTENTION_CASES)
    # past the one-block caps, off the cluster's slot grid, masked chunks
    assert not _old_k4_fits(1, names["long"]["L"])
    assert not _old_k4_fits(8, names["g8_long"]["L"])
    v = dict(cs.VERIFY_CASES)
    assert not _old_k8_fits(1, 5, v["q5_long"]["L"], 96)
    assert not _old_k8_fits(4, 5, v["q20_long"]["L"], 128)
    assert names["g8_d64"]["holes"] and v["g8_d64"]["holes"]
    for kw in (names["g2_d32"], v["g2_d32"], names["g8_d64"]):
        G = kw["H"] // kw["Hkv"]
        plan = tda.attention_plan(kw["B"], kw["Hkv"], G, kw.get("S", 1),
                                  kw["L"], kw["D"])
        assert kw["L"] % plan.slots_per_block, kw
    assert v["empty"]["empty"] and v["window"]["window"]
    assert v["q40"]["H"] // v["q40"]["Hkv"] * v["q40"]["S"] > tda.ATTN_QG


def test_chip_smoke_sass_rules_for_the_int8_attention():
    """K8's instantiations must run mma.sync or wgmma and bulk or TMA
    copies, K4's bulk or TMA copies; the conversion check is not ruled."""
    cs = _chip_smoke()
    text = """
		Function : _ZN12_GLOBAL__N_116attention_kernelILi96ELb1EEEvNS_4ArgsE
        /*0000*/                   UBLKCP.S.G [UR4], [UR6], R5 ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
		Function : _ZN12_GLOBAL__N_116attention_kernelILi64ELb1EEEvNS_4ArgsE
        /*0000*/              @!P0 UBLKCP.S.G [UR4], [UR6], R5 ;
		Function : _ZN12_GLOBAL__N_114convert_kernelEPKjPji
        /*0000*/                   LOP3.LUT R0, R2, 0x7f007f, RZ, 0xc0, !PT ;
"""
    got = cs.sass_counts(text)
    k96 = got["16attention_kernelILi96ELb1EEE"]
    assert k96["UBLKCP"] == 1 and k96["HMMA"] == 1
    assert cs.sass_ok("libverify_attention_int8.so",
                      "16attention_kernelILi96ELb1EEE", k96) is True
    # no tensor-core op: refused for K8, enough for K4
    k64 = got["16attention_kernelILi64ELb1EEE"]
    assert k64["UBLKCP"] == 1
    assert cs.sass_ok("libverify_attention_int8.so",
                      "16attention_kernelILi64ELb1EEE", k64) is False
    assert cs.sass_ok("libdecode_attention_int8.so",
                      "16attention_kernelILi64ELb0EEE", k64) is True
    # no bulk or TMA copy: refused for both
    bare = dict(k96, UBLKCP=0)
    assert cs.sass_ok("libverify_attention_int8.so", "attention_kernel",
                      bare) is False
    assert cs.sass_ok("libdecode_attention_int8.so", "attention_kernel",
                      bare) is False
    assert cs.sass_ok("libdecode_attention_int8.so", "14convert_kernelE",
                      got["14convert_kernelE"]) is None
