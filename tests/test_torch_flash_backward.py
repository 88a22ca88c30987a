"""The port's flash backward (plain version on CPU) against the JAX
_flash_bwd in Pallas interpret mode, on the same q, k, v, bias, o, lse and
do (o and lse from the JAX forward), and the autograd FlashAttention against
jax.grad of the JAX flash_mha. fp32, at the JAX package's backward bar
(rtol 1e-3, atol 1e-4, tests/test_flash_attention.py)."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.ops.flash_attention import (_flash_bwd,
                                                        _flash_fwd)
from grounded_video_llm_tpu.ops.flash_attention import (
    flash_mha as jax_flash_mha)
from grounded_video_llm_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 1e-3, 1e-4

# (B, Sq, Sk, H, Hkv, D, causal, window, q_offset, pads, pad_side)
# pads: per batch row, how many keys the mask removes, on pad_side
CASES = {
    "causal_mha_128": (1, 128, 128, 2, 2, 16, True, None, None, (0,), "r"),
    "causal_gqa_128": (1, 128, 128, 2, 1, 16, True, None, None, (0,), "r"),
    "causal_mha_100": (1, 100, 100, 2, 2, 16, True, None, None, (0,), "r"),
    "causal_gqa_100": (1, 100, 100, 4, 2, 16, True, None, None, (0,), "r"),
    "noncausal_mha_128": (1, 128, 128, 2, 2, 16, False, None, None, (0,),
                          "r"),
    "noncausal_gqa_100": (1, 100, 100, 4, 2, 16, False, None, None, (0,),
                          "r"),
    "causal_window": (2, 100, 100, 2, 2, 16, True, 9, None, (0, 0), "r"),
    "causal_q_offset": (1, 40, 100, 2, 1, 16, True, None, 37, (0,), "r"),
    "causal_rightpad": (2, 100, 100, 4, 2, 16, True, None, None, (0, 23),
                        "r"),
    "noncausal_rightpad_d88": (2, 64, 64, 2, 2, 88, False, None, None,
                               (5, 17), "r"),
    "causal_leftpad_dead_rows": (2, 48, 48, 4, 4, 16, True, None, None,
                                 (0, 11), "l"),
}


def _inputs(B, Sq, Sk, H, Hkv, D, pads, side, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    mask = np.ones((B, Sk), np.int32)
    for b, n in enumerate(pads):
        if n and side == "l":
            mask[b, :n] = 0
        elif n:
            mask[b, Sk - n:] = 0
    bias = np.where(mask > 0, 0.0, fa.NEG_INF).astype(np.float32)
    return q, k, v, do, mask, bias


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("name", list(CASES))
def test_flash_bwd_matches_jax(name):
    (B, Sq, Sk, H, Hkv, D, causal, window, q_offset, pads,
     side) = CASES[name]
    q, k, v, do, _, bias = _inputs(B, Sq, Sk, H, Hkv, D, pads, side,
                                   seed=len(name))
    scale = D ** -0.5
    jq, jk, jv, jbias, jdo = map(jnp.asarray, (q, k, v, bias, do))
    o, lse = _flash_fwd(jq, jk, jv, jbias, scale, causal, window=window,
                        q_offset=q_offset)
    dq_j, dk_j, dv_j = _flash_bwd(jq, jk, jv, jbias, o, lse, jdo, scale,
                                  causal, window, q_offset)
    dq_t, dk_t, dv_t = fa.flash_bwd(_t(q), _t(k), _t(v), _t(bias), _t(o),
                                    _t(lse), _t(do), scale, causal, window,
                                    q_offset)
    assert dq_t.shape == q.shape and dk_t.shape == k.shape
    for got, want in ((dq_t, dq_j), (dk_t, dk_j), (dv_t, dv_j)):
        assert not torch.isnan(got).any()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    if side == "l":
        # rows with no valid key: lse = +inf, their dq exactly 0 in both
        dead = np.isposinf(np.asarray(lse))           # [B, H, Sq]
        assert dead.any()
        rows = dead.transpose(0, 2, 1)                # [B, Sq, H]
        assert np.all(dq_t.numpy()[rows] == 0.0)
        assert np.all(np.asarray(dq_j)[rows] == 0.0)


@pytest.mark.parametrize("causal,mask_rows", [(True, None), (False, None),
                                              (True, (0, 7)),
                                              (False, (3, 0))])
def test_autograd_matches_jax_grad(causal, mask_rows):
    """FlashAttention's gradients (through flash_mha) against jax.grad of
    the JAX flash_mha, a GQA case with a loss that weighs every output."""
    B, S, H, Hkv, D = 2, 37, 4, 2, 16
    q, k, v, w, _, _ = _inputs(B, S, S, H, Hkv, D, (0, 0), "r", seed=5)
    mask = None
    if mask_rows is not None:
        mask = np.ones((B, S), np.int32)
        for b, n in enumerate(mask_rows):
            mask[b, S - n:] = 0

    def jloss(q, k, v):
        out = jax_flash_mha(q, k, v, causal=causal,
                            mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w))

    g_j = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_mha(tq, tk, tv, causal=causal,
                       mask=None if mask is None else torch.from_numpy(mask))
    (out * _t(w)).sum().backward()
    for got, want in ((tq.grad, g_j[0]), (tk.grad, g_j[1]),
                      (tv.grad, g_j[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_no_grad_forward_is_the_plain_forward():
    """Without a gradient to take, flash_mha is flash_fwd alone: the same
    output, and no autograd graph."""
    q, k, v = (torch.randn(1, 20, 2, 16, requires_grad=True)
               for _ in range(3))
    with torch.no_grad():
        out = fa.flash_mha(q, k, v, causal=True)
    assert out.grad_fn is None
    ref, _ = fa.flash_fwd_reference(q.detach(), k.detach(), v.detach(), None,
                                    16 ** -0.5, True)
    assert torch.equal(out, ref)
    with_grad = fa.flash_mha(q, k, v, causal=True)
    assert with_grad.grad_fn is not None
    assert torch.equal(with_grad.detach(), ref)


REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_flash_bwd_cases_reach_every_instantiation():
    """chip_smoke's K7 cases launch every (head dim, causal) instantiation
    that gvllm_flash_bwd dispatches (parsed from csrc/flash_bwd.cu), so the
    card checks each against the plain version and its [sass] lines cover
    each."""
    src = (REPO / "grounded_video_llm_tpu_torch" / "csrc"
           / "flash_bwd.cu").read_text()
    body = src[src.index("cudaError_t dispatch("):]
    body = body[:body.index("\n}\n")]
    causal = {c == "true" for c in re.findall(r"launch<D, (true|false)>",
                                              body)}
    entry = src[src.index('extern "C" int gvllm_flash_bwd('):]
    dims = {int(d) for d in re.findall(r"\bdispatch<(\d+)>", entry)}
    compiled = {(d, c) for d in dims for c in causal}
    assert compiled == {(d, c) for d in (64, 88, 96, 128)
                        for c in (True, False)}
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.flash_bwd_instantiations() == compiled
