"""Each ported module against its JAX function on the CPU, fp32, micro config
(rtol 2e-4, the repo's per-module bar). Inputs come from numpy seeds and the
weights from the JAX init through the weight bridge, so both packages compute
the same function.

On the CPU the JAX models attend through xla_mha, the port through the flash
kernel's plain version. The two differ only on query rows with no valid key
(left-padding rows): xla_mha averages every value there, the flash
convention emits zeros. Valid rows never read those rows' outputs, so the
logits agree; the cache comparisons below cover the valid slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import (micro_vlm_config,
                                                phi35_mini_config, replace)
from grounded_video_llm_tpu.models import clip_vit as jclip
from grounded_video_llm_tpu.models import internvideo2 as jiv2
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.ops import normalization as jnorm
from grounded_video_llm_tpu.ops import rope as jrope
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu_torch.models import clip_vit as tclip
from grounded_video_llm_tpu_torch.models import internvideo2 as tiv2
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops import normalization as tnorm
from grounded_video_llm_tpu_torch.ops import rope as trope

RTOL, ATOL = 2e-4, 2e-5


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(t).detach().numpy(),
                               np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def model():
    cfg = micro_vlm_config("phi3.5")
    jparams = jvlm.init_params(jax.random.key(0), cfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, "cpu")
    return cfg, jparams, tparams


def _rng_pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def test_rms_norm_layer_norm_layer_scale():
    x_t, x_j = _rng_pair((3, 7, 48), 0)
    w_t, w_j = _rng_pair((48,), 1)
    b_t, b_j = _rng_pair((48,), 2)
    close(tnorm.rms_norm(x_t, w_t, 1e-6), jnorm.rms_norm(x_j, w_j, 1e-6))
    close(tnorm.layer_norm(x_t, w_t, b_t), jnorm.layer_norm(x_j, w_j, b_j))
    close(tnorm.layer_scale(x_t, w_t * 1e-3),
          jnorm.layer_scale(x_j, w_j * 1e-3))


@pytest.mark.parametrize("hint", [4000, 5000], ids=["short", "long"])
def test_longrope_tables_and_rotation(hint):
    """Phi-3.5 LongRoPE: the factor set follows seq_len_hint (short up to
    original_max_position_embeddings=4096, long beyond), with mscale."""
    cfg = phi35_mini_config()
    pos = np.random.default_rng(hint).integers(0, 6000, size=(2, 16))
    cos_t, sin_t = trope.llm_rope_tables(cfg, torch.from_numpy(pos), hint)
    cos_j, sin_j = jrope.llm_rope_tables(cfg, jnp.asarray(pos), hint)
    close(cos_t, cos_j)
    close(sin_t, sin_j)
    q_t, q_j = _rng_pair((2, 16, 4, cfg.head_dim), 5)
    k_t, k_j = _rng_pair((2, 16, 4, cfg.head_dim), 6)
    for a, b in zip(trope.apply_rope(q_t, k_t, cos_t, sin_t),
                    jrope.apply_rope(q_j, k_j, cos_j, sin_j)):
        close(a, b)


def test_clip_features(model):
    cfg, jp, tp = model
    x_t, x_j = _rng_pair((2, 336, 336, 3), 10)
    out_t = tclip.features(tp["clip"], cfg.clip, x_t)
    assert out_t.shape == (2, cfg.clip.num_patches, cfg.clip.hidden_size)
    close(out_t, jclip.features(jp["clip"], cfg.clip, x_j))


def test_internvideo2_features(model):
    cfg, jp, tp = model
    x_t, x_j = _rng_pair((2, cfg.video.num_frames, 224, 224, 3), 11)
    out_t = tiv2.features(tp["video_encoder"], cfg.video, x_t)
    assert out_t.shape == (2, cfg.video.seq_len, cfg.video.embed_dim)
    close(out_t, jiv2.features(jp["video_encoder"], cfg.video, x_j))


def test_encode_video_uint8(model):
    cfg, jp, tp = model
    rng = np.random.default_rng(12)
    sp = rng.integers(0, 256, (1, cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tmp = rng.integers(0, 256, (1, cfg.num_frames, 224, 224, 3),
                       dtype=np.uint8)
    out_t = tvlm.encode_video(tp, cfg, torch.from_numpy(sp),
                              torch.from_numpy(tmp))
    out_j = jvlm.encode_video(jp, cfg, jnp.asarray(sp), jnp.asarray(tmp))
    assert out_t.shape == (1, cfg.num_video_tokens, cfg.llm.hidden_size)
    close(out_t, out_j)


def _prompt_batch(cfg, seed, S=12):
    """Two left-padded rows (3 pads in row 1), one image slot each."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 300, size=(2, S)).astype(np.int32)
    mask = np.ones((2, S), np.int32)
    ids[0, 4] = IMAGE_TOKEN_INDEX
    ids[1, 6] = IMAGE_TOKEN_INDEX
    mask[1, :3] = 0
    return ids, mask


def test_splice_multimodal_with_text_only_row(model):
    cfg, jp, tp = model
    ids, mask = _prompt_batch(cfg, 13)
    labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids).astype(np.int32)
    feats = np.random.default_rng(14).normal(
        size=(2, 20, cfg.llm.hidden_size)).astype(np.float32)
    is_text = np.array([False, True])
    out_t = tvlm.splice_multimodal(
        torch.from_numpy(ids).long(), torch.from_numpy(labels).long(),
        torch.from_numpy(mask).long(), torch.from_numpy(feats),
        tp["llm"]["embed"], torch.from_numpy(is_text))
    out_j = jvlm.splice_multimodal(
        jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(feats), jp["llm"]["embed"], jnp.asarray(is_text))
    close(out_t[0], out_j[0])
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    # the text-only row attends none of its appended video tokens
    assert int(out_t[2][1, -20:].sum()) == 0


@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
def test_prefill_and_decode_step(model, window):
    cfg, jp, tp = model
    lcfg = replace(cfg.llm, sliding_window=window)
    B, S, D = 2, 24, lcfg.hidden_size
    emb_t, emb_j = _rng_pair((B, S, D), 15, scale=0.5)
    mask = np.ones((B, S), np.int32)
    mask[1, :5] = 0
    max_len = 32

    lj, cj = jllm.prefill(jp["llm"], lcfg, emb_j, jnp.asarray(mask),
                          jllm.KVCache.create(lcfg, B, max_len, jnp.float32))
    lt, ct = tllm.prefill(tp["llm"], lcfg, emb_t, torch.from_numpy(mask),
                          tllm.KVCache.create(lcfg, B, max_len,
                                              torch.float32))
    close(lt, lj)
    valid = np.zeros((B, max_len), bool)
    valid[:, :S] = mask > 0
    for a, b in ((ct.k, cj.k), (ct.v, cj.v)):
        close(a.numpy()[:, valid], np.asarray(b)[:, valid])
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))

    tok_t, tok_j = _rng_pair((B, 1, D), 16, scale=0.5)
    pos = mask.sum(-1).astype(np.int32)
    lj2, cj2, vj2 = jllm.decode_step(jp["llm"], lcfg, tok_j, cj,
                                     jnp.asarray(valid), jnp.asarray(pos))
    lt2, ct2, vt2 = tllm.decode_step(tp["llm"], lcfg, tok_t, ct,
                                     torch.from_numpy(valid),
                                     torch.from_numpy(pos))
    close(lt2, lj2)
    np.testing.assert_array_equal(vt2.numpy(), np.asarray(vj2))
    for a, b in ((ct2.k, cj2.k), (ct2.v, cj2.v)):
        close(a.numpy()[:, :, S], np.asarray(b)[:, :, S])


def test_longrope_factor_set_follows_cache_capacity():
    """Prefill picks the LongRoPE factors from the cache capacity and decode
    from max_len, as the JAX package does: a short prompt in a cache larger
    than original_max_position_embeddings runs the long factors."""
    lcfg = replace(phi35_mini_config(), hidden_size=192, intermediate_size=64,
                   num_layers=1, num_heads=2, num_kv_heads=2, vocab_size=64,
                   sliding_window=None)
    jp = jllm.init_params(jax.random.key(2), lcfg)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    B, S = 1, 8
    emb_t, emb_j = _rng_pair((B, S, lcfg.hidden_size), 17, scale=0.5)
    tok_t, tok_j = _rng_pair((B, 1, lcfg.hidden_size), 18, scale=0.5)
    mask = np.ones((B, S), np.int32)
    outs = []
    for max_len in (128, 4224):                 # short, long factor sets
        lj, cj = jllm.prefill(jp, lcfg, emb_j, jnp.asarray(mask),
                              jllm.KVCache.create(lcfg, B, max_len,
                                                  jnp.float32))
        lt, ct = tllm.prefill(tp, lcfg, emb_t, torch.from_numpy(mask),
                              tllm.KVCache.create(lcfg, B, max_len,
                                                  torch.float32))
        close(lt, lj)
        valid = np.zeros((B, max_len), bool)
        valid[:, :S] = True
        pos = np.full((B,), S, np.int32)
        lj2, _, _ = jllm.decode_step(jp, lcfg, tok_j, cj, jnp.asarray(valid),
                                     jnp.asarray(pos))
        lt2, _, _ = tllm.decode_step(tp, lcfg, tok_t, ct,
                                     torch.from_numpy(valid),
                                     torch.from_numpy(pos))
        close(lt2, lj2)
        outs.append(lt2)
    assert not torch.allclose(outs[0], outs[1])   # the factor sets differ


def test_decode_step_rejects_active_rows(model):
    cfg, _, tp = model
    cache = tllm.KVCache.create(cfg.llm, 1, 8, torch.float32)
    with pytest.raises(NotImplementedError):
        tllm.decode_step(tp["llm"], cfg.llm,
                         torch.zeros(1, 1, cfg.llm.hidden_size), cache,
                         torch.ones(1, 8, dtype=torch.bool),
                         torch.zeros(1, dtype=torch.int32),
                         active=torch.ones(1, dtype=torch.bool))
