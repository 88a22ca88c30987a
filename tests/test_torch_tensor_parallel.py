"""Tensor-parallel compute's rank-local pieces, in one process with no
process group (the split layers themselves run in the 4-rank groups of
test_torch_parallel.py and test_torch_sharded_serving.py):

  * the head-aligned layout of the fused leaves (parallel/partitioning
    fused_blocks, parallel/tensor local_columns / unpermute_columns) for
    t in {2, 4} on micro_vlm_config: rank r holds q heads [rH/t, (r+1)H/t)
    and the matching k and v kv heads, gate block r then up block r, and
    InternVideo2's q, k, v heads alike; the ranks' columns put back are the
    leaf; the specs equal the JAX package's spec_for on a (1, 1, t) mesh;
  * the refusal where t does not divide the heads or MLP widths;
  * a row-split LoRA dropout mask equal to the slice of the mask the whole
    input draws;
  * the vocabulary-parallel cross entropy's rank-local steps (ce_*), run
    for t slices here, equal to causal_lm_loss_from_hidden in value
    (rtol 1e-6) and in d logits (rtol 1e-5, atol 1e-8), with a vocabulary
    that t does not divide.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grounded_video_llm_tpu.parallel.partitioning import \
    spec_for as jspec_for
from grounded_video_llm_tpu_torch.core.config import micro_vlm_config
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.parallel import partitioning as tpart
from grounded_video_llm_tpu_torch.parallel.tensor import (
    ce_local_grad, ce_local_logits, ce_local_sums, local_columns,
    unpermute_columns, vocab_shard)

FUSED = ("llm/layers/qkv_kernel", "llm/layers/gate_up_kernel",
         "video_encoder/blocks/qkv_kernel")


def _params(llm_name):
    cfg = micro_vlm_config(llm_name)
    g = torch.Generator()
    g.manual_seed(0)
    return cfg, tvlm.init_params(cfg, generator=g, device="cpu")


def _leaf(params, path):
    for k in path.split("/"):
        params = params[k]
    return params


def _heads(x, n, Dh):
    return x.reshape(*x.shape[:-1], n, Dh)


@pytest.mark.parametrize("llm_name,t", [("phi3.5", 2), ("phi3.5", 4),
                                        ("llama3", 2)])
def test_head_aligned_layout(llm_name, t):
    cfg, params = _params(llm_name)
    lc, vc = cfg.llm, cfg.video
    jmesh = jbuild_mesh(jax.devices()[:t], 1, 1, t)
    sizes = {"data": 1, "fsdp": 1, "tensor": t}
    # (path → per block: (heads or None, head dim or block width))
    layout = {FUSED[0]: [(lc.num_heads, lc.head_dim),
                         (lc.num_kv_heads, lc.head_dim),
                         (lc.num_kv_heads, lc.head_dim)],
              FUSED[1]: [(1, lc.intermediate_size)] * 2,
              FUSED[2]: [(vc.num_heads, vc.head_dim)] * 3}
    tpart.check_tensor_split(params, cfg, t)
    for path in FUSED:
        x = _leaf(params, path)
        spec = tpart.spec_for(path, tuple(x.shape), sizes)
        assert spec == tuple(jspec_for(path, tuple(x.shape), jmesh)), path
        assert spec[-1] == "tensor"
        blocks = tpart.fused_blocks(params, path)
        assert blocks == tuple(n * w for n, w in layout[path]), path
        shards = [local_columns(x, blocks, t, r) for r in range(t)]
        assert all(s.shape[-1] == x.shape[-1] // t for s in shards)
        assert torch.equal(unpermute_columns(torch.cat(shards, -1), blocks,
                                             t), x)
        parts = x.split(list(blocks), dim=-1)
        for r, s in enumerate(shards):
            mine = s.split([b // t for b in blocks], dim=-1)
            for (n, w), whole, got in zip(layout[path], parts, mine):
                if n == 1:          # gate / up: a contiguous column block
                    want = whole.chunk(t, dim=-1)[r]
                else:               # whole heads [rn/t, (r+1)n/t)
                    want = _heads(whole, n, w)[..., r * n // t:
                                               (r + 1) * n // t, :]
                    got = _heads(got, n // t, w)
                assert torch.equal(got, want), (path, r)
    # the row-split pairs keep JAX's contiguous rows: block r of o's input
    # is q head block r, of down's the gate/up block r
    for path in ("llm/layers/o_kernel", "llm/layers/down_kernel",
                 "video_encoder/blocks/proj/kernel"):
        x = _leaf(params, path)
        assert tpart.spec_for(path, tuple(x.shape), sizes)[-2] == "tensor"
        assert tpart.fused_blocks(params, path) is None


@pytest.mark.parametrize("llm_name,t,bad", [
    ("llama3", 4, "llm num_kv_heads 2"),
    ("phi3.5", 8, "llm num_heads 4")])
def test_tensor_split_refuses_a_split_head(llm_name, t, bad):
    """JAX drops (or cuts across heads with) a 'tensor' axis that does not
    divide the heads; the port's shard_params refuses with the numbers."""
    cfg, params = _params(llm_name)

    class Mesh:                          # the refusal comes before any
        shape = {"data": 1, "fsdp": 1, "tensor": t}   # communication

    with pytest.raises(ValueError, match=bad):
        tpart.shard_params(params, Mesh(), cfg)
    with pytest.raises(ValueError, match="pass the model config"):
        tpart.shard_params(params, Mesh())
    tpart.check_tensor_split(params, cfg, 1)
    wide = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_kv_heads=cfg.llm.num_heads))
    if llm_name == "llama3":         # MHA divides: the refusal was the GQA
        tpart.check_tensor_split(params, wide, t)


@pytest.mark.parametrize("t", [2, 4])
def test_row_split_dropout_mask_is_a_slice(t):
    rng = np.random.default_rng(1)
    W = 32
    x = torch.from_numpy(rng.normal(size=(2, 3, W)).astype(np.float32))
    want = tllm.lora_dropout(x, 0.3, 1234)
    n = W // t
    for r in range(t):
        got = tllm.lora_dropout(x[..., r * n:(r + 1) * n], 0.3, 1234,
                                cols=(W, r * n))
        assert torch.equal(got, want[..., r * n:(r + 1) * n])
    assert (want == 0).any() and (want != 0).any()


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_parallel_cross_entropy(t):
    """_VocabParallelCE's rank-local math for t ranks: each rank's hidden
    columns times its lm_head rows summed (the reduce-scatter's sum), the
    vocabulary padded to t·n and split, the maxima, sums of exponentials
    and target logits combined as the all-reduces combine them."""
    rng = np.random.default_rng(2)
    B, S, D, V = 2, 9, 16, 813
    hidden = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    head = torch.from_numpy((rng.normal(size=(D, V)) * 0.3)
                            .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, size=(B, S)))
    labels[0, :3] = -100
    labels[1, 5] = V - 1                  # a label in the last rank's part
    want = tllm.causal_lm_loss_from_hidden({"lm_head": head}, hidden, labels,
                                           chunk=4)

    d = D // t
    partial = [hidden[:, :-1, r * d:(r + 1) * d] @ head[r * d:(r + 1) * d]
               for r in range(t)]
    n = vocab_shard(V, t, 0)[0]
    full = torch.nn.functional.pad(sum(partial), (0, n * t - V))
    lab = labels[:, 1:]
    valid = lab != -100
    safe = torch.where(valid, lab, 0)
    local = [ce_local_logits(full[..., r * n:(r + 1) * n],
                             vocab_shard(V, t, r)[2]) for r in range(t)]
    assert torch.isinf(local[-1][..., -1]).all()   # padding at -inf
    row_max = torch.stack([lg.amax(-1) for lg in local]).amax(0)
    sums = [ce_local_sums(lg, safe, r * n, row_max)
            for r, lg in enumerate(local)]
    lse = row_max + torch.log(sum(s[0] for s in sums))
    ll = sum(s[1] for s in sums) - lse
    got = torch.where(valid, -ll, 0.0).sum() / valid.sum()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)

    logits = (hidden[:, :-1] @ head).requires_grad_(True)
    tllm.causal_lm_loss(torch.cat([logits, logits[:, :1]], 1),
                        labels).backward()
    g = torch.cat([ce_local_grad(lg, safe, r * n, lse)
                   for r, lg in enumerate(local)], -1)[..., :V]
    g = g * valid[..., None] / valid.sum()
    np.testing.assert_allclose(g.numpy(), logits.grad.numpy(), rtol=1e-5,
                               atol=1e-8)
