"""Serving on a sharded tree: the port's counterparts of the JAX package's
tests/test_sharded_inference.py and tests/test_sharded_continuous.py at
world size 4 (one group of 4 gloo ranks, spawned once for the module). The
output of parallel/partitioning.shard_params goes unchanged through
generate_tokens (meshes (1, 4, 1) and (1, 2, 2)), the prefix route with
the int8 cache (plain and shared-prefix), speculative generation and the
ContinuousServer pool (plain and speculative) on the (1, 2, 2) mesh, where
each rank computes its own heads and MLP columns; the greedy tokens of
every rank equal the single-process tokens on the unsharded tree exactly,
no layer reads a tensor-split leaf whole and every KV cache holds the
rank's num_kv_heads / tensor heads."""

import numpy as np
import pytest
import torch_mesh_ranks as ranks
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu_torch.parallel.launch import spawn

LEGS = ("generate", "prefix", "prefix_shared", "spec", "pool", "pool_spec")


@pytest.fixture(scope="module")
def group():
    return spawn(ranks.serving_rank, 4, timeout=180.0)


@pytest.fixture(scope="module")
def single():
    cfg, params = ranks.micro_params()
    return ranks.serving_legs(cfg, params)


def _equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", ranks.SERVING_MESHES)
def test_sharded_generate_matches_single_process(group, single, shape):
    for r in group:
        assert r[shape]["qkv_sharded"]
        _equal(r[shape]["generate"], single["generate"])


@pytest.mark.parametrize("shape", ranks.SERVING_MESHES)
def test_layers_read_shards_and_caches_hold_local_heads(group, shape):
    cfg, _ = ranks.micro_params()
    t = shape[2]
    for r in group:
        seen = r[shape]["watch"]
        assert seen["whole"] == 0
        assert (seen["split"] > 0) == (t > 1)
        assert seen["kv_heads"] == {cfg.llm.num_kv_heads // t}


@pytest.mark.parametrize("leg", LEGS[1:])
def test_sharded_serving_matches_single_process(group, single, leg):
    """prefix (plain and shared-prefix cascade), speculative, and the
    continuous pool (plain and speculative) over fsdp=2 x tensor=2."""
    for r in group:
        _equal(r[(1, 2, 2)][leg], single[leg])
