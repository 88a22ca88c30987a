"""The port's multi-device layer (grounded_video_llm_tpu_torch/parallel,
the mesh half of train/step.py) on the CPU: the partition specs against
the JAX package's leaf for leaf; one group of 4 gloo ranks (spawned once
for the module) running a grounded-preset step (grad_accum 2, LoRA
dropout 0, at optimizer count 1 so that it moves the parameters) at
meshes (1, 4, 1), (2, 1, 2) and (1, 2, 2) with genuinely sharded leaves,
the last two computing split over 'tensor' (no layer reads a
tensor-split leaf whole), held to the single-process step (loss,
grad_norm and every parameter within rtol 2e-4, atol 1e-6, fp32), the
gather's gradient summed over the batch ranks, and dryrun_multichip's
three legs; that
single-process step against the JAX make_train_step on the same weights
and batch (tests/test_train.py's step bar); a hung rank failing its group
within the collective timeout; the sampler giving every rank the same
number of batches; initialize_distributed's single-process and failure
paths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks
from torch_threads import one_thread  # noqa: F401
from torch.distributed.tensor import Replicate, Shard

from grounded_video_llm_tpu.core.config import STAGE_PRESETS, micro_vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grounded_video_llm_tpu.parallel.partitioning import param_specs
from grounded_video_llm_tpu.train import lora as jlora
from grounded_video_llm_tpu.train import optimizer as jopt
from grounded_video_llm_tpu.train import step as jstep
from grounded_video_llm_tpu_torch.data.loader import ShardedSampler
from grounded_video_llm_tpu_torch.parallel import mesh as tmesh
from grounded_video_llm_tpu_torch.parallel import partitioning as tpart
from grounded_video_llm_tpu_torch.parallel.launch import spawn
from grounded_video_llm_tpu_torch.train.optimizer import tree_items

RTOL, ATOL = 2e-4, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6      # tests/test_train.py's step bar


@pytest.fixture(scope="module")
def group():
    """Every rank's results of torch_mesh_ranks.parallel_rank on 4
    ranks."""
    return spawn(ranks.parallel_rank, 4, timeout=240.0)


@pytest.fixture(scope="module")
def single():
    """The same step in this process, no mesh."""
    metrics, state = ranks.grounded_step()
    return metrics, {p: t.detach() for p, t in tree_items(state.params)}


def _jax_grounded_step():
    """torch_mesh_ranks.grounded_step through the JAX package: the same
    weights (the port's tree as jnp arrays: the two trees have the same
    paths and shapes), the same batch, every optax count at 1."""
    cfg = micro_vlm_config("phi3.5")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                ranks.micro_params(lora=True)[1])
    stage = dataclasses.replace(STAGE_PRESETS["grounded"], lora_dropout=0.0)
    tx, labels = jopt.make_optimizer(stage, total_steps=100, params=jp)
    step = jstep.make_train_step(cfg, tx, grad_accum=2, remat=False,
                                 trainable_mask=jopt.trainable_mask(labels),
                                 lora_dropout=0.0)
    state = jstep.create_train_state(jp, tx)
    state = state._replace(opt_state=jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.ones_like(x) if getattr(path[-1], "name", None)
                         == "count" else x), state.opt_state))
    tb = ranks.step_batch(micro_vlm_config("phi3.5"))
    jb = jvlm.Batch(*(jnp.asarray(x.numpy().astype(np.int32)
                                  if x.dtype == torch.int64 else x.numpy())
                      for x in tb))
    state, m = step(state, jb)
    return ((float(m["loss"]), float(m["grad_norm"])),
            {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
             for path, x in jax.tree_util.tree_flatten_with_path(
                 state.params)[0]})


def test_single_process_step_matches_jax(single):
    """The reference the sharded steps are held to, against JAX on the same
    inputs (ragged label counts, a right-padded row, grad_accum 2)."""
    (metrics, params), (want_metrics, want) = single, _jax_grounded_step()
    np.testing.assert_allclose(metrics, want_metrics, rtol=STEP_RTOL)
    assert set(params) == set(want)
    for p, t in params.items():
        np.testing.assert_allclose(t.numpy(), want[p], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=p)


@pytest.mark.parametrize("shape", [(1, 4, 1), (2, 1, 2), (1, 2, 2),
                                   (2, 2, 2)])
def test_specs_match_jax(shape):
    """spec_for on every leaf of the micro tree with LoRA (rank 8) equals
    the JAX package's PartitionSpec on the same mesh shape."""
    cfg = micro_vlm_config("phi3.5")

    def init(key):
        p = jvlm.init_params(key, cfg)
        p["llm"] = jlora.attach_lora(
            p["llm"], jlora.init_lora(key, cfg.llm, rank=8))
        return p

    jp = jax.eval_shape(init, jax.random.key(0))      # shapes only
    n = int(np.prod(shape))
    jmesh = jbuild_mesh(jax.devices()[:n], *shape)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                param_specs(jp, jmesh),
                is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    got = dict(tree_items(tpart.param_specs(
        jax.tree_util.tree_map(lambda x: torch.empty(x.shape, device="meta"),
                               jp), dict(zip(tmesh.MESH_AXES, shape)))))
    assert got == want
    assert any(any(ax is not None for ax in s) for s in got.values())
    # placements: one per mesh axis, Shard(d) where the spec names it
    pl = tpart.placements(got["llm/layers/qkv_kernel"])
    assert len(pl) == 3
    assert (pl[1].is_shard(1) if shape[1] > 1 else pl[1].is_replicate())
    assert tmesh.batch_spec() == (Shard(0), Shard(0), Replicate())
    assert tmesh.replicated() == (Replicate(),) * 3


def test_int8_leaves_stay_replicated():
    """Int8Weight and Int8Embedding leaves match no rule: their spec is
    replicated where the bf16 leaf at the same path is split."""
    from grounded_video_llm_tpu_torch.serve.quantize import \
        quantize_llm_for_serving

    _, params = ranks.micro_params()
    sizes = {"data": 1, "fsdp": 2, "tensor": 2}
    dense = tpart.param_specs(params, sizes)["llm"]
    int8 = tpart.param_specs(
        {"llm": quantize_llm_for_serving(params["llm"], w8a8=True)},
        sizes)["llm"]
    for path in ("embed", "lm_head"):
        assert dense[path] != () and int8[path] == ()
    for name in ("qkv_kernel", "o_kernel", "gate_up_kernel", "down_kernel"):
        assert dense["layers"][name] != ()
        assert int8["layers"][name] == ()


@pytest.mark.parametrize("shape", ranks.STEP_MESHES)
def test_sharded_step_matches_single_process(group, single, shape):
    metrics, params = single
    got = group[0][shape]
    for r in group:
        assert r[shape]["metrics"] == got["metrics"]
    np.testing.assert_allclose(got["metrics"], metrics, rtol=RTOL)
    assert set(got["params"]) == set(params)
    for p, t in params.items():
        np.testing.assert_allclose(got["params"][p].numpy(), t.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=p)
    moved = sum(not torch.equal(got["params"][p], t0) for p, t0 in
                tree_items(ranks.micro_params(lora=True)[1]))
    assert moved == 2 * 4 + 2 * 4 + 2     # every trainable leaf


@pytest.mark.parametrize("shape,want", [
    ((1, 4, 1), {"llm/layers/qkv_kernel": (2, 16, 192),
                 "llm/layers/lora/qkv/a": (2, 16, 4),
                 "video_projector/fc1/kernel": (16, 64)}),
    ((2, 1, 2), {"llm/layers/qkv_kernel": (2, 64, 96),
                 "llm/embed": (814, 32), "llm/lm_head": (32, 814),
                 "clip/layers/o/kernel": (2, 16, 32)}),
    ((1, 2, 2), {"llm/layers/qkv_kernel": (2, 32, 96),
                 "llm/layers/gate_up_kernel": (2, 32, 128),
                 "llm/embed": (407, 32), "llm/lm_head": (32, 407),
                 "video_encoder/blocks/qkv_kernel": (2, 32, 96)})])
def test_step_leaves_are_sharded(group, shape, want):
    """The leaves are DTensors holding a part of the leaf on each rank."""
    sharded = group[0][shape]["sharded"]
    for p, local_shape in want.items():
        assert sharded[p][0] == local_shape, p
    assert all(np.prod(loc) < np.prod(full) for loc, full in
               sharded.values())


def test_gather_gradient_sums_over_batch_ranks(group):
    for r in group:
        assert r["gather"]["err"] == 0.0
        assert r["gather"]["columns"] == (4, 3)    # the tensor split stays
        assert r["gather"]["tensor_group"]
    assert "Shard(dim=0)" in group[0]["gather"]["placements"]


@pytest.mark.parametrize("shape", [s for s in ranks.STEP_MESHES
                                   if s[2] > 1])
def test_split_step_reads_tensor_shards(group, shape):
    """On a mesh with tensor 2 every fsdp gather of a tensor-split leaf
    (each LLM, InternVideo2 and CLIP layer, the embedding and the
    lm_head) gave the layer this rank's shard, never the whole leaf."""
    for r in group:
        seen = r[shape]["watch"]
        assert seen["whole"] == 0 and seen["split"] > 0, seen


def test_dryrun_multichip_legs(group):
    """dryrun_multichip(4)'s legs on the same group: mesh (2, 1, 2), the
    grounded step finite and equal on every rank, sharded generate and the
    continuous pool equal to single-process greedy (each rank checks)."""
    r0 = group[0]["dryrun"]
    assert r0["mesh"] == {"data": 2, "fsdp": 1, "tensor": 2}
    assert r0["train"]["sharded_leaves"] > 0
    assert len({(r["dryrun"]["train"]["loss"],
                 r["dryrun"]["train"]["grad_norm"]) for r in group}) == 1
    assert len(r0["generate"]) == 4 and len(r0["pool"]) == 4


def test_hung_rank_fails_within_its_timeout():
    import time

    t0 = time.monotonic()
    with pytest.raises(Exception):
        spawn(ranks.hang_rank, 2, timeout=60.0, collective_timeout=2.0)
    assert time.monotonic() - t0 < 45.0


@pytest.mark.parametrize("n", [10, 14, 16])
def test_sampler_gives_every_rank_the_same_batches(n):
    """4 shards of batch 1 over n samples: n // 4 batches on every shard
    (10 samples split 3, 3, 2, 2 would otherwise give two ranks a step the
    others never join), disjoint rows."""
    plans = [ShardedSampler(n, 1, seed=3, num_shards=4,
                            shard_id=r).epoch_indices(1) for r in range(4)]
    assert [p.shape for p in plans] == [(n // 4, 1)] * 4
    rows = np.concatenate(plans).ravel()
    assert len(set(rows.tolist())) == len(rows)


def test_initialize_distributed(monkeypatch):
    for v in tmesh.TORCHRUN_VARS + ("MASTER_PORT",):
        monkeypatch.delenv(v, raising=False)
    assert tmesh.initialize_distributed() is False
    assert tmesh.process_info() == (0, 1)
    # torchrun variables set but no address to reach: the run meant to be
    # distributed, so it raises instead of training alone
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(Exception):
        tmesh.initialize_distributed(timeout=5.0)
    assert tmesh.process_info() == (0, 1)
