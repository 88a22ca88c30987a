"""Rank bodies and shared inputs of the port's multi-process tests
(test_torch_parallel.py, test_torch_sharded_serving.py,
test_torch_async_checkpoint.py). Each ``*_rank(rank, world)`` runs inside
one rank of a gloo group started by
grounded_video_llm_tpu_torch.parallel.launch.spawn and returns plain data;
the test compares it with the same function run in one process. Nothing
here imports JAX, so the spawned ranks start quickly."""

from __future__ import annotations

import dataclasses
import os

import contextlib

import numpy as np
import torch

from grounded_video_llm_tpu_torch.core.config import (STAGE_PRESETS,
                                                      micro_vlm_config)
from grounded_video_llm_tpu_torch.models import llm as llm_mod
from grounded_video_llm_tpu_torch.models import vlm
from grounded_video_llm_tpu_torch.parallel import partitioning
from grounded_video_llm_tpu_torch.parallel.mesh import TENSOR_AXIS, build_mesh
from grounded_video_llm_tpu_torch.parallel.partitioning import (
    full_tree, gather, is_sharded, local, shard_params)
from grounded_video_llm_tpu_torch.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu_torch.train import lora as lora_mod
from grounded_video_llm_tpu_torch.train.optimizer import (make_optimizer,
                                                          tree_items)
from grounded_video_llm_tpu_torch.train.step import (create_train_state,
                                                     make_train_step,
                                                     shard_batch)

STEP_MESHES = ((1, 4, 1), (2, 1, 2), (1, 2, 2))
GREEDY = dict(do_sample=False, temperature=0.0, eos_token_id=-2,
              pad_token_id=0)


def micro_params(seed: int = 0, lora: bool = False):
    """micro_vlm_config("phi3.5") fp32 (the dry run's tree); with lora,
    rank-4 adapters whose B is drawn non-zero, so they act."""
    from grounded_video_llm_tpu_torch.cli.dryrun_multichip import \
        micro_params as dryrun_params

    cfg = micro_vlm_config("phi3.5")
    params = dryrun_params(cfg, seed)
    g = torch.Generator()
    g.manual_seed(seed + 1)
    if lora:
        ad = lora_mod.init_lora(cfg.llm, generator=g, rank=4, device="cpu")
        for la in ad.values():
            la["b"].normal_(0.0, 0.05, generator=g)
        params["llm"] = lora_mod.attach_lora(params["llm"], ad)
    return cfg, params


def step_batch(cfg, accum: int = 2, B: int = 4, S: int = 12, seed: int = 3):
    """A global [accum, B, ...] batch whose rows have different numbers of
    valid labels (so the per-rank counts differ) and one right-padded
    row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 50, size=(accum, B, S)).astype(np.int64)
    ids[..., 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    for a in range(accum):
        for b in range(B):
            labels[a, b, :2 + (a * B + b) % 7] = -100
    mask = np.ones((accum, B, S), np.int64)
    mask[:, -1, S - 3:] = 0
    labels[:, -1, S - 3:] = -100
    sp = (rng.normal(size=(accum, B, cfg.num_segs, 336, 336, 3)) * 0.5
          ).astype(np.float32)
    tp = (rng.normal(size=(accum, B, cfg.num_frames, 224, 224, 3)) * 0.5
          ).astype(np.float32)
    return vlm.Batch(torch.from_numpy(ids), torch.from_numpy(labels),
                     torch.from_numpy(mask), torch.from_numpy(sp),
                     torch.from_numpy(tp), torch.zeros(accum, B,
                                                       dtype=torch.bool))


def grounded_step(mesh=None):
    """One grounded-preset step (LoRA dropout 0, grad_accum 2) from
    micro_params(lora=True) on step_batch, at optimizer count 1 (at 0 the
    warmup's lr is 0 and nothing would move) → ((loss, grad_norm),
    state)."""
    cfg, params = micro_params(lora=True)
    stage = dataclasses.replace(STAGE_PRESETS["grounded"], lora_dropout=0.0)
    opt, _ = make_optimizer(stage, 100, params)
    state = create_train_state(params, opt, mesh=mesh, cfg=cfg)
    state.opt_state["count"] = 1
    batch = step_batch(cfg)
    if mesh is not None:
        batch = shard_batch(batch, mesh, grad_accum=2)
    step = make_train_step(cfg, opt, grad_accum=2, remat=False, mesh=mesh)
    state, m = step(state, batch)
    return (float(m["loss"]), float(m["grad_norm"])), state


def gather_grad_check(mesh):
    """A [4, 6] leaf split over fsdp (dim 0) and tensor (dim 1); gather()
    gives this rank's tensor columns, whole over fsdp, and each batch
    rank's loss weighs them by its own X. The gradient on this rank's shard
    must be the shard of the sum over batch ranks (DTensor's own
    full_tensor() would leave each rank its own term)."""
    w = torch.arange(24.0).reshape(4, 6)
    sp = shard_params({"llm": {"embed": w}}, mesh)["llm"]["embed"]
    sp.requires_grad_(True)
    f, t = mesh.coord["fsdp"], mesh.coord["tensor"]

    def x_of(r):
        x = torch.full((4, 6), float(r + 1)) + torch.arange(24.0).reshape(
            4, 6) * r
        return x.chunk(mesh.shape["tensor"], 1)[t]

    cols = gather(sp)
    loss = (cols * x_of(mesh.batch_rank)).sum()
    g = local(torch.autograd.grad(loss, [sp])[0])
    want = sum(x_of(r) for r in range(mesh.batch_ranks))
    want = want.chunk(mesh.shape["fsdp"], 0)[f]
    from grounded_video_llm_tpu_torch.parallel.tensor import tensor_group

    return {"placements": str(sp.placements),
            "columns": tuple(cols.shape),
            "tensor_group": mesh.tensor_group[:2] == tensor_group(sp)[:2]
            == (mesh.shape["tensor"], t),
            "err": float((g - want).abs().max())}


def parallel_rank(rank: int, world: int):
    """test_torch_parallel.py's group: the grounded step at each of
    STEP_MESHES (its gathers watched), the gather's gradient, and the dry
    run's three legs."""
    from grounded_video_llm_tpu_torch.cli.dryrun_multichip import run_legs

    out = {}
    for shape in STEP_MESHES:
        mesh = build_mesh(*shape)
        with watch_split({"split": 0, "whole": 0, "kv_heads": set()}) as seen:
            metrics, state = grounded_step(mesh)
        full = full_tree(state.params)
        out[shape] = {
            "metrics": metrics,
            "watch": seen,
            "sharded": {p: (tuple(local(t).shape), tuple(t.shape))
                        for p, t in tree_items(state.params)
                        if is_sharded(t)},
            "params": ({p: t.detach().clone() for p, t in tree_items(full)}
                       if rank == 0 else None)}
    out["gather"] = gather_grad_check(build_mesh(1, 2, 2))
    out["dryrun"] = run_legs(rank, world)
    return out


def hang_rank(rank: int, world: int):
    """Rank 1 skips the collective rank 0 waits in."""
    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.ones(1))
    return rank


# ---------------------------------------------------------------------------
# Serving on a sharded tree
# ---------------------------------------------------------------------------


def pixel_prompt(cfg, B=1, S=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 50, size=(B, S)).astype(np.int64)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return (torch.from_numpy(ids), torch.ones(B, S, dtype=torch.long),
            torch.zeros(B, cfg.num_segs, 336, 336, 3),
            torch.zeros(B, cfg.num_frames, 224, 224, 3))


@contextlib.contextmanager
def watch_split(seen):
    """Count, while it is open, the fsdp gathers of tensor-split leaves
    that gave a layer this rank's columns ("split") or the whole leaf
    ("whole"), and the kv heads of every cache made (seen["kv_heads"])."""
    gather_apply = partitioning._Gather.apply
    creates = {cls: cls.create for cls in (llm_mod.KVCache,
                                           llm_mod.QuantKVCache)}

    def apply(shard, dims):
        out = gather_apply(shard, dims)
        if TENSOR_AXIS in dims:
            d = dims[TENSOR_AXIS][0]
            seen["split" if out.shape[d] == shard.shape[d] else "whole"] += 1
        return out

    def create(cls):
        def make(*args, **kw):
            cache = creates[cls](*args, **kw)
            seen["kv_heads"].add(cache.k.shape[
                3 if cls is llm_mod.KVCache else 2])
            return cache
        return make

    partitioning._Gather.apply = apply
    for cls in creates:
        cls.create = create(cls)
    try:
        yield seen
    finally:
        partitioning._Gather.apply = gather_apply
        for cls, fn in creates.items():
            cls.create = fn


def generate_leg(cfg, params):
    from grounded_video_llm_tpu_torch.serve.generate import generate_tokens

    toks, _ = generate_tokens(params, cfg, *pixel_prompt(cfg), None,
                              max_new_tokens=3, **GREEDY)
    return toks.numpy()


def prefix_leg(cfg, params, shared: bool):
    from grounded_video_llm_tpu_torch.serve.generate import (
        build_prefix_kv, generate_tokens_from_prefix)

    rng = np.random.default_rng(2)
    pre_ids = torch.from_numpy(rng.integers(3, 50, size=(1, 3)))
    post_ids = torch.from_numpy(rng.integers(3, 50, size=(2, 5)))
    feats = torch.from_numpy((rng.normal(
        size=(1, cfg.num_video_tokens, cfg.llm.hidden_size)) * 0.05
        ).astype(np.float32))
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    hint = -(-(Sp + post_ids.shape[1] + 4) // 128) * 128
    k, v, pm = build_prefix_kv(params, cfg, pre_ids,
                               torch.ones_like(pre_ids), feats, hint)
    toks, _ = generate_tokens_from_prefix(
        params, cfg, post_ids, torch.ones_like(post_ids), k, v, pm, None,
        max_new_tokens=4, quantize_cache=True, shared_prefix=shared,
        **GREEDY)
    return toks.numpy()


def spec_leg(cfg, params):
    from grounded_video_llm_tpu_torch.serve.speculative import \
        generate_tokens_spec

    toks = generate_tokens_spec(params, cfg, *pixel_prompt(cfg), None,
                                max_new_tokens=4, draft_len=2, **GREEDY)[0]
    return toks.numpy()


def pool_requests(cfg, n=3, S=10):
    from grounded_video_llm_tpu_torch.serve.continuous import Request

    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(n):
        ids = rng.integers(3, 50, size=(S,)).astype(np.int64)
        ids[2] = IMAGE_TOKEN_INDEX
        reqs.append(Request(
            input_ids=ids, attn_mask=np.ones((S,), np.int64),
            spatial_pixels=(rng.normal(size=(cfg.num_segs, 336, 336, 3))
                            * 0.1).astype(np.float32),
            temporal_pixels=(rng.normal(size=(cfg.num_frames, 224, 224, 3))
                             * 0.1).astype(np.float32)))
    return reqs


def pool_leg(cfg, params, **kw):
    from grounded_video_llm_tpu_torch.serve.continuous import \
        ContinuousServer

    max_new = 4 if kw.get("spec_draft_len") else 5
    server = ContinuousServer(params, cfg, pool_size=2, prompt_len=10,
                              max_new_tokens=max_new, chunk=2, eos_token_id=2,
                              pad_token_id=0, **kw)
    return [np.asarray(t) for t in server.serve(pool_requests(cfg))]


SERVING_MESHES = ((1, 4, 1), (1, 2, 2))


def serving_legs(cfg, params):
    """Every serving leg of test_torch_sharded_serving.py on one tree."""
    return {"generate": generate_leg(cfg, params),
            "prefix": prefix_leg(cfg, params, shared=False),
            "prefix_shared": prefix_leg(cfg, params, shared=True),
            "spec": spec_leg(cfg, params),
            "pool": pool_leg(cfg, params),
            "pool_spec": pool_leg(cfg, params, spec_draft_len=2)}


def serving_rank(rank: int, world: int):
    """test_torch_sharded_serving.py's group: greedy generate on each of
    SERVING_MESHES, every leg on the (1, 2, 2) mesh, with the gathers and
    caches of each mesh watched (watch_split)."""
    cfg, params = micro_params()
    out = {}
    for shape in SERVING_MESHES:
        sharded = shard_params(params, build_mesh(*shape), cfg)
        out[shape] = {"qkv_sharded": is_sharded(
            sharded["llm"]["layers"]["qkv_kernel"])}
        with watch_split({"split": 0, "whole": 0, "kv_heads": set()}) as seen:
            if shape == (1, 2, 2):
                out[shape].update(serving_legs(cfg, sharded))
            else:
                out[shape]["generate"] = generate_leg(cfg, sharded)
        out[shape]["watch"] = seen
    return out


# ---------------------------------------------------------------------------
# Asynchronous checkpoints
# ---------------------------------------------------------------------------


class InMemoryGrounded:
    """n samples of random pixels and one rendered conversation (what the
    dataset mixes yield, without a video): by default a grounded one with
    time tokens and the grounding mark, as MixGrounded gives."""

    def __init__(self, cfg, n=4, seed=0, conv=None):
        from grounded_video_llm_tpu_torch.text import codec
        from grounded_video_llm_tpu_torch.text.templates import get_template

        rng = np.random.default_rng(seed)
        if conv is None:
            conv = codec.mark_grounding_conversations([
                {"from": "human", "value": "<image>\nWhen does the car "
                 "appear?"},
                {"from": "gpt", "value": "From <12> to <85>."}])
        text = get_template("phi3.5").encode(conv)
        self.items = [{
            "video_ids": f"v{i}", "text_inputs": text,
            "temporal_pixel_values": (rng.normal(size=(
                cfg.num_frames, 224, 224, 3)) * 0.5).astype(np.float32),
            "spatial_pixel_values": (rng.normal(size=(
                cfg.num_segs, 336, 336, 3)) * 0.5).astype(np.float32)}
            for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def resume_check(run_dir: str, mesh=None, global_batch: int = 1):
    """Three steps of one epoch with an asynchronous interval save at step
    2 and a blocking save of the same state (from on_step, which runs just
    before the interval save); one fresh strategy resumed from each runs
    step 3. → whether the two resumed states and the uninterrupted run's
    are bit-equal, the three step-3 losses, the steps, and the seconds the
    loop blocked on the interval save."""
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import STAGE_PRESETS as P
    from grounded_video_llm_tpu_torch.text.tokenizer import \
        build_test_tokenizer
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    cfg = micro_vlm_config("phi3.5")
    orig = P["grounded"]
    P["grounded"] = dataclasses.replace(
        orig, global_batch_size=global_batch, per_device_batch_size=1,
        epochs=1)
    # the CPU embedding backward otherwise adds a token's repeated rows in
    # an order that depends on the threads, which moves the last bit of
    # the embedding's gradient from one run of the same step to the next
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # 3 steps; on 4 ranks 14 samples, which shard 4, 4, 3, 3
        ds = InMemoryGrounded(cfg, n=3 * global_batch + global_batch // 2)

        def make(name):
            return TrainingStrategy(
                cfg, "grounded", build_params(cfg, "cpu", torch.float32, 0),
                build_test_tokenizer("phi3.5"),
                run_dir=os.path.join(run_dir, name), mesh=mesh,
                n_train_examples=len(ds))

        def run(strategy, **kw):
            losses = []
            strategy.run_training(
                ds, on_step=lambda step, m: losses.append(m["loss"]), **kw)
            return losses

        s = make("a")

        def on_step(step, m):
            if step == 2:
                s.save_checkpoint("blocking", block=True)

        s.run_training(ds, resume_interval=0.7, on_step=on_step)
        last = s.metrics.loss_window[-1]
        runs = [(s, [last])]
        for tag in ("latest", "blocking"):
            r = make("from_" + tag)
            runs.append((r, run(r, resume_from=os.path.join(
                run_dir, "a", f"state_{tag}.pt"), resume_interval=0)))

        def equal(x, y):
            return (all(torch.equal(local(a), local(b)) for (_, a), (_, b)
                        in zip(tree_items(x.state.params),
                               tree_items(y.state.params)))
                    and all(torch.equal(x.state.opt_state[k][p],
                                        y.state.opt_state[k][p])
                            for k in ("mu", "nu")
                            for p in x.state.opt_state[k]))

        return {"n_samples": len(ds),
                "equal": [equal(runs[0][0], r) for r, _ in runs[1:]],
                "losses": [lo for _, lo in runs],
                "steps": [r.state.step for r, _ in runs],
                "blocked_s": list(s.save_blocked_s)}
    finally:
        P["grounded"] = orig
        torch.use_deterministic_algorithms(deterministic)


def export_dumps(workdir: str, mesh=None):
    """models/export.write_weight_dumps of micro_params(lora=True), from
    the tree sharded on mesh and gathered back by full_tree (rank 0
    writes), or from the tree itself → {file: {name: tensor}}."""
    from grounded_video_llm_tpu_torch.models.export import \
        write_weight_dumps

    cfg, params = micro_params(lora=True)
    if mesh is not None:
        params = full_tree(shard_params(params, mesh, cfg))
        if any(mesh.coord.values()):
            return None
    write_weight_dumps(params, cfg, workdir)
    out = {}
    for root, _, files in os.walk(workdir):
        for f in files:
            path = os.path.join(root, f)
            out[os.path.relpath(path, workdir)] = torch.load(
                path, weights_only=True)
    return out


def checkpoint_rank(rank: int, world: int, run_dir: str):
    """test_torch_async_checkpoint.py's group: resume_check on a (1, 4, 1)
    mesh (global batch 4: one row a rank and step; 14 samples, so the
    ranks' shards differ in size), and export_dumps from a (1, 2, 2)
    mesh."""
    out = resume_check(run_dir, mesh=build_mesh(1, 4, 1), global_batch=4)
    out["export"] = export_dumps(os.path.join(run_dir, "export"),
                                 build_mesh(1, 2, 2))
    return out
