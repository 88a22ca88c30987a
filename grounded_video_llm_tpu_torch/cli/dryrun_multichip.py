"""Dry run of the multi-device layer on n gloo CPU ranks (the counterpart of
the root __graft_entry__.dryrun_multichip):

    python -m grounded_video_llm_tpu_torch.cli.dryrun_multichip 4

The mesh is JAX's for n: (data 2, fsdp n/4, tensor 2) when 4 divides n,
(2, n/2, 1) when 2 does, else (1, n, 1). On micro_vlm_config("phi3.5")
every rank runs three legs and checks them:
  * one grounded train step with LoRA (rank 8), grad_accum 2, remat and the
    stage's LoRA dropout, the parameters sharded by
    parallel/partitioning.shard_params and each rank on its rows of the
    batch, the two tensor ranks of a row computing their own heads and
    MLP columns: loss and grad_norm finite, the same on every rank;
  * greedy generate_tokens on the sharded tree equal to the unsharded
    tree's;
  * a 4-request ContinuousServer pool (2 slots) on the sharded tree equal
    to per-request greedy generate_tokens on the unsharded one.
Exits 0 when every rank passed; prints one line a leg from rank 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.config import STAGE_PRESETS, micro_vlm_config
from ..models import vlm
from ..parallel.launch import spawn
from ..parallel.mesh import build_mesh
from ..parallel.partitioning import is_sharded, shard_params
from ..text.templates import IMAGE_TOKEN_INDEX
from ..train import lora as lora_mod
from ..train.optimizer import make_optimizer, tree_items
from ..train.step import create_train_state, make_train_step, shard_batch


def mesh_shape(n: int):
    if n % 4 == 0:
        return 2, n // 4, 2
    if n % 2 == 0:
        return 2, n // 2, 1
    return 1, n, 1


def micro_params(cfg, seed: int = 0):
    g = torch.Generator()
    g.manual_seed(seed)
    return vlm.init_params(cfg, generator=g, device="cpu")


def _gen_kw(max_new: int):
    return dict(max_new_tokens=max_new, do_sample=False, temperature=0.0,
                eos_token_id=-2, pad_token_id=0)


def train_leg(mesh, cfg, n: int):
    params = micro_params(cfg)
    g = torch.Generator()
    g.manual_seed(1)
    params["llm"] = lora_mod.attach_lora(
        params["llm"], lora_mod.init_lora(cfg.llm, generator=g, rank=8,
                                          device="cpu", dtype=torch.float32))
    stage = STAGE_PRESETS["grounded"]
    opt, _ = make_optimizer(stage, 10, params)
    state = create_train_state(params, opt, mesh=mesh, cfg=cfg)
    sharded = sum(is_sharded(t) for _, t in tree_items(state.params))
    accum, B, S = 2, max(2, n), 12
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 50, size=(accum, B, S)).astype(np.int64)
    ids[..., 1] = IMAGE_TOKEN_INDEX
    batch = vlm.Batch(
        torch.from_numpy(ids), torch.from_numpy(ids),
        torch.ones(accum, B, S, dtype=torch.long),
        torch.zeros(accum, B, cfg.num_segs, 336, 336, 3),
        torch.zeros(accum, B, cfg.num_frames, 224, 224, 3),
        torch.zeros(accum, B, dtype=torch.bool))
    step = make_train_step(cfg, opt, grad_accum=accum, remat=True,
                           lora_dropout=stage.lora_dropout, mesh=mesh)
    state, m = step(state, shard_batch(batch, mesh, grad_accum=accum))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"non-finite loss {loss} or grad_norm {gnorm}")
    return {"loss": loss, "grad_norm": gnorm, "sharded_leaves": sharded}


def generate_leg(mesh, cfg, params):
    from ..serve.generate import generate_tokens

    rng = np.random.default_rng(1)
    ids = rng.integers(3, 50, size=(2, 10)).astype(np.int64)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    args = (torch.from_numpy(ids), torch.ones(2, 10, dtype=torch.long),
            torch.zeros(2, cfg.num_segs, 336, 336, 3),
            torch.zeros(2, cfg.num_frames, 224, 224, 3), None)
    want, _ = generate_tokens(params, cfg, *args, **_gen_kw(4))
    got, _ = generate_tokens(shard_params(params, mesh, cfg), cfg, *args,
                             **_gen_kw(4))
    if not torch.equal(want, got):
        raise AssertionError(f"sharded generate {got.tolist()} != "
                             f"{want.tolist()}")
    return got[0].tolist()


def pool_leg(mesh, cfg, params):
    from ..serve.continuous import ContinuousServer, Request
    from ..serve.generate import generate_tokens

    rng = np.random.default_rng(2)
    reqs = []
    for _ in range(4):
        ids = rng.integers(3, 50, size=(10,)).astype(np.int64)
        ids[2] = IMAGE_TOKEN_INDEX
        reqs.append(Request(
            input_ids=ids, attn_mask=np.ones((10,), np.int64),
            spatial_pixels=(rng.normal(size=(cfg.num_segs, 336, 336, 3))
                            * 0.1).astype(np.float32),
            temporal_pixels=(rng.normal(size=(cfg.num_frames, 224, 224, 3))
                             * 0.1).astype(np.float32)))
    got = ContinuousServer(shard_params(params, mesh, cfg), cfg, pool_size=2,
                           prompt_len=10, max_new_tokens=4, chunk=2,
                           eos_token_id=-2, pad_token_id=0).serve(reqs)
    for i, r in enumerate(reqs):
        want, _ = generate_tokens(
            params, cfg, torch.from_numpy(r.input_ids[None]),
            torch.from_numpy(r.attn_mask[None]),
            torch.from_numpy(r.spatial_pixels[None]),
            torch.from_numpy(r.temporal_pixels[None]), None, **_gen_kw(4))
        if not np.array_equal(np.asarray(got[i]), want[0].numpy()):
            raise AssertionError(f"pool request {i}: {got[i]} != "
                                 f"{want[0].tolist()}")
    return [np.asarray(t).tolist() for t in got]


def run_legs(rank: int, world: int):
    """The three legs on this rank (inside an initialized group)."""
    mesh = build_mesh(*mesh_shape(world))
    cfg = micro_vlm_config("phi3.5")
    out = {"mesh": mesh.shape, "train": train_leg(mesh, cfg, world)}
    params = micro_params(cfg)
    out["generate"] = generate_leg(mesh, cfg, params)
    out["pool"] = pool_leg(mesh, cfg, params)
    return out


def dryrun_multichip(n: int = 4, timeout: float = 300.0):
    """Run the legs on n spawned gloo ranks → rank 0's results."""
    results = spawn(run_legs, n, timeout=timeout)
    losses = {(r["train"]["loss"], r["train"]["grad_norm"]) for r in results}
    if len(losses) != 1:
        raise AssertionError(f"ranks disagree on loss / grad_norm: {losses}")
    r0 = results[0]
    print(f"dryrun_multichip({n}) mesh {r0['mesh']}: train OK loss="
          f"{r0['train']['loss']:.4f} grad_norm="
          f"{r0['train']['grad_norm']:.4f} "
          f"({r0['train']['sharded_leaves']} sharded leaves)")
    print(f"dryrun_multichip({n}) serving OK: generate tokens="
          f"{r0['generate']} (sharded == single-process)")
    print(f"dryrun_multichip({n}) pool OK: 4-request continuous pool "
          f"tokens={r0['pool'][0]} (sharded pool == lockstep)")
    return r0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dryrun_multichip(int(argv[0]) if argv else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
