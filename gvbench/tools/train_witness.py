"""Why the benchmark has no training cell yet: the program's grounded
training step rounds most of its updates away.

    python3 -m gvbench.tools.train_witness --device cuda --size full \
        --seeds 5,11,23 [--dtype bfloat16] [--total-steps 100]

The grounded stage (LoRA r=128 with B drawn non-zero, the projectors, the
embedding and lm_head trainable) at its published widths, cut to 2 LLM, 2
CLIP and 1 InternVideo2 layers (``--size micro``: the program's micro test
sizes), with parameters in ``--dtype``: bfloat16 is the only training path
on the card (its flash kernels take bf16). Three optimizer steps of
microbatch 2 × accumulation 2 on seeded tokens and pixels, through the
program's ``make_train_step``. Each update the program applies is also
applied, from the same gradients, to an fp32 shadow of the trainable
leaves with fp32 moments. Printed per leaf: the norm of the program's
parameter change, that of the shadow's, the share of elements each moved,
and the ratio of the norms (1 where nothing is rounded away). Not run by
the benchmark.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def run(device: str, size: str, dtype: torch.dtype, total: int,
        seed: int) -> None:
    from grounded_video_llm_tpu_torch.core.config import (
        STAGE_PRESETS, micro_vlm_config, replace, vlm_config)
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.text.templates import (
        IGNORE_INDEX, IMAGE_TOKEN_INDEX)
    from grounded_video_llm_tpu_torch.train import lora as lora_mod
    from grounded_video_llm_tpu_torch.train import optimizer as opt_mod
    from grounded_video_llm_tpu_torch.train.optimizer import (
        make_optimizer, tree_items)
    from grounded_video_llm_tpu_torch.train.step import (
        create_train_state, make_train_step)

    if size == "full":
        cfg = vlm_config("phi3.5", stage="grounded")
        cfg = replace(cfg, llm=replace(cfg.llm, num_layers=2),
                      clip=replace(cfg.clip, num_layers=2),
                      video=replace(cfg.video, depth=2, num_blocks_used=1))
    else:
        cfg = micro_vlm_config("phi3.5")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = vlm.init_params(cfg, generator=g, device=device, dtype=dtype)
    la = lora_mod.init_lora(cfg.llm, generator=g, device=device, dtype=dtype)
    for t in la.values():
        t["b"].normal_(0, 0.02, generator=g)
    p["llm"] = lora_mod.attach_lora(p["llm"], la)
    opt, _ = make_optimizer(STAGE_PRESETS["grounded"], total, p)
    shadow = {}
    apply = opt_mod.Optimizer.apply

    def shadowed(self, params, grads, state):
        """The program's update, and the same Adam step in fp32 on the
        shadow."""
        flat = dict(tree_items(params))
        gnorm = self.grad_norm(grads)
        clip = not bool(gnorm < self.grad_clip)
        count = state["count"]
        bc1, bc2 = 1 - 0.9 ** (count + 1), 1 - 0.999 ** (count + 1)
        for path, gr in grads.items():
            if not self.updated(path):
                continue
            s = shadow.setdefault(path, {
                "p": flat[path].detach().float().clone(),
                "m": torch.zeros_like(flat[path], dtype=torch.float32),
                "v": torch.zeros_like(flat[path], dtype=torch.float32)})
            gf = gr.float()
            if clip:
                gf = gf / gnorm.float() * self.grad_clip
            s["m"].mul_(0.9).add_(0.1 * gf)
            s["v"].mul_(0.999).add_(0.001 * gf * gf)
            u = (s["m"] / bc1) / (torch.sqrt(s["v"] / bc2) + 1e-8)
            if self.weight_decay:
                u = u + self.weight_decay * s["p"]
            s["p"].add_(u * -self.lr(self.labels[path], count))
        return apply(self, params, grads, state)

    opt_mod.Optimizer.apply = shadowed
    try:
        st = create_train_state(p, opt)
        before = {k: v.detach().float().clone()
                  for k, v in tree_items(st.params) if opt.updated(k)}
        step = make_train_step(cfg, opt, grad_accum=2, remat=True,
                               lora_dropout=0.0)
        B, S = 2, 64
        gen = np.random.default_rng(seed)
        for _ in range(3):
            ids = gen.integers(3, 500, (2, B, S))
            ids[:, :, 5] = IMAGE_TOKEN_INDEX
            labels = ids.copy()
            labels[:, :, :10] = IGNORE_INDEX
            spatial = gen.integers(0, 256, (2, B, cfg.num_segs,
                                            cfg.spatial_image_size,
                                            cfg.spatial_image_size, 3),
                                   dtype=np.uint8)
            temporal = gen.integers(0, 256, (2, B, cfg.num_frames,
                                             cfg.temporal_image_size,
                                             cfg.temporal_image_size, 3),
                                    dtype=np.uint8)
            batch = vlm.Batch(
                torch.from_numpy(ids).to(device),
                torch.from_numpy(labels).to(device),
                torch.ones(2, B, S, dtype=torch.long, device=device),
                torch.from_numpy(spatial).to(device),
                torch.from_numpy(temporal).to(device),
                torch.zeros(2, B, dtype=torch.bool, device=device))
            st, _ = step(st, batch)
    finally:
        opt_mod.Optimizer.apply = apply
    after = dict(tree_items(st.params))
    print(f"device {device} {size} {dtype} seed {seed} total_steps {total}")
    for k, b0 in before.items():
        db = after[k].detach().float() - b0
        df = shadow[k]["p"] - b0
        print(f"{k:34s} program |dp| {db.norm().item():.3e} moved "
              f"{(db != 0).float().mean().item():.3f}  fp32 shadow |dp| "
              f"{df.norm().item():.3e} moved "
              f"{(df != 0).float().mean().item():.3f}  ratio "
              f"{db.norm().item() / max(df.norm().item(), 1e-30):.3f}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", choices=("full", "micro"), default="full")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--total-steps", type=int, default=100)
    ap.add_argument("--seeds", default="5,11,23")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        run(args.device, args.size, getattr(torch, args.dtype),
            args.total_steps, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
