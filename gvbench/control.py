"""Readings for the limits of a serving cell's check, many seeds in one
process (set-up is long, so one process reads them all):

    python3 -m gvbench.control --workload serve.distinct-c8 \
        --seeds 11,12,13 --seconds 20 [--control 1] [--bf16-cache 1]

For each seed: the cell's set-up, a window of --seconds at the cell's own
load, the program's state freed, then the check's readings of the sampled
requests: the program's widest gap and, with --control 1, the control's
(the reference at fp8 e4m3 in the program's place, gvbench/check.py).
With --bf16-cache 1 the same sampled requests are served once more, before
the program's state is freed, through the engine's lockstep route on a
bf16 KV cache (the pool's is int8), each for as many tokens as the pool
served it, and that route's widest gap is read beside the pool's. One
JSON line a seed on standard output. The benchmark's runs never run this;
its readings set gvbench/limits/<cell>.json (PERF.md gives them).
"""

import argparse
import gc
import json
import sys
import time

from gvbench import harness
from gvbench.run import set_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--bf16-cache", type=int, default=0)
    args = ap.parse_args(argv)
    set_environment()
    import torch

    if not torch.cuda.is_available():
        print("gvbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    conf = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    drv = harness.driver(mix["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = drv.ServeRun(conf, mix, seed, "cuda")
        try:
            run.setup()
            run.window(args.seconds, False)
            n = len(run.finished())
            bf16 = bf16_cache_served(run) if args.bf16_cache else None
            run.free_program()
            t1 = time.perf_counter()
            r = run.check(control=bool(args.control))
            if bf16 is not None:
                r["bf16_cache_gap"] = run.check(requests=bf16)["gap"]
            r.update(seed=seed, finished=n,
                     failed=run.failed(window_only=False),
                     check_s=time.perf_counter() - t1,
                     run_s=time.perf_counter() - t)
            print(json.dumps(r), flush=True)
        finally:
            run.close()
            del run
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


def bf16_cache_served(run):
    """The run's sampled requests served again through the engine's
    lockstep route with a bf16 KV cache, greedy, each for as many tokens as
    the pool served it."""
    from grounded_video_llm_tpu_torch.core.config import GenerateConfig

    from gvbench import check, traffic

    out = []
    for s in run.sampled():
        gen = GenerateConfig(max_new_tokens=len(s.tokens), do_sample=False,
                             temperature=0.0, quantize_cache=False)
        run.engine.run_frames(traffic.derive(run.bases, s.video),
                              s.video.duration, s.question, run.mix["mode"],
                              gen)
        tokens, lengths = run.engine.last_tokens
        out.append(check.Served(s.video, s.question,
                                [int(t) for t in tokens[0][:int(lengths[0])]]))
    return out


if __name__ == "__main__":
    sys.exit(main())
