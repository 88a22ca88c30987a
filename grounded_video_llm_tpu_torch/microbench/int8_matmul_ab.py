"""K3/K6 (``ops/int8_matmul.int8_matmul``) of this checkout against the same
wrapper of another checkout of the repository, on one card, in one process:
both built from their own sources, each call checked against the other (w8a8
bit-equal, weight-only within 2**-7 of the larger output), then timed in
turns (other, this, this, other) by CUDA-graph replays over weight copies
past the L2: Phi-3.5's four projections over 32 layers at M=6 (w8a8, a mode
A step), M=1 (weight-only, a mode B/C step) and M=30 (w8a8, a path D verify
pass), and the lm_head over 4 copies at M=6 and M=30.

    git archive <rev> | tar -x -C build/other      # build/ is gitignored
    python3 -m grounded_video_llm_tpu_torch.microbench.int8_matmul_ab build/other

Each line carries the card's name and power limit. Raises without a card.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

from ..core.config import vlm_config
from ..ops import int8_matmul as mm
from .timing import card, device_ms, require_cuda

HBM_BPS = 3.35e12
LAYERS, LM_HEAD_COPIES = 32, 4
REPS = 5             # passes over the copies in one timed graph


def load_other(root: Path):
    """The other checkout's ``ops.int8_matmul``, imported as a package of
    its own (``gvllm_other``), so it builds from and into that checkout."""
    pkg = root / "grounded_video_llm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "gvllm_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["gvllm_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("gvllm_other.ops.int8_matmul")


def cases(cfg):
    """(label, w8a8, M, {name: (D, O)}, copies)."""
    L = cfg.llm
    D = L.hidden_size
    proj = {"qkv": (D, L.q_dim + 2 * L.kv_dim), "o": (L.q_dim, D),
            "gate_up": (D, 2 * L.intermediate_size),
            "down": (L.intermediate_size, D)}
    head = {"lm_head": (D, L.padded_vocab_size)}
    return (("mode A step, w8a8", True, 6, proj, LAYERS),
            ("mode B/C step, weight-only", False, 1, proj, LAYERS),
            ("path D verify pass, w8a8", True, 30, proj, LAYERS),
            ("lm_head", False, 6, head, LM_HEAD_COPIES),
            ("lm_head", False, 30, head, LM_HEAD_COPIES))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    if len(argv) != 1:
        raise SystemExit("usage: int8_matmul_ab <other checkout>")
    other = load_other(Path(argv[0]).resolve())
    name = card()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for label, w8a8, M, shapes, copies in cases(
            vlm_config("phi3.5", stage="inference")):
        total = {"other": 0.0, "this": 0.0}
        for pname, (d, o) in shapes.items():
            w = torch.randint(-127, 128, (copies, d, o), generator=g,
                              device=dev, dtype=torch.int8)
            wp = mm.empty_int8_weight((copies, d, o), dev).copy_(w)
            s = torch.rand(copies, o, generator=g, device=dev) + 1e-4
            x = torch.randn(M, d, generator=g, device=dev).bfloat16()
            calls = {"other": lambda i: other.int8_matmul(x, w[i], s[i], w8a8),
                     "this": lambda i: mm.int8_matmul(x, wp[i], s[i], w8a8)}
            y0, y1 = calls["other"](0), calls["this"](0)
            err = float((y0.float() - y1.float()).abs().max()
                        / y0.float().abs().max().clamp_min(1e-30))
            if (err != 0.0) if w8a8 else (err > 2 ** -7):
                raise AssertionError(f"{label} {pname}: the two checkouts "
                                     f"disagree ({err:.3e})")
            ms = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                ms[who].append(device_ms(
                    lambda: [calls[who](i) for i in range(copies)], REPS,
                    graph=True) / copies)
            per = LAYERS if copies == LAYERS else 1
            for who in total:
                total[who] += per * min(ms[who])
            bound = (d * o + 4 * o + 2 * M * d + 2 * M * o) / HBM_BPS * 1e3
            print(f"[int8_matmul_ab] {label} {pname} M={M} D={d} O={o}: "
                  f"other {ms['other'][0]:.4f} / {ms['other'][1]:.4f} ms, "
                  f"this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms, "
                  f"bound {bound:.4f} ms, max|dy|/max|y| {err:.2e} | {name}",
                  flush=True)
            del w, wp, s, x
            torch.cuda.empty_cache()
        print(f"[int8_matmul_ab] {label} M={M} total: other "
              f"{total['other']:.4f} ms, this {total['this']:.4f} ms "
              f"({total['this'] / total['other']:.3f}x) | {name}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
