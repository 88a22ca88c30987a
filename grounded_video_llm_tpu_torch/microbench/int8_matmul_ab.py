"""K3/K6 (``ops/int8_matmul.int8_matmul``), M1/M3/M3d (``ops/int8_gemm``)
and K10 (``ops/fused_block``) of this checkout against the same wrappers of
another checkout of the repository, on one card, in one process: both built
from their own sources, each call checked against the other (w8a8 and M3
bit-equal, weight-only, M3d and K10 within 2**-7 of the larger output), then
timed in turns (other, this, this, other) by CUDA-graph replays. K3/K6 over
weight copies past the L2: Phi-3.5's four projections over 32 layers at M=6
(w8a8, a mode A step), M=1 (weight-only, a mode B/C step) and M=30 (w8a8, a
path D verify pass), and the lm_head over 4 copies at M=6 and M=30. M1 at
microbench/decode's three projections at M=6 over its weight copies (one
pass, summed; within 2**-7, as M1's contract allowed before it ran K3's
bit-equal kernel). M3 and M3d at microbench/int8_gemm's shapes, fc1
8192 x 1408 x 6144 and the fc2 transpose, and K10's four GEMMs (qkv with
qk_norm, fc1 with GELU, proj and fc2 with LayerScale and residual) at path
D's 147,528 rows, with this / other ratios: the int8 GEMM for large M
(csrc/int8_wgmma.cuh) that M3, M3d and K10 share, against another revision
of it.

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
from ..ops import fused_block as fb
from ..ops import int8_gemm as ig
from ..ops import int8_matmul as mm
from . import decode as mb_decode
from . import int8_gemm as mb_gemm
from .timing import card, device_ms, require_cuda

HBM_BPS = 3.35e12
LAYERS, LM_HEAD_COPIES = 32, 4
REPS = 5             # passes over the copies in one timed graph
GEMM_REPS = 10       # M3 / M3d calls in one timed graph
FUSED_REPS = 2       # K10 calls in one timed graph (an output is 1.8 GB)
PATH_D_VIDEOS = 6    # path D encodes its batch's six videos in one call


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


def gemm_cases():
    """(label, M, K, N) of M3 / M3d: microbench/int8_gemm's shapes."""
    return tuple(zip(("fc1", "fc2 transpose"), *zip(*mb_gemm.SHAPES)))


def fused_cases(cfg):
    """(label, entry, epilogue, K, N) of K10's four GEMMs in an IV2 block."""
    v = cfg.video
    D, I = v.embed_dim, v.mlp_hidden
    return (("qkv", "fused_norm_quant_gemm", "qk_norm", D, 3 * D),
            ("fc1", "fused_norm_quant_gemm", "gelu", D, I),
            ("proj", "fused_quant_gemm_ls_residual", None, D, D),
            ("fc2", "fused_quant_gemm_ls_residual", None, I, D))


def turns(label, calls, reps, bar, name) -> None:
    """Check the two checkouts' calls against each other (max |dy| / max |y|
    <= bar), time them in turns (other, this, this, other) by CUDA-graph
    replays of `reps` calls and print both times and their ratio."""
    y0, y1 = calls["other"](), calls["this"]()
    err = float((y0.float() - y1.float()).abs().max()
                / y0.float().abs().max().clamp_min(1e-30))
    del y0, y1
    if err > bar:
        raise AssertionError(f"{label}: the two checkouts disagree "
                             f"({err:.3e})")
    ms = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        ms[who].append(device_ms(calls[who], reps, graph=True))
    ratio = min(ms["this"]) / min(ms["other"])
    print(f"[int8_gemm_ab] {label}: other {ms['other'][0]:.4f} / "
          f"{ms['other'][1]:.4f} ms, this {ms['this'][0]:.4f} / "
          f"{ms['this'][1]:.4f} ms ({ratio:.3f}x), max|dy|/max|y| "
          f"{err:.2e} | {name}", flush=True)
    torch.cuda.empty_cache()


def m1_ab(other_ig, name, g, dev) -> None:
    """M1 (i8i8_matmul) of both checkouts in turns at microbench/decode's
    projections and batch, each call reading the next weight copy; the
    per-call times and one pass (the three projections) summed."""
    total = {"other": 0.0, "this": 0.0}
    M = 6
    for d, o, tag in mb_decode.PROJECTIONS:
        C = mb_decode.copies(d * o)
        w = torch.randint(-127, 128, (C, d, o), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(C, o, generator=g, device=dev) * 1e-3 + 1e-4
        x = (torch.randn(M, d, generator=g, device=dev) * 0.1).bfloat16()
        fns = {who: (lambda f=mod.i8i8_matmul: [f(x, w[i], s[i])
                                                 for i in range(C)])
               for who, mod in (("other", other_ig), ("this", ig))}
        y0, y1 = other_ig.i8i8_matmul(x, w[0], s[0]), ig.i8i8_matmul(
            x, w[0], s[0])
        err = float((y0.float() - y1.float()).abs().max()
                    / y0.float().abs().max().clamp_min(1e-30))
        if err > 2 ** -7:
            raise AssertionError(f"i8i8_matmul {tag}: the two checkouts "
                                 f"disagree ({err:.3e})")
        ms = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            ms[who].append(device_ms(fns[who], REPS, graph=True) / C)
        for who in total:
            total[who] += min(ms[who])
        bound = (d * o + 4 * o + 2 * M * d + 2 * M * o) / HBM_BPS * 1e3
        print(f"[m1_ab] i8i8_matmul {tag} M={M} D={d} O={o} over {C} "
              f"copies: other {ms['other'][0]:.4f} / {ms['other'][1]:.4f} "
              f"ms, this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms, bound "
              f"{bound:.4f} ms, max|dy|/max|y| {err:.2e} | {name}",
              flush=True)
        del w, s, x, fns
        torch.cuda.empty_cache()
    print(f"[m1_ab] i8i8_matmul pass (3 projections) M={M}: other "
          f"{total['other']:.4f} ms, this {total['this']:.4f} ms "
          f"({total['this'] / total['other']:.3f}x) | {name}", flush=True)


def gemm_ab(other_ig, other_fb, other_mm, cfg, name, g, dev) -> None:
    """M3 and M3d at gemm_cases(), then K10's four GEMMs at path D's rows
    (PATH_D_VIDEOS videos in one encode), of both checkouts in turns."""
    for label, M, K, N in gemm_cases():
        x = (torch.randn(M, K, generator=g, device=dev) * 0.1).bfloat16()
        x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                           dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(N, generator=g, device=dev) * 1e-3 + 1e-4
        for fn, xin, bar in (("int8_gemm", x8, 0.0),
                             ("int8_gemm_dynamic", x, 2 ** -7)):
            turns(f"{fn} {label} M={M} K={K} N={N}",
                  {"other": lambda: getattr(other_ig, fn)(xin, w, s),
                   "this": lambda: getattr(ig, fn)(xin, w, s)},
                  GEMM_REPS, bar, name)
        del x, x8, w, s
    v = cfg.video
    M = PATH_D_VIDEOS * cfg.num_segs * v.seq_len
    x = torch.randn(M, v.embed_dim, generator=g, device=dev).bfloat16()
    h = (torch.randn(M, v.mlp_hidden, generator=g, device=dev)
         * 0.5).bfloat16()
    for label, entry, epi, K, N in fused_cases(cfg):
        q = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(N, generator=g, device=dev) * 1e-3 + 1e-4
        vec = (torch.randn(N, generator=g, device=dev) * 0.1).bfloat16()
        nw = 1.0 + 0.1 * torch.randn(K, generator=g, device=dev)
        qn = 1.0 + 0.1 * torch.randn(2, K, generator=g, device=dev)
        xin = h if K == v.mlp_hidden else x
        fns = {}
        for who, fbm, mmm in (("other", other_fb, other_mm),
                              ("this", fb, mm)):
            wq = mmm.Int8Weight(q, sc)
            if epi is None:
                fns[who] = (lambda f=fbm, wq=wq:
                            f.fused_quant_gemm_ls_residual(xin, wq, vec, vec,
                                                           x))
            else:
                fns[who] = (lambda f=fbm, wq=wq: f.fused_norm_quant_gemm(
                    xin, nw, wq, eps=v.rms_eps, epilogue=epi,
                    bias=vec if epi == "gelu" else None,
                    qk_norm_w=qn if epi == "qk_norm" else None))
        turns(f"K10 {entry} {label} M={M} K={K} N={N}", fns, FUSED_REPS,
              2 ** -7, name)
        del q, sc, vec, nw, qn, fns
    del x, h
    torch.cuda.empty_cache()


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
            # both checkouts take the weight as the quantizer stores it
            # (rows padded to 16 bytes where O is ragged)
            calls = {"other": lambda i: other.int8_matmul(x, wp[i], s[i],
                                                          w8a8),
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
    other_ig = importlib.import_module("gvllm_other.ops.int8_gemm")
    m1_ab(other_ig, name, g, dev)
    gemm_ab(other_ig, importlib.import_module("gvllm_other.ops.fused_block"),
            other, vlm_config("phi3.5", stage="inference"), name, g, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
