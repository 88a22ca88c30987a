"""Package hygiene of the PyTorch port: it never imports jax nor any module
of the JAX package, its kernel modules import on a machine without nvcc, and
the kernel wrappers refuse inputs the CUDA kernels do not take (checked
without a card: validation runs before any launch)."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import grounded_video_llm_tpu_torch
from grounded_video_llm_tpu_torch.ops import cache_write as cw
from grounded_video_llm_tpu_torch.ops import cuda_build
from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as da
from grounded_video_llm_tpu_torch.ops import flash_attention as fa
from grounded_video_llm_tpu_torch.ops import fused_block as fb
from grounded_video_llm_tpu_torch.ops import int8_gemm as ig
from grounded_video_llm_tpu_torch.ops import int8_matmul as mm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        grounded_video_llm_tpu_torch.__path__,
        prefix="grounded_video_llm_tpu_torch."))


def test_port_never_imports_jax():
    """In a fresh interpreter (this one has jax loaded by conftest): neither
    jax nor the JAX package (grounded_video_llm_tpu, any of its modules)."""
    mods = _port_modules()
    assert "grounded_video_llm_tpu_torch.ops.flash_attention" in mods
    assert "grounded_video_llm_tpu_torch.serve.engine" in mods
    assert "grounded_video_llm_tpu_torch.serve.speculative" in mods
    assert "grounded_video_llm_tpu_torch.ops.fused_block" in mods
    assert "grounded_video_llm_tpu_torch.cli.inference" in mods
    assert "grounded_video_llm_tpu_torch.video.native.decoder" in mods
    for m in ("train.strategy", "train.step", "train.optimizer", "train.lora",
              "train.vocab", "data.collate", "data.datasets", "data.loader",
              "obs.logger", "obs.trackers", "cli.train", "ops.int8_gemm",
              "serve.calibrate", "serve.quant_ab", "microbench.timing",
              "microbench.int8_gemm", "microbench.decode",
              "microbench.encoder_attn", "microbench.static_scales"):
        assert f"grounded_video_llm_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'grounded_video_llm_tpu')\n"
            "             or m.startswith(('jax.', 'jaxlib',\n"
            "                              'grounded_video_llm_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_names_the_jax_package():
    """Static check over every .py of the port and chip_smoke.py: no import
    or from-import names jax or grounded_video_llm_tpu(.*)."""
    files = sorted(Path(grounded_video_llm_tpu_torch.__path__[0]).rglob(
        "*.py")) + [Path(REPO) / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f), n) for f in files for n in _imported_names(f)
           if n.split(".")[0] in ("jax", "jaxlib", "grounded_video_llm_tpu")]
    assert not bad, bad


def test_kernel_module_imports_without_nvcc():
    """Importing builds nothing; a build without nvcc raises instead of
    falling back, for every registered kernel."""
    code = ("from grounded_video_llm_tpu_torch.ops import cuda_build, "
            "flash_attention, int8_matmul, decode_attention_int8, "
            "cache_write, fused_block, int8_gemm\n"
            "ks = cuda_build.REGISTRY\n"
            "assert len(ks) == 14, [k.symbol for k in ks]\n"
            "assert all(k._fn is None and k.launches == 0 for k in ks)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    kernels = cuda_build.REGISTRY
    assert {k.symbol for k in kernels} == {
        "gvllm_flash_fwd", "gvllm_flash_bwd", "gvllm_int8_gemv",
        "gvllm_int8_matmul",
        "gvllm_decode_attention_int8", "gvllm_scatter_write",
        "gvllm_scatter_write_multi", "gvllm_verify_attention_int8",
        "gvllm_fused_norm_quant_gemm", "gvllm_fused_quant_gemm_ls_residual",
        "gvllm_flash_variant", "gvllm_int8_gemm", "gvllm_int8_gemm_dynamic",
        "gvllm_i8i8_gemv"}
    if (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
            or any(k.library_path().exists() for k in kernels)):
        pytest.skip("nvcc or a built library present: the no-nvcc build "
                    "error cannot be shown")
    for k in kernels:
        with pytest.raises(RuntimeError, match="nvcc"):
            k.build()
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.build_all([k])


def _qkv(B=1, S=8, H=2, Hkv=2, D=64, dtype=torch.bfloat16):
    return (torch.zeros(B, S, H, D, dtype=dtype),
            torch.zeros(B, S, Hkv, D, dtype=dtype),
            torch.zeros(B, S, Hkv, D, dtype=dtype))


@pytest.mark.parametrize("case", [
    "fp32_q", "fp16_k", "head_dim_80", "strided_q", "gqa_ratio",
    "bias_fp16", "bias_shape", "window_zero", "empty", "misaligned_q",
    "heads_65536", "batch_65536", "seq_2_31"])
def test_launch_checks_refuse_unsupported_inputs(case):
    q, k, v = _qkv()
    bias, window = None, None
    if case == "misaligned_q":
        # the tensor maps need 16-byte aligned bases
        q = torch.zeros(1 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            1, 8, 2, 64)
    elif case in ("heads_65536", "batch_65536", "seq_2_31"):
        B, S, H = {"heads_65536": (1, 8, 65536), "batch_65536": (65536, 8, 1),
                   "seq_2_31": (1, 2 ** 31, 1)}[case]
        q, k, v = (torch.empty(B, S, H, 64, dtype=torch.bfloat16,
                               device="meta") for _ in range(3))
    elif case == "fp32_q":
        q = q.float()
    elif case == "fp16_k":
        k = k.half()
    elif case == "head_dim_80":
        q, k, v = _qkv(D=80)
    elif case == "strided_q":
        q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)[:, :, ::2]
    elif case == "gqa_ratio":
        q, k, v = _qkv(H=3, Hkv=2)
    elif case == "bias_fp16":
        bias = torch.zeros(1, 8, dtype=torch.float16)
    elif case == "bias_shape":
        bias = torch.zeros(1, 9)
    elif case == "window_zero":
        window = 0
    elif case == "empty":
        q, k, v = _qkv(S=0)
    with pytest.raises((TypeError, ValueError)):
        fa._check_launch_args(q, k, v, bias, window)


def test_launch_checks_accept_the_paths_shapes():
    for D, H, Hkv in ((64, 16, 16), (88, 16, 16), (96, 32, 32),
                      (128, 32, 8)):
        q, k, v = _qkv(H=H, Hkv=Hkv, D=D)
        fa._check_launch_args(q, k, v, torch.zeros(1, 8), 262144)


def test_mask_and_device_errors():
    q, k, v = _qkv(dtype=torch.float32)
    with pytest.raises(ValueError):
        fa.flash_mha(q, k, v, mask=torch.ones(1, 1, 8, 8))
    with pytest.raises(ValueError):
        fa.flash_mha(q, k, v, causal=False, sliding_window=4)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_fwd(*meta, None, 0.125, False)


def test_cpu_tensors_run_the_plain_version_without_counting():
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    before = fa.FLASH_FWD.launches
    o, lse = fa.flash_fwd(q, k, v, None, 0.25, True)
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, None, 0.25, True)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert fa.FLASH_FWD.launches == before


def _bwd_args(**kw):
    q, k, v = _qkv(**kw)
    B, S, H, _ = q.shape
    return [q, k, v, None, torch.zeros_like(q), torch.zeros(B, H, S),
            torch.zeros_like(q), None]


@pytest.mark.parametrize("case", [
    "fp32_do", "do_shape", "strided_o", "lse_fp16", "lse_shape",
    "head_dim_80", "bias_shape", "window_zero", "empty", "fp32_k"])
def test_flash_bwd_launch_checks_refuse_unsupported_inputs(case):
    a = _bwd_args()
    if case == "fp32_do":
        a[6] = a[6].float()
    elif case == "do_shape":
        a[6] = torch.zeros(1, 7, 2, 64, dtype=torch.bfloat16)
    elif case == "strided_o":
        a[4] = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)[:, :, ::2]
    elif case == "lse_fp16":
        a[5] = a[5].half()
    elif case == "lse_shape":
        a[5] = torch.zeros(1, 8, 2)
    elif case == "head_dim_80":
        a = _bwd_args(D=80)
    elif case == "bias_shape":
        a[3] = torch.zeros(1, 7)
    elif case == "window_zero":
        a[7] = 0
    elif case == "empty":
        a = _bwd_args(S=0)
    elif case == "fp32_k":
        a[1] = a[1].float()
    with pytest.raises((TypeError, ValueError)):
        fa._check_bwd_args(*a)


def test_flash_bwd_launch_checks_accept_the_paths_shapes():
    for D, H, Hkv in ((96, 32, 32), (88, 16, 16), (128, 32, 8), (64, 4, 4)):
        a = _bwd_args(H=H, Hkv=Hkv, D=D)
        a[3], a[7] = torch.zeros(1, 8), 262144
        fa._check_bwd_args(*a)


def test_flash_bwd_devices_and_cpu_plain_version():
    """No kernel for a device other than CUDA; CPU tensors run the plain
    version and count nothing."""
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    o, lse = fa.flash_fwd(q, k, v, None, 0.25, True)
    do = torch.randn_like(q)
    meta = [t.to("meta") for t in (q, k, v, o, lse, do)]
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_bwd(meta[0], meta[1], meta[2], None, meta[3], meta[4],
                     meta[5], 0.25, True)
    before = fa.FLASH_BWD.launches
    got = fa.flash_bwd(q, k, v, None, o, lse, do, 0.25, True)
    want = fa.flash_bwd_reference(q, k, v, None, o, lse, do, 0.25, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.FLASH_BWD.launches == before


def _gemv_args(M=2, D=64, O=128):
    return (torch.zeros(M, D, dtype=torch.bfloat16),
            torch.zeros(D, O, dtype=torch.int8), torch.zeros(O))


@pytest.mark.parametrize("case", [
    "fp32_x", "fp16_scale", "uint8_w", "x_3d", "d_mismatch", "d_not_4",
    "d_not_8", "empty", "strided_w", "unpadded_ragged_w", "w8a8_ragged_o"])
def test_int8_matmul_checks_refuse_unsupported_inputs(case):
    x, w, s = _gemv_args()
    w8a8 = False
    if case == "fp32_x":
        x = x.float()
    elif case == "fp16_scale":
        s = s.half()
    elif case == "uint8_w":
        w = w.to(torch.uint8)
    elif case == "x_3d":
        x = x[None]
    elif case == "d_mismatch":
        x, _, _ = _gemv_args(D=32)
    elif case == "d_not_4":
        x, w, s = _gemv_args(D=66)
    elif case == "d_not_8":           # the kernel's TMA reads x rows
        x, w, s = _gemv_args(D=68)
    elif case == "empty":
        x, w, s = _gemv_args(M=0)
    elif case == "strided_w":
        w = torch.zeros(64, 256, dtype=torch.int8)[:, ::2]
    elif case == "unpadded_ragged_w":  # rows 120 bytes apart: no TMA
        x, w, s = _gemv_args(O=120)
    elif case == "w8a8_ragged_o":
        x, w, s = _gemv_args(O=120)
        w8a8 = True
    with pytest.raises((TypeError, ValueError)):
        mm._check_launch_args("int8_matmul", x, w, s, w8a8)


def test_int8_matmul_checks_accept_the_paths_shapes():
    for M, D, O in ((1, 3072, 9216), (6, 3072, 16384), (6, 8192, 3072),
                    (255, 3072, 32366)):
        x = torch.empty(M, D, dtype=torch.bfloat16, device="meta")
        w = mm.empty_int8_weight((D, O), device="meta")   # as quantized
        s = torch.empty(O, device="meta")
        mm._check_launch_args("int8_matmul", x, w, s, O % 16 == 0)


def _attention_args(B=2, H=4, Hkv=2, D=64, L=16):
    return [torch.zeros(B, 1, H, D, dtype=torch.bfloat16),
            torch.zeros(B, Hkv, L, D, dtype=torch.int8), torch.ones(B, Hkv, L),
            torch.zeros(B, Hkv, L, D, dtype=torch.int8), torch.ones(B, Hkv, L),
            torch.ones(B, L, dtype=torch.bool),
            torch.zeros(B, 1, Hkv, D, dtype=torch.bfloat16),
            torch.zeros(B, 1, Hkv, D, dtype=torch.bfloat16)]


@pytest.mark.parametrize("case", [
    "fp32_q", "two_queries", "head_dim_80", "head_dim_160", "gqa_3",
    "int32_mask", "fp16_scales", "strided_cache", "cache_shape", "new_shape"])
def test_decode_attention_checks_refuse_unsupported_inputs(case):
    a = _attention_args()
    if case == "fp32_q":
        a[0] = a[0].float()
    elif case == "two_queries":
        a[0] = torch.zeros(2, 2, 4, 64, dtype=torch.bfloat16)
    elif case == "head_dim_80":
        a = _attention_args(D=80)
    elif case == "head_dim_160":
        a = _attention_args(D=160)
    elif case == "gqa_3":
        a = _attention_args(H=6, Hkv=2)
    elif case == "int32_mask":
        a[5] = a[5].int()
    elif case == "fp16_scales":
        a[2] = a[2].half()
    elif case == "strided_cache":
        a[1] = torch.zeros(2, 2, 32, 64, dtype=torch.int8)[:, :, ::2]
    elif case == "cache_shape":
        a[3] = torch.zeros(2, 2, 15, 64, dtype=torch.int8)
    elif case == "new_shape":
        a[6] = torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        da._check_launch_args(*a)


def test_decode_attention_checks_accept_the_paths_shapes():
    da._check_launch_args(*_attention_args(B=6, H=32, Hkv=32, D=96, L=3840))
    da._check_launch_args(*_attention_args(B=2, H=32, Hkv=8, D=128, L=1000))


def _write_args(L=2, B=3, Hkv=2, S=8, D=16):
    caches = [torch.zeros(L, B, Hkv, S, D, dtype=torch.int8),
              torch.ones(L, B, Hkv, S)]
    news = [torch.zeros(L, B, Hkv, D, dtype=torch.int8),
            torch.ones(L, B, Hkv)]
    return caches, news, torch.zeros(B, dtype=torch.int32)


@pytest.mark.parametrize("case", [
    "no_pairs", "five_pairs", "unpaired", "dtype", "new_shape", "lead_shape",
    "odd_bytes", "idx_int64", "idx_shape", "strided_cache"])
def test_scatter_write_checks_refuse_unsupported_inputs(case):
    caches, news, idx = _write_args()
    if case == "no_pairs":
        caches, news = [], []
    elif case == "five_pairs":
        caches, news = caches * 3, news * 3
        caches, news = caches[:5], news[:5]
    elif case == "unpaired":
        news = news[:1]
    elif case == "dtype":
        news[0] = news[0].to(torch.int16)
    elif case == "new_shape":
        news[0] = torch.zeros(2, 3, 2, 15, dtype=torch.int8)
    elif case == "lead_shape":
        caches[1] = torch.ones(2, 3, 2, 9)
        news[1] = torch.ones(2, 3, 2)
    elif case == "odd_bytes":
        caches, news, idx = _write_args(D=6)
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "idx_shape":
        idx = torch.zeros(4, dtype=torch.int32)
    elif case == "strided_cache":
        caches[0] = torch.zeros(2, 3, 2, 16, 16, dtype=torch.int8)[:, :, :, ::2]
    with pytest.raises((TypeError, ValueError)):
        cw._check_launch_args(caches, news, idx)


def test_int8_wrappers_refuse_devices_without_a_kernel():
    x, w, s = (t.to("meta") for t in _gemv_args())
    for w8a8 in (False, True):
        with pytest.raises(RuntimeError, match="no kernel"):
            mm.int8_matmul(x, w, s, w8a8)
    a = [t.to("meta") for t in _attention_args()]
    with pytest.raises(RuntimeError, match="no kernel"):
        da.decode_attention_int8(*a, scale=0.125)
    caches, news, idx = _write_args()
    with pytest.raises(RuntimeError, match="no kernel"):
        cw.scatter_write([c.to("meta") for c in caches],
                         [n.to("meta") for n in news], idx.to("meta"))


def test_int8_cpu_tensors_run_the_plain_versions_without_counting():
    counters = [mm.INT8_GEMV, mm.INT8_MATMUL, da.DECODE_ATTENTION_INT8,
                cw.SCATTER_WRITE]
    before = [k.launches for k in counters]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g).to(torch.bfloat16)
    w = torch.randint(-127, 128, (64, 128), generator=g, dtype=torch.int8)
    s = torch.rand(128, generator=g)
    assert torch.equal(mm.int8_matmul(x, w, s, True),
                       mm.int8_matmul_reference(x, w, s, True))
    assert torch.equal(mm.int8_matmul(x, w, s),
                       mm.int8_matmul_reference(x, w, s))
    a = _attention_args()
    assert torch.equal(da.decode_attention_int8(*a, scale=0.125),
                       da.decode_attention_int8_reference(*a, scale=0.125))
    caches, news, idx = _write_args()
    cw.scatter_write(caches, news, idx)
    assert [k.launches for k in counters] == before


def _verify_args(B=2, S=3, H=4, Hkv=2, D=64, L=16):
    return [torch.zeros(B, S, H, D, dtype=torch.bfloat16),
            torch.zeros(B, Hkv, L, D, dtype=torch.int8), torch.ones(B, Hkv, L),
            torch.zeros(B, Hkv, L, D, dtype=torch.int8), torch.ones(B, Hkv, L),
            torch.ones(B, S, L, dtype=torch.bool),
            torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16),
            torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16)]


@pytest.mark.parametrize("case", [
    "fp32_q", "head_dim_80", "head_dim_160", "gqa_3", "int32_mask",
    "mask_one_row", "fp16_scales", "strided_cache", "new_shape",
    "too_many_scores"])
def test_verify_attention_checks_refuse_unsupported_inputs(case):
    a = _verify_args()
    if case == "fp32_q":
        a[0] = a[0].float()
    elif case == "head_dim_80":
        a = _verify_args(D=80)
    elif case == "head_dim_160":
        a = _verify_args(D=160)
    elif case == "gqa_3":
        a = _verify_args(H=6, Hkv=4)
    elif case == "int32_mask":
        a[5] = a[5].int()
    elif case == "mask_one_row":
        a[5] = torch.ones(2, 16, dtype=torch.bool)
    elif case == "fp16_scales":
        a[2] = a[2].half()
    elif case == "strided_cache":
        a[1] = torch.zeros(2, 2, 32, 64, dtype=torch.int8)[:, :, ::2]
    elif case == "new_shape":
        a[6] = torch.zeros(2, 2, 2, 64, dtype=torch.bfloat16)
    elif case == "too_many_scores":
        a = [t.to("meta") for t in _verify_args(S=8, H=32, Hkv=8, D=128,
                                                L=30000)]
    with pytest.raises((TypeError, ValueError)):
        da._check_verify_args(*a)


def test_verify_attention_checks_accept_the_paths_shapes():
    for kw in (dict(B=6, S=5, H=32, Hkv=32, D=96, L=3840),
               dict(B=6, S=1, H=32, Hkv=32, D=96, L=3840),
               dict(B=2, S=8, H=32, Hkv=32, D=96, L=1000),
               dict(B=2, S=8, H=32, Hkv=8, D=128, L=1000)):
        da._check_verify_args(*[t.to("meta") for t in _verify_args(**kw)])


def _multi_args(L=2, B=3, Hkv=2, S=4, max_len=8, D=16):
    caches = [torch.zeros(L, B, Hkv, max_len, D, dtype=torch.int8),
              torch.ones(L, B, Hkv, max_len)]
    news = [torch.zeros(L, B, S, Hkv, D, dtype=torch.int8),
            torch.ones(L, B, S, Hkv)]
    return caches, news, torch.zeros(B, dtype=torch.int32)


@pytest.mark.parametrize("case", [
    "no_pairs", "five_pairs", "unpaired", "dtype", "slots_129", "new_shape",
    "new_without_slots", "odd_bytes", "base_int64", "base_shape",
    "rows_2_31"])
def test_scatter_write_multi_checks_refuse_unsupported_inputs(case):
    caches, news, base = _multi_args()
    if case == "rows_2_31":
        L, B, Hkv = 2 ** 16, 2 ** 8, 2 ** 7
        caches = [torch.empty(L, B, Hkv, 8, 16, dtype=torch.int8,
                              device="meta")]
        news = [torch.empty(L, B, 4, Hkv, 16, dtype=torch.int8,
                            device="meta")]
        base = torch.empty(B, dtype=torch.int32, device="meta")
    elif case == "no_pairs":
        caches, news = [], []
    elif case == "five_pairs":
        caches, news = (caches * 3)[:5], (news * 3)[:5]
    elif case == "unpaired":
        news = news[:1]
    elif case == "dtype":
        news[0] = news[0].to(torch.int16)
    elif case == "slots_129":
        caches, news, base = _multi_args(S=129, max_len=256)
    elif case == "new_shape":
        news[0] = torch.zeros(2, 3, 4, 2, 15, dtype=torch.int8)
    elif case == "new_without_slots":
        news[0] = torch.zeros(2, 3, 2, 16, dtype=torch.int8)
    elif case == "odd_bytes":
        caches, news, base = _multi_args(D=6)
    elif case == "base_int64":
        base = base.long()
    elif case == "base_shape":
        base = torch.zeros(4, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        cw._check_multi_args(caches, news, base)


def _fused_args(M=8, D=128, O=384):
    return (torch.zeros(M, D, dtype=torch.bfloat16),
            mm.Int8Weight(torch.zeros(D, O, dtype=torch.int8), torch.ones(O)))


@pytest.mark.parametrize("case", [
    "fp32_x", "dense_weight", "fp16_scale", "d_not_64", "o_not_128",
    "d_mismatch", "stacked_weight", "bias_shape", "residual_dtype", "empty"])
def test_fused_block_checks_refuse_unsupported_inputs(case):
    x, w = _fused_args()
    vectors, residual = [("bias", None, 384)], None
    if case == "fp32_x":
        x = x.float()
    elif case == "dense_weight":
        w = torch.zeros(128, 384)
    elif case == "fp16_scale":
        w = w._replace(scale=w.scale.half())
    elif case == "d_not_64":
        x, w = _fused_args(D=96)
    elif case == "o_not_128":
        x, w = _fused_args(O=320)
    elif case == "d_mismatch":
        x = torch.zeros(8, 64, dtype=torch.bfloat16)
    elif case == "stacked_weight":
        w = mm.Int8Weight(torch.zeros(2, 128, 384, dtype=torch.int8),
                          torch.ones(2, 384))
    elif case == "bias_shape":
        vectors = [("bias", torch.zeros(383), 384)]
    elif case == "residual_dtype":
        residual = torch.zeros(8, 384)
    elif case == "empty":
        x = torch.zeros(0, 128, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        fb._check_launch_args("fused", x, w, vectors, residual)


def test_fused_block_checks_accept_the_paths_shapes():
    M = 6 * 12 * 2049
    for D, O in ((1408, 4224), (1408, 6144), (1408, 1408), (6144, 1408)):
        x = torch.empty(M, D, dtype=torch.bfloat16, device="meta")
        w = mm.Int8Weight(torch.empty(D, O, dtype=torch.int8, device="meta"),
                          torch.empty(O, device="meta"))
        fb._check_launch_args("fused", x, w,
                              [("bias", torch.empty(O, device="meta"), O)],
                              torch.empty(M, O, dtype=torch.bfloat16,
                                          device="meta"))


def test_new_wrappers_refuse_devices_without_a_kernel():
    a = [t.to("meta") for t in _verify_args()]
    with pytest.raises(RuntimeError, match="no kernel"):
        da.verify_attention_int8(*a, scale=0.125)
    caches, news, base = _multi_args()
    with pytest.raises(RuntimeError, match="no kernel"):
        cw.scatter_write_multi([c.to("meta") for c in caches],
                               [n.to("meta") for n in news], base.to("meta"))
    x, w = _fused_args()
    x, w = x.to("meta"), mm.Int8Weight(w.q.to("meta"), w.scale.to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_norm_quant_gemm(x, torch.ones(128, device="meta"), w,
                                 eps=1e-6)
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_quant_gemm_ls_residual(
            x, mm.Int8Weight(w.q[:, :128], w.scale[:128]), None,
            torch.ones(128, device="meta"), x)


def test_new_cpu_tensors_run_the_plain_versions_without_counting():
    counters = [da.VERIFY_ATTENTION_INT8, cw.SCATTER_WRITE_MULTI,
                fb.FUSED_NORM_QUANT_GEMM, fb.FUSED_QUANT_GEMM_LS_RESIDUAL]
    before = [k.launches for k in counters]
    a = _verify_args()
    assert torch.equal(da.verify_attention_int8(*a, scale=0.125),
                       da.verify_attention_int8_reference(*a, scale=0.125))
    caches, news, base = _multi_args()
    cw.scatter_write_multi(caches, news, base)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 128, generator=g).to(torch.bfloat16)
    w = mm.Int8Weight(torch.randint(-127, 128, (128, 384), generator=g,
                                    dtype=torch.int8), torch.rand(384) * 1e-2)
    nw, qn = torch.ones(128), torch.ones(2, 128)
    assert torch.equal(
        fb.fused_norm_quant_gemm(x, nw, w, eps=1e-6, epilogue="qk_norm",
                                 qk_norm_w=qn),
        fb.fused_norm_quant_gemm_reference(x, nw, w, eps=1e-6,
                                           epilogue="qk_norm", qk_norm_w=qn))
    w2 = mm.Int8Weight(w.q[:, :128].contiguous(), w.scale[:128])
    assert torch.equal(
        fb.fused_quant_gemm_ls_residual(x, w2, None, nw, x),
        fb.fused_quant_gemm_ls_residual_reference(x, w2, None, nw, x))
    assert [k.launches for k in counters] == before
    with pytest.raises(ValueError):
        fb.fused_norm_quant_gemm(x, nw, w, eps=1e-6, epilogue="relu")
    with pytest.raises(ValueError):
        fb.fused_norm_quant_gemm(x, nw, w2, eps=1e-6, epilogue="qk_norm",
                                 qk_norm_w=qn)


@pytest.mark.parametrize("embed_dim,mlp_ratio,fused", [(96, 4.0, None),
                                                       (128, 4.0, True),
                                                       (128, 3.0, None),
                                                       (1152, 4.0, None),
                                                       (1408, 4.0, True)])
def test_fused_iv2_switch_off_the_cpu_runs_k10_or_raises(monkeypatch,
                                                         embed_dim,
                                                         mlp_ratio, fused):
    """GVLLM_FUSED_IV2=1 with int8 blocks on a device other than the CPU:
    widths the kernels tile take the fused block, others raise (None) in
    place of falling back to the unfused chain; the switch off, never."""
    from grounded_video_llm_tpu_torch.core.config import InternVideo2Config
    from grounded_video_llm_tpu_torch.models import internvideo2 as iv2

    cfg = InternVideo2Config(embed_dim=embed_dim, depth=1, num_heads=2,
                             mlp_ratio=mlp_ratio, image_size=28,
                             patch_size=14, num_frames=2, num_blocks_used=1)
    bp = {"qkv_kernel": mm.Int8Weight(
        torch.empty(embed_dim, 3 * embed_dim, dtype=torch.int8,
                    device="meta"), torch.empty(3 * embed_dim, device="meta"))}
    monkeypatch.setenv("GVLLM_FUSED_IV2", "1")
    if fused is None:
        with pytest.raises(ValueError, match="GVLLM_FUSED_IV2"):
            iv2._fused_int8_ok(bp, cfg)
    else:
        assert iv2._fused_int8_ok(bp, cfg)
    monkeypatch.setenv("GVLLM_FUSED_IV2", "0")
    assert not iv2._fused_int8_ok(bp, cfg)


@pytest.mark.parametrize("D,tile", [(1408, 176), (128, 128), (1024, 256),
                                    (2048, 256), (1152, None), (3200, None),
                                    (96, None)])
def test_fused_qk_norm_widths(D, tile):
    """qk_norm runs each K-wide third as one cluster of at most 8 blocks of
    256, 176 or 128 columns (IV2-1B's 1,408 = 8 x 176); the launch checks
    refuse other widths for qk_norm only."""
    assert fb.qk_norm_tile(D) == tile
    x = torch.empty(8, D, dtype=torch.bfloat16, device="meta")
    O = 3 * D if D % 128 == 0 else 384
    w = mm.Int8Weight(torch.empty(D, O, dtype=torch.int8, device="meta"),
                      torch.empty(O, device="meta"))
    if D % 64:
        return
    fb._check_launch_args("fused", x, w, [])
    if tile is None:
        with pytest.raises(ValueError, match="qk_norm"):
            fb._check_launch_args("fused", x, w, [], qk_norm=True)
    else:
        fb._check_launch_args("fused", x, w, [], qk_norm=True)


def _gemm_args(M=8, K=128, N=256, x_dtype=torch.int8):
    return (torch.zeros(M, K, dtype=x_dtype), torch.zeros(K, N,
                                                          dtype=torch.int8),
            torch.ones(N))


@pytest.mark.parametrize("case", [
    "x_dtype", "w_dtype", "s_dtype", "x_3d", "k_mismatch", "k_not_64",
    "n_not_128", "empty", "strided_w", "s_shape"])
def test_int8_gemm_checks_refuse_unsupported_inputs(case):
    for name, x_dtype in (("int8_gemm", torch.int8),
                          ("int8_gemm_dynamic", torch.bfloat16)):
        x, w, s = _gemm_args(x_dtype=x_dtype)
        if case == "x_dtype":
            x = x.float()
        elif case == "w_dtype":
            w = w.to(torch.uint8)
        elif case == "s_dtype":
            s = s.half()
        elif case == "x_3d":
            x = x[None]
        elif case == "k_mismatch":
            x = torch.zeros(8, 64, dtype=x_dtype)
        elif case == "k_not_64":
            x, w, s = _gemm_args(K=96, x_dtype=x_dtype)
        elif case == "n_not_128":
            x, w, s = _gemm_args(N=192, x_dtype=x_dtype)
        elif case == "empty":
            x, w, s = _gemm_args(M=0, x_dtype=x_dtype)
        elif case == "strided_w":
            w = torch.zeros(128, 512, dtype=torch.int8)[:, ::2]
        elif case == "s_shape":
            s = torch.ones(255)
        with pytest.raises((TypeError, ValueError)):
            ig._check_gemm_args(name, x, w, s, x_dtype)


def test_int8_gemm_row_limit_follows_the_kernel_route():
    """M3d with K <= RES_KMAX keeps 64 rows per block, so its grid's 65,535
    row blocks hold half the rows of M3's and of M3d's streaming route."""
    def args(M, K, dt):
        return (torch.empty(M, K, dtype=dt, device="meta"),
                torch.empty(K, 128, dtype=torch.int8, device="meta"),
                torch.empty(128, device="meta"))

    ig._check_gemm_args("int8_gemm", *args(65535 * 128, 1408, torch.int8),
                        torch.int8)
    ig._check_gemm_args("int8_gemm_dynamic",
                        *args(65535 * 128, ig.RES_KMAX + 64, torch.bfloat16),
                        torch.bfloat16)
    ig._check_gemm_args("int8_gemm_dynamic",
                        *args(65535 * 64, ig.RES_KMAX, torch.bfloat16),
                        torch.bfloat16)
    with pytest.raises(ValueError, match="M <= "):
        ig._check_gemm_args("int8_gemm_dynamic",
                            *args(65535 * 64 + 1, 1408, torch.bfloat16),
                            torch.bfloat16)


@pytest.mark.parametrize("case", [
    "seventeen_rows", "fp32_x", "k_not_32", "n_not_16", "empty"])
def test_i8i8_gemv_checks_refuse_unsupported_inputs(case):
    x, w, s = _gemm_args(M=6, K=3072, N=9216, x_dtype=torch.bfloat16)
    if case == "seventeen_rows":
        x = torch.zeros(17, 3072, dtype=torch.bfloat16)
    elif case == "fp32_x":
        x = x.float()
    elif case == "k_not_32":
        x, w, s = _gemm_args(M=6, K=3080, N=9216, x_dtype=torch.bfloat16)
    elif case == "n_not_16":
        x, w, s = _gemm_args(M=6, K=3072, N=9208, x_dtype=torch.bfloat16)
    elif case == "empty":
        x = torch.zeros(0, 3072, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        ig._check_gemv_args(x, w, s)


def test_microbench_kernel_checks_accept_their_shapes():
    for M, K, N in ((8192, 1408, 6144), (8192, 6144, 1408), (300, 1408, 6144)):
        for name, dt in (("int8_gemm", torch.int8),
                         ("int8_gemm_dynamic", torch.bfloat16)):
            x = torch.empty(M, K, dtype=dt, device="meta")
            w = torch.empty(K, N, dtype=torch.int8, device="meta")
            ig._check_gemm_args(name, x, w, torch.empty(N, device="meta"), dt)
    for M in (1, 6, 16):
        for K, N in ((3072, 9216), (3072, 16384), (8192, 3072)):
            ig._check_gemv_args(
                torch.empty(M, K, dtype=torch.bfloat16, device="meta"),
                torch.empty(K, N, dtype=torch.int8, device="meta"),
                torch.empty(N, device="meta"))
    q = torch.empty(12, 16, 2049, 88, dtype=torch.bfloat16, device="meta")
    fa._check_variant_args(q, q, q)
    for chunk in (ig.gemv_chunk(3072, 9216, 132), ig.gemv_chunk(8192, 3072, 132),
                  ig.gemv_chunk(64, 16, 132)):
        assert chunk % 128 == 0 and chunk >= 128


@pytest.mark.parametrize("case", ["fp32_q", "shape_k", "head_dim_80",
                                  "strided_v", "empty", "heads_65536",
                                  "seq_2_31"])
def test_flash_variant_checks_refuse_unsupported_inputs(case):
    q = k = v = torch.zeros(1, 2, 16, 88, dtype=torch.bfloat16)
    if case in ("heads_65536", "seq_2_31"):
        H, S = (65536, 16) if case == "heads_65536" else (1, 2 ** 31)
        q = k = v = torch.empty(1, H, S, 88, dtype=torch.bfloat16,
                                device="meta")
    elif case == "fp32_q":
        q = q.float()
    elif case == "shape_k":
        k = torch.zeros(1, 2, 15, 88, dtype=torch.bfloat16)
    elif case == "head_dim_80":
        q = k = v = torch.zeros(1, 2, 16, 80, dtype=torch.bfloat16)
    elif case == "strided_v":
        v = torch.zeros(1, 2, 32, 88, dtype=torch.bfloat16)[:, :, ::2]
    elif case == "empty":
        q = k = v = torch.zeros(1, 2, 0, 88, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        fa._check_variant_args(q, k, v)


def test_microbench_wrappers_refuse_devices_and_count_nothing_on_cpu():
    counters = [ig.INT8_GEMM, ig.INT8_GEMM_DYNAMIC, ig.I8I8_GEMV,
                fa.FLASH_VARIANT]
    before = [k.launches for k in counters]
    g = torch.Generator().manual_seed(0)
    x8 = torch.randint(-127, 128, (8, 128), generator=g, dtype=torch.int8)
    x = torch.randn(8, 128, generator=g).to(torch.bfloat16)
    w = torch.randint(-127, 128, (128, 256), generator=g, dtype=torch.int8)
    s = torch.rand(256, generator=g)
    assert torch.equal(ig.int8_gemm(x8, w, s),
                       ig.int8_gemm_reference(x8, w, s))
    assert torch.equal(ig.int8_gemm_dynamic(x, w, s),
                       ig.int8_gemm_dynamic_reference(x, w, s))
    assert torch.equal(ig.i8i8_matmul(x, w, s),
                       ig.i8i8_matmul_reference(x, w, s))
    q = torch.randn(1, 2, 8, 64, generator=g).to(torch.bfloat16)
    assert torch.equal(fa.flash_variant(q, q, q, "full"),
                       fa.flash_variant_reference(q, q, q, "full"))
    assert [k.launches for k in counters] == before
    meta = [t.to("meta") for t in (x8, x, w, s, q)]
    for fn, args in ((ig.int8_gemm, (meta[0], meta[2], meta[3])),
                     (ig.int8_gemm_dynamic, (meta[1], meta[2], meta[3])),
                     (ig.i8i8_matmul, (meta[1], meta[2], meta[3]))):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*args)
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_variant(meta[4], meta[4], meta[4], "sumdot")
