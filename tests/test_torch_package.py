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
    assert "grounded_video_llm_tpu_torch.video.native.decoder" in mods
    for m in ("train.strategy", "train.step", "train.optimizer", "train.lora",
              "train.vocab", "data.collate", "data.datasets", "data.loader",
              "obs.logger", "obs.trackers", "cli.train"):
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
            "cache_write\n"
            "ks = cuda_build.REGISTRY\n"
            "assert len(ks) == 6, [k.symbol for k in ks]\n"
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
        "gvllm_decode_attention_int8", "gvllm_scatter_write"}
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
    "bias_fp16", "bias_shape", "window_zero", "empty"])
def test_launch_checks_refuse_unsupported_inputs(case):
    q, k, v = _qkv()
    bias, window = None, None
    if case == "fp32_q":
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
    "empty", "strided_w", "w8a8_ragged_o"])
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
    elif case == "empty":
        x, w, s = _gemv_args(M=0)
    elif case == "strided_w":
        w = torch.zeros(64, 256, dtype=torch.int8)[:, ::2]
    elif case == "w8a8_ragged_o":
        x, w, s = _gemv_args(O=120)
        w8a8 = True
    with pytest.raises((TypeError, ValueError)):
        mm._check_launch_args("int8_matmul", x, w, s, w8a8)


def test_int8_matmul_checks_accept_the_paths_shapes():
    for M, D, O in ((1, 3072, 9216), (6, 3072, 16384), (6, 8192, 3072),
                    (255, 3072, 32366)):
        x = torch.empty(M, D, dtype=torch.bfloat16, device="meta")
        w = torch.empty(D, O, dtype=torch.int8, device="meta")
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
