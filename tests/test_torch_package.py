"""Package hygiene of the PyTorch port: it never imports jax, its kernel
module imports on a machine without nvcc, and the kernel wrapper refuses
inputs the CUDA kernel does not take (checked without a card: validation
runs before any launch)."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import grounded_video_llm_tpu_torch
from grounded_video_llm_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        grounded_video_llm_tpu_torch.__path__,
        prefix="grounded_video_llm_tpu_torch."))


def test_port_never_imports_jax():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    mods = _port_modules()
    assert "grounded_video_llm_tpu_torch.ops.flash_attention" in mods
    assert "grounded_video_llm_tpu_torch.serve.engine" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_kernel_module_imports_without_nvcc():
    """Importing builds nothing; a build without nvcc raises instead of
    falling back."""
    code = ("from grounded_video_llm_tpu_torch.ops import flash_attention "
            "as fa\n"
            "assert fa.FLASH_FWD._fn is None and fa.FLASH_FWD.launches == 0\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    if (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
            or fa.FLASH_FWD.library_path().exists()):
        pytest.skip("nvcc or a built library present: the no-nvcc build "
                    "error cannot be shown")
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.FLASH_FWD.build()


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
