"""Flash attention: the hand-written CUDA kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) and their plain PyTorch versions (port of
grounded_video_llm_tpu/ops/flash_attention.py).

``flash_fwd`` keeps the contract of the JAX ``_flash_fwd``: q [B,Sq,H,D],
k/v [B,Sk,Hkv,D], an additive fp32 key bias [B,Sk], returns (o [B,Sq,H,D],
lse [B,H,Sq] fp32). ``flash_bwd`` keeps the contract of the JAX
``_flash_bwd``: (dq, dk, dv) from q, k, v, bias, o, lse and do, the softmax
replayed from lse. On CPU tensors each runs its plain version; on CUDA
tensors it launches its kernel or raises. There is no fallback between the
two. ``FlashAttention`` ties them together as an autograd Function (the JAX
``custom_vjp``); ``flash_mha`` goes through it only when a gradient is
wanted, so inference runs exactly the forward.

``flash_variant(q, k, v, mode)`` (M2, a second entry of csrc/flash_fwd.cu)
is the encoder-attention variant family of scripts/microbench_encoder_attn.py
on q/k/v [B, H, S, D]: "full" (exact softmax), the fixed-offset softmax of
"nomax", "exp2", "unroll2", "pipe" and "dh128", "noexp" (p = s) and
"sumdot" (the denominator from the bf16-rounded p); its plain version
``flash_variant_reference`` follows the script's ``_kernel`` op for op.

The kernel libraries are built at first use by ``ops/cuda_build.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import CudaKernel

NEG_INF = float(torch.finfo(torch.float32).min)
# Fixed exp offset replacing the row max when scores are known to be bounded
# (QK-RMSNormed InternVideo2 attention). Softmax is offset-invariant, so the
# result is the same; exp(s - 40) overflows fp32 only at s > 128.4.
BOUNDED_OFFSET = 40.0
# Finite start of the online-softmax running max: -inf - -inf is NaN.
_M_INIT = -1e30
_LOG2E = 1.4426950408889634

HEAD_DIMS = (64, 88, 96, 128)
# M2: the script's fixed offset, and its modes → the kernel's softmax modes
# (0 online max, 1 fixed offset, 2 p = s, 3 fixed offset with bf16 sums)
VARIANT_OFFSET = 30.0
VARIANT_MODES = {"full": 0, "nomax": 1, "exp2": 1, "unroll2": 1, "pipe": 1,
                 "dh128": 1, "noexp": 2, "sumdot": 3}

# gvllm_flash_fwd(q, k, v, bias, o, lse, B, Sq, Sk, H, Hkv, D, scale, causal,
#                 bounded, window, q_offset, stream) -> cudaError_t
FLASH_FWD = CudaKernel(
    "flash_fwd.cu", "gvllm_flash_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p])

# gvllm_flash_variant(q, k, v, o, B, S, H, D, scale, mode, stream)
#   -> cudaError_t
FLASH_VARIANT = CudaKernel(
    "flash_fwd.cu", "gvllm_flash_variant",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] + [ctypes.c_void_p])

# gvllm_flash_bwd(q, k, v, bias, lse, delta, do, dq, dk, dv, B, Sq, Sk, H,
#                 Hkv, D, scale, causal, window, q_offset, stream)
#   -> cudaError_t; one call launches the dq and the dk/dv kernels
FLASH_BWD = CudaKernel(
    "flash_bwd.cu", "gvllm_flash_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def flash_fwd_reference(q, k, v, bias, scale, causal, bounded=False,
                        window=None, has_bias=True, q_offset=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: fp32 einsum and softmax with the
    kernel's bias, causal, window, dead-row and lse conventions. bias is
    added when has_bias (non-causal) or always (causal), as in the two
    Pallas kernels; the causal kernel ignores bounded."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    if q_offset is None:
        q_offset = Sk - Sq
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()).reshape(
        B, H, Sq, Sk)
    add_bias = bias is not None and (causal or has_bias)
    bounded = bounded and not causal
    if bounded and not add_bias:
        # raw scores feed exp2 through one fused scale (the encoder path)
        m = torch.full((B, H, Sq, 1), BOUNDED_OFFSET, device=q.device)
        p = torch.exp2(s * (scale * _LOG2E) - BOUNDED_OFFSET * _LOG2E)
    else:
        s = s * scale
        if add_bias:
            s = s + bias.float()[:, None, None, :]
        if causal:
            qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
            kpos = torch.arange(Sk, device=q.device)[None, :]
            keep = kpos <= qpos
            if window is not None:
                keep = keep & (qpos - kpos < window)
            s = torch.where(keep, s, NEG_INF)
        if bounded:
            m = torch.full((B, H, Sq, 1), BOUNDED_OFFSET, device=q.device)
            p = torch.exp2(s * _LOG2E - BOUNDED_OFFSET * _LOG2E)
        else:
            m = s.amax(dim=-1, keepdim=True).clamp_min(_M_INIT)
            p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                        # [B, H, Sq, 1]
    dead = l <= 0.0
    l_safe = torch.where(dead, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.reshape(B, Hkv, G, Sq, Sk),
                     v.float()).reshape(B, H, Sq, D)
    o = torch.where(dead, 0.0, o / l_safe)
    lse = torch.where(dead, torch.inf, m + torch.log(l_safe))[..., 0]
    return o.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def _check_launch_args(q, k, v, bias, window, kernel="flash_fwd"):
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{kernel}: q, k, v and bias must share a device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bf16 {name}, "
                            f"got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel takes a contiguous, 16-byte "
                             f"aligned [B, S, H, D] {name}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{kernel}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{kernel}: {H} q heads over {Hkv} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel head dims are {HEAD_DIMS}, "
                         f"got {D}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError(f"{kernel}: empty sequence")
    _check_grid(kernel, B, H, max(Sq, k.shape[1]))
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (B, k.shape[1])
                             or not bias.is_contiguous()):
        raise ValueError(f"{kernel} kernel takes a contiguous fp32 [B, Sk] "
                         "bias")
    if window is not None and window <= 0:
        raise ValueError(f"{kernel}: window must be positive, got {window}")


def _check_grid(kernel, B, H, S):
    """What the kernels' grids and tensor maps take: a block per (q tile,
    head, batch row) with at most 65,535 heads and batch rows, and
    sequence positions that are 32-bit TMA coordinates."""
    if B > 65535 or H > 65535:
        raise ValueError(f"{kernel} kernel grid takes at most 65535 batch "
                         f"rows and heads, got B={B}, H={H}")
    if S >= 2 ** 31 - 256:
        raise ValueError(f"{kernel} kernel takes sequences shorter than "
                         f"2^31 - 256, got {S}")


def _check_bwd_args(q, k, v, bias, o, lse, do, window):
    """flash_bwd's launch checks: the forward's, plus o and do shaped, typed
    and laid out as q, and lse the forward's fp32 [B, H, Sq]."""
    _check_launch_args(q, k, v, bias, window, "flash_bwd")
    B, Sq, H, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"flash_bwd: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_bwd kernel takes a contiguous, 16-byte "
                             f"aligned {name}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, Sq) or not lse.is_contiguous()):
        raise ValueError("flash_bwd kernel takes the forward's contiguous "
                         "fp32 [B, H, Sq] lse")


def flash_fwd(q, k, v, bias, scale, causal, bounded=False, window=None,
              has_bias=True, q_offset=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B,Sq,H,D], lse [B,H,Sq] fp32). CPU tensors run the plain version;
    CUDA tensors launch the kernel (each launch counts in
    FLASH_FWD.launches) or raise."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, bias, scale, causal, bounded,
                                   window, has_bias, q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_fwd: no kernel for device {q.device}")
    if not (causal or has_bias):
        bias = None
    _check_launch_args(q, k, v, bias, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = Sk - Sq
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              bias.data_ptr() if bias is not None else None,
              o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, Hkv, D,
              float(scale), int(causal), int(bounded),
              int(window) if window is not None else 0, int(q_offset),
              torch.cuda.current_stream(q.device).cuda_stream)
    FLASH_FWD.launches += 1
    return o, lse


def _variant_mode(mode: str) -> int:
    if mode not in VARIANT_MODES:
        raise ValueError(f"flash_variant: mode {mode!r} is not one of "
                         f"{sorted(VARIANT_MODES)}")
    return VARIANT_MODES[mode]


def flash_variant_reference(q, k, v, mode: str) -> torch.Tensor:
    """Plain version of M2, the script's ``_kernel`` op for op in fp32:
    q, k, v [B, H, S, D] → o [B, H, S, D] in q's dtype, scale D**-0.5."""
    _variant_mode(mode)
    scale = q.shape[-1] ** -0.5
    raw = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = raw * scale
    if mode == "full":
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    elif mode == "nomax":
        p = torch.exp(s - VARIANT_OFFSET)
    elif mode == "noexp":
        p = s
    else:
        p = torch.exp2(raw * (scale * _LOG2E) - VARIANT_OFFSET * _LOG2E)
    pv = p.to(v.dtype).float()
    denom = (pv if mode == "sumdot" else p).sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", pv, v.float())
    return (o / denom).to(q.dtype)


def flash_variant(q, k, v, mode: str) -> torch.Tensor:
    """M2: q, k, v [B, H, S, D] → o [B, H, S, D] (non-causal, no mask).
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in FLASH_VARIANT.launches) or raise."""
    kernel_mode = _variant_mode(mode)
    if q.device.type == "cpu":
        return flash_variant_reference(q, k, v, mode)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_variant: no kernel for device {q.device}")
    _check_variant_args(q, k, v)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    FLASH_VARIANT(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, D, float(D ** -0.5), kernel_mode,
                  torch.cuda.current_stream(q.device).cuda_stream)
    FLASH_VARIANT.launches += 1
    return o


def _check_variant_args(q, k, v):
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_variant: q, k and v must share a device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_variant kernel takes bf16 {name}, "
                            f"got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_variant kernel takes a contiguous, "
                             f"16-byte aligned [B, H, S, D] {name}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_variant: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_variant kernel head dims are {HEAD_DIMS}, "
                         f"got {q.shape[3]}")
    if q.shape[2] == 0:
        raise ValueError("flash_variant: empty sequence")
    _check_grid("flash_variant", q.shape[0], q.shape[1], q.shape[2])


def flash_bwd_reference(q, k, v, bias, o, lse, do, scale, causal,
                        window=None, q_offset=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels (the JAX
    ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` arithmetic, in fp32): P is
    replayed from lse with no max or denominator recompute, delta =
    rowsum(o * do) in fp32, and P and dS are rounded to the input dtype
    before the products they feed, where the kernels round them. A row with
    lse = +inf (no valid key) replays P = 0 and contributes nothing. bias
    None is a zero bias; the bias gets no gradient."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    if q_offset is None:
        q_offset = Sk - Sq
    dt = q.dtype
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    dof = do.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, None, :]
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        s = torch.where(keep, s, NEG_INF)
    lse5 = lse.float().reshape(B, Hkv, G, Sq, 1)
    p = torch.exp(s - lse5)                         # [B, Hkv, G, Sq, Sk]
    delta = (do.float() * o.float()).sum(-1)        # [B, Sq, H]
    delta5 = delta.permute(0, 2, 1).reshape(B, Hkv, G, Sq, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = (p * (dp - delta5) * scale).to(dt).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, bias, o, lse, do, scale, causal, window=None,
              q_offset=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq [B,Sq,H,D], dk, dv [B,Sk,Hkv,D]) in the input dtype. CPU tensors
    run the plain version; CUDA tensors launch the kernels (each call counts
    once in FLASH_BWD.launches) or raise. delta = rowsum(o * do) is one
    fp32 PyTorch reduction here, as it is one XLA reduction in JAX."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, bias, o, lse, do, scale, causal,
                                   window, q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_bwd: no kernel for device {q.device}")
    _check_bwd_args(q, k, v, bias, o, lse, do, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = Sk - Sq
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_BWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              bias.data_ptr() if bias is not None else None,
              lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, Sq, Sk, H, Hkv, D, float(scale), int(causal),
              int(window) if window is not None else 0, int(q_offset),
              torch.cuda.current_stream(q.device).cuda_stream)
    FLASH_BWD.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the flash kernels on both passes: the
    forward saves (q, k, v, bias, o, lse), the backward replays the softmax
    from lse through flash_bwd. The bias gets no gradient (a mask)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, bounded, window,
                has_bias):
        o, lse = flash_fwd(q, k, v, bias, scale, causal, bounded, window,
                           has_bias)
        # the backward replays with the bias the forward added
        bias = bias if (causal or has_bias) else None
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale, ctx.causal, ctx.window = scale, causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, bias, o, lse, do.contiguous(),
                               ctx.scale, ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None, None, None, None


def flash_mha(q, k, v, *, causal: bool = False,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              bounded_softmax: bool = False,
              sliding_window: Optional[int] = None) -> torch.Tensor:
    """Attention through the flash kernels. mask: [B, Sk] keep-mask or None.
    bounded_softmax: skip the row-max pass (qk-normed scores only).
    sliding_window: causal only; keep keys with qpos - kpos < window.
    Differentiable in q, k and v; without a gradient to take (no_grad,
    inference_mode, or no input that requires one) it is flash_fwd alone."""
    if mask is not None and mask.dim() != 2:
        raise ValueError("flash_mha takes a [B, Sk] keep-mask; got "
                         f"{tuple(mask.shape)}")
    if sliding_window is not None and not causal:
        raise ValueError("sliding_window requires causal attention")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = None
    if mask is not None:
        bias = torch.where(mask.bool(), 0.0, NEG_INF).float().contiguous()
    # split q/k/v projections arrive as strided views; the kernels read
    # dense [B, S, H, D]
    args = (q.contiguous(), k.contiguous(), v.contiguous(), bias, scale,
            causal, bounded_softmax, sliding_window, mask is not None)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(*args)
    o, _ = flash_fwd(*args)
    return o
