"""Attention over the int8 KV cache: K4 (``decode_attention_int8``,
csrc/decode_attention_int8.cu) and K8 (``verify_attention_int8``,
csrc/verify_attention_int8.cu), each with its plain PyTorch version (port
of grounded_video_llm_tpu/ops/decode_attention_int8.py, ``_kernel`` and
``_kernel_multi``).

Cache layout (``models/llm.QuantKVCache``): values [L, B, Hkv, max_len, D]
int8 with fp32 scales [L, B, Hkv, max_len], one scale per (slot, kv head).
One slot's D bytes are contiguous, so the slots of a (batch row, kv head)
are one contiguous run, which the kernels copy in chunks of 128 slots.
(The JAX package's head-major transposed [.., D, max_len] layout is a TPU
lane-padding choice; it has no use on the GPU.) A layer is a free view
``cache.k[l]`` [B, Hkv, max_len, D], so there is no layer-indexed twin.

The math, including where it rounds (the kernel and the plain version
agree; the tests hold both to the JAX function): scores use q rounded to
bf16 against the int8 keys, times the key scale and the softmax scale, the
fp32 minimum where the slot is not valid; the current token rides as an
extra bf16 slot whose score uses q unrounded; after the softmax over all
slots, p times the value scale is rounded to bf16 before the value sum.

K8, the speculative verify, takes S new tokens' queries [B, S, H, D], a
per-query mask [B, S, L] and the S tokens' own bf16 k/v [B, S, Hkv, D]:
query i sees the cache through its mask row and new token j where j <= i.
It keeps ``_kernel_multi``'s roundings, which are not K4's: q is rounded to
bf16 for the new-token scores too, the new k/v are rounded to bf16, the
joint softmax is normalised before the value sums, and both p * v_scale and
the new tokens' p are rounded to bf16. So at S = 1 it is close to K4, not
bit-equal to it. The output is in q's dtype.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .cuda_build import CudaKernel
from .flash_attention import NEG_INF
from .int8_matmul import quantize_rows

# the launch plan of csrc/int8_attention.cuh (make_plan), mirrored here so
# the wrappers refuse what the C entries would and the CPU tests can hold it
ATTN_CHUNK = 128          # slots a chunk: one bulk copy, one mask test
ATTN_QG = 32              # queries a value pass
ATTN_CMAX = 16            # blocks a cluster at most
ATTN_TARGET_BLOCKS = 396  # blocks a grid aims for: one wave, three an SM
ATTN_MIN_CHUNKS = 4       # chunks a block, where the grid allows
_SMEM_TARGET = 74 * 1024   # three blocks an SM
_SMEM_LIMIT = 227 * 1024


class AttentionPlan(NamedTuple):
    """One launch of K4 or K8: ``cluster`` blocks per (b, kv head) (grid
    ``blocks`` = B * Hkv * cluster), ``slots_per_block`` consecutive slots
    each (the last block of a row fewer), ``stages`` ring stages of
    ATTN_CHUNK * (D + 4) bytes and ``smem`` bytes of dynamic shared
    memory."""
    cluster: int
    blocks: int
    slots_per_block: int
    stages: int
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _plan_with(c0, B, Hkv, G, S, L, D) -> Optional[AttentionPlan]:
    Q = G * S
    nch = -(-L // ATTN_CHUNK)
    cpb = -(-nch // c0)
    C = -(-nch // cpb)
    P = min(cpb * ATTN_CHUNK, _round_up(L, 16)) + 8      # row pitch
    items = cpb * (1 + -(-Q // ATTN_QG))
    stage = ATTN_CHUNK * (D + 4) + 16     # rows, key scales, mbarriers
    Qp = _round_up(Q, 8)
    rest = (Q * P * 4 + _round_up(S * cpb * ATTN_CHUNK // 8, 16)
            + Qp * D * 2 + min(Qp, ATTN_QG) * D * 4
            + _round_up(Q * S * 4, 16) + _round_up(16 * Q, 16)
            + _round_up(4 * cpb, 16))
    n = min(max((_SMEM_TARGET - rest) // stage, 2), items)
    if rest + n * stage > _SMEM_LIMIT:
        n = (_SMEM_LIMIT - rest) // stage
    if n < 1:
        return None
    return AttentionPlan(C, B * Hkv * C, cpb * ATTN_CHUNK, n, rest + n * stage)


def attention_plan(B: int, Hkv: int, G: int, S: int, L: int,
                   D: int) -> Optional[AttentionPlan]:
    """The C entries' plan for q [B, S, Hkv * G, D] over L slots (K4: S = 1):
    clusters of ATTN_TARGET_BLOCKS // (B * Hkv) blocks, but none so many
    that a block gets fewer than ATTN_MIN_CHUNKS chunks (at least 1 block,
    at most ATTN_CMAX and one a chunk), more while a block needs more than
    _SMEM_TARGET of shared memory; None where not even ATTN_CMAX blocks fit
    the 227 KB a block may have."""
    nch = -(-L // ATTN_CHUNK)
    top = min(nch, ATTN_CMAX)
    c0 = min(ATTN_TARGET_BLOCKS // (B * Hkv), -(-nch // ATTN_MIN_CHUNKS))
    for c0 in range(min(max(c0, 1), top), top + 1):
        plan = _plan_with(c0, B, Hkv, G, S, L, D)
        if plan is not None and (plan.smem <= _SMEM_TARGET or c0 == top):
            return plan
    return _plan_with(top, B, Hkv, G, S, L, D)


def _check_plan(kernel: str, B, Hkv, G, S, L, D) -> None:
    if attention_plan(B, Hkv, G, S, L, D) is None:
        raise ValueError(
            f"{kernel} kernel: G*S = {G * S} queries over L = {L} slots "
            f"need more than {_SMEM_LIMIT} bytes of shared memory in each "
            f"block of a {ATTN_CMAX}-block cluster (a block keeps L/"
            f"{ATTN_CMAX} slots' scores and mask bits, 4*G*S + S/8 bytes a "
            f"slot, plus at least one stage of {ATTN_CHUNK}*(D + 4) bytes); "
            "too many (at D = 96 the cap is 827,392 slots for G*S = 1, "
            "165,888 for 5)")


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] → (int8 [..., D], fp32 scales [...]), absmax per row."""
    q, s = quantize_rows(x)
    return q, s[..., 0]


def decode_attention_int8_reference(q, k_q, k_s, v_q, v_s, valid_mask,
                                    k_new, v_new, *, scale: float
                                    ) -> torch.Tensor:
    """Plain version. q [B, 1, H, D]; k_q/v_q [B, Hkv, L, D] int8;
    k_s/v_s [B, Hkv, L] fp32; valid_mask [B, L]; k_new/v_new [B, 1, Hkv, D]
    → [B, 1, H, D] in q's dtype."""
    B, _, H, D = q.shape
    Hkv = k_q.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, D)
    qb = q.to(torch.bfloat16).float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhld->bhgl", qb, k_q.float())
    s = s * k_s[:, :, None, :] * scale
    s = torch.where(valid_mask[:, None, None, :].bool(), s, NEG_INF)
    kn = k_new.float().reshape(B, Hkv, 1, D)
    vn = v_new.float().reshape(B, Hkv, 1, D)
    s_new = (qf * kn).sum(dim=-1, keepdim=True) * scale        # [B,Hkv,G,1]
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_new)
    p = torch.exp(s - m)
    p_new = torch.exp(s_new - m)
    denom = p.sum(dim=-1, keepdim=True) + p_new
    pv = (p * v_s[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bhgl,bhld->bhgd", pv, v_q.float()) + p_new * vn
    return (out / denom).reshape(B, 1, H, D).to(q.dtype)


# gvllm_decode_attention_int8(q, k8, ks, v8, vs, valid, k_new, v_new, out,
#                             B, H, Hkv, L, D, scale, stream) -> cudaError_t
DECODE_ATTENTION_INT8 = CudaKernel(
    "decode_attention_int8.cu", "gvllm_decode_attention_int8",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_void_p])


def _check_tensors(kernel, q, k_q, k_s, v_q, v_s, k_new, v_new, S):
    """dtype, shape, contiguity and alignment of K4's and K8's inputs, the
    cache [B, Hkv, L, D] giving the shapes and S the number of queries."""
    B, Hkv, L, D = k_q.shape
    H = q.shape[2]
    for name, t, shape, dtype in (
            ("q", q, (B, S, H, D), torch.bfloat16),
            ("k_q", k_q, (B, Hkv, L, D), torch.int8),
            ("v_q", v_q, (B, Hkv, L, D), torch.int8),
            ("k_s", k_s, (B, Hkv, L), torch.float32),
            ("v_s", v_s, (B, Hkv, L), torch.float32),
            ("k_new", k_new, (B, S, Hkv, D), torch.bfloat16),
            ("v_new", v_new, (B, S, Hkv, D), torch.bfloat16)):
        if t.dtype != dtype:
            raise TypeError(f"{kernel} kernel takes {dtype} {name}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel takes a contiguous, 16-byte "
                             f"aligned {name}")


def _check_launch_args(q, k_q, k_s, v_q, v_s, valid_mask, k_new, v_new):
    tensors = (q, k_q, k_s, v_q, v_s, valid_mask, k_new, v_new)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention_int8: all inputs must share a "
                         "device")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention_int8 takes q [B, 1, H, D], got "
                         f"{tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_q.dim() != 4 or k_q.shape[0] != B or k_q.shape[3] != D:
        raise ValueError(f"decode_attention_int8: cache {tuple(k_q.shape)} "
                         f"does not match q {tuple(q.shape)}")
    Hkv, L = k_q.shape[1], k_q.shape[2]
    _check_tensors("decode_attention_int8", q, k_q, k_s, v_q, v_s, k_new,
                   v_new, S=1)
    if (valid_mask.dtype not in (torch.bool, torch.uint8)
            or tuple(valid_mask.shape) != (B, L)):
        raise ValueError("decode_attention_int8 kernel takes a bool or uint8 "
                         f"[B, L] valid_mask, got {valid_mask.dtype} "
                         f"{tuple(valid_mask.shape)}")
    G = H // Hkv if H % Hkv == 0 else 0
    if G not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention_int8 kernel takes 1, 2, 4 or 8 "
                         f"q heads per kv head; got {H} over {Hkv}")
    if D % 32 or D > 128:
        raise ValueError(f"decode_attention_int8 kernel takes D in (32, 64, "
                         f"96, 128), got {D}")
    _check_plan("decode_attention_int8", B, Hkv, G, 1, L, D)


def decode_attention_int8(q, k_q, k_s, v_q, v_s, valid_mask, k_new, v_new,
                          *, scale: float) -> torch.Tensor:
    """K4: [B, 1, H, D] attention of one new token over one layer of the
    int8 cache plus its own k/v. CPU tensors run the plain version; CUDA
    tensors launch the kernel (counted in DECODE_ATTENTION_INT8.launches)
    or raise."""
    if q.device.type == "cpu":
        return decode_attention_int8_reference(
            q, k_q, k_s, v_q, v_s, valid_mask, k_new, v_new, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention_int8: no kernel for device "
                           f"{q.device}")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    q = q.contiguous()
    valid_mask = valid_mask.contiguous()
    _check_launch_args(q, k_q, k_s, v_q, v_s, valid_mask, k_new, v_new)
    B, _, H, D = q.shape
    Hkv, L = k_q.shape[1], k_q.shape[2]
    out = torch.empty_like(q)
    DECODE_ATTENTION_INT8(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), valid_mask.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), out.data_ptr(), B, H, Hkv, L, D, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    DECODE_ATTENTION_INT8.launches += 1
    return out


def verify_attention_int8_reference(q, k_q, k_s, v_q, v_s, mask, k_new,
                                    v_new, *, scale: float) -> torch.Tensor:
    """Plain version of K8. q [B, S, H, D]; k_q/v_q [B, Hkv, L, D] int8;
    k_s/v_s [B, Hkv, L] fp32; mask [B, S, L]; k_new/v_new [B, S, Hkv, D]
    → [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    Hkv = k_q.shape[1]
    G = H // Hkv
    bf16 = torch.bfloat16
    qb = q.to(bf16).float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bhgid,bhld->bhgil", qb, k_q.float())
    s = s * (k_s * scale)[:, :, None, None, :]
    s = torch.where(mask[:, None, None].bool(), s, NEG_INF)
    kn = k_new.to(bf16).float().permute(0, 2, 1, 3)          # [B,Hkv,S,D]
    vn = v_new.to(bf16).float().permute(0, 2, 1, 3)
    sn = torch.einsum("bhgid,bhjd->bhgij", qb, kn) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    sn = torch.where(causal, sn, NEG_INF)
    m = torch.maximum(s.amax(dim=-1), sn.amax(dim=-1))[..., None]
    p = torch.exp(s - m)
    pn = torch.exp(sn - m)
    denom = p.sum(dim=-1, keepdim=True) + pn.sum(dim=-1, keepdim=True)
    pv = (p / denom * v_s[:, :, None, None, :]).to(bf16).float()
    pn = (pn / denom).to(bf16).float()
    out = (torch.einsum("bhgil,bhld->bhgid", pv, v_q.float())
           + torch.einsum("bhgij,bhjd->bhgid", pn, vn))
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


# gvllm_verify_attention_int8(q, k8, ks, v8, vs, mask, k_new, v_new, out,
#                             B, S, H, Hkv, L, D, scale, stream)
VERIFY_ATTENTION_INT8 = CudaKernel(
    "verify_attention_int8.cu", "gvllm_verify_attention_int8",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_void_p])

def _check_verify_args(q, k_q, k_s, v_q, v_s, mask, k_new, v_new):
    tensors = (q, k_q, k_s, v_q, v_s, mask, k_new, v_new)
    if any(t.device != q.device for t in tensors):
        raise ValueError("verify_attention_int8: all inputs must share a "
                         "device")
    if q.dim() != 4 or q.shape[1] < 1:
        raise ValueError(f"verify_attention_int8 takes q [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    B, S, H, D = q.shape
    if k_q.dim() != 4 or k_q.shape[0] != B or k_q.shape[3] != D:
        raise ValueError(f"verify_attention_int8: cache {tuple(k_q.shape)} "
                         f"does not match q {tuple(q.shape)}")
    Hkv, L = k_q.shape[1], k_q.shape[2]
    _check_tensors("verify_attention_int8", q, k_q, k_s, v_q, v_s, k_new,
                   v_new, S=S)
    if (mask.dtype not in (torch.bool, torch.uint8)
            or tuple(mask.shape) != (B, S, L) or not mask.is_contiguous()):
        raise ValueError("verify_attention_int8 kernel takes a contiguous "
                         f"bool or uint8 [B, S, L] mask, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if H % Hkv:
        raise ValueError(f"verify_attention_int8: {H} query heads over {Hkv} "
                         "kv heads")
    if D % 32 or D > 128:
        raise ValueError(f"verify_attention_int8 kernel takes D in (32, 64, "
                         f"96, 128), got {D}")
    _check_plan("verify_attention_int8", B, Hkv, H // Hkv, S, L, D)


def verify_attention_int8(q, k_q, k_s, v_q, v_s, mask, k_new, v_new, *,
                          scale: float) -> torch.Tensor:
    """K8: [B, S, H, D] attention of S new tokens over one layer of the int8
    cache plus their own k/v, causally. CPU tensors run the plain version;
    CUDA tensors launch the kernel (counted in
    VERIFY_ATTENTION_INT8.launches) or raise."""
    if q.device.type == "cpu":
        return verify_attention_int8_reference(
            q, k_q, k_s, v_q, v_s, mask, k_new, v_new, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"verify_attention_int8: no kernel for device "
                           f"{q.device}")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    mask = mask.contiguous()
    _check_verify_args(q, k_q, k_s, v_q, v_s, mask, k_new, v_new)
    B, S, H, D = q.shape
    Hkv, L = k_q.shape[1], k_q.shape[2]
    out = torch.empty_like(q)
    VERIFY_ATTENTION_INT8(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), mask.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        out.data_ptr(), B, S, H, Hkv, L, D, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    VERIFY_ATTENTION_INT8.launches += 1
    return out
