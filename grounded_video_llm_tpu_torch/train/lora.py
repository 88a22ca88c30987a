"""LoRA overlay on the LLM's fused projection matrices (port of
grounded_video_llm_tpu/train/lora.py).

Low-rank adapters on the attention and MLP projections (peft r=128, α=256,
dropout 0.05 in the reference's grounded and sft stages), attached to the
fused qkv / o / gate_up / down kernels and stacked over layers like them:
``layers/lora/<target>/{a [L, D_in, r], b [L, r, D_out], scale [L]}``.
models/llm.py:_dense computes (x @ A) @ B * scale without forming the delta.
"""

from __future__ import annotations

import torch

from ..core.config import LLMConfig
from ..models.param_utils import normal

LORA_TARGETS = ("qkv", "o", "gate_up", "down")
_TARGET_DIMS = {
    "qkv": lambda cfg: (cfg.hidden_size, cfg.q_dim + 2 * cfg.kv_dim),
    "o": lambda cfg: (cfg.q_dim, cfg.hidden_size),
    "gate_up": lambda cfg: (cfg.hidden_size, 2 * cfg.intermediate_size),
    "down": lambda cfg: (cfg.intermediate_size, cfg.hidden_size),
}


def init_lora(cfg: LLMConfig, *, generator: torch.Generator, device,
              rank: int = 128, alpha: float = 256.0, dtype=torch.float32):
    """A ~ N(0, 0.02) from ``generator``, B = 0 (the adapters start as a
    zero delta), scale = alpha / rank."""
    L = cfg.num_layers
    out = {}
    for name in LORA_TARGETS:
        d_in, d_out = _TARGET_DIMS[name](cfg)
        out[name] = {
            "a": normal((L, d_in, rank), 0.02, generator=generator,
                        device=device, dtype=dtype),
            "b": torch.zeros(L, rank, d_out, device=device, dtype=dtype),
            "scale": torch.full((L,), alpha / rank, device=device,
                                dtype=dtype),
        }
    return out


def attach_lora(llm_params, lora_params):
    """A new LLM tree with the lora subtree under ``layers``."""
    layers = dict(llm_params["layers"])
    layers["lora"] = lora_params
    out = dict(llm_params)
    out["layers"] = layers
    return out


def detach_lora(llm_params):
    """→ (the LLM tree without adapters, the lora subtree or None)."""
    layers = dict(llm_params["layers"])
    lora = layers.pop("lora", None)
    out = dict(llm_params)
    out["layers"] = layers
    return out, lora


@torch.no_grad()
def merge_lora(llm_params):
    """Fold the adapters into the base kernels for serving without the
    extra products: W' = W + scale * A @ B."""
    params, lora = detach_lora(llm_params)
    if lora is None:
        return llm_params
    layers = dict(params["layers"])
    for name, la in lora.items():
        key = f"{name}_kernel"
        delta = torch.einsum("lir,lro->lio", la["a"], la["b"])
        layers[key] = layers[key] + delta * la["scale"][:, None, None].to(
            layers[key].dtype)
    out = dict(params)
    out["layers"] = layers
    return out
