# The port's own copy of grounded_video_llm_tpu/core/config.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Typed configuration system.

The reference threads a flat argparse namespace everywhere (reference train.py:17-57,
inference.py:13-51) with magic numbers inlined in the model file
(reference models/llava_next_video.py:41-71). Here every subsystem gets a frozen,
hashable dataclass so configs can be closed over by jit without retracing hazards,
and the three training-stage presets (reference scripts/phi3.5_*_8_a100.sh) are
first-class constructors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Vision encoders
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14-336 spatial encoder (reference models/llava_next_video.py:56-71)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # Penultimate-layer feature tap: run only the first (num_layers - 1) encoder
    # layers; the reference takes hidden_states[-2] (llava_next_video.py:505).
    feature_layer: int = -2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2  # 576

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class InternVideo2Config:
    """InternVideo2-1B temporal encoder (reference models/internvideo2.py:1089-1116).

    The runtime path stops one block early (x_vis_return_idx=-2 →
    blocks 0..depth-2 inclusive, reference internvideo2.py:1028-1030) and never
    runs the CLIP-teacher heads, so only the trunk is modeled.
    """

    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48 / 11
    image_size: int = 224
    patch_size: int = 14
    num_frames: int = 8  # frames per segment clip
    tubelet_size: int = 1
    qkv_bias: bool = False
    qk_normalization: bool = True
    rms_eps: float = 1e-6
    layerscale_init: float = 1e-5
    # Early exit: number of transformer blocks actually run (depth - 1 for
    # x_vis_return_idx=-2: loop breaks *after* running block idx depth-2).
    num_blocks_used: int = 39

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)  # 6144

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads  # 88

    @property
    def patches_per_frame(self) -> int:
        return (self.image_size // self.patch_size) ** 2  # 256

    @property
    def seq_len(self) -> int:
        # cls + T*L tokens
        return 1 + (self.num_frames // self.tubelet_size) * self.patches_per_frame


# ---------------------------------------------------------------------------
# Language models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only causal LM covering Phi-3.5-mini and Llama-3-8B.

    family: "phi3" → fused qkv/gate_up weights, LongRoPE-capable
            (reference models/modeling_phi3.py); "llama" → GQA with separate
            q/k/v, rope theta from config (reference models/modeling_llama.py).
    """

    family: str = "phi3"
    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 96
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    # LongRoPE dual-factor scaling (reference modeling_phi3.py:371-409); tuples of
    # per-dim factors, empty → plain RoPE.
    rope_scaling_short: Tuple[float, ...] = ()
    rope_scaling_long: Tuple[float, ...] = ()
    # Sliding-window attention (reference modeling_phi3.py:688-718): each query
    # attends the most recent `sliding_window` keys (qpos - kpos < window).
    # None → full causal. Phi-3.5-mini ships 262144, which never binds at this
    # framework's sequence lengths (≤ ~7.5k) — parity surface, not a hot path.
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    # Number of extra rows appended for temporal tokens + grounding token
    # (reference llava_next_video.py:231-268): <0>..<300> plus <timestamp_grounding>.
    num_extra_tokens: int = 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab_size(self) -> int:
        return self.vocab_size + self.num_extra_tokens


# Phi-3.5 LongRoPE per-frequency rescale tables (48 = head_dim/2 entries each),
# from the published microsoft/Phi-3.5-mini-instruct config.json ("longrope"
# scaling — the same LLM trunk the reference's Phi-3.5-vision config wraps,
# reference models/llava_next_video.py:85 + modeling_phi3.py:371-409).
# models/convert.py overrides these with the checkpoint's own tables when real
# weights carry a rope_scaling dict, so the defaults only need to match the
# published release.
PHI35_ROPE_SHORT_FACTOR: Tuple[float, ...] = (
    1.0, 1.0199999809265137, 1.0299999713897705, 1.0299999713897705,
    1.0499999523162842, 1.0499999523162842, 1.0499999523162842,
    1.0499999523162842, 1.0499999523162842, 1.0699999332427979,
    1.0999999046325684, 1.1099998950958252, 1.1599998474121094,
    1.1599998474121094, 1.1699998378753662, 1.2899998426437378,
    1.339999794960022, 1.679999828338623, 1.7899998426437378,
    1.8199998140335083, 1.8499997854232788, 1.8799997568130493,
    1.9099997282028198, 1.9399996995925903, 1.9899996519088745,
    2.0199997425079346, 2.0199997425079346, 2.0199997425079346,
    2.0199997425079346, 2.0199997425079346, 2.0199997425079346,
    2.0299997329711914, 2.0299997329711914, 2.0299997329711914,
    2.0299997329711914, 2.0299997329711914, 2.0299997329711914,
    2.0299997329711914, 2.0299997329711914, 2.0299997329711914,
    2.0799996852874756, 2.0899996757507324, 2.189999580383301,
    2.2199995517730713, 2.5899994373321533, 2.729999542236328,
    2.749999523162842, 2.8399994373321533,
)
PHI35_ROPE_LONG_FACTOR: Tuple[float, ...] = (
    1.0800000429153442, 1.1100000143051147, 1.1399999856948853,
    1.340000033378601, 1.5899999141693115, 1.600000023841858,
    1.6200000047683716, 2.620000123977661, 3.2300000190734863,
    3.2300000190734863, 4.789999961853027, 7.400000095367432,
    7.700000286102295, 9.09000015258789, 12.199999809265137,
    17.670000076293945, 24.46000099182129, 28.57000160217285,
    30.420001983642578, 30.840002059936523, 32.590003967285156,
    32.93000411987305, 42.320003509521484, 44.96000289916992,
    50.340003967285156, 50.45000457763672, 57.55000305175781,
    57.93000411987305, 58.21000289916992, 60.1400032043457,
    62.61000442504883, 62.62000274658203, 62.71000289916992,
    63.1400032043457, 63.1400032043457, 63.77000427246094,
    63.93000411987305, 63.96000289916992, 63.970001220703125,
    64.02999877929688, 64.06999969482422, 64.08000183105469,
    64.12000274658203, 64.41000366210938, 64.4800033569336,
    64.51000213623047, 64.52999877929688, 64.83999633789062,
)


def phi35_mini_config(num_extra_tokens: int = 0) -> LLMConfig:
    """Phi-3.5-mini-instruct 3.8B."""
    return LLMConfig(
        family="phi3",
        vocab_size=32064,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        rms_eps=1e-5,
        rope_theta=10000.0,
        max_position_embeddings=131072,
        original_max_position_embeddings=4096,
        rope_scaling_short=PHI35_ROPE_SHORT_FACTOR,
        rope_scaling_long=PHI35_ROPE_LONG_FACTOR,
        sliding_window=262144,
        num_extra_tokens=num_extra_tokens,
    )


def vicuna_7b_config(num_extra_tokens: int = 0) -> LLMConfig:
    """Vicuna-7B-v1.5 (Llama-2-7B architecture: MHA, vocab 32000, θ=1e4,
    intermediate 11008). The reference exposes the vicuna backend via its
    template + the llama code path (reference train.py:23,
    datasets/chat/base_template.py:121-128); the weights are llama-2-arch,
    not llama-3 — vocab/θ/MLP all differ."""
    return LLMConfig(
        family="llama",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        rms_eps=1e-5,
        rope_theta=10000.0,
        max_position_embeddings=4096,
        original_max_position_embeddings=4096,
        num_extra_tokens=num_extra_tokens,
    )


def llama3_8b_config(num_extra_tokens: int = 0) -> LLMConfig:
    """Meta-Llama-3-8B (LLaVA-Next wiring)."""
    return LLMConfig(
        family="llama",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rms_eps=1e-5,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        original_max_position_embeddings=8192,
        num_extra_tokens=num_extra_tokens,
    )


# ---------------------------------------------------------------------------
# Composite VLM
# ---------------------------------------------------------------------------

NUM_TEMPORAL_TOKENS = 300  # <0>..<300> inclusive → 301 tokens
NUM_SPECIAL_TOKENS = NUM_TEMPORAL_TOKENS + 1 + 1  # + <timestamp_grounding> = 302


@dataclass(frozen=True)
class VLMConfig:
    """The composite dual-stream VLM (reference models/llava_next_video.py:73-268).

    llm_name selects the fusion arithmetic:
      phi3.5  → 2x2 patch-merge + sub_GN newlines → 156 spatial tokens/seg,
                glb_GN-projected newline, 156+128+1 = 285 tokens/seg.
      llama3  → avg-pool to 8x8 → 64 spatial tokens/seg, stored image_newline,
                64+128+1 = 193 tokens/seg.
    """

    llm_name: str = "phi3.5"  # "phi3.5" | "llama3" | "vicuna"
    num_frames: int = 96
    num_segs: int = 12
    num_temporal_tokens: int = NUM_TEMPORAL_TOKENS
    max_txt_len: int = 2048
    spatial_image_size: int = 336
    temporal_image_size: int = 224
    # Device-memory cap for serving: models/vlm.encode_video runs
    # InternVideo2 in a loop over chunks of this many clips (where it is
    # below B*num_segs and divides it), so the encoder's activations scale
    # with the chunk, not with B*num_segs. None → one whole-batch encode.
    encoder_chunk_clips: Optional[int] = None
    clip: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    video: InternVideo2Config = field(default_factory=InternVideo2Config)
    llm: LLMConfig = field(default_factory=phi35_mini_config)

    @property
    def num_frames_per_seg(self) -> int:
        return self.num_frames // self.num_segs

    @property
    def spatial_tokens_per_seg(self) -> int:
        if self.llm_name == "phi3.5":
            return 12 * 13  # 12 rows x (12 + 1 newline col) = 156
        return 64

    @property
    def temporal_tokens_per_seg(self) -> int:
        return self.num_frames_per_seg * 16  # pool to 4x4 per frame → 128

    @property
    def tokens_per_seg(self) -> int:
        return self.spatial_tokens_per_seg + self.temporal_tokens_per_seg + 1

    @property
    def num_video_tokens(self) -> int:
        # phi3.5: 12*285 = 3420; llama3: 12*193 = 2316 (reference :563)
        return self.num_segs * self.tokens_per_seg


def vlm_config(llm_name: str = "phi3.5", stage: str = "pretrain", **kw) -> VLMConfig:
    """Build the full-size config for an LLM backend + training stage.

    Vocab expansion (302 extra rows) applies in grounded/sft stages only
    (reference llava_next_video.py:175,197).
    """
    extra = NUM_SPECIAL_TOKENS if stage in ("grounded", "sft", "inference") else 0
    if llm_name == "phi3.5":
        llm = phi35_mini_config(num_extra_tokens=extra)
    elif llm_name == "llama3":
        llm = llama3_8b_config(num_extra_tokens=extra)
    elif llm_name == "vicuna":
        llm = vicuna_7b_config(num_extra_tokens=extra)
    else:
        raise ValueError(f"unknown llm {llm_name!r}")
    max_txt_len = 4096 if stage == "grounded" else 2048
    defaults = dict(llm_name=llm_name, llm=llm, max_txt_len=max_txt_len)
    defaults.update(kw)
    return VLMConfig(**defaults)


def tiny_vlm_config(llm_name: str = "phi3.5") -> VLMConfig:
    """A miniature config for tests: same wiring, tiny dims, full token arithmetic."""
    clip = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_layers=3, num_heads=4,
        image_size=336, patch_size=14,
    )
    video = InternVideo2Config(
        embed_dim=64, depth=3, num_heads=4, mlp_ratio=2.0,
        image_size=224, patch_size=14, num_frames=8, num_blocks_used=2,
    )
    if llm_name == "phi3.5":
        llm = LLMConfig(
            family="phi3", vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
            num_extra_tokens=NUM_SPECIAL_TOKENS,
        )
    else:
        llm = LLMConfig(
            family="llama", vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            rope_theta=500000.0, num_extra_tokens=NUM_SPECIAL_TOKENS,
        )
    return VLMConfig(llm_name=llm_name, clip=clip, video=video, llm=llm,
                     num_frames=96, num_segs=12)


def micro_vlm_config(llm_name: str = "phi3.5") -> VLMConfig:
    """Even smaller than tiny: 8 frames / 2 segs, for compute-path tests that
    must run in seconds on a single CPU core. Keeps the real patch grids
    (336/14=24, 224/14=16) so the merge/pool arithmetic is exercised."""
    base = tiny_vlm_config(llm_name)
    video = replace(base.video, num_frames=4, depth=2, num_blocks_used=2)
    clip = replace(base.clip, num_layers=2)
    return replace(base, num_frames=8, num_segs=2, video=video, clip=clip)


# ---------------------------------------------------------------------------
# Training stages
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageConfig:
    """One training stage (reference scripts/phi3.5_{pretrain,grounded,sft}_8_a100.sh
    + the frozen/trainable split in llava_next_video.py:155-210 and the optimizer
    groups in training/fsdp.py:184-256)."""

    name: str = "pretrain"
    dataset: str = "mix_pretrain"
    global_batch_size: int = 256
    per_device_batch_size: int = 16
    epochs: int = 1
    max_txt_len: int = 2048
    lora: bool = False
    lora_dropout: float = 0.0   # peft lora_dropout (reference :215 → 0.05)
    expand_vocab: bool = False
    # learning rates by param group
    lr_video_projector: float = 1e-3
    lr_mm_projector: float = 1e-5
    lr_llm: float = 0.0          # lm_head + embed rows (grounded/sft)
    lr_lora: float = 0.0
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    sharding: str = "shard-grad-op"  # "shard-grad-op" (ZeRO-2) | "full-shard" (ZeRO-3)


STAGE_PRESETS = {
    "pretrain": StageConfig(
        name="pretrain", dataset="mix_pretrain", global_batch_size=256,
        per_device_batch_size=16, epochs=1, max_txt_len=2048,
        lora=False, expand_vocab=False,
        lr_video_projector=1e-3, lr_mm_projector=1e-5,
        sharding="shard-grad-op",
    ),
    "grounded": StageConfig(
        name="grounded", dataset="mix_grounded", global_batch_size=128,
        per_device_batch_size=16, epochs=3, max_txt_len=4096,
        lora=True, lora_dropout=0.05, expand_vocab=True,
        lr_video_projector=2e-5, lr_mm_projector=2e-5, lr_llm=2e-5, lr_lora=2e-4,
        sharding="full-shard",
    ),
    "sft": StageConfig(
        name="sft", dataset="mix_sft", global_batch_size=96,
        per_device_batch_size=12, epochs=1, max_txt_len=2048,
        lora=True, lora_dropout=0.05, expand_vocab=True,
        lr_video_projector=2e-5, lr_mm_projector=2e-5, lr_llm=2e-5, lr_lora=2e-4,
        sharding="full-shard",
    ),
}


@dataclass(frozen=True)
class GenerateConfig:
    """Sampling defaults (reference inference.py:45-49, 170-176)."""

    max_new_tokens: int = 2048
    do_sample: bool = True
    temperature: float = 0.2
    top_p: Optional[float] = None
    num_beams: int = 1
    # speculative decoding (serve/speculative.py): n-gram prompt-lookup
    # drafts verified in one pass. 0 = off. Greedy mode is token-exact vs
    # lockstep; sampling uses delta-draft rejection (distribution-exact).
    # Uses the int8 KV cache.
    spec_draft_len: int = 0
    # int8 KV cache for lockstep decode (models/llm.py QuantKVCache + the
    # Pallas dequant-in-VMEM decode attention) — the serving-stack decode
    # path (12.4 ms/tok vs ~17 bf16 at batch 6 on the TPU). Ignored by beam
    # search; speculative decoding always uses it.
    quantize_cache: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes. data = DP (+ DCN replica), fsdp = param sharding over ICI,
    tensor = optional TP within a replica (reference has no TP; SURVEY §2.5)."""

    data: int = 1
    fsdp: int = -1  # -1 → all remaining devices
    tensor: int = 1


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
