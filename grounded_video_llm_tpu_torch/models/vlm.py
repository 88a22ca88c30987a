"""The composite dual-stream VLM: encode, fuse, splice, loss (port of
grounded_video_llm_tpu/models/vlm.py).

  encode_video:
    spatial [B,12,336,336,3] → CLIP penultimate (CLS dropped) → [B*12,576,C]
      phi3.5: 2x2 patch merge → +sub_GN newline column → mm_projector
              → [B,12,156,H]
      llama3 / vicuna: 24x24 → 8x8 mean pool → mm_projector → [B,12,64,H]
    temporal [B,96,224,224,3] → 12 clips of 8 → InternVideo2 (early exit, CLS
      dropped; in chunks of cfg.encoder_chunk_clips clips where set) →
      per-frame 16x16 → 4x4 mean pool → video_projector → [B,12,128,H]
    fuse: per segment [image | segment | newline], newline =
      mm_projector(glb_GN) (phi3.5) or the stored image_newline (llama3,
      vicuna)
  splice_multimodal: the single IMAGE_TOKEN_INDEX slot is replaced by the
    video tokens as one static-shape gather; text-only rows append the video
    tokens at the end with attention 0.
  forward_loss: encode (frozen encoders under no_grad) → splice → LLM →
    sequence-chunked cross entropy.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import VLMConfig
from ..ops.preprocess import (INTERNVIDEO_MEAN, INTERNVIDEO_STD,
                              OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
from ..text.templates import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from . import clip_vit, internvideo2, llm as llm_mod, projectors
from .param_utils import child_generator, normal


class Batch(NamedTuple):
    """Training batch of tensors on one device."""
    input_ids: torch.Tensor        # [B, S] int, one IMAGE_TOKEN_INDEX per row
    labels: torch.Tensor           # [B, S] int, IGNORE_INDEX masked
    attn_mask: torch.Tensor        # [B, S] int
    spatial_pixels: torch.Tensor   # [B, num_segs, 336, 336, 3]
    temporal_pixels: torch.Tensor  # [B, num_frames, 224, 224, 3]
    is_text: torch.Tensor          # [B] bool, text-only sample


def init_params(cfg: VLMConfig, *, generator: Optional[torch.Generator],
                device, dtype=torch.float32, skip=frozenset(),
                llm_init=None):
    """The seeded random tree. Each piece (and each top-level entry of the
    LLM) draws from its own generator, seeded from ``generator`` in a fixed
    order, so a piece's values do not depend on which others are drawn.
    skip: paths — ("clip",), ("llm", "embed"), ... — left on the meta
    device (shapes only, nothing drawn), for pieces a caller fills from
    files. llm_init: called as models/llm.init_params is, in its place,
    with the LLM's own generator (serve/quantize.init_llm_params_quantized
    draws the LLM directly in serving int8 there)."""
    H = cfg.llm.hidden_size
    C = cfg.clip.hidden_size

    def piece(name, make):
        g = child_generator(generator, device)
        if (name,) in skip:
            return make(generator=None, device="meta", dtype=dtype)
        return make(generator=g, device=device, dtype=dtype)

    def extras(**kw):
        if cfg.llm_name == "phi3.5":
            # glb_GN [4C], sub_GN [4C]
            return {"glb_GN": normal((4 * C,), 0.02, **kw),
                    "sub_GN": normal((4 * C,), 0.02, **kw)}
        return {"image_newline": normal((H,), 0.02, **kw)}

    llm_skip = frozenset(p[1:] for p in skip if p[0] == "llm" and len(p) > 1)
    return {
        "clip": piece("clip", lambda **kw: clip_vit.init_params(cfg.clip,
                                                                **kw)),
        "video_encoder": piece("video_encoder",
                               lambda **kw: internvideo2.init_params(
                                   cfg.video, **kw)),
        "mm_projector": piece("mm_projector",
                              lambda **kw: projectors.init_mm_projector(
                                  cfg.llm_name, H, C, **kw)),
        "video_projector": piece("video_projector",
                                 lambda **kw: projectors.init_video_projector(
                                     H, cfg.video.embed_dim, **kw)),
        "llm": piece("llm", lambda **kw: (llm_init or llm_mod.init_params)(
            cfg.llm, skip=llm_skip, **kw)),
        "extras": piece("extras", extras),
    }


# ---------------------------------------------------------------------------
# Fusion pieces
# ---------------------------------------------------------------------------


def merge_2x2_phi3(feats: torch.Tensor) -> torch.Tensor:
    """[N, 576, C] → [N, 12, 12, 4C] 2x2 patch merge."""
    N, L, C = feats.shape
    H = 24
    x = feats.reshape(N, H // 2, 2, H // 2, 2, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(N, H // 2, H // 2, 4 * C)


def add_newline_phi3(feats_hd: torch.Tensor,
                     sub_gn: torch.Tensor) -> torch.Tensor:
    """[N, h, w, D] + newline column → [N, h*(w+1), D]."""
    N, h, w, D = feats_hd.shape
    newline = sub_gn.to(feats_hd.dtype).expand(N, h, 1, D)
    return torch.cat([feats_hd, newline], dim=2).reshape(N, h * (w + 1), D)


def _pool_grid(x: torch.Tensor, in_side: int, out_side: int) -> torch.Tensor:
    """[..., in_side*in_side, C] → [..., out_side*out_side, C] exact mean."""
    lead = x.shape[:-2]
    C = x.shape[-1]
    r = in_side // out_side
    x = x.reshape(*lead, out_side, r, out_side, r, C)
    x = x.mean(dim=(-4, -2))
    return x.reshape(*lead, out_side * out_side, C)


def _maybe_normalize(pixels: torch.Tensor, mean, std,
                     dtype) -> torch.Tensor:
    """uint8 pixels → fp32 / 255 → normalize → cast. Float inputs pass
    through untouched (already normalized on the host)."""
    if pixels.dtype != torch.uint8:
        return pixels
    x = pixels.float() / 255.0
    x = ((x - torch.tensor(mean, device=x.device))
         / torch.tensor(std, device=x.device))
    return x.to(dtype)


def encode_video(params, cfg: VLMConfig, spatial_pixels: torch.Tensor,
                 temporal_pixels: torch.Tensor,
                 freeze_encoders: bool = True) -> torch.Tensor:
    """→ video features [B, num_video_tokens, H_llm].

    freeze_encoders: both encoders run under torch.no_grad(), the JAX
    package's stop_gradient at their outputs; both are frozen in every
    training stage, so their backward is never needed. The fusion,
    sub_GN / glb_GN / image_newline and the projectors stay in the graph.

    cfg.encoder_chunk_clips, where set below B*num_segs and dividing it,
    runs InternVideo2 over that many clips at a time, one call after the
    other: the encoder's activations then scale with the chunk, not with
    B*num_segs. The clips are independent until fusion, so the features
    are the same."""
    enc_dtype = params["clip"]["embeddings"]["patch_kernel"].dtype
    spatial_pixels = _maybe_normalize(
        spatial_pixels, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, enc_dtype)
    temporal_pixels = _maybe_normalize(
        temporal_pixels, INTERNVIDEO_MEAN, INTERNVIDEO_STD, enc_dtype)
    B, S_segs = spatial_pixels.shape[:2]
    fps = cfg.num_frames_per_seg

    # ---- spatial stream
    frozen = torch.no_grad() if freeze_encoders else contextlib.nullcontext()
    sp = spatial_pixels.reshape(B * S_segs, *spatial_pixels.shape[2:])
    with frozen:
        image_feats = clip_vit.features(params["clip"], cfg.clip, sp)
    if cfg.llm_name == "phi3.5":
        x = merge_2x2_phi3(image_feats)                     # [B*12,12,12,4C]
        x = add_newline_phi3(x, params["extras"]["sub_GN"])  # [B*12,156,4C]
        x = x.reshape(B, S_segs, *x.shape[1:])
    else:
        x = image_feats.reshape(B, S_segs, *image_feats.shape[1:])
        x = _pool_grid(x, 24, 8)                            # [B,12,64,C]
    image_feats = projectors.mlp_project(params["mm_projector"], x)

    # ---- temporal stream
    tp = temporal_pixels.reshape(B * S_segs, fps, *temporal_pixels.shape[2:])
    n = B * S_segs
    chunk = cfg.encoder_chunk_clips
    if not (chunk and n > chunk and n % chunk == 0):
        chunk = n
    with frozen:
        parts = [internvideo2.features(params["video_encoder"], cfg.video,
                                       tp[i:i + chunk])
                 for i in range(0, n, chunk)]
    seg = parts[0] if len(parts) == 1 else torch.cat(parts)
    seg = seg[:, 1:, :]                                   # drop CLS
    seg = seg.reshape(B * S_segs, fps, cfg.video.patches_per_frame, -1)
    seg = _pool_grid(seg, 16, 4)                          # [B*12,fps,16,C]
    seg = seg.reshape(B, S_segs, fps * 16, -1)            # [B,12,128,C]
    seg_feats = projectors.mlp_project(params["video_projector"], seg)

    # ---- newline + fuse
    H = cfg.llm.hidden_size
    if cfg.llm_name == "phi3.5":
        nl = projectors.mlp_project(params["mm_projector"],
                                    params["extras"]["glb_GN"][None, :])
    else:
        nl = params["extras"]["image_newline"]
    newline = nl.reshape(1, 1, 1, H).expand(B, S_segs, 1, H)
    newline = newline.to(image_feats.dtype)
    video = torch.cat([image_feats, seg_feats, newline], dim=2)
    return video.reshape(B, S_segs * video.shape[2], H)


# ---------------------------------------------------------------------------
# Multimodal splice
# ---------------------------------------------------------------------------


def splice_multimodal(input_ids: torch.Tensor,          # [B, S]
                      labels: Optional[torch.Tensor],   # [B, S] or None
                      attn_mask: torch.Tensor,          # [B, S]
                      video_features: torch.Tensor,     # [B, NV, H]
                      embed_table,                      # [V, H] or int8
                      is_text: Optional[torch.Tensor] = None,  # [B] bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 torch.Tensor]:
    """Static-shape splice, out length S - 1 + NV.

    Normal rows:    [pre_text | video | post_text]  (video labels IGNORE)
    Text-only rows: [text (image slot removed) | video]  (video attn 0)
    """
    B, S = input_ids.shape
    NV = video_features.shape[1]
    S_out = S - 1 + NV
    device = input_ids.device
    if is_text is None:
        is_text = torch.zeros(B, dtype=torch.bool, device=device)
    is_text_i = is_text.long()

    img_pos = torch.argmax((input_ids == IMAGE_TOKEN_INDEX).int(), dim=1)
    vstart = torch.where(is_text, S - 1, img_pos)                   # [B]

    j = torch.arange(S_out, device=device)[None, :]                 # [1,S_out]
    in_video = (j >= vstart[:, None]) & (j < vstart[:, None] + NV)
    # text source index: before the video → j (+1 past the removed image
    # slot for text-only rows); after it → j - NV + 1
    t_pre = j + (j >= img_pos[:, None]).long() * is_text_i[:, None]
    t_post = j - NV + 1
    t = torch.where(j < vstart[:, None], t_pre, t_post).clamp(0, S - 1)

    gathered_ids = torch.gather(input_ids, 1, t)
    safe_ids = torch.where(gathered_ids == IMAGE_TOKEN_INDEX, 0,
                           gathered_ids)
    text_embeds = llm_mod.embed_lookup(
        embed_table, safe_ids, llm_mod.embed_dtype(embed_table))  # [B,S_out,H]

    vj = (j - vstart[:, None]).clamp(0, NV - 1)
    video_gathered = torch.gather(
        video_features, 1,
        vj[..., None].expand(B, S_out, video_features.shape[2]))
    embeds = torch.where(in_video[..., None],
                         video_gathered.to(text_embeds.dtype), text_embeds)

    video_attn = torch.where(is_text, 0, 1)[:, None].to(attn_mask.dtype)
    mask_out = torch.where(in_video, video_attn,
                           torch.gather(attn_mask, 1, t))
    if labels is None:
        return embeds, None, mask_out
    labels_out = torch.where(in_video, IGNORE_INDEX,
                             torch.gather(labels, 1, t))
    return embeds, labels_out, mask_out


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def forward_loss(params, cfg: VLMConfig, batch: Batch, remat: bool = False,
                 freeze_encoders: bool = True, lora_dropout: float = 0.0,
                 dropout_seed: Optional[int] = None,
                 remat_group: int = 1, mesh=None) -> torch.Tensor:
    """Full multimodal forward → scalar fp32 cross-entropy loss.
    lora_dropout with dropout_seed: training-only dropout on the LoRA
    branch (peft lora_dropout). mesh: the batch holds this rank's rows;
    the loss is this rank's share of the whole batch's (see
    llm.causal_lm_loss_from_hidden)."""
    video_features = encode_video(params, cfg, batch.spatial_pixels,
                                  batch.temporal_pixels,
                                  freeze_encoders=freeze_encoders)
    embeds, labels, mask = splice_multimodal(
        batch.input_ids, batch.labels, batch.attn_mask, video_features,
        params["llm"]["embed"], batch.is_text)
    hidden = llm_mod.forward_hidden(params["llm"], cfg.llm, embeds, mask,
                                    remat=remat, remat_group=remat_group,
                                    lora_dropout=lora_dropout,
                                    dropout_seed=dropout_seed)
    return llm_mod.causal_lm_loss_from_hidden(params["llm"], hidden, labels,
                                              mesh=mesh)


def embed_tokens(params, token_ids: torch.Tensor) -> torch.Tensor:
    return llm_mod.embed_lookup(params["llm"]["embed"], token_ids)
