"""The plain float32 reference of the dual-stream video LLM served by the
benchmark's serving cells.

It follows the published architecture, written out from the configuration
file alone: CLIP ViT-L/14-336 (pre-LN, quick-GELU, the penultimate layer,
CLS dropped), InternVideo2-1B (per-frame patches, pre-RMSNorm blocks with
QK-RMSNorm over the flattened heads, LayerScale, exact GELU, early exit),
the Phi-3.5 fusion (2x2 patch merge, a newline column, the projector MLPs,
[image | segment | newline] per segment) and Phi-3.5-mini (pre-RMSNorm,
fused qkv and gate_up, SiLU gating, LongRoPE with its magnitude scale,
causal attention, float32 logits).

Every product runs in float32 with TF32 off (``strict_float32``). Weights
are read from the benchmark's own tree (gvbench/weights.py) one layer at a
time and widened to float32 there, so the reference never holds a float32
copy of a whole model. It imports nothing of the program under test.

``matmul`` is the one place every weight product goes through; the control
of the correctness check (gvbench/check.py) swaps it for a lower-precision
one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

IMAGE_SLOT = -200


@contextlib.contextmanager
def strict_float32():
    """float32 products without TF32 for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


class Reference:
    """conf: the configuration file's dict; weights: the benchmark's tree
    (nested dicts of tensors in the stored dtype); matmul(x, w): the
    product of every weight (x float32, w float32)."""

    def __init__(self, conf: dict, weights: dict,
                 matmul: Callable = f32_matmul):
        self.conf = conf
        self.w = weights
        self.matmul = matmul

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def f(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float32)

    def dense(self, x, kernel, bias=None):
        y = self.matmul(x, self.f(kernel))
        return y if bias is None else y + self.f(bias)

    @staticmethod
    def attention(q, k, v, causal: bool, block: int = 1024):
        """q, k, v [B, S, H, D] float32 → [B, S, H, D]; queries in blocks."""
        B, S, H, D = q.shape
        scale = D ** -0.5
        kt = k.permute(0, 2, 3, 1)                    # [B, H, D, S]
        vt = v.permute(0, 2, 1, 3)                    # [B, H, S, D]
        out = torch.empty_like(q)
        for s0 in range(0, S, block):
            qb = q[:, s0:s0 + block].permute(0, 2, 1, 3)   # [B, H, b, D]
            scores = (qb @ kt) * scale
            if causal:
                qpos = torch.arange(s0, s0 + qb.shape[2],
                                    device=q.device)[:, None]
                kpos = torch.arange(S, device=q.device)[None, :]
                scores = scores.masked_fill(kpos > qpos, float("-inf"))
            probs = torch.softmax(scores, dim=-1)
            out[:, s0:s0 + block] = (probs @ vt).permute(0, 2, 1, 3)
        return out

    @staticmethod
    def layer_norm(x, scale, bias, eps):
        return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(),
                            eps)

    @staticmethod
    def rms_norm(x, weight, eps):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
            * weight.float()

    @staticmethod
    def patch_conv(pixels, kernel, patch: int):
        """pixels [N, S, S, 3] float32, kernel [P, P, 3, D] → [N, n, D]."""
        out = F.conv2d(pixels.permute(0, 3, 1, 2),
                       kernel.float().permute(3, 2, 0, 1), stride=patch)
        return out.flatten(2).transpose(1, 2)

    @staticmethod
    def normalize(pixels_u8, mean, std):
        x = pixels_u8.float() / 255.0
        mean = torch.tensor(mean, device=x.device)
        std = torch.tensor(std, device=x.device)
        return (x - mean) / std

    # -- CLIP ---------------------------------------------------------------

    def clip_features(self, spatial_u8: torch.Tensor) -> torch.Tensor:
        """spatial [segs, 336, 336, 3] uint8 → penultimate features, CLS
        dropped [segs, 576, C]."""
        c = self.conf["clip"]
        w = self.w["clip"]
        x = self.normalize(spatial_u8, self.conf["pixels"]["clip_mean"],
                           self.conf["pixels"]["clip_std"])
        emb = w["embeddings"]
        x = self.patch_conv(x, emb["patch_kernel"], c["patch_size"])
        cls = self.f(emb["class_embedding"]).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.f(emb["position_embedding"])
        eps = c["layer_norm_eps"]
        x = self.layer_norm(x, w["pre_ln"]["scale"], w["pre_ln"]["bias"], eps)
        H = c["num_heads"]
        D = c["hidden_size"] // H
        lay = w["layers"]
        for i in range(c["num_layers"] + c["feature_layer"] + 1):
            N, S, C = x.shape
            h = self.layer_norm(x, lay["ln1"]["scale"][i],
                                lay["ln1"]["bias"][i], eps)
            q, k, v = (self.dense(h, lay[n]["kernel"][i], lay[n]["bias"][i])
                       .reshape(N, S, H, D) for n in "qkv")
            a = self.attention(q, k, v, causal=False).reshape(N, S, C)
            x = x + self.dense(a, lay["o"]["kernel"][i], lay["o"]["bias"][i])
            h = self.layer_norm(x, lay["ln2"]["scale"][i],
                                lay["ln2"]["bias"][i], eps)
            h = self.dense(h, lay["fc1"]["kernel"][i], lay["fc1"]["bias"][i])
            h = h * torch.sigmoid(1.702 * h)
            x = x + self.dense(h, lay["fc2"]["kernel"][i],
                               lay["fc2"]["bias"][i])
        return x[:, 1:]

    # -- InternVideo2 -------------------------------------------------------

    def internvideo_features(self, temporal_u8: torch.Tensor,
                             clips_per_block: int = 4) -> torch.Tensor:
        """temporal [F, 224, 224, 3] uint8 → per-clip tokens, CLS dropped
        [clips, frames_per_clip * patches, D]."""
        c = self.conf["video"]
        w = self.w["video_encoder"]
        fpc = c["num_frames"]
        x = self.normalize(temporal_u8, self.conf["pixels"]["video_mean"],
                           self.conf["pixels"]["video_std"])
        clips = x.shape[0] // fpc
        out = []
        for c0 in range(0, clips, clips_per_block):
            frames = x[c0 * fpc:(c0 + clips_per_block) * fpc]
            n = frames.shape[0] // fpc
            p = self.patch_conv(frames, w["patch_kernel"], c["patch_size"])
            p = (p + self.f(w["patch_bias"])).reshape(n, -1, p.shape[-1])
            cls = self.f(w["cls_token"]).expand(n, 1, -1)
            h = torch.cat([cls, p], 1) + self.f(w["pos_embed"])
            for i in range(c["num_blocks_used"]):
                h = self._iv2_block(h, w["blocks"], i, c)
            out.append(h[:, 1:])
        return torch.cat(out)

    def _iv2_block(self, x, b, i: int, c: dict):
        N, S, D = x.shape
        H = c["num_heads"]
        eps = c["rms_eps"]
        h = self.rms_norm(x, b["norm1_w"][i], eps)
        q, k, v = self.matmul(h, self.f(b["qkv_kernel"][i])).split(D, -1)
        q = self.rms_norm(q, b["q_norm_w"][i], eps)
        k = self.rms_norm(k, b["k_norm_w"][i], eps)
        a = self.attention(*(t.reshape(N, S, H, D // H) for t in (q, k, v)),
                           causal=False).reshape(N, S, D)
        x = x + self.dense(a, b["proj"]["kernel"][i],
                           b["proj"]["bias"][i]) * self.f(b["ls1"][i])
        h = self.rms_norm(x, b["norm2_w"][i], eps)
        h = F.gelu(self.dense(h, b["fc1"]["kernel"][i], b["fc1"]["bias"][i]))
        return x + self.dense(h, b["fc2"]["kernel"][i],
                              b["fc2"]["bias"][i]) * self.f(b["ls2"][i])

    # -- fusion -------------------------------------------------------------

    def mlp(self, p, x):
        h = F.gelu(self.dense(x, p["fc1"]["kernel"], p["fc1"]["bias"]))
        return self.dense(h, p["fc2"]["kernel"], p["fc2"]["bias"])

    def video_tokens(self, temporal_u8, spatial_u8) -> torch.Tensor:
        """One video's tokens [num_video_tokens, H] (the Phi-3.5 fusion)."""
        segs = spatial_u8.shape[0]
        img = self.clip_features(spatial_u8)                  # [segs, 576, C]
        N, L, C = img.shape
        side = int(math.isqrt(L))
        m = img.reshape(N, side // 2, 2, side // 2, 2, C).permute(
            0, 1, 3, 2, 4, 5).reshape(N, side // 2, side // 2, 4 * C)
        sub = self.f(self.w["extras"]["sub_GN"]).expand(N, side // 2, 1,
                                                        4 * C)
        m = torch.cat([m, sub], 2).reshape(N, -1, 4 * C)
        img = self.mlp(self.w["mm_projector"], m)             # [segs, 156, H]

        vid = self.internvideo_features(temporal_u8)          # [clips, T*P, D]
        c = self.conf["video"]
        side = c["image_size"] // c["patch_size"]
        pooled = self.conf["fusion"]["pool_side"]
        r = side // pooled
        T = c["num_frames"]
        D = vid.shape[-1]
        vid = vid.reshape(segs, T, pooled, r, pooled, r, D).mean((3, 5))
        vid = self.mlp(self.w["video_projector"],
                       vid.reshape(segs, T * pooled * pooled, D))
        nl = self.mlp(self.w["mm_projector"],
                      self.f(self.w["extras"]["glb_GN"])[None])
        nl = nl.expand(segs, 1, nl.shape[-1])
        return torch.cat([img, vid, nl], 1).reshape(-1, nl.shape[-1])

    # -- language model -----------------------------------------------------

    def rope(self, positions: torch.Tensor, seq_len: int):
        c = self.conf["llm"]
        D = c["head_dim"]
        inv = 1.0 / (c["rope_theta"] ** (torch.arange(
            0, D, 2, dtype=torch.float64, device=positions.device) / D))
        mscale = 1.0
        short, long = c.get("rope_scaling_short"), c.get("rope_scaling_long")
        if short or long:
            orig = c["original_max_position_embeddings"]
            factors = long if seq_len > orig else short
            inv = inv / torch.tensor(factors, dtype=torch.float64,
                                     device=positions.device)
            scale = c["max_position_embeddings"] / orig
            if scale > 1.0:
                mscale = math.sqrt(1.0 + math.log(scale) / math.log(orig))
        ang = positions.double()[:, None] * inv[None]
        ang = torch.cat([ang, ang], -1)
        return (torch.cos(ang) * mscale).float(), \
            (torch.sin(ang) * mscale).float()

    @staticmethod
    def rotate(x, cos, sin):
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos[:, None] + rot * sin[:, None]

    def llm_logits(self, embeds: torch.Tensor, rows: Sequence[int],
                   on_layer: Optional[Callable] = None) -> torch.Tensor:
        """embeds [S, H] float32 of one sequence → float32 logits [len(rows),
        V] at positions rows."""
        c = self.conf["llm"]
        lay = self.w["llm"]["layers"]
        S = embeds.shape[0]
        Hq, Hkv, Dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
        I = c["intermediate_size"]
        cos, sin = self.rope(torch.arange(S, device=embeds.device), S)
        x = embeds[None]
        eps = c["rms_eps"]
        for i in range(c["num_layers"]):
            h = self.rms_norm(x, lay["input_norm_w"][i], eps)
            qkv = self.matmul(h, self.f(lay["qkv_kernel"][i]))
            q, k, v = qkv.split([Hq * Dh, Hkv * Dh, Hkv * Dh], -1)
            q = self.rotate(q.reshape(1, S, Hq, Dh), cos, sin)
            k = self.rotate(k.reshape(1, S, Hkv, Dh), cos, sin)
            v = v.reshape(1, S, Hkv, Dh)
            if Hkv != Hq:
                k = k.repeat_interleave(Hq // Hkv, 2)
                v = v.repeat_interleave(Hq // Hkv, 2)
            a = self.attention(q, k, v, causal=True).reshape(1, S, Hq * Dh)
            x = x + self.matmul(a, self.f(lay["o_kernel"][i]))
            h = self.rms_norm(x, lay["post_norm_w"][i], eps)
            gate, up = self.matmul(h, self.f(lay["gate_up_kernel"][i])).split(
                I, -1)
            x = x + self.matmul(F.silu(gate) * up,
                                self.f(lay["down_kernel"][i]))
            if on_layer is not None:
                on_layer(i)
        h = self.rms_norm(x[0, list(rows)], self.w["llm"]["final_norm_w"], eps)
        return self.matmul(h, self.f(self.w["llm"]["lm_head"]))

    def embed(self, ids: Sequence[int]) -> torch.Tensor:
        table = self.w["llm"]["embed"]
        return self.f(table[torch.tensor(list(ids), device=table.device)])

    def served_logits(self, prompt_ids: List[int], video: torch.Tensor,
                      served: List[int]) -> torch.Tensor:
        """Logits [len(served), V] that predict each served token: the
        prompt with its image slot replaced by the video tokens, then the
        served tokens but the last, run as one sequence."""
        slot = prompt_ids.index(IMAGE_SLOT)
        pre, post = prompt_ids[:slot], prompt_ids[slot + 1:]
        seq = torch.cat([self.embed(pre), video.float(),
                         self.embed(post + served[:-1])])
        first = len(pre) + video.shape[0] + len(post) - 1
        return self.llm_logits(seq, range(first, first + len(served)))


# -- the prompt the serving cells send -------------------------------------


class ByteTokens:
    """The byte-level token layout of the configuration's tokenizer:
    pad, bos, eos placeholders, the 256 bytes, then the named strings in
    order, each one token."""

    def __init__(self, spec: dict):
        self.byte_offset = spec["byte_offset"]
        self.bos = spec["bos_id"]
        first = self.byte_offset + 256
        self.specials = {s: first + i for i, s in enumerate(spec["specials"])}
        self.order = sorted(self.specials, key=len, reverse=True)

    def encode(self, text: str) -> List[int]:
        ids, i = [], 0
        while i < len(text):
            for s in self.order:
                if text.startswith(s, i):
                    ids.append(self.specials[s])
                    i += len(s)
                    break
            else:
                ids.extend(self.byte_offset + b for b in text[i].encode())
                i += 1
        return ids


def grounding_prompt_ids(conf: dict, question: str) -> List[int]:
    """The token ids of a grounding request for ``question``: the chat
    template's system text, the user turn with the video slot, the grounding
    token and the question, and the assistant prefix; bos first."""
    t = conf["template"]
    tok = ByteTokens(conf["tokenizer"])
    text = (t["system"] + t["user_prefix"] + t["image"] + " "
            + t["grounding"] + "\n" + question + t["assistant_prefix"])
    pre, post = text.split(t["image"])
    return [tok.bos] + tok.encode(pre) + [IMAGE_SLOT] + tok.encode(post)
