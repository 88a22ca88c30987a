"""Weight bridge from the JAX package: its ``vlm.init_params`` pytree,
converted to numpy arrays, becomes this package's parameter tree, so both
packages compute the same function in the parity tests.

The two trees share names, nesting and layouts ([D_in, D_out] kernels, HWIO
patch kernels, stacked layers). The bridge builds the expected tree on the
meta device (shapes only, no memory), fills every leaf from the numpy tree
by its path, and fails loudly on a missing, extra, reused or misshapen
tensor.

A training tree maps as well: the LoRA subtree
``llm/layers/lora/{qkv,o,gate_up,down}/{a,b,scale}`` (its rank read from the
tree) and a vocabulary expanded by ``train/vocab.expand_vocab`` on a config
without the extra rows.

A partial tree maps too when a seed is given (cli/model_loading.build_params
places what it read from the reference's files this way): the entries it
lacks are the seeded random init (models/vlm.init_params), and the entries
it has are never drawn at random first. A stacked leaf may come as a
``models/convert.Stacked``, placed one slice at a time; a dense leaf is
made float32 first and then cast to ``dtype`` (round to nearest even, as
the JAX package's loader rounds).

A serving-int8 tree (the JAX ``serve/quantize.py``) maps exactly: each
``{"q", "scale"}`` pair becomes an ``Int8Weight`` (values and scales copied
bit for bit, whatever ``dtype`` says), the ``"w8a8": None`` marker its
``w8a8`` flag, a calibrated ``x_scale`` (serve/calibrate.py: one fp32
scale per layer of an encoder weight) its ``x_scale``, and the LLM's
embedding pair an ``Int8Embedding``. Any other entry of such a pair, and an
``x_scale`` on an LLM weight (its matmuls never read one), is refused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import NUM_SPECIAL_TOKENS, VLMConfig, replace
from ..ops.int8_matmul import Int8Embedding, Int8Weight, empty_int8_weight
from . import vlm
from .convert import Stacked, leaf_shape

_EMBED = ("llm", "embed")


def _is_int8_pair(tree) -> bool:
    return isinstance(tree, dict) and {"q", "scale"} <= set(tree)


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    if isinstance(tree, dict) and not _is_int8_pair(tree):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _int8_from_jax(path, pair: dict, shape, device):
    name = "/".join(path)
    extra = sorted(set(pair) - {"q", "scale", "w8a8", "x_scale"})
    if extra:
        raise ValueError(f"params_from_jax: {name} has {extra}, which an "
                         "int8 pair does not carry")
    if "x_scale" in pair and path[0] == "llm":
        raise ValueError(f"params_from_jax: {name} has an x_scale; static "
                         "activation scales apply to the encoders only")
    if pair.get("w8a8", None) is not None:
        raise ValueError(f"params_from_jax: {name}/w8a8 must be the None "
                         "marker")
    q, s = np.asarray(pair["q"]), np.asarray(pair["scale"])
    want_s = shape[:1] if path == _EMBED else shape[:-2] + shape[-1:]
    if (q.dtype != np.int8 or s.dtype != np.float32
            or q.shape != shape or s.shape != want_s):
        raise ValueError(f"params_from_jax: {name} int8 pair is "
                         f"{q.dtype}{q.shape} / {s.dtype}{s.shape}, expected "
                         f"int8{shape} / float32{want_s}")
    xt = None
    if "x_scale" in pair:
        xs = np.asarray(pair["x_scale"])
        if xs.dtype != np.float32 or xs.shape != shape[:-2]:
            raise ValueError(f"params_from_jax: {name}/x_scale is "
                             f"{xs.dtype}{xs.shape}, expected "
                             f"float32{shape[:-2]}")
        xt = torch.from_numpy(xs.copy()).to(device)
    st = torch.from_numpy(s.copy()).to(device)
    if path == _EMBED:
        if "w8a8" in pair:
            raise ValueError("params_from_jax: the embedding has no w8a8 "
                             "marker")
        return Int8Embedding(torch.from_numpy(q.copy()).to(device), st)
    qt = empty_int8_weight(q.shape, device)
    qt.copy_(torch.from_numpy(q.copy()))
    return Int8Weight(qt, st, "w8a8" in pair, xt)


def vocab_config(np_tree, cfg: VLMConfig) -> VLMConfig:
    """cfg with as many extra vocabulary rows as the tree's embedding has
    over the base vocabulary, where that is 0 or NUM_SPECIAL_TOKENS: a tree
    expanded by train/vocab.expand_vocab on a config without the extra rows,
    a stage checkpoint's expanded embedding, or a base LLM dump read for a
    stage whose config has them (the training strategy expands it)."""
    embed = np_tree.get("llm", {}).get("embed")
    if embed is None or _is_int8_pair(embed):
        return cfg
    extra = leaf_shape(embed)[0] - cfg.llm.vocab_size
    if extra in (0, NUM_SPECIAL_TOKENS) and extra != cfg.llm.num_extra_tokens:
        return replace(cfg, llm=replace(cfg.llm, num_extra_tokens=extra))
    return cfg


def _dense_from_numpy(leaf, device, dtype) -> torch.Tensor:
    def place(arr):
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=dtype)

    if not isinstance(leaf, Stacked):
        return place(leaf)
    out = torch.empty(leaf.shape, device=device, dtype=dtype)
    for i in range(len(leaf)):
        out[i] = place(leaf.slice(i))
    return out


def _present(np_tree) -> frozenset:
    """The pieces a partial tree brings whole: top-level entries, and the
    LLM's top-level entries."""
    out = set()
    for k, v in np_tree.items():
        if k == "llm" and isinstance(v, dict):
            out.update(("llm", kk) for kk in v)
        else:
            out.add((k,))
    return frozenset(out)


def _on_meta(leaf) -> bool:
    if isinstance(leaf, (Int8Weight, Int8Embedding)):
        leaf = leaf.q
    return leaf.is_meta


def params_from_jax(np_tree, cfg: VLMConfig, device,
                    dtype=torch.float32, seed: Optional[int] = None,
                    llm_init=None) -> dict:
    """np_tree: the JAX ``vlm.init_params`` pytree (serving-quantized or
    not) with numpy leaves (e.g. ``jax.tree_util.tree_map(np.asarray,
    params)``) → this package's params on ``device``, dense tensors in
    ``dtype``. Every leaf is used exactly once. With a seed, leaves the tree
    lacks are the seeded random init instead of an error, the LLM's drawn
    by llm_init where it is given (models/vlm.init_params)."""
    cfg = vocab_config(np_tree, cfg)
    if seed is None:
        expected = vlm.init_params(cfg, generator=None, device="meta",
                                   dtype=dtype)
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        expected = vlm.init_params(cfg, generator=generator, device=device,
                                   dtype=dtype, skip=_present(np_tree),
                                   llm_init=llm_init)
    lora = np_tree.get("llm", {}).get("layers", {}).get("lora")
    if lora is not None:
        from ..train.lora import attach_lora, init_lora

        rank = leaf_shape(lora["qkv"]["a"])[-1]
        expected["llm"] = attach_lora(expected["llm"], init_lora(
            cfg.llm, generator=None, device="meta", rank=rank, dtype=dtype))
    want = _flatten(expected)
    have = _flatten(np_tree)
    missing = sorted(p for p in set(want) - set(have)
                     if seed is None or _on_meta(want[p]))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, "
                         f"unexpected {extra}")
    used = 0
    for path, meta in want.items():
        if path not in have:
            continue
        shape = tuple(meta.shape)
        src = have[path]
        if _is_int8_pair(src):
            value = _int8_from_jax(path, src, shape, device)
        else:
            if leaf_shape(src) != shape:
                raise ValueError(f"params_from_jax: {'/'.join(path)} has "
                                 f"shape {leaf_shape(src)}, expected "
                                 f"{shape}")
            value = _dense_from_numpy(src, device, dtype)
        _set(expected, path, value)
        used += 1
    if used != len(have):
        raise ValueError(f"params_from_jax: used {used} of {len(have)} JAX "
                         f"leaves for {len(want)} parameters")
    return expected
