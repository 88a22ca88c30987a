"""The port's reference-format checkpoints against the JAX package's, fp32
and bf16, on the micro config: files written by the JAX exporters read by
the port's build_params into exactly the tree params_from_jax gives from
the same JAX tree; the port's exports equal the JAX exporters' key by key
and read back by JAX's import_reference_pth + convert_*; the InternVideo2
f4 → 8 pos-embed case, llm_config_from_hf, the CLIP-teacher head, the
trained-state round trip and the LoRA-dropping export (a fault of the
reference exporter that both packages share)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core import checkpoint as jckpt
from grounded_video_llm_tpu.core.config import InternVideo2Config
from grounded_video_llm_tpu.core.config import micro_vlm_config as jmicro
from grounded_video_llm_tpu.models import convert as jconvert
from grounded_video_llm_tpu.models import export as jexport
from grounded_video_llm_tpu.models import internvideo2 as jiv2
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.train import lora as jlora
from grounded_video_llm_tpu_torch.cli.model_loading import build_params
from grounded_video_llm_tpu_torch.core import checkpoint as tckpt
from grounded_video_llm_tpu_torch.core.config import micro_vlm_config
from grounded_video_llm_tpu_torch.models import convert as tconvert
from grounded_video_llm_tpu_torch.models import export as texport
from grounded_video_llm_tpu_torch.models import internvideo2 as tiv2
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.train.optimizer import tree_items

FAMILIES = ("phi3.5", "llama3", "vicuna")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jp = jvlm.init_params(jax.random.key(11), jmicro(name))
    return name, micro_vlm_config(name), jmicro(name), jp


def _jax_dumps(jp, jcfg, workdir):
    """scripts/eval_dress_rehearsal.py's layout, written by the JAX
    exporters."""
    wroot = os.path.join(workdir, "weights")
    lm_dir = os.path.join(wroot, "language_model_seperated")
    os.makedirs(lm_dir, exist_ok=True)

    def save(path, sd, wrap=False):
        t = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        torch.save({"model": t} if wrap else t, path)

    save(os.path.join(wroot, "vision_model.pth"),
         jexport.export_clip_full(jp["clip"], jcfg.clip))
    save(os.path.join(wroot, "multi_modal_projector.pth"),
         jexport.export_mm_projector(jp["mm_projector"], jcfg.llm_name))
    save(os.path.join(wroot, "image_newlines.pth"),
         jexport.export_extras_full(jp["extras"], jcfg.llm_name))
    save(os.path.join(lm_dir, "pytorch_model-00001-of-00001.bin"),
         jexport.export_llm_full(jp["llm"], jcfg.llm))
    iv2 = os.path.join(workdir, "video_encoder.pt")
    save(iv2, jexport.export_internvideo2_full(jp["video_encoder"],
                                               jcfg.video), wrap=True)
    stage = os.path.join(workdir, "stage_grounded.pth")
    jexport.export_vlm_to_reference(jp, jcfg, stage, trainable_only=False)
    return {"weight_root": wroot, "video_encoder_path": iv2,
            "stage_ckpt": stage}


def _assert_trees_equal(got, want):
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert set(g) == set(w)
    for path, t in w.items():
        assert g[path].dtype == t.dtype and g[path].shape == t.shape, path
        assert torch.equal(g[path], t), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_build_params_reads_jax_files_bit_equal(family, dtype, tmp_path):
    """JAX exporters' files → the port's build_params == params_from_jax of
    the same JAX tree (fp32, and bf16: float32 first, then round to nearest
    even, as the JAX loader rounds)."""
    name, cfg, jcfg, jp = family
    paths = _jax_dumps(jp, jcfg, str(tmp_path))
    got = build_params(cfg, "cpu", dtype, seed=5, **paths)
    want = params_from_jax(_np(jp), cfg, "cpu", dtype)
    _assert_trees_equal(got, want)


def test_port_exports_equal_jax_exports_and_jax_reads_them(family,
                                                             tmp_path):
    """Every port exporter against its JAX counterpart key by key (float32,
    same shapes, equal values), the port's stage checkpoint read back by
    JAX's import_reference_pth + convert_* into JAX's tree, and the port's
    weight dumps read by the port back to the same tree."""
    name, cfg, jcfg, jp = family
    tp = params_from_jax(_np(jp), cfg, "cpu")
    pairs = {
        "clip": (texport.export_clip_full(tp["clip"], cfg.clip),
                 jexport.export_clip_full(jp["clip"], jcfg.clip)),
        "internvideo2": (
            texport.export_internvideo2_full(tp["video_encoder"], cfg.video),
            jexport.export_internvideo2_full(jp["video_encoder"],
                                             jcfg.video)),
        "llm": (texport.export_llm_full(tp["llm"], cfg.llm),
                jexport.export_llm_full(jp["llm"], jcfg.llm)),
        "extras": (texport.export_extras_full(tp["extras"], name),
                   jexport.export_extras_full(jp["extras"], name)),
        "mm_projector": (texport.export_mm_projector(tp["mm_projector"],
                                                     name),
                         jexport.export_mm_projector(jp["mm_projector"],
                                                     name)),
        "video_projector": (
            texport.export_video_projector(tp["video_projector"]),
            jexport.export_video_projector(jp["video_projector"])),
        "llm_trainable": (texport.export_llm_trainable(tp["llm"]),
                          jexport.export_llm_trainable(jp["llm"])),
    }
    for piece, (mine, theirs) in pairs.items():
        assert list(mine) == list(theirs), piece
        for k, v in theirs.items():
            assert mine[k].dtype == np.float32, (piece, k)
            np.testing.assert_array_equal(mine[k], np.asarray(v),
                                          err_msg=f"{piece} {k}")

    stage = str(tmp_path / "port_stage.pth")
    texport.export_vlm_to_reference(tp, cfg, stage, trainable_only=False)
    mods = jckpt.import_reference_pth(stage)
    assert set(mods) == {"multi_modal_projector", "video_projecter",
                         "language_model"}
    back = {"mm_projector": jconvert.convert_projector(
                mods["multi_modal_projector"], name),
            "video_projector": jconvert.convert_video_projector(
                mods["video_projecter"])}
    for piece, tree in back.items():
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(tree)[0],
                jax.tree_util.tree_flatten_with_path(jp[piece])[0]):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=piece)
    lm = mods["language_model"]
    np.testing.assert_array_equal(lm["model.embed_tokens.weight"],
                                  np.asarray(jp["llm"]["embed"]))
    np.testing.assert_array_equal(lm["lm_head.weight"].T,
                                  np.asarray(jp["llm"]["lm_head"]))

    paths = texport.write_weight_dumps(tp, cfg, str(tmp_path / "port"))
    jllm = jconvert.convert_llm(
        {k: v.numpy() for k, v in torch.load(
            os.path.join(paths["weight_root"], "language_model_seperated",
                         "pytorch_model-00001-of-00001.bin"),
            weights_only=True).items()}, jcfg.llm)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jllm)[0],
            jax.tree_util.tree_flatten_with_path(jp["llm"])[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    again = build_params(cfg, "cpu", torch.float32, seed=3,
                         weight_root=paths["weight_root"],
                         video_encoder_path=paths["video_encoder"],
                         stage_ckpt=paths["stage_ckpt"])
    _assert_trees_equal(again, tp)


@pytest.mark.parametrize("piece", ["clip", "internvideo2", "llm",
                                   "projector", "video_projector", "extras"])
def test_converters_match_jax(family, piece):
    """The port's convert_* on the JAX exporters' state dicts equal the JAX
    converters' trees (Stacked leaves through np.asarray)."""
    name, cfg, jcfg, jp = family
    cases = {
        "clip": (jexport.export_clip_full(jp["clip"], jcfg.clip),
                 lambda sd: jconvert.convert_clip(sd, jcfg.clip),
                 lambda sd: tconvert.convert_clip(sd, cfg.clip)),
        "internvideo2": (
            jexport.export_internvideo2_full(jp["video_encoder"], jcfg.video),
            lambda sd: jconvert.convert_internvideo2(
                sd, jcfg.video, ckpt_num_frames=jcfg.video.num_frames),
            lambda sd: tconvert.convert_internvideo2(sd, cfg.video)),
        "llm": (jexport.export_llm_full(jp["llm"], jcfg.llm),
                lambda sd: jconvert.convert_llm(sd, jcfg.llm),
                lambda sd: tconvert.convert_llm(sd, cfg.llm)),
        "projector": (jexport.export_mm_projector(jp["mm_projector"], name),
                      lambda sd: jconvert.convert_projector(sd, name),
                      lambda sd: tconvert.convert_projector(sd, name)),
        "video_projector": (
            jexport.export_video_projector(jp["video_projector"]),
            jconvert.convert_video_projector,
            tconvert.convert_video_projector),
        "extras": (jexport.export_extras_full(jp["extras"], name),
                   lambda sd: jconvert.convert_extras(sd, name),
                   lambda sd: tconvert.convert_extras(sd, name)),
    }
    sd, jfn, tfn = cases[piece]
    sd = {k: np.asarray(v) for k, v in sd.items()}
    j, t = jfn(sd), tfn(sd)
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    tl = dict(tree_items(t))
    assert len(jl) == len(tl)
    for path, leaf in jl:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(tl[key]), np.asarray(leaf),
                                      err_msg=key)


def test_llama_fusion_order_and_resplit():
    """q|k|v and gate|up in that order in convert_llm, and export_llm_full
    splits them back at the same offsets (JAX tests/test_convert.py:52)."""
    cfg = micro_vlm_config("llama3").llm
    rng = np.random.default_rng(0)
    D, I = cfg.hidden_size, cfg.intermediate_size
    sd = {"model.embed_tokens.weight": rng.normal(size=(cfg.padded_vocab_size,
                                                        D)),
          "model.norm.weight": rng.normal(size=(D,)),
          "lm_head.weight": rng.normal(size=(cfg.padded_vocab_size, D))}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for n, shape in (("input_layernorm", (D,)),
                         ("post_attention_layernorm", (D,)),
                         ("self_attn.q_proj", (cfg.q_dim, D)),
                         ("self_attn.k_proj", (cfg.kv_dim, D)),
                         ("self_attn.v_proj", (cfg.kv_dim, D)),
                         ("self_attn.o_proj", (D, cfg.q_dim)),
                         ("mlp.gate_proj", (I, D)), ("mlp.up_proj", (I, D)),
                         ("mlp.down_proj", (D, I))):
            sd[p + n + ".weight"] = rng.normal(size=shape)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    tree = tconvert.convert_llm(sd, cfg)
    qkv = np.asarray(tree["layers"]["qkv_kernel"])[1]
    q, kv = cfg.q_dim, cfg.kv_dim
    np.testing.assert_array_equal(qkv[:, :q],
                                  sd["model.layers.1.self_attn.q_proj.weight"].T)
    np.testing.assert_array_equal(qkv[:, q:q + kv],
                                  sd["model.layers.1.self_attn.k_proj.weight"].T)
    np.testing.assert_array_equal(qkv[:, q + kv:],
                                  sd["model.layers.1.self_attn.v_proj.weight"].T)
    gu = np.asarray(tree["layers"]["gate_up_kernel"])[1]
    np.testing.assert_array_equal(gu[:, :I],
                                  sd["model.layers.1.mlp.gate_proj.weight"].T)
    tp = params_from_jax({"llm": tree}, micro_vlm_config("llama3"), "cpu",
                         seed=0)["llm"]
    back = texport.export_llm_full(tp, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_internvideo2_f4_pos_embed_interpolates_as_jax():
    """A 4-frame checkpoint table read into an 8-frame model: the port's
    convert (frames read from the table) equals the JAX converter
    (ckpt_num_frames=4) and JAX's interpolation."""
    cfg = InternVideo2Config(embed_dim=16, depth=1, num_heads=2,
                             mlp_ratio=2.0, num_frames=8, num_blocks_used=1)
    jp = jiv2.init_params(jax.random.key(0), cfg)
    sd = jexport.export_internvideo2_full(jp, cfg)
    rng = np.random.default_rng(1)
    sd["pos_embed"] = rng.normal(size=(1, 1 + 4 * 256, 16)).astype(
        np.float32)
    want = jconvert.convert_internvideo2(sd, cfg, ckpt_num_frames=4)
    got = tconvert.convert_internvideo2(sd, cfg)
    assert got["pos_embed"].shape == (1 + 8 * 256, 16)
    np.testing.assert_array_equal(got["pos_embed"],
                                  np.asarray(want["pos_embed"]))
    np.testing.assert_array_equal(got["pos_embed"],
                                  tiv2.interpolate_temporal_pos_embed(
                                      sd["pos_embed"][0], 4, 8, 256))
    # the JAX converter cannot read a table at the model's own length
    # without being told; the port reads its length from the rows
    own = jexport.export_internvideo2_full(jp, cfg)
    np.testing.assert_array_equal(
        tconvert.convert_internvideo2(own, cfg)["pos_embed"],
        np.asarray(jp["pos_embed"]))
    with pytest.raises(ValueError):
        jconvert.convert_internvideo2(own, cfg)


def test_llm_config_from_hf_matches_jax():
    from grounded_video_llm_tpu.core.config import phi35_mini_config as jphi
    from grounded_video_llm_tpu_torch.core.config import phi35_mini_config

    hf = {"vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
          "num_hidden_layers": 32, "num_attention_heads": 32,
          "num_key_value_heads": 32, "rms_norm_eps": 1e-5,
          "rope_theta": 10000.0, "max_position_embeddings": 131072,
          "original_max_position_embeddings": 4096,
          "tie_word_embeddings": False,
          "rope_scaling": {"type": "longrope",
                           "short_factor": [1.0 + i / 100 for i in range(48)],
                           "long_factor": [2.0 + i for i in range(48)]}}
    want = jconvert.llm_config_from_hf(hf, jphi(302))
    got = tconvert.llm_config_from_hf(hf, phi35_mini_config(302))
    import dataclasses

    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rope_scaling_long[3] == 5.0 and got.head_dim == 96
    plain = tconvert.llm_config_from_hf({"vocab_size": 7},
                                        phi35_mini_config())
    assert plain.vocab_size == 7 and plain.rope_scaling_short == \
        phi35_mini_config().rope_scaling_short


def test_clip_projector_head_matches_jax():
    """convert_clip_projector_head on a reference-named state dict, then
    clip_projector: rtol 2e-4 against the JAX pair (fp32)."""
    cfg = micro_vlm_config().video
    rng = np.random.default_rng(3)
    D, out = cfg.embed_dim, 24
    p = "clip_projector."
    sd = {}
    for n in ("norm1_q", "norm1_k", "norm1_v"):
        sd[p + n + ".weight"] = 1 + 0.1 * rng.normal(size=(D,))
        sd[p + n + ".bias"] = 0.1 * rng.normal(size=(D,))
    for n in ("q", "k", "v"):
        sd[p + f"cross_attn.{n}.weight"] = 0.1 * rng.normal(size=(D, D))
        sd[p + f"cross_attn.{n}_bias"] = 0.1 * rng.normal(size=(D,))
    sd[p + "cross_attn.proj.weight"] = 0.1 * rng.normal(size=(out, D))
    sd[p + "cross_attn.proj.bias"] = 0.1 * rng.normal(size=(out,))
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    jt = jconvert.convert_clip_projector_head(sd)
    tt = tconvert.convert_clip_projector_head(sd)
    x = rng.normal(size=(2, 33, D)).astype(np.float32)
    want = jiv2.clip_projector(jax.tree_util.tree_map(jnp.asarray, jt), cfg,
                               jnp.asarray(x))
    tparams = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
               for k, v in tt.items()}
    got = tiv2.clip_projector(tparams, cfg, torch.from_numpy(x))
    assert tuple(got.shape) == (2, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=1e-6)
    init = tiv2.init_clip_projector(cfg, generator=torch.Generator(),
                                    device="cpu")
    jinit = jiv2.init_clip_projector(jax.random.key(0), cfg)
    assert {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
            for k, v in init.items()} == \
        {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
         for k, v in jinit.items()}


def test_export_drops_lora_as_the_reference_exporter_does(tmp_path):
    """A fault of the JAX exporter, kept so both packages read each other's
    files alike: with LoRA attached (B != 0) the trainable-only export's
    language_model holds lm_head and embed_tokens only — the adapters'
    deltas, which export_llm_trainable's docstring says are folded in, are
    not written — and build_params reads the base projections back."""
    name = "llama3"
    jcfg, cfg = jmicro(name), micro_vlm_config(name)
    jp = jvlm.init_params(jax.random.key(4), jcfg)
    jp["llm"] = jlora.attach_lora(
        jp["llm"], jlora.init_lora(jax.random.key(5), jcfg.llm, rank=4))
    for la in jp["llm"]["layers"]["lora"].values():
        la["b"] = jnp.full(la["b"].shape, 0.05, jnp.float32)
    tp = params_from_jax(_np(jp), cfg, "cpu")
    written = {}
    for who, export in (("jax", jexport.export_vlm_to_reference),
                        ("port", texport.export_vlm_to_reference)):
        path = str(tmp_path / f"{who}.pth")
        export(jp if who == "jax" else tp, jcfg if who == "jax" else cfg,
               path)
        written[who] = tckpt.import_reference_pth(path)
        assert sorted(written[who]["language_model"]) == [
            "lm_head.weight", "model.embed_tokens.weight"]
    for mod, sd in written["jax"].items():
        for k, v in sd.items():
            np.testing.assert_array_equal(written["port"][mod][k], v)
    merged = jlora.merge_lora(jp["llm"])["layers"]["qkv_kernel"]
    base = np.asarray(jp["llm"]["layers"]["qkv_kernel"])
    assert not np.allclose(np.asarray(merged), base)
    loaded = build_params(cfg, "cpu", torch.float32, seed=0,
                          stage_ckpt=str(tmp_path / "port.pth"))
    assert "lora" not in loaded["llm"]["layers"]
    np.testing.assert_array_equal(loaded["llm"]["embed"].numpy(),
                                  np.asarray(jp["llm"]["embed"]))


def test_build_params_fills_only_what_the_files_lack(tmp_path):
    """A stage checkpoint alone: its projectors, embed and lm_head are
    read, every other piece is the seeded random tree build_params makes
    with no file (each piece draws from its own generator), and a base
    vocabulary read for an expanded config keeps its rows."""
    cfg = micro_vlm_config("llama3")
    base = build_params(cfg, "cpu", torch.float32, seed=9)
    jp = jvlm.init_params(jax.random.key(6), jmicro("llama3"))
    stage = str(tmp_path / "stage.pth")
    jexport.export_vlm_to_reference(jp, jmicro("llama3"), stage,
                                    trainable_only=False)
    got = build_params(cfg, "cpu", torch.float32, seed=9, stage_ckpt=stage)
    read = {"mm_projector", "video_projector", "llm/embed", "llm/lm_head"}
    want = dict(tree_items(params_from_jax(_np(jp), cfg, "cpu")))
    rand = dict(tree_items(base))
    for path, t in tree_items(got):
        src = want if any(path.startswith(r) for r in read) else rand
        assert torch.equal(t, src[path]), path

    small = {"llm": {"embed": np.asarray(jp["llm"]["embed"])[
        :cfg.llm.vocab_size]}}
    tp = params_from_jax(small, cfg, "cpu", seed=0)
    assert tp["llm"]["embed"].shape[0] == cfg.llm.vocab_size
    assert tp["llm"]["lm_head"].shape[1] == cfg.llm.vocab_size
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(small, cfg, "cpu")


def test_checkpoint_store_round_trips(tmp_path):
    """core/checkpoint's save_pytree/load_pytree into a template (paths and
    shapes checked, tensors copied in place) and save_json/load_json."""
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"mu": {"a/w": torch.ones(2, 3)}, "count": 4}, "step": 4}
    path = str(tmp_path / "s.pt")
    tckpt.save_pytree(path, tree)
    tmpl = {"a": {"w": torch.zeros(2, 3)},
            "opt": {"mu": {"a/w": torch.zeros(2, 3)}, "count": 0}, "step": 0}
    w = tmpl["a"]["w"]
    out = tckpt.load_pytree(path, template=tmpl)
    assert tmpl["a"]["w"] is w and torch.equal(w, tree["a"]["w"])
    assert torch.equal(tmpl["opt"]["mu"]["a/w"], tree["opt"]["mu"]["a/w"])
    assert out["opt"]["count"] == 4 and out["step"] == 4
    with pytest.raises(ValueError, match="paths differ"):
        tckpt.load_pytree(path, template={"a": {"w": torch.zeros(2, 3)}})
    tckpt.save_json(str(tmp_path / "j.json"), {"x": [1, 2]})
    assert tckpt.load_json(str(tmp_path / "j.json")) == {"x": [1, 2]}
    assert tckpt.REF_MODULE_KEYS == jckpt.REF_MODULE_KEYS
