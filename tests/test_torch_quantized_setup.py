"""The serving-int8 trees the port builds directly (serve/quantize.py
init_llm_params_quantized, init_vlm_params_serving, upload_llm_quantized;
cli/model_loading.build_params(quantize=)) on micro_vlm_config, against the
port's own init-then-quantize and against the JAX package.

Bars: the port's direct routes are bit-equal to its bf16 route quantized by
quantize_llm_for_serving (every int8 byte, fp32 scale, w8a8 flag and the
padded row layout). Against JAX: the seeded trees have the structure,
types, dtypes and shapes params_from_jax gives JAX's (the two packages'
random draws differ); trees read from the same weight files agree as JAX's
own upload test holds its upload: scales rtol 1e-6, int8 values off by at
most 1 on under 1e-3 of the elements (jit-vs-eager reductions may move a
scale by an ulp and flip a round() at an exact tie), every dense leaf
bit-equal.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.cli import model_loading as jml
from grounded_video_llm_tpu.core.config import micro_vlm_config as jmicro
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu_torch.cli.model_loading import build_params
from grounded_video_llm_tpu_torch.core.config import micro_vlm_config, replace
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.convert import Stacked
from grounded_video_llm_tpu_torch.models.export import write_weight_dumps
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops.int8_matmul import (Int8Embedding,
                                                         Int8Weight)
from grounded_video_llm_tpu_torch.serve import quantize as tq
from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
from grounded_video_llm_tpu_torch.serve.generate import generate_tokens
from grounded_video_llm_tpu_torch.train.optimizer import tree_items

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run beside the other test workers,
    where torch's default of one thread per core oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(tree_items(tree))


def _assert_bit_equal(got, want):
    """Same paths, types, dtypes, shapes, row layouts, values and flags."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for path, b in w.items():
        a = g[path]
        assert type(a) is type(b), path
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
            continue
        for field, u, v in zip(b._fields, a, b):
            if isinstance(v, torch.Tensor):
                assert (u.dtype == v.dtype and u.shape == v.shape
                        and u.stride() == v.stride()
                        and torch.equal(u, v)), (path, field)
            else:
                assert u == v, (path, field)


def _signature(tree):
    """{path: (type, w8a8, ((dtype, shape) of each tensor))}."""
    out = {}
    for path, leaf in _leaves(tree).items():
        if isinstance(leaf, torch.Tensor):
            out[path] = ("tensor", None, ((leaf.dtype, tuple(leaf.shape)),))
        else:
            out[path] = (type(leaf).__name__, getattr(leaf, "w8a8", None),
                         tuple((t.dtype, tuple(t.shape)) for t in leaf
                               if isinstance(t, torch.Tensor)))
    return out


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
def test_direct_init_bit_equal_to_init_then_quantize(w8a8, monkeypatch):
    """init_llm_params_quantized == quantize_llm_for_serving(llm.init_params)
    for the same generator state, with the embed and lm_head quantized in
    chunks of 100 rows / columns (the 814-row vocabulary: 9 chunks, the
    lm_head's rows padded to 16 bytes)."""
    monkeypatch.setattr(tq, "_CHUNK", 100)
    cfg = micro_vlm_config("phi3.5").llm
    got = tq.init_llm_params_quantized(cfg, generator=_gen(3), device="cpu",
                                       w8a8=w8a8)
    want = tq.quantize_llm_for_serving(tllm.init_params(
        cfg, generator=_gen(3), device="cpu", dtype=BF16), w8a8)
    _assert_bit_equal(got, want)


@pytest.fixture(scope="module")
def jax_seeded():
    """JAX's seeded build_params(quantize="int8_full") as a numpy tree: its
    vlm.init_params with the LLM from init_llm_params_quantized(w8a8) —
    init_vlm_params_serving(w8a8=True) without the encoders' quantization."""
    return _np(jml.build_params(jmicro("phi3.5"), quantize="int8_full"))


def test_seeded_trees_shaped_as_jax(jax_seeded):
    """The port's init_vlm_params_serving(w8a8=True) and seeded
    build_params(quantize="int8_full") have exactly the paths, types, w8a8
    flags, dtypes and shapes params_from_jax gives JAX's seeded tree."""
    cfg = micro_vlm_config("phi3.5")
    want = _signature(params_from_jax(jax_seeded, cfg, "cpu", BF16))
    serving = tq.init_vlm_params_serving(cfg, generator=_gen(0),
                                         device="cpu", w8a8=True)
    assert _signature(serving) == want
    assert _signature(build_params(cfg, "cpu", BF16, seed=5,
                                   quantize="int8_full")) == want
    assert isinstance(serving["llm"]["embed"], Int8Embedding)
    assert serving["llm"]["layers"]["qkv_kernel"].w8a8 is True
    assert serving["llm"]["lm_head"].w8a8 is False


def test_serving_tree_keeps_every_piece_and_generates():
    """init_vlm_params_serving: every non-LLM piece equal to a plain bf16
    init_params with the same generator (the per-piece order kept), the
    LLM equal to its quantization; with quantize_encoders it drives
    generate_tokens over the int8 cache (JAX's
    test_init_vlm_params_serving_generates)."""
    cfg = micro_vlm_config("phi3.5")
    plain = tvlm.init_params(cfg, generator=_gen(0), device="cpu",
                             dtype=BF16)
    got = tq.init_vlm_params_serving(cfg, generator=_gen(0), device="cpu",
                                     w8a8=True)
    _assert_bit_equal(got, dict(plain, llm=tq.quantize_llm_for_serving(
        plain["llm"], w8a8=True)))

    params = tq.init_vlm_params_serving(cfg, generator=_gen(0), device="cpu",
                                        w8a8=True, quantize_encoders=True)
    assert tq.is_quantized(params["clip"]["layers"]["q"]["kernel"])
    assert tq.is_quantized(params["video_encoder"]["blocks"]["qkv_kernel"])
    B, S = 1, 8
    ids = torch.full((B, S), 5, dtype=torch.long)
    ids[:, 1] = -200
    sp = torch.zeros(B, cfg.num_segs, 336, 336, 3, dtype=torch.uint8)
    tp = torch.zeros(B, cfg.num_frames, 224, 224, 3, dtype=torch.uint8)
    toks, lengths = generate_tokens(
        params, cfg, ids, torch.ones(B, S, dtype=torch.long), sp, tp,
        _gen(1), max_new_tokens=4, temperature=0.2, do_sample=True,
        eos_token_id=-1, pad_token_id=0, quantize_cache=True)
    assert tuple(toks.shape) == (B, 4)
    assert bool((lengths >= 1).all())


@pytest.fixture(scope="module")
def host_llm():
    """A 5-layer micro LLM in fp32 as host leaves: numpy, with two stacks
    given as models/convert.Stacked (read a layer at a time)."""
    cfg = replace(micro_vlm_config("phi3.5").llm, num_layers=5)
    tree = tllm.init_params(cfg, generator=_gen(7), device="cpu",
                            dtype=torch.float32)
    host = {k: v.numpy() for k, v in tree.items() if k != "layers"}
    host["layers"] = {k: v.numpy() for k, v in tree["layers"].items()}
    for name in ("qkv_kernel", "input_norm_w"):
        arr = host["layers"][name]
        host["layers"][name] = Stacked([lambda i=i, a=arr: a[i]
                                        for i in range(len(arr))])
    return cfg, host


@pytest.mark.parametrize("chunk_layers", [1, 3, 5])
def test_upload_bit_equal_to_whole_tree_quantization(host_llm, chunk_layers,
                                                     monkeypatch):
    """upload_llm_quantized == quantize_llm_for_serving of the whole tree
    uploaded in bf16, for chunks of 1, 3 (ragged: 3 + 2) and all 5 layers;
    the embed and lm_head in chunks of 100 rows / columns."""
    monkeypatch.setattr(tq, "_CHUNK", 100)
    _, host = host_llm
    whole = {k: torch.from_numpy(np.array(v, np.float32)).to(BF16)
             for k, v in host.items() if k != "layers"}
    whole["layers"] = {k: torch.from_numpy(np.array(v, np.float32)).to(BF16)
                       for k, v in host["layers"].items()}
    got = tq.upload_llm_quantized(host, w8a8=True, chunk_layers=chunk_layers,
                                  device="cpu")
    _assert_bit_equal(got, tq.quantize_llm_for_serving(whole, w8a8=True))


def _assert_close_to_jax(got, want):
    """Dense leaves bit-equal; int8 pairs: scales rtol 1e-6, values off by
    at most 1 on under 1e-3 of the elements, the same w8a8 flag."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for path, b in w.items():
        a = g[path]
        assert type(a) is type(b), path
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
            continue
        assert getattr(a, "w8a8", None) == getattr(b, "w8a8", None), path
        np.testing.assert_allclose(a.scale.numpy(), b.scale.numpy(),
                                   rtol=1e-6, err_msg=path)
        diff = (a.q.int() - b.q.int()).abs()
        assert int(diff.max()) <= 1, path
        assert float((diff > 0).float().mean()) < 1e-3, path


def test_upload_matches_jax_upload(host_llm):
    """The port's upload against JAX's upload_llm_quantized of the same
    host tree (w8a8)."""
    _, host = host_llm
    jhost = dict(host, layers={k: np.array(v, np.float32)
                               for k, v in host["layers"].items()})
    jtree = _np(jq.upload_llm_quantized(jhost, w8a8=True, chunk_layers=2))
    want = {k: v for k, v in params_from_jax(
        {"llm": jtree}, replace(micro_vlm_config("phi3.5"),
                                llm=host_llm[0]), "cpu", BF16,
        seed=0)["llm"].items()}
    got = tq.upload_llm_quantized(host, w8a8=True, chunk_layers=2,
                                  device="cpu")
    _assert_close_to_jax(got, want)


def test_build_params_quantized_from_files_matches_jax(tmp_path):
    """build_params(quantize="int8_full"): seeded, bit-equal to the port's
    bf16 build quantized; from the weight dumps of models/export.write_weight_dumps (a
    stage checkpoint included, whose embed and lm_head replace the dumps'),
    bit-equal to the port's bf16 read quantized and within the upload bars
    of JAX's build_params(quantize="int8_full") of the same files."""
    cfg = micro_vlm_config("phi3.5")
    jcfg = jmicro("phi3.5")
    got = build_params(cfg, "cpu", BF16, seed=5, quantize="int8_full")
    plain = build_params(cfg, "cpu", BF16, seed=5)
    _assert_bit_equal(got, dict(plain, llm=tq.quantize_llm_for_serving(
        plain["llm"], w8a8=True)))

    src = build_params(cfg, "cpu", torch.float32, seed=9)
    # the stage checkpoint brings another embed and lm_head than the dumps
    stage_src = dict(src, llm=dict(src["llm"], **{
        k: src["llm"][k] * 0.5 for k in ("embed", "lm_head")}))
    dumps = write_weight_dumps(src, cfg, str(tmp_path / "dumps"))
    stage = write_weight_dumps(stage_src, cfg, str(tmp_path / "stage"))
    files = dict(weight_root=dumps["weight_root"],
                 video_encoder_path=dumps["video_encoder"],
                 stage_ckpt=stage["stage_ckpt"])
    got = build_params(cfg, "cpu", BF16, seed=1, quantize="int8_full",
                       **files)
    plain = build_params(cfg, "cpu", BF16, seed=1, **files)
    _assert_bit_equal(got, dict(plain, llm=tq.quantize_llm_for_serving(
        plain["llm"], w8a8=True)))
    assert torch.equal(got["llm"]["embed"].q, tq.quantize_embed_int8(
        stage_src["llm"]["embed"].to(BF16)).q)
    jfiles = params_from_jax(_np(jml.build_params(
        jcfg, quantize="int8_full", **files)), cfg, "cpu", BF16)
    _assert_close_to_jax(got, jfiles)

    # only a stage checkpoint: its embed and lm_head quantized, the rest of
    # the LLM drawn directly in int8, each as the bf16 route has it
    got = build_params(cfg, "cpu", BF16, seed=1, quantize="int8",
                       stage_ckpt=files["stage_ckpt"])
    plain = build_params(cfg, "cpu", BF16, seed=1,
                         stage_ckpt=files["stage_ckpt"])
    _assert_bit_equal(got, dict(plain, llm=tq.quantize_llm_for_serving(
        plain["llm"])))


def test_build_params_refuses_bad_modes_and_shapes(tmp_path):
    cfg = micro_vlm_config("phi3.5")
    with pytest.raises(ValueError, match="quantize='int4'"):
        build_params(cfg, "cpu", quantize="int4")
    wide = replace(cfg, llm=replace(cfg.llm, intermediate_size=256))
    dumps = write_weight_dumps(build_params(wide, "cpu", torch.float32,
                                            seed=2), wide, str(tmp_path))
    with pytest.raises(ValueError, match="gate_up_kernel in the files is "
                       r"\(2, 64, 512\), expected \(2, 64, 256\)"):
        build_params(cfg, "cpu", quantize="int8",
                     weight_root=dumps["weight_root"])


def test_engine_keeps_the_prequantized_llm():
    """The engine serves build_params(quantize=)'s tree as it is (the same
    LLM object) and quantizes the encoders itself for int8_full (JAX's
    test_build_params_quantized_and_engine_skip)."""
    cfg = micro_vlm_config("phi3.5")
    params = build_params(cfg, "cpu", BF16, seed=0, quantize="int8_full")
    assert isinstance(params["llm"]["lm_head"], Int8Weight)
    assert params["llm"]["layers"]["qkv_kernel"].w8a8
    eng = InferenceEngine(params, cfg, object(), quantize="int8_full")
    assert eng.params["llm"] is params["llm"]
    assert tq.is_quantized(eng.params["video_encoder"]["blocks"]
                           ["qkv_kernel"])
    assert tq.is_quantized(eng.params["clip"]["layers"]["q"]["kernel"])


def test_direct_init_on_the_meta_device_and_skip():
    """skip leaves an entry on the meta device and draws the others as
    before (each entry has its own generator)."""
    cfg = micro_vlm_config("phi3.5").llm
    full = tq.init_llm_params_quantized(cfg, generator=_gen(4), device="cpu")
    part = tq.init_llm_params_quantized(cfg, generator=_gen(4), device="cpu",
                                        skip=frozenset({("embed",)}))
    assert part["embed"].q.is_meta and part["embed"].scale.is_meta
    _assert_bit_equal({k: v for k, v in part.items() if k != "embed"},
                      {k: v for k, v in full.items() if k != "embed"})
    meta = functools.partial(tq.init_llm_params_quantized, cfg,
                             generator=None, device="meta")
    assert _signature(meta()) == _signature(full)
