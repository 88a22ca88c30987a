"""The port's training path against the JAX package on the CPU, fp32, micro
config (Phi-3.5 and Llama-3), weights carried across by params_from_jax: forward_loss with LoRA
(remat off, per layer, grouped), the gradients of every trainable leaf, two
grounded-preset optimizer steps with grad_accum 2 against make_train_step
and make_host_accum_step, the optimizer groups, expand_vocab and merge_lora;
LoRA dropout on its own terms (torch.Generator and jax.random streams
differ); TrainingStrategy end to end."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_ranks import InMemoryGrounded
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import (LLMConfig, STAGE_PRESETS,
                                                micro_vlm_config)
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.train import lora as jlora
from grounded_video_llm_tpu.train import optimizer as jopt
from grounded_video_llm_tpu.train import step as jstep
from grounded_video_llm_tpu.train.vocab import expand_vocab as jexpand
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.train import lora as tlora
from grounded_video_llm_tpu_torch.train import optimizer as topt
from grounded_video_llm_tpu_torch.train import step as tstep
from grounded_video_llm_tpu_torch.train.vocab import expand_vocab as texpand

LOSS_RTOL = 5e-4        # composite forward, fp32 (the repo's composite bar)
GRAD_REL = 1e-3         # relative L2 per trainable leaf
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6   # tests/test_train.py's parity bar


def _jax_params(cfg, lora_b_seed=7):
    """JAX init + rank-4 LoRA with a non-zero B (so the adapters act)."""
    p = jvlm.init_params(jax.random.key(0), cfg)
    p["llm"] = jlora.attach_lora(
        p["llm"], jlora.init_lora(jax.random.key(1), cfg.llm, rank=4))
    rng = np.random.default_rng(lora_b_seed)
    for name, la in p["llm"]["layers"]["lora"].items():
        la["b"] = jnp.asarray(
            (rng.normal(size=la["b"].shape) * 0.05).astype(np.float32))
    return p


def _torch_params(jp, cfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")


def _batch(cfg, B=1, S=12, accum=None, seed=0):
    """The same numpy batch as (JAX Batch, torch Batch); [accum, B, ...]
    leaves when accum is given."""
    rng = np.random.default_rng(seed)
    lead = (B,) if accum is None else (accum, B)
    ids = rng.integers(3, 50, size=lead + (S,)).astype(np.int32)
    ids[..., 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[..., :3] = -100
    sp = (rng.normal(size=lead + (cfg.num_segs, 336, 336, 3)) * 0.5).astype(
        np.float32)
    tp = (rng.normal(size=lead + (cfg.num_frames, 224, 224, 3)) * 0.5
          ).astype(np.float32)
    arrays = (ids, labels, np.ones(lead + (S,), np.int32), sp, tp,
              np.zeros(lead, bool))
    return (jvlm.Batch(*map(jnp.asarray, arrays)),
            tvlm.Batch(*(torch.from_numpy(a.copy()) for a in arrays)))


@pytest.fixture(scope="module", params=["phi3.5", "llama3"])
def model(request):
    cfg = micro_vlm_config(request.param)
    jp = _jax_params(cfg)
    return cfg, jp


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("remat,group", [(False, 1), (True, 1), (True, 2)],
                         ids=["no_remat", "per_layer", "group2"])
def test_forward_loss_matches_jax(model, remat, group):
    cfg, jp = model
    tp = _torch_params(jp, cfg)
    jb, tb = _batch(cfg, seed=1)
    want = jvlm.forward_loss(jp, cfg, jb, remat=remat, remat_group=group)
    got = tvlm.forward_loss(tp, cfg, tb, remat=remat, remat_group=group)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_trainable_gradients_match_jax(model):
    """Every trainable leaf's gradient (grounded groups: projectors, embed,
    lm_head, LoRA a and b) against jax.grad of the JAX loss."""
    cfg, jp = model
    tp = _torch_params(jp, cfg)
    jb, tb = _batch(cfg, B=2, seed=2)
    labels = jopt.label_params(jp)
    mask = jopt.trainable_mask(labels)
    trainable, frozen = jstep.partition_params(jp, mask)
    g_j = jax.grad(lambda t: jvlm.forward_loss(
        jstep.merge_params(t, frozen), cfg, jb, remat=True))(trainable)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
              for path, g in jax.tree_util.tree_flatten_with_path(g_j)[0]}

    opt, _ = topt.make_optimizer(STAGE_PRESETS["grounded"], 10, tp)
    tstep.set_trainable(tp, opt)
    loss = tvlm.forward_loss(tp, cfg, tb, remat=True)
    loss.backward()
    seen = 0
    for path, t in topt.tree_items(tp):
        if not opt.trainable(path):
            assert t.grad is None and not t.requires_grad
            continue
        seen += 1
        assert _rel(t.grad.numpy(), flat_j[path]) <= GRAD_REL, path
    # lora a and b, both projectors' kernels and biases, embed, lm_head
    assert seen == len(flat_j) == 2 * 4 + 2 * 4 + 2


@pytest.mark.parametrize("accum_fn", ["make_train_step",
                                      "make_host_accum_step"])
def test_two_grounded_steps_match_jax(model, accum_fn):
    """Two optimizer steps of the grounded preset with grad_accum 2 (lora
    dropout off: the two RNG streams differ): loss, grad_norm and every
    parameter after the steps."""
    cfg, jp0 = model
    stage = dataclasses.replace(STAGE_PRESETS["grounded"], lora_dropout=0.0)
    jp = jax.tree_util.tree_map(lambda x: x.copy(), jp0)
    tp = _torch_params(jp, cfg)
    jb, tb = _batch(cfg, B=1, accum=2, seed=3)

    tx, labels = jopt.make_optimizer(stage, total_steps=100, params=jp)
    mask = jopt.trainable_mask(labels)
    make = getattr(jstep, accum_fn)
    j_step = make(cfg, tx, grad_accum=2, remat=False, trainable_mask=mask,
                  lora_dropout=0.0)
    j_state = jstep.create_train_state(jp, tx)

    opt, _ = topt.make_optimizer(stage, 100, tp)
    t_state = tstep.create_train_state(tp, opt)
    t_step = tstep.make_train_step(cfg, opt, grad_accum=2, remat=False)
    for _ in range(2):
        j_state, m_j = j_step(j_state, jb)
        t_state, m_t = t_step(t_state, tb)
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=STEP_RTOL)
    assert t_state.step == int(j_state.step) == 2
    flat_j = jax.tree_util.tree_flatten_with_path(j_state.params)[0]
    flat_t = dict(topt.tree_items(t_state.params))
    assert len(flat_j) == len(flat_t)
    moved = 0
    for path, leaf in flat_j:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        got = flat_t[key].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(leaf), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)
        moved += not np.array_equal(got, np.asarray(_leaf(jp0, path)))
    assert moved == 2 * 4 + 2 * 4 + 2   # every trainable leaf, no other


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", k)]
    return tree


def test_first_step_is_a_no_op(model):
    """lr is 0 at count 0 (the schedule is evaluated before the count
    advances), so one step leaves every leaf as it was."""
    cfg, jp = model
    tp = _torch_params(jp, cfg)
    _, tb = _batch(cfg, seed=4)
    before = {p: t.clone() for p, t in topt.tree_items(tp)}
    opt, _ = topt.make_optimizer(STAGE_PRESETS["grounded"], 100, tp)
    state = tstep.create_train_state(tp, opt)
    state, m = tstep.make_train_step(cfg, opt, remat=False)(state, tb)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for p, t in topt.tree_items(state.params):
        assert torch.equal(t, before[p]), p
    assert state.opt_state["count"] == 1


def test_label_params_match_jax(model):
    cfg, jp = model
    tp = _torch_params(jp, cfg)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): label
            for path, label in jax.tree_util.tree_flatten_with_path(
                jopt.label_params(jp))[0]}
    got = dict(topt.tree_items(topt.label_params(tp)))
    assert got == want
    assert got["llm/layers/lora/qkv/scale"] == "frozen"
    assert got["llm/embed"] == got["llm/lm_head"] == "llm"


def test_schedule_matches_optax():
    import optax

    for total, warmup in ((100, 3), (10, 1), (2, 1)):
        want = optax.warmup_cosine_decay_schedule(
            0.0, 2e-4, warmup, max(total, warmup + 1), 0.0)
        got = topt.warmup_cosine_decay(0.0, 2e-4, warmup,
                                       max(total, warmup + 1))
        for c in range(total + 3):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                       atol=1e-12)


def test_expand_vocab_and_merge_lora_match_jax():
    cfg = LLMConfig(family="phi3", vocab_size=16, hidden_size=8,
                    intermediate_size=16, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=4)
    jp = jllm.init_params(jax.random.key(0), cfg)
    tp = {k: (torch.from_numpy(np.asarray(v).copy()) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.asarray(vv).copy())
                    for kk, vv in v.items()}) for k, v in jp.items()}
    je, te = jexpand(jp, 3), texpand(tp, 3)
    for key in ("embed", "lm_head"):
        np.testing.assert_allclose(te[key].numpy(), np.asarray(je[key]),
                                   rtol=1e-6, atol=1e-7)
    jl = jlora.init_lora(jax.random.key(1), cfg, rank=2, alpha=4.0)
    jl["qkv"]["b"] = jnp.ones_like(jl["qkv"]["b"]) * 0.01
    tl = {n: {k: torch.from_numpy(np.asarray(v).copy()) for k, v in d.items()}
          for n, d in jl.items()}
    jm = jlora.merge_lora(jlora.attach_lora(jp, jl))
    tm = tlora.merge_lora(tlora.attach_lora(tp, tl))
    assert "lora" not in tm["layers"]
    for key, v in jm["layers"].items():
        np.testing.assert_allclose(tm["layers"][key].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    init = tlora.init_lora(cfg, generator=g, device="cpu", rank=2, alpha=4.0)
    assert float(init["o"]["scale"][0]) == 2.0
    assert not init["down"]["b"].any()
    assert abs(float(init["gate_up"]["a"].std()) - 0.02) < 0.01


def test_lora_dropout_keep_rate_and_scaling():
    """Keep probability 1 - rate within binomial bounds (5 sigma), kept
    values scaled by 1 / (1 - rate), the same seed the same mask."""
    rate, n = 0.05, 1_000_000
    x = torch.ones(n)
    y = tllm.lora_dropout(x, rate, seed=123)
    kept = y != 0
    frac = float(kept.float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(frac - (1 - rate)) < 5 * sigma
    np.testing.assert_allclose(y[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
    assert torch.equal(y, tllm.lora_dropout(x, rate, seed=123))
    assert not torch.equal(y, tllm.lora_dropout(x, rate, seed=124))


def test_lora_dropout_reaches_only_the_lora_branch():
    """With B = 0 the dropped and undropped projections are equal (the base
    path sees x untouched); with B != 0 they differ."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=g)
    w = torch.randn(8, 6, generator=g)
    la = {"a": torch.randn(8, 3, generator=g), "b": torch.zeros(3, 6),
          "scale": torch.tensor(2.0)}
    lp = {"lora": {"qkv": la}}
    base = x @ w
    assert torch.equal(tllm._dense(x, w, lp, "qkv", drop=(0.5, 9)), base)
    la["b"] = torch.randn(3, 6, generator=g)
    plain = tllm._dense(x, w, lp, "qkv")
    dropped = tllm._dense(x, w, lp, "qkv", drop=(0.5, 9))
    assert not torch.allclose(plain, dropped)
    xl = tllm.lora_dropout(x, 0.5, tllm.mix_seed(9, tllm._LORA_SLOT["qkv"]))
    torch.testing.assert_close(dropped, base + (xl @ la["a"] @ la["b"]) * 2.0)


def test_lora_dropout_masks_survive_remat(model):
    """The same dropout seed gives the same masks with remat on and off
    (the recompute redraws them from the same per-layer seeds), so the loss
    and the gradients are equal."""
    cfg, jp = model
    _, tb = _batch(cfg, seed=6)
    out = []
    for remat in (False, True):
        tp = _torch_params(jp, cfg)
        opt, _ = topt.make_optimizer(STAGE_PRESETS["grounded"], 10, tp)
        tstep.set_trainable(tp, opt)
        loss = tvlm.forward_loss(tp, cfg, tb, remat=remat, lora_dropout=0.05,
                                 dropout_seed=77)
        loss.backward()
        out.append((loss.item(), {p: t.grad.clone()
                                  for p, t in topt.tree_items(tp)
                                  if t.grad is not None}))
    assert out[0][0] == out[1][0]
    for p, gr in out[0][1].items():
        torch.testing.assert_close(out[1][1][p], gr, rtol=1e-6, atol=0)
    no_drop = tvlm.forward_loss(_torch_params(jp, cfg), cfg, tb)
    assert float(no_drop) != out[0][0]


@pytest.fixture()
def grounded_2x2():
    """The grounded preset at a global batch of 2 in microbatches of 1."""
    from grounded_video_llm_tpu_torch.core.config import STAGE_PRESETS as P

    orig = P["grounded"]
    P["grounded"] = dataclasses.replace(orig, global_batch_size=2,
                                        per_device_batch_size=1, epochs=1)
    yield
    P["grounded"] = orig


def test_training_strategy_end_to_end(tmp_path, grounded_2x2):
    """dataset → loader → collate → two accumulated steps → metrics →
    checkpoint → resume, and the NaN abort."""
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import micro_vlm_config
    from grounded_video_llm_tpu_torch.text.tokenizer import \
        build_test_tokenizer
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    cfg = micro_vlm_config("phi3.5")
    tok = build_test_tokenizer("phi3.5")
    ds = InMemoryGrounded(cfg)

    def make(run):
        return TrainingStrategy(cfg, "grounded",
                                build_params(cfg, "cpu", torch.float32, 0),
                                tok, run_dir=str(tmp_path / run),
                                n_train_examples=len(ds))

    s1 = make("a")
    assert s1.grad_accum == 2
    assert "lora" in s1.state.params["llm"]["layers"]
    # the micro config carries the extra rows: no second expansion
    assert s1.state.params["llm"]["embed"].shape[0] == \
        cfg.llm.padded_vocab_size
    seen = []
    s1.run_training(ds, on_step=lambda step, m: seen.append((step, m)))
    assert [s for s, _ in seen] == [1, 2] and s1.metrics.global_step == 2
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for _, m in seen)
    log = (tmp_path / "a" / "grounded-phi3.5.jsonl").read_text().splitlines()
    assert json.loads(log[-1])["step"] == 2
    path = s1.save_checkpoint("latest", s1.make_loader(ds))
    assert os.path.exists(path)

    s2 = make("b")
    loader = s2.make_loader(ds)
    s2.load_resume(path, loader)
    assert s2.state.step == 2 and s2.state.opt_state["count"] == 2
    for (p, a), (_, b) in zip(topt.tree_items(s1.state.params),
                              topt.tree_items(s2.state.params)):
        assert torch.equal(a, b), p
    for p, t in s1.state.opt_state["mu"].items():
        assert torch.equal(t, s2.state.opt_state["mu"][p])

    s3 = make("c")
    with torch.no_grad():
        s3.state.params["llm"]["lm_head"].fill_(float("nan"))
    with pytest.raises(RuntimeError, match="NaN loss"):
        s3.run_training(ds)


def test_training_strategy_expands_a_base_vocab(tmp_path, grounded_2x2):
    """A tree with only the base vocabulary gets NUM_SPECIAL_TOKENS
    mean-initialised rows, once."""
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import (NUM_SPECIAL_TOKENS,
                                                          micro_vlm_config,
                                                          replace)
    from grounded_video_llm_tpu_torch.text.tokenizer import \
        build_test_tokenizer
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    cfg = micro_vlm_config("phi3.5")
    base = replace(cfg, llm=replace(cfg.llm, num_extra_tokens=0))
    params = build_params(base, "cpu", torch.float32, 0)
    s = TrainingStrategy(cfg, "grounded", params, build_test_tokenizer(),
                         run_dir=str(tmp_path), n_train_examples=4)
    embed = s.state.params["llm"]["embed"]
    assert embed.shape[0] == cfg.llm.vocab_size + NUM_SPECIAL_TOKENS
    torch.testing.assert_close(embed[-1], embed[:cfg.llm.vocab_size].mean(0))


def test_weight_bridge_carries_an_expanded_vocab_and_refuses_bad_lora():
    """A JAX tree expanded by expand_vocab on a config without the extra
    rows maps onto the port; a LoRA leaf of the wrong shape is refused."""
    from grounded_video_llm_tpu.core.config import replace

    cfg = micro_vlm_config("phi3.5")
    base = replace(cfg, llm=replace(cfg.llm, num_extra_tokens=0))
    jp = jvlm.init_params(jax.random.key(0), base)
    jp["llm"] = jexpand(jp["llm"], 302)
    tp = _torch_params(jp, base)
    assert tp["llm"]["embed"].shape[0] == base.llm.vocab_size + 302
    np.testing.assert_array_equal(tp["llm"]["lm_head"].numpy(),
                                  np.asarray(jp["llm"]["lm_head"]))
    bad = _jax_params(cfg)
    bad["llm"]["layers"]["lora"]["o"]["b"] = jnp.zeros((2, 3, 64))
    with pytest.raises(ValueError, match="lora/o/b"):
        _torch_params(bad, cfg)


def _grounded_run_files(tmp_path):
    """A small mp4 (cv2) and a grounded annotation of two samples on it."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (80, 60))
    for i in range(30):
        w.write(np.full((60, 80, 3), 8 * i, np.uint8))
    w.release()
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps([{
        "question_id": f"q{i}", "video_id": "v0", "video_file": path.name,
        "conversation": [
            {"from": "human", "value": "<image>\nWhen does it happen?"},
            {"from": "gpt", "value": "From <0.5> to <2.0>."}]}
        for i in range(2)]))
    return ["--debug_tiny", "--device", "cpu", "--stage", "grounded",
            "--dataset", "mix_grounded", "--anno_path", str(anno),
            "--data_dir", str(tmp_path), "--global_batch_size", "2",
            "--per_device_batch_size", "1", "--epoch", "1"]


def _run_train_cli(argv):
    from grounded_video_llm_tpu_torch.cli import train as cli
    from grounded_video_llm_tpu_torch.core import config as tcfg

    orig = tcfg.STAGE_PRESETS["grounded"]
    try:
        return cli.main(argv)
    finally:
        tcfg.STAGE_PRESETS["grounded"] = orig


def test_cli_train_debug_tiny_on_the_cpu(tmp_path):
    """cli/train.py --debug_tiny --device cpu: a grounded run over two
    annotated samples of a written video, one optimizer step, a final
    checkpoint."""
    out = _run_train_cli(_grounded_run_files(tmp_path)
                         + ["--save_dir", str(tmp_path / "run")])
    saved = torch.load(out, weights_only=True)
    assert saved["step"] == 1 and saved["opt_state"]["count"] == 1
    assert "lora" in saved["params"]["llm"]["layers"]


def test_cli_train_loads_reference_files_and_exports(tmp_path):
    """cli/train.py with --pretrained_vision_proj_llm_path,
    --pretrained_video_path and --pretrained_proj on files the port's
    exporter wrote: the run starts from them (the frozen pieces equal the
    files'), and after the final
    checkpoint it writes the reference-format export at the root train.py's
    name, which the JAX package reads."""
    from grounded_video_llm_tpu.core.checkpoint import import_reference_pth
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import \
        micro_vlm_config as tmicro
    from grounded_video_llm_tpu_torch.models.export import write_weight_dumps

    cfg = tmicro("phi3.5")
    src = build_params(cfg, "cpu", torch.float32, seed=123)
    paths = write_weight_dumps(src, cfg, str(tmp_path / "ckpt"))
    run = tmp_path / "run"
    out = _run_train_cli(_grounded_run_files(tmp_path) + [
        "--save_dir", str(run),
        "--pretrained_vision_proj_llm_path", paths["weight_root"],
        "--pretrained_video_path", paths["video_encoder"],
        "--pretrained_proj", paths["stage_ckpt"]])
    saved = torch.load(out, weights_only=True)["params"]
    for key in ("clip", "video_encoder", "extras"):
        for (p, a), (_, b) in zip(topt.tree_items(saved[key]),
                                  topt.tree_items(src[key])):
            assert torch.equal(a, b), p
    assert torch.equal(saved["llm"]["layers"]["qkv_kernel"],
                       src["llm"]["layers"]["qkv_kernel"])
    export = run / "grounded_llava_next_video_phi3.5_mix_grounded.pth"
    mods = import_reference_pth(str(export))
    assert set(mods) == {"multi_modal_projector", "video_projecter",
                         "language_model"}
    np.testing.assert_array_equal(mods["language_model"]["lm_head.weight"].T,
                                  saved["llm"]["lm_head"].detach().numpy())
    np.testing.assert_array_equal(mods["video_projecter"]["up_proj.weight"].T,
                                  saved["video_projector"]["fc1"]["kernel"]
                                  .detach().numpy())


@pytest.mark.parametrize("chunk", [4, 1024])
def test_llm_losses_match_jax(model, chunk):
    """forward_logits + causal_lm_loss and the chunked
    causal_lm_loss_from_hidden (value and the lm_head / hidden gradients)
    against the JAX functions, with a right-padded mask and ignored
    labels."""
    cfg, jp = model
    tp = _torch_params(jp, cfg)
    rng = np.random.default_rng(8)
    B, S, D = 2, 11, cfg.llm.hidden_size
    x = (rng.normal(size=(B, S, D)) * 0.5).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 8:] = 0
    labels = rng.integers(0, cfg.llm.padded_vocab_size, (B, S)).astype(
        np.int32)
    labels[0, :4] = -100
    jl, tl = jp["llm"], tp["llm"]
    want = jllm.causal_lm_loss(jllm.forward_logits(
        jl, cfg.llm, jnp.asarray(x), jnp.asarray(mask)), jnp.asarray(labels))
    got = tllm.causal_lm_loss(tllm.forward_logits(
        tl, cfg.llm, torch.from_numpy(x), torch.from_numpy(mask)),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)

    hj, _ = jllm.forward_hidden(jl, cfg.llm, jnp.asarray(x),
                                jnp.asarray(mask))

    def jloss(h, head):
        return jllm.causal_lm_loss_from_hidden(dict(jl, lm_head=head), h,
                                               jnp.asarray(labels),
                                               chunk=chunk)

    lj, (dh_j, dw_j) = jax.value_and_grad(jloss, argnums=(0, 1))(
        hj, jl["lm_head"])
    h = torch.from_numpy(np.asarray(hj)).requires_grad_()
    head = tl["lm_head"].detach().clone().requires_grad_()
    lt = tllm.causal_lm_loss_from_hidden({"lm_head": head}, h,
                                         torch.from_numpy(labels),
                                         chunk=chunk)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert _rel(h.grad.numpy(), dh_j) <= 1e-5
    assert _rel(head.grad.numpy(), dw_j) <= 1e-5
