"""The pretrain and sft stages of the port against the JAX package on the
CPU (fp32, micro config, weights carried across by params_from_jax): two
optimizer steps of each preset against the JAX make_train_step (loss, grad_norm and every parameter within rtol 1e-4,
atol 1e-6, tests/test_train.py's bar); pretrain leaves the LLM and both
encoders bit-equal and moves only the projectors (JAX's
test_pretrain_stage_freezes_llm_and_encoders), sft moves LoRA, lm_head /
embed and the projectors; TrainingStrategy runs both presets end to end
(stage features: no LoRA and no vocabulary expansion for pretrain, both
for sft, each stage's max_txt_len)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_ranks import InMemoryGrounded
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import STAGE_PRESETS, micro_vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.train import lora as jlora
from grounded_video_llm_tpu.train import optimizer as jopt
from grounded_video_llm_tpu.train import step as jstep
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.train import optimizer as topt
from grounded_video_llm_tpu_torch.train import step as tstep

STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
ENCODERS = ("clip", "video_encoder")
PROJECTORS = ("mm_projector", "video_projector")


def _batch(cfg, B=1, S=12, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 50, size=(B, S)).astype(np.int32)
    ids[..., 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[..., :3] = -100
    sp = (rng.normal(size=(B, cfg.num_segs, 336, 336, 3)) * 0.5
          ).astype(np.float32)
    tp = (rng.normal(size=(B, cfg.num_frames, 224, 224, 3)) * 0.5
          ).astype(np.float32)
    arrays = (ids, labels, np.ones((B, S), np.int32), sp, tp,
              np.zeros((B,), bool))
    return (jvlm.Batch(*map(jnp.asarray, arrays)),
            tvlm.Batch(*(torch.from_numpy(a.copy()) for a in arrays)))


@functools.lru_cache(maxsize=1)
def _base_params():
    """The JAX micro tree as numpy, drawn once for both presets (jitted:
    the eager init dispatches op by op, ~12 s here)."""
    cfg = micro_vlm_config("phi3.5")
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jvlm.init_params(k, cfg))(jax.random.key(0)))


def _key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


@pytest.fixture(scope="module", params=["pretrain", "sft"])
def two_steps(request):
    """Both packages' two steps of one preset (LoRA dropout 0: the RNG
    streams differ) from the same weights."""
    name = request.param
    cfg = micro_vlm_config("phi3.5")
    jp = jax.tree_util.tree_map(jnp.asarray, _base_params())
    if name == "sft":
        jp["llm"] = jlora.attach_lora(
            jp["llm"], jlora.init_lora(jax.random.key(1), cfg.llm, rank=4))
        rng = np.random.default_rng(7)
        for la in jp["llm"]["layers"]["lora"].values():
            la["b"] = jnp.asarray(
                (rng.normal(size=la["b"].shape) * 0.05).astype(np.float32))
    before = {_key(p): np.asarray(x).copy()
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    stage = dataclasses.replace(STAGE_PRESETS[name], lora_dropout=0.0)
    jb, tb = _batch(cfg)

    tx, labels = jopt.make_optimizer(stage, total_steps=100, params=jp)
    j_step = jstep.make_train_step(cfg, tx, remat=False,
                                   trainable_mask=jopt.trainable_mask(labels))
    j_state = jstep.create_train_state(jp, tx)
    opt, _ = topt.make_optimizer(stage, 100, tp)
    t_state = tstep.create_train_state(tp, opt)
    t_step = tstep.make_train_step(cfg, opt, remat=False)
    metrics = []
    for _ in range(2):
        j_state, m_j = j_step(j_state, jb)
        t_state, m_t = t_step(t_state, tb)
        metrics.append(((float(m_t["loss"]), float(m_t["grad_norm"])),
                        (float(m_j["loss"]), float(m_j["grad_norm"]))))
    after_j = {_key(p): np.asarray(x) for p, x in
               jax.tree_util.tree_flatten_with_path(j_state.params)[0]}
    after_t = {p: t.detach().numpy()
               for p, t in topt.tree_items(t_state.params)}
    return name, metrics, before, after_j, after_t


def test_two_stage_steps_match_jax(two_steps):
    name, metrics, _, after_j, after_t = two_steps
    for (lt, nt), (lj, nj) in metrics:
        np.testing.assert_allclose(lt, lj, rtol=STEP_RTOL)
        np.testing.assert_allclose(nt, nj, rtol=STEP_RTOL)
        assert nt > 0
    assert set(after_t) == set(after_j)
    for p, want in after_j.items():
        np.testing.assert_allclose(after_t[p], want, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=f"{name} {p}")


def test_stage_moves_only_its_groups(two_steps):
    """pretrain: the LLM (embed and lm_head have lr 0 there) and both
    encoders stay bit-equal, the projectors move; sft also moves LoRA,
    lm_head and embed."""
    name, _, before, _, after_t = two_steps
    moved = {p for p, t in after_t.items()
             if not np.array_equal(t, before[p])}
    projectors = {p for p in after_t if p.split("/")[0] in PROJECTORS}
    assert len(projectors) == 8
    if name == "pretrain":
        assert moved == projectors
        for p in after_t:
            if p.split("/")[0] in ENCODERS + ("llm",):
                np.testing.assert_array_equal(after_t[p], before[p],
                                              err_msg=p)
    else:
        lora = {p for p in after_t if "/lora/" in p and
                p.endswith(("/a", "/b"))}
        assert moved == projectors | lora | {"llm/embed", "llm/lm_head"}


def _conversation(stage):
    """A caption (pretrain's format) or an SFT mix of a question and a
    grounding turn, with the grounding mark and time tokens."""
    from grounded_video_llm_tpu_torch.text import codec

    conv = [{"from": "human", "value": "<image>\nDescribe the video."},
            {"from": "gpt", "value": "A car drives along a street."}]
    if stage == "pretrain":
        return conv
    return codec.mark_grounding_conversations(conv + [
        {"from": "human", "value": "When does the car stop?"},
        {"from": "gpt", "value": "From <30> to <41>."}])


@pytest.mark.parametrize("stage", ["pretrain", "sft"])
def test_training_strategy_runs_the_stage(tmp_path, stage):
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import STAGE_PRESETS as P
    from grounded_video_llm_tpu_torch.core.config import (NUM_SPECIAL_TOKENS,
                                                          replace)
    from grounded_video_llm_tpu_torch.core.config import \
        micro_vlm_config as tmicro
    from grounded_video_llm_tpu_torch.text.tokenizer import \
        build_test_tokenizer
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    cfg = tmicro("phi3.5")
    base = replace(cfg, llm=replace(cfg.llm, num_extra_tokens=0))
    orig = P[stage]
    P[stage] = dataclasses.replace(orig, global_batch_size=1,
                                   per_device_batch_size=1, epochs=1)
    try:
        ds = InMemoryGrounded(cfg, n=2, conv=_conversation(stage))
        s = TrainingStrategy(cfg, stage,
                             build_params(base, "cpu", torch.float32, 0),
                             build_test_tokenizer("phi3.5"),
                             run_dir=str(tmp_path), n_train_examples=len(ds))
        assert s.grad_accum == 1 and s.stage.max_txt_len == 2048
        layers = s.state.params["llm"]["layers"]
        rows = s.state.params["llm"]["embed"].shape[0]
        if stage == "pretrain":
            assert "lora" not in layers and rows == cfg.llm.vocab_size
        else:
            assert "lora" in layers
            assert rows == cfg.llm.vocab_size + NUM_SPECIAL_TOKENS
        seen = []
        s.run_training(ds, on_step=lambda step, m: seen.append(m))
        assert len(seen) == 2
        assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
                   for m in seen)
    finally:
        P[stage] = orig
