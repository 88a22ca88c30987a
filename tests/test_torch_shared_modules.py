"""The port's own copies of the JAX package's framework-free modules (core
config, text codec, templates and tokenizer, frame sampling, the PIL-exact
resize, the data loader, the logger and metric trackers, the dataset mixes
with their host preprocessing, the Porter stemmer, the prompt pools, the IO
helpers) against their originals: same inputs, equal outputs."""

import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from grounded_video_llm_tpu.core import config as jcfg
from grounded_video_llm_tpu.ops import pil_resize as jresize
from grounded_video_llm_tpu.text import codec as jcodec
from grounded_video_llm_tpu.text import porter as jporter
from grounded_video_llm_tpu.text import prompt_pools as jpools
from grounded_video_llm_tpu.text import templates as jtpl
from grounded_video_llm_tpu.text import tokenizer as jtok
from grounded_video_llm_tpu.video import sampling as jsamp
from grounded_video_llm_tpu_torch.core import config as tcfg
from grounded_video_llm_tpu_torch.ops import pil_resize as tresize
from grounded_video_llm_tpu_torch.text import codec as tcodec
from grounded_video_llm_tpu_torch.text import porter as tporter
from grounded_video_llm_tpu_torch.text import prompt_pools as tpools
from grounded_video_llm_tpu_torch.text import templates as ttpl
from grounded_video_llm_tpu_torch.text import tokenizer as ttok
from grounded_video_llm_tpu_torch.video import sampling as tsamp

TEXTS = [
    "The event happens from <12> to <87>.",
    "From <0> to <300> and again <5>-<9>, then nothing.",
    "No timestamps here at all.",
    "It occurs between 30 seconds and 45 seconds.",
]


@pytest.mark.parametrize("name", ["phi3.5", "llama3", "vicuna"])
def test_config_copy(name):
    for stage in ("inference", "grounded"):
        assert (dataclasses.asdict(tcfg.vlm_config(name, stage=stage))
                == dataclasses.asdict(jcfg.vlm_config(name, stage=stage)))
    assert (dataclasses.asdict(tcfg.micro_vlm_config(name))
            == dataclasses.asdict(jcfg.micro_vlm_config(name)))
    assert (dataclasses.asdict(tcfg.GenerateConfig())
            == dataclasses.asdict(jcfg.GenerateConfig()))


@pytest.mark.parametrize("text", TEXTS)
def test_codec_parse_copy(text):
    for duration in (12.5, 96.0):
        assert (tcodec.parse_time_interval(text, duration, 300, "phi3.5")
                == jcodec.parse_time_interval(text, duration, 300, "phi3.5"))
        assert (tcodec.extract_intervals(text, duration, 300)
                == jcodec.extract_intervals(text, duration, 300))
        assert tcodec.has_timestamp(text) == jcodec.has_timestamp(text)


@pytest.mark.parametrize("query", [
    "What is happening from 70 seconds to 80 seconds?",
    "Describe 3 seconds to 9 seconds.", "No time at all"])
def test_codec_encode_copy(query):
    for duration in (12.5, 96.0, 431.0):
        assert (tcodec.encode_referring_query(query, duration, 300)
                == jcodec.encode_referring_query(query, duration, 300))
        assert (tcodec.quantize_time(duration / 3, duration, 300)
                == jcodec.quantize_time(duration / 3, duration, 300))


@pytest.mark.parametrize("name", ["phi3.5", "llama3", "vicuna"])
def test_template_encode_for_generation_copy(name):
    conv = [{"from": "human", "value": "<image>\nWhen does it happen?"},
            {"from": "gpt", "value": ""}]
    assert (ttpl.get_template(name).encode_for_generation(conv)
            == jtpl.get_template(name).encode_for_generation(conv))
    assert (ttpl.IMAGE_TOKEN_INDEX, ttpl.IGNORE_INDEX, ttpl.GROUNDING_TOKEN) \
        == (jtpl.IMAGE_TOKEN_INDEX, jtpl.IGNORE_INDEX, jtpl.GROUNDING_TOKEN)


@pytest.mark.parametrize("name", ["phi3.5", "llama3"])
def test_tokenize_and_pad_copy(name):
    tt, jt = ttok.build_test_tokenizer(name), jtok.build_test_tokenizer(name)
    prompts = ["<image>\nwhen does it happen? <12>",
               "a longer question <image> about <timestamp_grounding> it",
               "two <image> images <image> here"]
    t_seqs = [ttok.tokenize_with_image(p, tt) for p in prompts]
    j_seqs = [jtok.tokenize_with_image(p, jt) for p in prompts]
    assert t_seqs == j_seqs
    for max_len in (64, 8):
        for a, b in zip(ttok.pad_batch_generate(t_seqs, tt.pad_token_id,
                                                max_len),
                        jtok.pad_batch_generate(j_seqs, jt.pad_token_id,
                                                max_len)):
            np.testing.assert_array_equal(a, b)
    assert tt.decode(t_seqs[0]) == jt.decode(j_seqs[0])


@pytest.mark.parametrize("sample", ["middle", "fps1", "fps0.5"])
def test_sampling_indices_copy(sample):
    for vlen in (7, 96, 1000):
        assert (tsamp.get_frame_indices(96, vlen, sample, input_fps=30.0)
                == jsamp.get_frame_indices(96, vlen, sample, input_fps=30.0))
    assert tsamp.spatial_indices(96, 12) == jsamp.spatial_indices(96, 12)


@pytest.mark.parametrize("hw,out", [((60, 80), (224, 298)),
                                    ((240, 320), (336, 448)),
                                    ((400, 300), (112, 84))])
def test_pil_resize_numpy_copy(hw, out):
    frames = np.random.default_rng(sum(hw)).integers(
        0, 256, (2, *hw, 3), dtype=np.uint8)
    a = np.stack([tresize._resize_np(f, *out) for f in frames])
    b = np.stack([jresize._resize_np(f, *out) for f in frames])
    np.testing.assert_array_equal(a, b)
    assert (tresize.resized_shape_torchvision(*hw, 224)
            == jresize.resized_shape_torchvision(*hw, 224))


def test_loader_copy():
    """ShardedSampler and DataLoader: the same plans, the same batches in
    the same order, the same mid-epoch resume."""
    from grounded_video_llm_tpu.data import loader as jload
    from grounded_video_llm_tpu_torch.data import loader as tload

    for kw in (dict(shuffle=True, seed=7, num_shards=2, shard_id=1),
               dict(shuffle=False, seed=0)):
        for epoch in (0, 3):
            np.testing.assert_array_equal(
                tload.ShardedSampler(50, 4, **kw).epoch_indices(epoch),
                jload.ShardedSampler(50, 4, **kw).epoch_indices(epoch))
    data = list(range(23))
    runs = []
    for mod in (tload, jload):
        ld = mod.DataLoader(data, collate_fn=lambda xs: tuple(xs),
                            batch_size=3, seed=5)
        it = ld.epoch_iterator()
        first = [next(it), next(it)]
        state = ld.state_dict()
        resumed = mod.DataLoader(data, collate_fn=lambda xs: tuple(xs),
                                 batch_size=3, seed=5)
        resumed.load_state_dict(state)
        runs.append((first, state, list(resumed.epoch_iterator()),
                     ld.batches_per_epoch()))
    assert runs[0] == runs[1]


def test_logger_copy(capsys):
    from grounded_video_llm_tpu.obs import logger as jlog
    from grounded_video_llm_tpu_torch.obs import logger as tlog

    assert (tlog.LOG_FORMAT, tlog.DATE_FORMAT, tlog._CTX_PREFIXES) == \
        (jlog.LOG_FORMAT, jlog.DATE_FORMAT, jlog._CTX_PREFIXES)
    outs = []
    for mod, name in ((tlog, "port_copy_test"), (jlog, "jax_copy_test")):
        ow = mod.initialize_overwatch(name, rank=0, world_size=1)
        assert ow.is_rank_zero() and ow.world_size() == 1
        ow.info("hello", ctx_level=2)
        outs.append(capsys.readouterr().out.split(" :: ")[-1])
        assert mod.Overwatch(name + "_r1", 1, 2).logger.logger.level == 40
    assert outs[0] == outs[1] == "   ->> hello\n"
    assert tlog.initialize_overwatch("port_default").rank() == 0


def test_trackers_copy(tmp_path):
    from grounded_video_llm_tpu.obs import trackers as jtr
    from grounded_video_llm_tpu_torch.obs import trackers as ttr

    logs = []
    for mod in (ttr, jtr):
        d = tmp_path / mod.__name__.split(".")[0]
        m = mod.Metrics("run", str(d), {"stage": "grounded"}, window=2)
        status = []
        for loss in (3.0, 2.0, 1.0):
            m.commit(loss)
            status.append(m.push(lr=1e-4, extra={"grad_norm": loss / 2})
                          .split(" | ")[:3])
        rows = [json.loads(r) for r in (d / "run.jsonl").read_text()
                .splitlines()]
        for r in rows[1:]:
            r.pop("step_time_s")
        logs.append((status, rows, m.global_step))
    assert logs[0] == logs[1]


def test_datasets_and_host_preprocess_copy(tmp_path):
    """MixGrounded / MixPretrain over a small written video: the same
    rendered prompts (grounding mark, quantized timestamps) and the same
    fp32 pixels from both packages' host preprocessing."""
    cv2 = pytest.importorskip("cv2")
    from grounded_video_llm_tpu.data import datasets as jds
    from grounded_video_llm_tpu_torch.data import datasets as tds

    path = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (80, 60))
    rng = np.random.default_rng(0)
    for _ in range(40):
        w.write(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
    w.release()
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps([{
        "question_id": "q0", "video_id": "v0", "video_file": path.name,
        "conversation": [
            {"from": "human", "value": "<image>\nWhen does it happen?"},
            {"from": "gpt", "value": "From <1.0> to <2.5>."}]}]))
    for name in ("MixGrounded", "MixPretrain"):
        items = [getattr(mod, name)(anno_path=str(anno),
                                    video_path=str(tmp_path), num_frames=8,
                                    num_segs=2, sample="middle")[0]
                 for mod in (tds, jds)]
        assert items[0]["text_inputs"] == items[1]["text_inputs"]
        assert items[0]["durations"] == items[1]["durations"]
        for key in ("temporal_pixel_values", "spatial_pixel_values"):
            assert items[0][key].dtype == np.float32
            np.testing.assert_array_equal(items[0][key], items[1][key])


# the words of the Porter paper's examples, of dense-caption text, and of
# every prompt pool
PORTER_WORDS = {
    "paper": ("caresses ponies ties caress cats feed agreed plastered bled "
              "motoring sing conflated troubled sized hopping tanned falling "
              "hissing fizzed failing filing happy sky relational "
              "conditional rational valenci hesitanci digitizer "
              "conformabli radicalli differentli vileli analogousli "
              "vietnamization predication operator feudalism decisiveness "
              "hopefulness callousness formaliti sensitiviti sensibiliti "
              "triplicate formative formalize electriciti electrical "
              "hopeful goodness revival allowance inference airliner "
              "gyroscopic adjustable defensible irritant replacement "
              "adjustment dependent adoption homologou communism activate "
              "angulariti homologous effective bowdlerize probate rate "
              "cease controll roll generalizations oscillators").split(),
    "captions": ("A man is running quickly across the crowded fields while "
                 "the children were playing happily; she opened the doors, "
                 "closing them again, and sat down to eat her dinner. "
                 "People dancing, singing, jumped, cycling, cooked "
                 "meals").split(),
    "pools": sorted({w for pool in jpools.POOLS.values() for p in pool
                     for w in p.split()}),
}


@pytest.mark.parametrize("words", sorted(PORTER_WORDS))
def test_porter_copy(words):
    for w in PORTER_WORDS[words]:
        w = w.lower().strip(".,;")
        assert tporter.porter_stem(w) == jporter.porter_stem(w), w


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.text(alphabet="abcdefghijklmnopqrstuvwxyz", max_size=14))
def test_porter_copy_free_words(word):
    assert tporter.porter_stem(word) == jporter.porter_stem(word)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prompt_pools_copy(seed):
    import random

    assert tpools.POOLS == jpools.POOLS
    for pool in sorted(jpools.POOLS):
        assert (tpools.sample_prompt(pool, random.Random(seed))
                == jpools.sample_prompt(pool, random.Random(seed)))


@pytest.mark.parametrize("kind", ["json", "jsonl", "pkl", "csv"])
def test_io_copy(kind, tmp_path):
    """What one package's helpers write, both read alike."""
    from grounded_video_llm_tpu.utils import io as jio
    from grounded_video_llm_tpu_torch.utils import io as tio

    rows = [{"video": "a.mp4", "start": "1.5"}, {"video": "b.mp4",
                                                 "start": "2"}]
    for writer in (tio, jio):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.{kind}")
        if kind == "json":
            writer.save_json(rows, path)
        elif kind == "jsonl":
            writer.save_jsonl(rows, path)
        elif kind == "pkl":
            import pickle
            with open(path, "wb") as f:
                pickle.dump(rows, f)
        else:
            with open(path, "w") as f:
                f.write("video,start\na.mp4,1.5\nb.mp4,2\n")
        for reader in (tio, jio):
            got = getattr(reader, f"load_{kind}")(path)
            assert got == rows


@pytest.fixture(scope="module")
def micro_trees():
    """A micro JAX tree (its init compiled) and the port's bridge of it."""
    import jax

    from grounded_video_llm_tpu.models import vlm as jvlm
    from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax

    cfg = jcfg.micro_vlm_config("phi3.5")
    jp = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.key(0), cfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               "cpu")


@pytest.mark.parametrize("quantize", [None, "int8", "int8_full"])
def test_get_parameter_number_copy(quantize, micro_trees):
    """The port's tree (bridged from the JAX one, then quantized the same
    way) counts what the JAX tree counts, total and trainable."""
    from grounded_video_llm_tpu.serve import quantize as jq
    from grounded_video_llm_tpu.train import optimizer as jopt
    from grounded_video_llm_tpu.utils import io as jio
    from grounded_video_llm_tpu_torch.serve import quantize as tq
    from grounded_video_llm_tpu_torch.train import optimizer as topt
    from grounded_video_llm_tpu_torch.utils import io as tio

    jp, tp = micro_trees
    if quantize:
        w8a8 = quantize == "int8_full"
        jp = dict(jp, llm=jq.quantize_llm_for_serving(jp["llm"], w8a8=w8a8))
        tp = dict(tp, llm=tq.quantize_llm_for_serving(tp["llm"], w8a8=w8a8))
    want = jio.get_parameter_number(
        jp, jopt.trainable_mask(jopt.label_params(jp)))
    assert tio.get_parameter_number(
        tp, topt.trainable_mask(topt.label_params(tp))) == want
    assert tio.get_parameter_number(tp) == jio.get_parameter_number(jp)
    assert want["Trainable"] < want["Total"]
