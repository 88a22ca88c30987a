"""The port's own copies of the JAX package's framework-free modules (core
config, text codec, templates and tokenizer, frame sampling, the PIL-exact
resize) against their originals: same inputs, equal outputs."""

import dataclasses

import numpy as np
import pytest

from grounded_video_llm_tpu.core import config as jcfg
from grounded_video_llm_tpu.ops import pil_resize as jresize
from grounded_video_llm_tpu.text import codec as jcodec
from grounded_video_llm_tpu.text import templates as jtpl
from grounded_video_llm_tpu.text import tokenizer as jtok
from grounded_video_llm_tpu.video import sampling as jsamp
from grounded_video_llm_tpu_torch.core import config as tcfg
from grounded_video_llm_tpu_torch.ops import pil_resize as tresize
from grounded_video_llm_tpu_torch.text import codec as tcodec
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
