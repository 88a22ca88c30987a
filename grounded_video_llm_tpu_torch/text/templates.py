# The port's own copy of grounded_video_llm_tpu/text/templates.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Chat templates and special-token constants.

Behavioral parity with reference datasets/chat/base_template.py:13-139: per-LLM
prompt formats, separators, and the image-token / grounding-token interaction
(the image-token re-format is skipped when <timestamp_grounding> is present,
reference base_template.py:105-107).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
GROUNDING_TOKEN = "<timestamp_grounding>"


@dataclass(frozen=True)
class ChatTemplate:
    """A chat template: system preamble + per-round user/assistant formats.

    separator = (assistant_prefix, eos) is used by label masking to locate the
    instruction/response boundary within each round (reference
    llava_next_video.py:325-407).
    """

    name: str
    system: str
    user_fmt: str        # contains {content}
    assistant_fmt: str   # contains {content}; ends with eos
    image_token_fmt: str  # contains {content}
    separator: Tuple[str, str]  # (assistant_prefix, eos)

    @property
    def eos(self) -> str:
        return self.separator[1]

    def encode(self, messages: Sequence[Dict[str, str]]) -> str:
        """Render a conversation [{from: human|gpt, value: str}, ...] to a prompt.

        Mirrors Template.encode/_prompt (reference base_template.py:51-108):
        leading non-human message is dropped; the <image> placeholder is moved
        to the template position unless the grounding token is present.
        """
        questions: List[str] = []
        answers: List[str] = []
        first_is_not_question = 0
        for i, message in enumerate(messages):
            if i == 0 and message["from"] != "human":
                first_is_not_question = 1
                continue
            if i % 2 == first_is_not_question:
                questions.append(message["value"])
            else:
                answers.append(message["value"])
        assert len(questions) == len(answers), (len(questions), len(answers))

        msg = ""
        for i, (question, answer) in enumerate(zip(questions, answers)):
            if i == 0:
                msg += self.system
            if DEFAULT_IMAGE_TOKEN in question and GROUNDING_TOKEN not in question:
                question = question.replace(DEFAULT_IMAGE_TOKEN, "").strip()
                question = self.image_token_fmt.format(content=question).strip()
            msg += self.user_fmt.format(content=question)
            msg += self.assistant_fmt.format(content=answer)
        return msg

    def encode_for_generation(self, messages: Sequence[Dict[str, str]]) -> str:
        """Prompt for generation: encode with an empty answer, strip the eos
        (reference inference.py:112-113)."""
        return self.encode(messages).replace(self.eos, "")


PHI35_TEMPLATE = ChatTemplate(
    name="phi3.5",
    system="<|system|>\nYou are a helpful AI assistant that can generate responses based on visual inputs.",
    user_fmt="\n<|user|>\n{content}",
    assistant_fmt="\n<|assistant|>\n{content}<|endoftext|>",
    image_token_fmt=DEFAULT_IMAGE_TOKEN + "\n{content}",
    separator=("\n<|assistant|>\n", "<|endoftext|>"),
)

LLAMA3_TEMPLATE = ChatTemplate(
    name="llama3",
    system="<|start_header_id|>system<|end_header_id|>You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, and assist the user "
           "with a variety of tasks using natural language.",
    user_fmt="<|start_header_id|>user<|end_header_id|>{content}",
    assistant_fmt="<|start_header_id|>assistant<|end_header_id|>{content}<|eot_id|>",
    image_token_fmt=DEFAULT_IMAGE_TOKEN + "\n{content}",
    separator=("<|start_header_id|>assistant<|end_header_id|>", "<|eot_id|>"),
)

VICUNA_TEMPLATE = ChatTemplate(
    name="vicuna",
    system="You are a helpful language and vision assistant. You are able to understand the visual "
           "content that the user provides, and assist the user with a variety of tasks using natural language.",
    user_fmt="\nUSER: {content}",
    assistant_fmt="\nASSISTANT: {content}</s>",
    image_token_fmt=DEFAULT_IMAGE_TOKEN + "\n{content}",
    separator=("\nASSISTANT: ", "</s>"),
)

TEMPLATES = {
    "phi3.5": PHI35_TEMPLATE,
    "llama3": LLAMA3_TEMPLATE,
    "vicuna": VICUNA_TEMPLATE,
}


def get_template(llm_name: str) -> ChatTemplate:
    return TEMPLATES[llm_name]
