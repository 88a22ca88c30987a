# The port's own copy of grounded_video_llm_tpu/text/prompt_pools.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Prompt template pools for the offline annotation / instruction pipeline.

Functional counterpart of the pools in reference mm_utils/utils.py:11-137: one
pool per task family, sampled uniformly when building training conversations.
Placeholder conventions match the reference exactly — '%s' for the grounding
query (vtg), '<start>'/'<end>' for referring intervals (vtu) — so annotation
tooling written against either codebase interoperates. Phrasings are this
framework's own.
"""

from __future__ import annotations

import random
from typing import List, Optional

DENSE_CAPTION_DETAIL_PROMPTS: List[str] = [
    "List every event in the video in detail together with its start and end timestamps.",
    "Go through the video and describe each activity thoroughly, giving the time interval of each one.",
    "Identify all events in the video; for every event output a detailed description plus its start and end times in seconds.",
    "Provide a complete, detailed rundown of the activities in this video with their temporal boundaries.",
    "Enumerate the events shown in the video in depth, attaching the start and end timestamps of each.",
    "Analyze the video carefully and report every event in detail along with when it begins and ends.",
    "What events take place in this video? Describe each in detail and include its time span.",
    "Walk through the video and detail each occurrence with its corresponding timestamps.",
]

DENSE_CAPTION_SHORT_PROMPTS: List[str] = [
    "Localize the activity events in the video, output each event's start and end timestamp, and describe it briefly.",
    "Report the start and end times of the activities in the video with a short description of each.",
    "Give the time intervals of the events in this video and summarize each one.",
    "List the activities featured in the video together with their timestamps.",
    "Catalog every event in the video along with when it starts and ends.",
]

DENSE_CAPTION_SINGLE_TIMESTAMP_PROMPTS: List[str] = [
    "Localize the activity events in the video, output one single timestamp for each event, and describe it.",
    "Report the point of time of each activity in the video with a description.",
    "Give one timestamp per event in this video and summarize what happens.",
    "List the activities in the video, each with a single representative timestamp.",
    "Catalog every event in the video along with its point of time.",
]

STEP_LOCALIZATION_PROMPTS: List[str] = [
    "Localize the sequence of action steps in the video, giving one timestamp and a brief description per step.",
    "Identify the steps performed in the video and report the point of time of each with a short description.",
    "Mark the video segments corresponding to each step, specifying its time and what happens.",
    "Determine when each distinct step occurs in the video; output a timestamp and concise description per step.",
    "List the procedure's steps shown in the video with one timestamp and a description each.",
]

SHORT_CAPTION_PROMPTS: List[str] = [
    "Describe this video concisely.",
    "Give a brief description of the video clip.",
    "Summarize the visual content of the video in a sentence or two.",
    "Provide a short, clear account of what the video shows.",
    "Write a compact caption for this video.",
    "Offer a succinct summary of the footage.",
    "Briefly explain what happens in the clip.",
    "Present a terse but informative description of the video.",
]

DETAIL_CAPTION_PROMPTS: List[str] = [
    "Describe this video in detail.",
    "What does this video depict? Answer thoroughly.",
    "Provide a detailed account of the events taking place in the video.",
    "Give a comprehensive description of everything shown in the clip.",
    "Offer an in-depth analysis of this video's content.",
    "Generate a detailed caption covering the whole video.",
]

#: temporal grounding — '%s' is the query text (reference vtg_prompts)
VTG_PROMPTS: List[str] = [
    "When does '%s' happen in the video?",
    "At what time does '%s' occur in the video?",
    "During which part of the video does '%s' take place?",
    "In which time interval of the video can '%s' be seen?",
    "When in the video does the event '%s' occur?",
    "Locate the moment when '%s' happens in the video.",
    "At which moment of the video does '%s' take place?",
    "Find the start and end times of '%s' in the video.",
]

#: referring understanding — '<start>'/'<end>' placeholders (reference vtu_prompts)
VTU_PROMPTS: List[str] = [
    "What is happening from <start> to <end>?",
    "What takes place between <start> and <end>?",
    "Describe the events occurring between <start> and <end>.",
    "What happens in the video during the period from <start> to <end>?",
    "Summarize what goes on from <start> to <end>.",
    "Provide an overview of the interval from <start> to <end>.",
    "Narrate the actions between <start> and <end>.",
]

GROUNDED_QA_PROMPTS: List[str] = [
    "Answer the question and provide the relevant time interval: %s",
    "%s Also return the start and end timestamps of the moment that supports your answer.",
    "%s Ground your answer with the corresponding video segment's timestamps.",
]

POOLS = {
    "dense_caption_detail": DENSE_CAPTION_DETAIL_PROMPTS,
    "dense_caption_short": DENSE_CAPTION_SHORT_PROMPTS,
    "dense_caption_single": DENSE_CAPTION_SINGLE_TIMESTAMP_PROMPTS,
    "step_localization": STEP_LOCALIZATION_PROMPTS,
    "short_caption": SHORT_CAPTION_PROMPTS,
    "detail_caption": DETAIL_CAPTION_PROMPTS,
    "vtg": VTG_PROMPTS,
    "vtu": VTU_PROMPTS,
    "grounded_qa": GROUNDED_QA_PROMPTS,
}


def sample_prompt(pool: str, rng: Optional[random.Random] = None) -> str:
    r = rng or random
    return r.choice(POOLS[pool])
