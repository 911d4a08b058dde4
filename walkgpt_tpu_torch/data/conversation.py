"""Conversation prompt templating.

Byte-compatible with the reference's template grammar
(the reference's model/llava_walkgpt/conversation.py:30-135 get_prompt and the
template registry :413-428). Prompt strings are *data* that the trained
tokenizer/weights expect, so the system prompts — including the rewritten
WalkGPT accessibility-analyst system prompt of `llava_v1`
(conversation.py:367-384) — are preserved verbatim.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_TOKEN_INDEX = -200
IGNORE_INDEX = -100


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style,
            sep=self.sep, sep2=self.sep2, version=self.version)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        messages = self.messages
        # Gradio-style tuple first message (text, image, process_mode): the
        # mmtag versions wrap the image in <Image></Image> with an ack turn,
        # others prepend "<image>\n" (reference conversation.py:31-45).
        if messages and isinstance(messages[0][1], tuple):
            messages = list(messages)
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace(DEFAULT_IMAGE_TOKEN, "").strip()
            if "mmtag" in self.version:
                messages[0] = (init_role, init_msg)
                messages.insert(0, (self.roles[0], "<Image><image></Image>"))
                messages.insert(1, (self.roles[1], "Received."))
            else:
                messages[0] = (init_role, DEFAULT_IMAGE_TOKEN + "\n" + init_msg)
        messages = [(r, m[0] if isinstance(m, tuple) else m)
                    for r, m in messages]
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (_, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg): return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"
            def wrap_inst(msg): return f"[INST] {msg} [/INST]"
            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        raise ValueError(f"Invalid style: {self.sep_style}")


def _conv(**kw) -> Conversation:
    kw.setdefault("messages", [])
    kw["messages"] = [list(m) for m in kw["messages"]]
    return Conversation(**kw)


conv_vicuna_v0 = _conv(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = _conv(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = _conv(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = _conv(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = _conv(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = _conv(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[["Human", "Hi!"], ["Assistant", "Hi there! How can I help you today?"]],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

# The WalkGPT accessibility-analyst prompt; byte-exact with the reference
# (conversation.py:367-384) because the trained weights condition on it.
conv_llava_v1 = _conv(
    system=(
        "You are WalkGPT, an accessibility analyst. For every question respond in this format:\n"
        "1. Begin with an [assessment] ... [/assessment] summary of pedestrian accessibility.\n"
        "2. List accessible features under “Accessible features:” and, for each, wrap the label in [p] … [/p] "
        "and then append the single segmentation token used in training.\n"
        "3. List non‑accessible features the same way under “Non‑accessible features:”.\n"
        "4. Finish with one [distance] ... [/distance] block describing distances to the features.\n"
        "Keep the response concise and follow that structure exactly."
    ),
    roles=("USER", "ASSISTANT"),
    version="walkgpt_v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_chatml = _conv(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant name StableCapybara. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.TWO,
    sep="###",
    sep2="###",
    messages=[],
    offset=0,
)

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
    "chatml": conv_chatml,
}

# Mutable module-level default, mirroring the reference's
# `conversation_lib.default_conversation` override (train_walkgpt.py:259).
default_conversation = conv_vicuna_v0


def set_default_conversation(conv_type: str) -> None:
    global default_conversation
    default_conversation = conv_templates[conv_type]


def get_default_conversation() -> Conversation:
    return default_conversation
