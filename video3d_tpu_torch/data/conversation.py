"""Conversation templates.

The reference carries a template zoo inherited from LLaVA-NeXT
(the reference llava/conversation.py:11-585); the Video-3D-LLM recipe uses
exactly one — ``qwen_1_5`` ChatML (conversation.py:443-452): system "You are
a helpful assistant.", ``<|im_start|>role\\ncontent<|im_end|>\\n`` turns.

The rest of the zoo exists so the other LLM families can be trained with
their native prompts (train_3d.py preprocess dispatch :945-966): vicuna v1
(SeparatorStyle.TWO, :345-354), llama-2 ``[INST]`` (:356-378), mpt ChatML-
without-trailing-newline (:432-441), gemma ``<start_of_turn>`` (:454), and
the bare PLAIN pretraining template (:456-463). ``get_prompt`` reproduces
each style's exact string (conversation.py:47-178, minus the gradio
tuple-message handling which is serve-only).

The port's own copy of ``video3d_tpu/data/conversation.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    CHATML = enum.auto()
    LLAMA_2 = enum.auto()
    GEMMA = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[Tuple[str, Optional[str]]]
    sep_style: SeparatorStyle = SeparatorStyle.CHATML
    sep: str = "<|im_end|>"
    sep2: Optional[str] = None
    version: str = "qwen_1_5"

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.CHATML:
            out = "" if self.system == "" else self.system + self.sep + "\n"
            for role, message in self.messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out += role + "\n" + message + self.sep + "\n"
                else:
                    out += role + "\n"
            return out
        if self.sep_style == SeparatorStyle.SINGLE:
            # conversation.py:64-72
            out = self.system + self.sep
            for role, message in self.messages:
                if message:
                    out += role + ": " + message + self.sep
                else:
                    out += role + ":"
            return out
        if self.sep_style == SeparatorStyle.TWO:
            # conversation.py:74-83
            seps = [self.sep, self.sep2]
            out = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    out += role + ": " + message + seps[i % 2]
                else:
                    out += role + ":"
            return out
        if self.sep_style == SeparatorStyle.MPT:
            # conversation.py:121-129
            out = self.system + self.sep
            for role, message in self.messages:
                if message:
                    out += role + message + self.sep
                else:
                    out += role
            return out
        if self.sep_style == SeparatorStyle.GEMMA:
            # conversation.py:131-141
            out = ""
            for i, (role, message) in enumerate(self.messages):
                assert role == self.roles[i % 2], \
                    "Conversation should alternate user/assistant/..."
                if message:
                    out += role + message + self.sep
                else:
                    out += role
            return out
        if self.sep_style == SeparatorStyle.LLAMA_2:
            # conversation.py:143-163
            wrap_sys = (lambda msg:
                        f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg)
            wrap_inst = lambda msg: f"[INST] {msg} [/INST]"
            out = ""
            for i, (role, message) in enumerate(self.messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], \
                        "first message should come from user"
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        out += self.sep + wrap_inst(message)
                    else:
                        out += " " + message + " " + self.sep2
            return out.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.PLAIN:
            # conversation.py:165-174
            seps = [self.sep, self.sep2 or ""]
            out = self.system
            for i, (_, message) in enumerate(self.messages):
                if message:
                    out += message + seps[i % 2]
            return out
        raise ValueError(self.sep_style)

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            messages=list(self.messages),
                            sep_style=self.sep_style, sep=self.sep,
                            sep2=self.sep2, version=self.version)


conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="qwen_1_5",
)

# conversation.py:345-354 ("v1"; conv_llava_v1 :486-495 differs only in the
# system string's "human" wording)
conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_v1 = dataclasses.replace(
    conv_vicuna_v1,
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    messages=[])

# conversation.py:369-378
conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user "
           "provides, and assist the user with a variety of tasks using "
           "natural language.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

# conversation.py:432-441
conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an "
           "LLM-based AI assistant. The assistant gives helpful and honest "
           "answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    version="mpt",
)

# conversation.py:454
conv_gemma_instruct = Conversation(
    system="",
    roles=("<start_of_turn>user\n", "<start_of_turn>model\n"),
    messages=[],
    sep_style=SeparatorStyle.GEMMA,
    sep="<end_of_turn>\n",
    version="gemma",
)

# conversation.py:313-343 (messages' few-shot examples omitted: the
# preprocess fallback uses only system + roles)
conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

# conversation.py:456-463
conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    version="plain",
)

conv_templates: Dict[str, Conversation] = {
    "qwen_1_5": conv_qwen,
    "qwen_2": conv_qwen,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_v1": conv_llava_v1,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
    "gemma_instruct": conv_gemma_instruct,
    "plain": conv_llava_plain,
    "llava_plain": conv_llava_plain,
}

default_conversation = conv_qwen
