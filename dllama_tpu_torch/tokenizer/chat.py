"""Chat templating and streaming EOS detection.

Behavioral ports of the reference's ChatTemplateGenerator
(src/tokenizer.cpp:549-637) and EosDetector (src/tokenizer.cpp:639-724).
The port's own copy of dllama_tpu/tokenizer/chat.py; the code is unchanged.
"""

from __future__ import annotations

import dataclasses
import enum


class ChatTemplateType(enum.IntEnum):
    """(reference: src/tokenizer.hpp:102-108)"""

    UNKNOWN = 0
    LLAMA2 = 1
    LLAMA3 = 2
    DEEP_SEEK3 = 3
    CHATML = 4


# CLI names (reference: parseChatTemplateType, src/app.cpp); the argparse
# choices and every name->type lookup derive from this single map
CHAT_TEMPLATE_NAMES = {
    "llama2": ChatTemplateType.LLAMA2,
    "llama3": ChatTemplateType.LLAMA3,
    "deepSeek3": ChatTemplateType.DEEP_SEEK3,
    "chatml": ChatTemplateType.CHATML,
}


@dataclasses.dataclass
class ChatItem:
    role: str
    message: str


@dataclasses.dataclass
class GeneratedChat:
    content: str
    public_prompt: str | None


def detect_chat_template(chat_template: str) -> ChatTemplateType:
    """Template auto-detection from jinja source content
    (reference: src/tokenizer.cpp:552-565)."""
    if "[INST]" in chat_template:
        return ChatTemplateType.LLAMA2
    if "<|start_header_id|>" in chat_template:
        return ChatTemplateType.LLAMA3
    if "<｜Assistant｜>" in chat_template:
        return ChatTemplateType.DEEP_SEEK3
    if "<|im_start|>" in chat_template:
        return ChatTemplateType.CHATML
    raise ValueError("not supported chat template")


class ChatTemplateGenerator:
    """Renders role messages into a prompt string
    (reference: src/tokenizer.cpp:549-637)."""

    def __init__(
        self,
        type: ChatTemplateType,
        chat_template: str | None,
        eos: str,
    ):
        if type == ChatTemplateType.UNKNOWN:
            if chat_template is None:
                raise ValueError("the tokenizer does not include chat template")
            self.type = detect_chat_template(chat_template)
        else:
            self.type = type
        self.eos = eos

    def generate(
        self, items: list[ChatItem], append_generation_prompt: bool = True
    ) -> GeneratedChat:
        buf: list[str] = []
        public_prompt_size = 0
        eos = self.eos

        if self.type == ChatTemplateType.LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                buf.append(
                    "[INST] <<SYS>>\n"
                    + items[0].message
                    + "\n<</SYS>>\n\n"
                    + items[1].message
                    + " [/INST]"
                    + eos
                )
                i = 2
            for item in items[i:]:
                if item.role == "assistant":
                    buf.append(item.message + eos)
                elif item.role == "user":
                    buf.append("[INST] " + item.message + " [/INST]" + eos)
        elif self.type == ChatTemplateType.LLAMA3:
            for item in items:
                buf.append(
                    "<|start_header_id|>"
                    + item.role
                    + "<|end_header_id|>\n\n"
                    + item.message
                    + eos
                )
            if append_generation_prompt:
                buf.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == ChatTemplateType.DEEP_SEEK3:
            i = 0
            if items and items[0].role == "system":
                buf.append(items[0].message)
                i = 1
            for item in items[i:]:
                if item.role == "user":
                    buf.append("<｜User｜>" + item.message)
                elif item.role == "assistant":
                    buf.append("<｜Assistant｜>" + item.message)
            if append_generation_prompt:
                buf.append("<｜Assistant｜><think>\n")
                public_prompt_size = 8
        elif self.type == ChatTemplateType.CHATML:
            for item in items:
                if item.role == "system":
                    buf.append("<|im_start|>system\n" + item.message + "<|im_end|>\n")
                elif item.role == "user":
                    buf.append("<|im_start|>user\n" + item.message + "<|im_end|>\n")
                elif item.role == "assistant":
                    buf.append(
                        "<|im_start|>assistant\n" + item.message + "<|im_end|>\n"
                    )
                # Quirk kept from the reference (src/tokenizer.cpp:623-624):
                # the generation prompt is appended once per item, inside the
                # loop, not after it.
                if append_generation_prompt:
                    buf.append("<|im_start|>assistant\n")

        content = "".join(buf)
        public_prompt = (
            content[len(content) - public_prompt_size :]
            if public_prompt_size > 0
            else None
        )
        return GeneratedChat(content=content, public_prompt=public_prompt)


class EosResult(enum.IntEnum):
    """(reference: src/tokenizer.hpp:130-134)"""

    MAYBE_EOS = 0
    EOS = 1
    NOT_EOS = 2


class EosDetector:
    """Streaming multi-token stop-string matcher with padding windows
    (reference: src/tokenizer.cpp:639-724).

    ``padding_left`` allows junk before a stop string (e.g. a leading space),
    ``padding_right`` allows trailing bytes after it within the window.
    """

    def __init__(
        self,
        tokens: list[int],
        pieces: list[str],
        padding_left: int = 0,
        padding_right: int = 0,
    ):
        # Unlike the reference (which always passes parallel arrays), the
        # token-id set and the stop-string set are independent here: the API
        # server combines the tokenizer's EOS ids with client-supplied stop
        # strings of any count.
        self.tokens = list(tokens)
        self.pieces = list(pieces)
        self.piece_sizes = [len(p) for p in pieces]
        self.padding_left = padding_left
        self.padding_right = padding_right
        self.buffer = ""
        self.eos_pos = -1

    def is_eos(self, token_id: int) -> bool:
        return token_id in self.tokens

    def append(self, token_id: int, piece: str | None) -> EosResult:
        if piece is not None:
            self.buffer += piece

        if self.is_eos(token_id):
            self.eos_pos = len(self.buffer)
            return EosResult.EOS
        self.eos_pos = -1

        buf_len = len(self.buffer)
        for s, piece_size in zip(self.pieces, self.piece_sizes):
            if buf_len > piece_size + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = buf_len - lo
                if n == 0 or n > piece_size + self.padding_right:
                    continue
                n = min(n, piece_size)
                if self.buffer[lo : lo + n] == s[:n]:
                    if n == piece_size:
                        self.eos_pos = lo
                        self.buffer = self.buffer[:lo]
                        return EosResult.EOS
                    return EosResult.MAYBE_EOS
        return EosResult.NOT_EOS

    def get_delta(self) -> str | None:
        """Printable text accumulated since the last reset, with any matched
        stop string stripped (reference: src/tokenizer.cpp:715-720)."""
        if not self.buffer:
            return None
        if self.eos_pos == 0:
            return None
        return self.buffer

    def reset(self) -> None:
        self.buffer = ""
        self.eos_pos = -1
