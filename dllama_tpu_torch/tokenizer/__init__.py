from .bpe import StreamDecoder, Tokenizer
from .chat import (
    CHAT_TEMPLATE_NAMES,
    ChatItem,
    ChatTemplateGenerator,
    ChatTemplateType,
    EosDetector,
    EosResult,
)

__all__ = [
    "StreamDecoder",
    "Tokenizer",
    "CHAT_TEMPLATE_NAMES",
    "ChatItem",
    "ChatTemplateType",
    "ChatTemplateGenerator",
    "EosDetector",
    "EosResult",
]
