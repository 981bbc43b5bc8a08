from .bpe import Tokenizer

__all__ = ["Tokenizer"]
