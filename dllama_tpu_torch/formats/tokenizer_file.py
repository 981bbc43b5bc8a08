"""Reader/writer for distributed-llama's `.t` tokenizer file format.

Format (reference: src/tokenizer.cpp:42-164, converter/tokenizer-writer.py):

    int32 magic = 0x567124
    int32 headerSize                       # bytes, counting magic+headerSize
    int32 key, int32 value                 # repeated (TokenizerHeaderKey)
    bytes chatTemplate[CHAT_TEMPLATE]      # if key present (value = length)
    int32 eosTokenId * N_EOS_TOKENS
    per token: float32 score, int32 length, bytes token[length]

Notes mirrored from the reference:
  * ``CHAT_STOP`` payloads are skipped (src/tokenizer.cpp:87);
  * ``EOS_ID`` / ``CHAT_EOS_ID`` keys append to the EOS set (back-compat);
  * the vocab splits into regular tokens [0, bos_id) and special tokens
    [bos_id, vocab_size) — the same "unstable assumption" the reference
    makes (src/tokenizer.cpp:138-140).
"""

from __future__ import annotations

import dataclasses
import enum
import struct

TOKENIZER_MAGIC = 0x567124
TOKENIZER_OLD_MAGIC = 0x567123


class TokHeaderKey(enum.IntEnum):
    """`.t` header keys (reference: src/tokenizer.hpp:21-33)."""

    VERSION = 0
    VOCAB_SIZE = 1
    MAX_TOKEN_LENGTH = 2
    BOS_ID = 3
    EOS_ID = 4  # backward compatibility
    PAD_ID = 5  # ignored
    CHAT_EOS_ID = 6  # backward compatibility
    CHAT_TEMPLATE = 7
    CHAT_STOP = 8  # ignored (payload skipped)
    N_EOS_TOKENS = 9
    ADD_BOS = 10


@dataclasses.dataclass
class TokenizerData:
    """Raw contents of a `.t` file."""

    vocab: list[bytes]
    scores: list[float]
    bos_id: int
    add_bos: bool
    eos_token_ids: list[int]
    chat_template: str | None
    max_token_length: int

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def _read_vocab(f, vocab_size: int) -> tuple[list[bytes], list[float]]:
    """Per-token (score, length, bytes) section shared by both header formats
    (reference: src/tokenizer.cpp:125-136)."""
    vocab: list[bytes] = []
    scores: list[float] = []
    for _ in range(vocab_size):
        score, length = struct.unpack("<fi", f.read(8))
        if length < 1:
            raise ValueError(f"invalid token length: {length}")
        vocab.append(f.read(length))
        scores.append(score)
    return vocab, scores


def read_tokenizer(path: str) -> TokenizerData:
    """Parse a `.t` file (reference: src/tokenizer.cpp:42-164)."""
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
        if magic == TOKENIZER_OLD_MAGIC:
            return _read_old_tokenizer(f)
        if magic != TOKENIZER_MAGIC:
            raise ValueError(f"invalid tokenizer magic: {magic:#x}")

        (header_size,) = struct.unpack("<i", f.read(4))
        n_kv_ints = (header_size - 8) // 4
        kv = struct.unpack(f"<{n_kv_ints}i", f.read(n_kv_ints * 4))

        version = -1
        vocab_size = 0
        max_token_length = 0
        bos_id = -1
        add_bos = False
        chat_template_length = -1
        n_eos_tokens = 0
        eos_token_ids: list[int] = []
        skip_bytes = 0
        for key, value in zip(kv[0::2], kv[1::2]):
            key = TokHeaderKey(key)
            if key == TokHeaderKey.VERSION:
                version = value
            elif key == TokHeaderKey.VOCAB_SIZE:
                vocab_size = value
            elif key == TokHeaderKey.MAX_TOKEN_LENGTH:
                max_token_length = value
            elif key == TokHeaderKey.BOS_ID:
                bos_id = value
            elif key in (TokHeaderKey.EOS_ID, TokHeaderKey.CHAT_EOS_ID):
                eos_token_ids.append(value)
            elif key == TokHeaderKey.CHAT_TEMPLATE:
                chat_template_length = value
            elif key == TokHeaderKey.CHAT_STOP:
                skip_bytes += value
            elif key == TokHeaderKey.PAD_ID:
                pass
            elif key == TokHeaderKey.N_EOS_TOKENS:
                n_eos_tokens = value
            elif key == TokHeaderKey.ADD_BOS:
                add_bos = value == 1

        if version != 1:
            raise ValueError("old tokenizer version, please regenerate your tokenizer")
        if skip_bytes:
            f.seek(skip_bytes, 1)

        chat_template: str | None = None
        if chat_template_length > 0:
            chat_template = f.read(chat_template_length).decode("utf-8")
        for _ in range(n_eos_tokens):
            (eos_id,) = struct.unpack("<i", f.read(4))
            eos_token_ids.append(eos_id)

        if max_token_length < 1:
            raise ValueError("invalid tokenizer max token length")

        vocab, scores = _read_vocab(f, vocab_size)

    return TokenizerData(
        vocab=vocab,
        scores=scores,
        bos_id=bos_id,
        add_bos=add_bos,
        eos_token_ids=eos_token_ids,
        chat_template=chat_template,
        max_token_length=max_token_length,
    )


def _read_old_tokenizer(f) -> TokenizerData:
    """Read the legacy fixed-header format (magic 0x567123): the 5-field
    TokenizerOldHeader then the vocab section (reference:
    src/tokenizer.hpp:13-19, src/tokenizer.cpp:57-64)."""
    vocab_size, max_token_length, bos_id, eos_id, _pad_id = struct.unpack(
        "<IIiii", f.read(20)
    )
    if max_token_length < 1:
        raise ValueError("invalid tokenizer max token length")
    vocab, scores = _read_vocab(f, vocab_size)
    return TokenizerData(
        vocab=vocab,
        scores=scores,
        bos_id=bos_id,
        # The old header carries no add_bos flag (the reference leaves the
        # field unset on this path); legacy sentencepiece tokenizers prepend
        # BOS, so default True.
        add_bos=True,
        eos_token_ids=[eos_id],
        chat_template=None,
        max_token_length=max_token_length,
    )


def write_tokenizer(path: str, data: TokenizerData) -> None:
    """Write a `.t` file byte-compatible with converter/tokenizer-writer.py."""
    params: list[tuple[TokHeaderKey, int]] = [
        (TokHeaderKey.BOS_ID, data.bos_id),
        (TokHeaderKey.VERSION, 1),
        (TokHeaderKey.VOCAB_SIZE, len(data.vocab)),
        (TokHeaderKey.MAX_TOKEN_LENGTH, max(len(t) for t in data.vocab)),
    ]
    template_bytes = (
        data.chat_template.encode("utf-8") if data.chat_template is not None else None
    )
    if template_bytes:
        params.append((TokHeaderKey.CHAT_TEMPLATE, len(template_bytes)))
    params.append((TokHeaderKey.N_EOS_TOKENS, len(data.eos_token_ids)))
    params.append((TokHeaderKey.ADD_BOS, 1 if data.add_bos else 0))

    kv_data = b"".join(struct.pack("<ii", int(k), v) for k, v in params)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", TOKENIZER_MAGIC, 8 + len(kv_data)))
        f.write(kv_data)
        if template_bytes:
            f.write(template_bytes)
        for eos_id in data.eos_token_ids:
            f.write(struct.pack("<i", eos_id))
        for token, score in zip(data.vocab, data.scores):
            assert len(token) > 0
            f.write(struct.pack("<fI", score, len(token)))
            f.write(token)
