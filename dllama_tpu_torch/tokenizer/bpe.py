"""Score-based BPE tokenizer over `.t` vocabularies.

Behavioral port of the reference tokenizer (src/tokenizer.cpp:196-390):

* the vocab splits at ``bos_id`` into regular tokens (exact-match lookup)
  and special tokens (prefix scan in id order);
* ``encode`` greedily accumulates bytes until the accumulated span is a
  regular token, then runs the score-maximizing pair-merge loop;
* ``decode`` is a streaming detokenizer: pieces are raw bytes, multi-byte
  UTF-8 sequences may span several tokens, and invalid bytes recover to
  U+FFFD (src/tokenizer.cpp:224-309) — implemented with Python's
  incremental UTF-8 decoder, which has exactly those semantics.

Departure from the reference (an intentional upgrade, same results): the
merge loop keeps the O(n) scan per round but looks pairs up in a dict
instead of bsearch over a sorted array.

The port's own copy of dllama_tpu/tokenizer/bpe.py, pure-Python encode only
(the JAX package's optional C++ encode loop stays out).
"""

from __future__ import annotations

import codecs

from ..formats.tokenizer_file import TokenizerData, read_tokenizer


class Tokenizer:
    """Tokenizer over a `.t` vocabulary (reference: src/tokenizer.hpp:35-70)."""

    def __init__(self, source: str | TokenizerData):
        data = read_tokenizer(source) if isinstance(source, str) else source
        self.data = data
        self.vocab: list[bytes] = data.vocab
        self.scores: list[float] = data.scores
        self.vocab_size = len(data.vocab)
        self.bos_id = data.bos_id
        self.add_bos = data.add_bos
        self.eos_token_ids = list(data.eos_token_ids)
        self.chat_template = data.chat_template
        self.max_token_length = data.max_token_length

        # Regular/special split at bos_id (reference: src/tokenizer.cpp:138-153).
        self.regular_vocab_size = self.bos_id
        # Exact-match index; on duplicate strings keep the first id, matching
        # what a bsearch over a stably-sorted array would most often return.
        self._regular: dict[bytes, int] = {}
        for i in range(self.regular_vocab_size):
            self._regular.setdefault(self.vocab[i], i)
        self._special_ids = list(range(self.regular_vocab_size, self.vocab_size))

        self._decoder = codecs.getincrementaldecoder("utf-8")("replace")

    # -- encode ---------------------------------------------------------------

    def find_regular_token(self, piece: bytes) -> int:
        """Exact regular-vocab lookup (reference: src/tokenizer.cpp:206-210)."""
        return self._regular.get(piece, -1)

    def find_special_token_start_with(self, text: bytes, start: int = 0) -> int:
        """First special token that prefixes ``text[start:]``, scanned in id
        order (reference: src/tokenizer.cpp:196-204). Offset-based to avoid
        copying a tail slice per byte position."""
        for tid in self._special_ids:
            if text.startswith(self.vocab[tid], start):
                return tid
        return -1

    def encode(
        self,
        text: str | bytes,
        is_start: bool = True,
        add_special_tokens: bool = True,
    ) -> list[int]:
        """Encode text to token ids (reference: src/tokenizer.cpp:311-390)."""
        if text is None:
            raise ValueError("input text is None")
        raw = text.encode("utf-8") if isinstance(text, str) else bytes(text)

        use_bos = is_start and self.add_bos and self.bos_id >= 0
        tokens: list[int] = []
        if use_bos:
            tokens.append(self.bos_id)

        # Greedy byte accumulation; specials matched by prefix at every byte
        # position — even mid-accumulation, in which case the special is
        # emitted and accumulation continues across it, exactly as the
        # reference does (src/tokenizer.cpp:325-333).
        acc = bytearray()
        i = 0
        n = len(raw)
        while i < n:
            if add_special_tokens:
                sid = self.find_special_token_start_with(raw, i)
                if sid >= 0:
                    tokens.append(sid)
                    i += len(self.vocab[sid])
                    continue
            acc.append(raw[i])
            i += 1
            tid = self.find_regular_token(bytes(acc))
            if tid != -1:
                tokens.append(tid)
                acc.clear()
        if acc:
            raise ValueError(
                f"un-tokenizable trailing bytes (vocab lacks byte fallback?): {bytes(acc)!r}"
            )

        # Score-maximizing pair merge (reference: src/tokenizer.cpp:349-378).
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for j in range(len(tokens) - 1):
                merged = self.vocab[tokens[j]] + self.vocab[tokens[j + 1]]
                mid = self._regular.get(merged, -1)
                if mid != -1 and self.scores[mid] > best_score:
                    best_score = self.scores[mid]
                    best_id = mid
                    best_idx = j
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [best_id]
        return tokens

    # -- decode ---------------------------------------------------------------

    def is_eos(self, token: int) -> bool:
        return token in self.eos_token_ids

    def reset_decoder(self) -> None:
        """Drop pending partial UTF-8 state (reference: resetDecoder)."""
        self._decoder.reset()

    def _decode_with(self, decoder, token: int) -> str | None:
        """Streaming decode of one token against an incremental UTF-8
        decoder (reference: src/tokenizer.cpp:291-309)."""
        if token == self.bos_id:
            return None
        if not 0 <= token < self.vocab_size:
            # the model's vocab is larger than the tokenizer's (the
            # reference would read out of bounds here); fail with context
            raise ValueError(
                f"token {token} outside tokenizer vocab "
                f"({self.vocab_size} entries) — model/tokenizer mismatch?"
            )
        if self.is_eos(token):
            # Flush whatever partial sequence is pending (reference returns the
            # raw pending buffer; we replace the incomplete tail like the
            # recovery path would).
            out = decoder.decode(b"", final=True)
            decoder.reset()
            return out if out else None
        piece = self.vocab[token]
        out = decoder.decode(piece)
        return out if out else None

    def decode(self, token: int) -> str | None:
        """Streaming decode of one token; returns printable text accumulated so
        far or None (reference: src/tokenizer.cpp:291-309)."""
        return self._decode_with(self._decoder, token)

    def decode_tokens(self, tokens: list[int]) -> str:
        """Non-streaming convenience: decode a whole sequence. Starts from a
        clean decoder so stale streaming state cannot leak in."""
        self.reset_decoder()
        parts = []
        for t in tokens:
            s = self.decode(t)
            if s:
                parts.append(s)
        tail = self._decoder.decode(b"", final=True)
        self._decoder.reset()
        if tail:
            parts.append(tail)
        return "".join(parts)
