"""Token sampler: argmax / temperature / top-p nucleus.

Behavioral port of the reference Sampler (src/tokenizer.cpp:392-520),
including its xorshift* RNG so that seeded runs are reproducible across the
two implementations. Operates on host numpy over the final logits row; the
engine also offers fused on-device greedy sampling for the decode hot loop
(see runtime/engine.py) — this class is the reference-parity path.
"""

from __future__ import annotations

import numpy as np

_U64 = (1 << 64) - 1


class XorshiftRng:
    """xorshift* PRNG (reference: src/tokenizer.cpp:25-35)."""

    def __init__(self, seed: int):
        self.state = seed & _U64

    def random_u32(self) -> int:
        s = self.state
        s ^= (s >> 12) & _U64
        s = (s ^ (s << 25)) & _U64
        s ^= (s >> 27) & _U64
        self.state = s
        return ((s * 0x2545F4914F6CDD1D) & _U64) >> 32

    def random_f32(self) -> float:
        # float32 in [0, 1)
        return (self.random_u32() >> 8) / 16777216.0


def softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max()
    e = np.exp(x, dtype=np.float32)
    return e / e.sum()


def sample_argmax(probs: np.ndarray) -> int:
    return int(np.argmax(probs))


def sample_mult(probs: np.ndarray, coin: float) -> int:
    """Sample from a normalized distribution (reference: sample_mult)."""
    cdf = np.cumsum(probs, dtype=np.float32)
    idx = int(np.searchsorted(cdf, coin, side="right"))
    return min(idx, len(probs) - 1)


def topp_support(probs: np.ndarray, topp: float) -> tuple[np.ndarray, np.ndarray]:
    """Nucleus candidate set: (token ids in descending-prob order, their
    cumulative sums). Keeps the smallest prefix whose mass exceeds topp,
    including the crossing token, over the reference's cutoff pre-filter
    (src/tokenizer.cpp:426-467); the whole filtered set when the f32
    cumsum never crosses. Shared by sample_topp and the device-mask
    equivalence test."""
    n = len(probs)
    cutoff = (1.0 - topp) / (n - 1)
    idx = np.nonzero(probs >= cutoff)[0]
    # descending sort; stable to make ties deterministic
    order = idx[np.argsort(-probs[idx], kind="stable")]
    csum = np.cumsum(probs[order], dtype=np.float32)
    over = np.nonzero(csum > topp)[0]
    last = int(over[0]) if len(over) else len(order) - 1
    return order[: last + 1], csum[: last + 1]


def sample_topp(probs: np.ndarray, topp: float, coin: float) -> int:
    """Nucleus sampling (reference: src/tokenizer.cpp:426-467)."""
    order, csum = topp_support(probs, topp)
    last = len(order) - 1
    r = coin * csum[last]
    pick = int(np.searchsorted(csum, r, side="right"))
    pick = min(pick, last)
    return int(order[pick])


class Sampler:
    """(reference: src/tokenizer.hpp:77-91)"""

    def __init__(self, vocab_size: int, temperature: float, topp: float, seed: int):
        self.vocab_size = vocab_size
        self.temperature = temperature
        self.topp = topp
        self.rng = XorshiftRng(seed)

    def set_temp(self, temperature: float) -> None:
        self.temperature = temperature

    def set_topp(self, topp: float) -> None:
        self.topp = topp

    def set_seed(self, seed: int) -> None:
        self.rng = XorshiftRng(seed)

    def sample(self, logits: np.ndarray) -> int:
        """Sample the next token from a logits row (reference: Sampler::sample)."""
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)
        assert logits.shape[0] == self.vocab_size, (
            f"logits size {logits.shape[0]} != vocab {self.vocab_size}"
        )
        if self.temperature == 0.0:
            return sample_argmax(logits)
        probs = softmax(logits / self.temperature)
        coin = self.rng.random_f32()
        if self.topp <= 0 or self.topp >= 1:
            return sample_mult(probs, coin)
        return sample_topp(probs, self.topp, coin)
