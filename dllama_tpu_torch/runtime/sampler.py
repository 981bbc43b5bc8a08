"""Token sampler: argmax / temperature / top-p nucleus.

Behavioral port of the reference Sampler (src/tokenizer.cpp:392-520),
including its xorshift* RNG so that seeded runs are reproducible across the
two implementations. Operates on host numpy over the final logits row; the
engine also offers fused on-device greedy sampling for the decode hot loop
(see runtime/engine.py) — this class is the reference-parity path.

`topp_mask` and `sample_per_lane` are the on-device lane sampler, twins of
dllama_tpu/runtime/engine.py ``_topp_mask`` and ``_sample_per_lane``. The
JAX engine draws from the JAX PRNG, which torch cannot replay; here a
lane's draw comes from a stateless integer hash of (its seed, its absolute
position, the token id) in torch ops (`lane_uniform`), so a seeded lane's
stream does not depend on the other lanes or on how blocks split.
"""

from __future__ import annotations

import numpy as np
import torch

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


def topp_mask(probs: torch.Tensor, topp: torch.Tensor) -> torch.Tensor:
    """Top-p nucleus mask on the device, [B, V] probs -> masked probs, with
    ``topp`` [B] f32 (twin of the JAX engine's ``_topp_mask``). The host
    rule (`topp_support`) as a threshold: after the cutoff pre-filter
    (1 - topp) / (V - 1), keep every prob >= the one whose cumulative sum
    first exceeds topp, so exact ties at the nucleus edge are all kept; the
    whole filtered set when the sum never crosses; the full distribution
    for topp outside (0, 1)."""
    b, v = probs.shape
    topp_col = topp.to(torch.float32).reshape(-1, 1).expand(b, 1)
    valid = (topp_col > 0.0) & (topp_col < 1.0)
    cutoff = (1.0 - topp_col) / np.float32(v - 1)
    pf = torch.where(valid & (probs < cutoff), torch.zeros_like(probs), probs)
    sorted_probs = torch.sort(pf, dim=-1, descending=True).values
    crossed = torch.cumsum(sorted_probs, dim=-1) > topp_col
    cross = torch.where(crossed.any(-1), crossed.int().argmax(-1), v - 1)
    thresh = torch.maximum(sorted_probs.gather(-1, cross[:, None]), cutoff)
    masked = torch.where(pf >= thresh, pf, torch.zeros_like(pf))
    return torch.where(valid, masked, probs)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32) in int64, by 16-bit halves of c so
    that no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply, lowbias32 constants)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def lane_uniform(seeds: torch.Tensor, positions: torch.Tensor, v: int) -> torch.Tensor:
    """Uniform f32 in (0, 1), [B, V]: entry (l, i) is a function of
    (seeds[l], positions[l], i) only."""
    key = _hash32(seeds.long() ^ _hash32(positions.long() + 0x9E3779B9))
    ids = torch.arange(v, device=seeds.device, dtype=torch.int64)
    bits = _hash32(key[:, None] + _mul32(ids, 0x9E3779B9)[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) / np.float32(1 << 24)


def sample_per_lane(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32
    topp: torch.Tensor,  # [B] f32
    seeds: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int: the absolute position each lane samples at
) -> torch.Tensor:
    """Per-lane temperature + top-p sampling on the device -> [B] int64
    (twin of the JAX engine's ``_sample_per_lane``): the Gumbel-max draw
    over log(probs) with the noise of `lane_uniform`. Lanes with
    temperature <= 0 take the argmax."""
    temp_col = temperature.to(torch.float32)[:, None]
    probs = topp_mask(torch.softmax(logits / temp_col.clamp(min=1e-6), dim=-1), topp)
    u = lane_uniform(seeds, positions, logits.shape[-1])
    sampled = torch.argmax(torch.log(probs + 1e-30) - torch.log(-torch.log(u)), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp_col[:, 0] <= 0.0, greedy, sampled)
