"""The port's own copies of the formats, tokenizer and sampler agree with
the JAX package's, and its synthetic writer produces a readable model."""

import numpy as np
import pytest

from dllama_tpu.formats import model_file as j_model_file
from dllama_tpu.formats import quants as j_quants
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.runtime.sampler import Sampler as JSampler
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.formats import model_file as t_model_file
from dllama_tpu_torch.formats import quants as t_quants
from dllama_tpu_torch.runtime.sampler import Sampler as TSampler
from dllama_tpu_torch.tokenizer import Tokenizer as TTokenizer

from helpers import make_tiny_model, make_tiny_tokenizer


@pytest.mark.parametrize("arch", [LlmArch.LLAMA, LlmArch.QWEN3])
def test_model_reader_matches(tmp_path, arch):
    mp = str(tmp_path / "m.m")
    make_tiny_model(mp, arch=arch)
    j, t = j_model_file.ModelReader(mp), t_model_file.ModelReader(mp)
    assert vars(j.header) == vars(t.header)  # IntEnums compare by value
    assert [(s.name, s.shape, s.offset) for s in j] == [(s.name, s.shape, s.offset) for s in t]
    for name in ("layers.0.q", "wcls"):
        np.testing.assert_array_equal(j.planar_q40(name)[0], t.planar_q40(name)[0])
        np.testing.assert_array_equal(j.dense_f32(name), t.dense_f32(name))


def test_quant_codecs_match():
    x = (np.random.default_rng(0).standard_normal(4096) * 0.1).astype(np.float32)
    assert t_quants.quantize_q40(x).tobytes() == j_quants.quantize_q40(x).tobytes()
    assert t_quants.quantize_q80(x).tobytes() == j_quants.quantize_q80(x).tobytes()
    raw = j_quants.quantize_q40(x)
    for a, b in zip(t_quants.q40_to_planar(raw, x.size), j_quants.q40_to_planar(raw, x.size)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_quants.dequantize_q40(raw, x.size), j_quants.dequantize_q40(raw, x.size)
    )


@pytest.mark.parametrize("text", ["hello world", "the hello there, world!", "<s>hi</s> the"])
def test_tokenizer_matches(tmp_path, text):
    tp = str(tmp_path / "t.t")
    make_tiny_tokenizer(tp)
    j, t = JTokenizer(tp), TTokenizer(tp)
    ids = j.encode(text)
    assert t.encode(text) == ids
    assert t.decode_tokens(ids) == j.decode_tokens(ids)


@pytest.mark.parametrize("temperature,topp", [(0.0, 0.9), (0.8, 0.9), (1.0, 0.0)])
def test_sampler_matches(temperature, topp):
    rng = np.random.default_rng(1)
    j, t = JSampler(64, temperature, topp, 7), TSampler(64, temperature, topp, 7)
    for _ in range(20):
        logits = rng.standard_normal(64).astype(np.float32)
        assert t.sample(logits) == j.sample(logits)


def test_synthetic_model_reads_back(tmp_path):
    from dllama_tpu_torch.models.synthetic import write_synth_model

    mp = str(tmp_path / "s.m")
    cfg = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
               vocab_size=300, seq_len=512)
    h = write_synth_model(mp, cfg, seed=3, max_seq_len=128, chunk_blocks=100)
    r = t_model_file.ModelReader(mp)
    assert (r.header.dim, r.header.n_layers, r.header.seq_len) == (64, 2, 128)
    assert h.vocab_size == r.header.vocab_size
    q, d = r.planar_q40("wcls")
    assert q.min() >= -8 and q.max() <= 7 and np.all(np.abs(d) > 0)
    # rows differ (the JAX writer tiles one row per width)
    assert not np.array_equal(q[0], q[1])
    w = r.dense_f32("layers.0.w1")
    assert 0.01 < w.std() < 0.03
