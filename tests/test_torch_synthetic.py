"""The port's synthetic models against the JAX package's: every preset's
header field by field (rope type included), and a cut-down random
Qwen3-MoE file from the port's writer read by both ModelReaders."""

import dataclasses

import numpy as np
import pytest

from dllama_tpu.formats import model_file as j_model_file
from dllama_tpu.models import synthetic as j_synthetic
from dllama_tpu_torch.formats import model_file as t_model_file
from dllama_tpu_torch.models import synthetic as t_synthetic


@pytest.mark.parametrize("preset", sorted(j_synthetic.PRESETS))
def test_make_header_matches_jax(preset):
    assert sorted(t_synthetic.PRESETS) == sorted(j_synthetic.PRESETS)
    for max_seq_len in (0, 4096):
        want = vars(j_synthetic.make_header(preset, max_seq_len=max_seq_len))
        got = vars(t_synthetic.make_header(preset, max_seq_len=max_seq_len))
        assert got == want  # IntEnums compare by value


def test_synthetic_qwen3_moe_file_reads_in_both_readers(tmp_path):
    mp = str(tmp_path / "moe.m")
    cfg = dict(t_synthetic.PRESETS["qwen3-30b-a3b"], dim=64, hidden_dim=128, moe_hidden_dim=96,
               n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=300, n_experts=6,
               n_active_experts=2)
    h = t_synthetic.write_synth_model(mp, cfg, seed=4, max_seq_len=128, chunk_blocks=64)
    t, j = t_model_file.ModelReader(mp), j_model_file.ModelReader(mp)
    assert vars(t.header) == vars(j.header)
    assert t.header.arch == j_model_file.LlmArch.QWEN3_MOE
    assert t.header.rope_type == j_model_file.RopeType.FALCON
    # the writer's header is the file's, but for what only the file knows
    # and the original seq_len (the file stores the cut one)
    file_only = {"header_bytes", "file_size", "orig_seq_len"}
    for f in dataclasses.fields(h):
        if f.name not in file_only:
            assert getattr(h, f.name) == getattr(t.header, f.name), f.name
    assert (t.header.ff_dim, t.header.n_experts, t.header.n_active_experts) == (96, 6, 2)
    assert [(s.name, s.shape, s.offset) for s in t] == [(s.name, s.shape, s.offset) for s in j]
    for name in ("layers.1.experts.5.w2", "layers.0.experts.0.w1", "wcls"):
        for a, b in zip(t.planar_q40(name), j.planar_q40(name)):
            np.testing.assert_array_equal(a, b)
    gate = t.dense_f32("layers.0.moe_gate")
    np.testing.assert_array_equal(gate, j.dense_f32("layers.0.moe_gate"))
    assert gate.shape == (6, 64) and 0.01 < gate.std() < 0.03
