"""The port's engine and CLI on CPU: the greedy token stream equals the JAX
InferenceEngine's (f32, weight_format="q40") for a tiny Llama and a tiny
Qwen3-MoE, and for the q40i4 and q40i8 formats on a dim-128 Llama and the
tiny Qwen3-MoE; the inference CLI runs and lists every weight format."""

import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch import cli
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    mp, tp = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, cfg=CFG)
    make_tiny_tokenizer(tp, pad_to=CFG["vocab_size"])
    return mp, tp


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    mp = str(tmp_path_factory.mktemp("engine_moe") / "moe.m")
    make_tiny_model(mp, arch=LlmArch.QWEN3_MOE)
    return mp


STREAMS = [([1, 2, 3, 4], 24, 8), (list(range(5, 18)), 40, 5)]


@pytest.fixture(scope="module")
def tiny128(tmp_path_factory):
    """dim 128, hidden 256: int8 group 128 (the tiny preset's is 32)."""
    mp = str(tmp_path_factory.mktemp("engine128") / "m128.m")
    make_tiny_model(mp, cfg=dict(CFG, dim=128, hidden_dim=256, vocab_size=256))
    return mp


def _greedy_streams_agree(mp, prompt, steps, block, weight_format="q40"):
    jeng = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, weight_format=weight_format)
    want, jev, _ = jeng.generate(prompt, max_steps=steps, block_size=block)
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, weight_format=weight_format,
                          device="cpu")
    got, ev, pred = eng.generate(prompt, max_steps=steps, block_size=block)
    assert got == want
    assert ev.n_tokens == jev.n_tokens == len(prompt) - 1
    assert pred.n_tokens == len(got) == steps - len(prompt) + 1
    assert eng.weight_format == weight_format and eng.i8_group == jeng.i8_group
    return eng


@pytest.mark.parametrize("prompt,steps,block", STREAMS)
def test_greedy_stream_matches_jax_engine(tiny, prompt, steps, block):
    _greedy_streams_agree(tiny[0], prompt, steps, block)


@pytest.mark.parametrize("prompt,steps,block", STREAMS)
def test_greedy_stream_matches_jax_engine_qwen3_moe(tiny_moe, prompt, steps, block):
    # the 13-token prompt prefills in a 32-row chunk (the grouped wrapper),
    # the 4-token one in an 8-row chunk (the active-experts wrapper)
    _greedy_streams_agree(tiny_moe, prompt, steps, block)


@pytest.mark.parametrize("weight_format,group", [("q40i4", 0), ("q40i8", 128)])
@pytest.mark.parametrize("prompt,steps,block", STREAMS)
def test_greedy_stream_matches_jax_engine_formats(tiny128, prompt, steps, block, weight_format,
                                                  group):
    eng = _greedy_streams_agree(tiny128, prompt, steps, block, weight_format)
    assert eng.i8_group == group


@pytest.mark.parametrize("weight_format", ["q40i4", "q40i8"])
def test_greedy_stream_matches_jax_engine_qwen3_moe_formats(tiny_moe, weight_format):
    eng = _greedy_streams_agree(tiny_moe, *STREAMS[1], weight_format)
    assert type(eng.params["layers"][0]["w1"]).__name__ == "QuantWeight"  # experts stay Q40


def test_engine_refuses_unknown_weight_format(tiny):
    with pytest.raises(ValueError, match="weight_format"):
        InferenceEngine(tiny[0], dtype=torch.float32, weight_format="q40i2", device="cpu")


def test_cli_help_lists_weight_formats(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "--weight-format {auto,q40,q40i8,q40i4,dense}" in out


def test_decode_step_stream_equals_block_stream(tiny):
    mp, _ = tiny
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, weight_format="q40",
                          device="cpu")
    blocks, _, _ = eng.generate([1, 2, 3], max_steps=20, block_size=8)
    eng.reset()
    steps, _, _ = eng.generate([1, 2, 3], max_steps=20, block_size=1)
    assert blocks == steps


def test_sampled_stream_reproducible_per_seed(tiny):
    mp, _ = tiny
    outs = []
    for _ in range(2):
        eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.9, topp=0.9, seed=7,
                              device="cpu")
        outs.append(eng.generate([1, 2, 3], max_steps=16)[0])
    assert outs[0] == outs[1] and len(outs[0]) == 14


def test_engine_bounds_checks(tiny):
    mp, _ = tiny
    eng = InferenceEngine(mp, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        eng.prefill(list(range(CFG["seq_len"] + 2)))
    with pytest.raises(ValueError):
        eng.decode_step(1, CFG["seq_len"])
    assert eng._bucket_for(5, 0) == 8
    assert eng._bucket_for(40, 60) == 1  # the padded chunk must fit the cache


def test_engine_default_device_is_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tiny[0])
    from dllama_tpu_torch.formats import ModelReader
    from dllama_tpu_torch.models import init_kv_cache, load_params

    reader = ModelReader(tiny[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_params(reader, weight_format="q40")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(reader.header, 1)


def _cli_run_matches_engine(tiny, capsys, weight_format):
    mp, tp = tiny
    res = cli.main(["inference", "--model", mp, "--tokenizer", tp, "--prompt", "hello world",
                    "--steps", "20", "--temperature", "0", "--dtype", "f32",
                    "--weight-format", weight_format, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Evaluation" in out and "Prediction" in out and "hello world" in out
    assert f"WeightFormat: {weight_format}" in out
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, weight_format=weight_format,
                          device="cpu")
    want, _, _ = eng.generate(res["prompt_tokens"], max_steps=20)
    assert res["tokens"] == want and len(want) == 20 - len(res["prompt_tokens"]) + 1


def test_cli_inference_on_cpu(tiny, capsys):
    _cli_run_matches_engine(tiny, capsys, "q40")


def test_cli_inference_on_cpu_q40i8(tiny, capsys):
    _cli_run_matches_engine(tiny, capsys, "q40i8")
