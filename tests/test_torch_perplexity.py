"""The port's ``InferenceEngine.perplexity`` and ``perplexity`` CLI mode on
CPU, f32, against the JAX engine's and CLI's, on a tiny Llama and a tiny
Qwen3-MoE; prompts of 9, 40 and 50 tokens cross the 8- and 32-row bucket
edges. Tolerance: 1e-5 relative on the NLL (the two engines differ in sum
order only); the CLI prints 4 decimals, so its values agree to one unit
of the last printed place. As in the JAX test (tests/test_engine.py), the
NLL does not depend on the chunk shapes and equals a single un-chunked
forward scored on the host."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import cli as jcli
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch import cli
from dllama_tpu_torch.models import forward, init_kv_cache
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
REL = 1e-5
LENGTHS = (9, 40, 50)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    out = {"llama": str(d / "llama.m"), "qwen3_moe": str(d / "moe.m")}
    make_tiny_model(out["llama"], cfg=CFG)
    make_tiny_model(out["qwen3_moe"], arch=LlmArch.QWEN3_MOE)
    tp = str(d / "t.t")
    make_tiny_tokenizer(tp, pad_to=CFG["vocab_size"])
    return out, tp


def _prompt(n, vocab):
    return [(i * 7 + 3) % vocab for i in range(n)]


@pytest.mark.parametrize("arch", ["llama", "qwen3_moe"])
@pytest.mark.parametrize("weight_format", ["q40", "dense"])
def test_perplexity_matches_jax_engine(models, arch, weight_format):
    mp = models[0][arch]
    jeng = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, weight_format=weight_format)
    eng = InferenceEngine(mp, dtype=torch.float32, weight_format=weight_format, device="cpu")
    for n in LENGTHS:
        prompt = _prompt(n, eng.header.vocab_size)
        want, got = jeng.perplexity(prompt), eng.perplexity(prompt)
        assert got[2] == want[2] == n - 1
        assert abs(got[0] - want[0]) <= REL * abs(want[0]), (n, got, want)
        assert abs(got[1] - want[1]) <= 2 * REL * abs(want[1]), (n, got, want)


@pytest.mark.parametrize("arch", ["llama", "qwen3_moe"])
def test_perplexity_chunk_size_invariant(models, arch):
    eng = InferenceEngine(models[0][arch], dtype=torch.float32, weight_format="q40",
                          device="cpu")
    prompt = _prompt(50, eng.header.vocab_size)
    nlls = []
    for buckets in [(4,), (8, 32), (50,)]:
        eng.prefill_buckets = buckets
        nll, _, n = eng.perplexity(prompt)
        assert n == len(prompt) - 1
        nlls.append(nll)
    # oracle: one un-chunked forward, scored on the host
    cache = init_kv_cache(eng.header, 1, dtype=torch.float32, device="cpu")
    logits, _ = forward(eng.params, eng.header, torch.tensor([prompt]), 0, cache, "all")
    lg = logits[0].double().numpy()
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    oracle = float(np.mean(lse[:-1] - lg[np.arange(len(prompt) - 1), prompt[1:]]))
    for nll in nlls:
        assert abs(nll - oracle) <= REL * abs(oracle), (nlls, oracle)


def test_perplexity_checks(models):
    eng = InferenceEngine(models[0]["llama"], dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        eng.perplexity([1])
    with pytest.raises(ValueError, match="exceed seqLen"):
        eng.perplexity([1] * (CFG["seq_len"] + 1))
    with pytest.raises(ValueError, match="out of range"):
        eng.perplexity([1, CFG["vocab_size"]])


def _values(out: str) -> dict:
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^\s*(nTokens|nScored|nll|perplexity): (\S+)$", out, re.M)}


def test_cli_perplexity_matches_jax_cli(models, capsys):
    (paths, tp) = models
    argv = ["perplexity", "--model", paths["llama"], "--tokenizer", tp, "--prompt",
            "hello world, the world says hello", "--dtype", "f32", "--weight-format", "q40"]
    jcli.run_perplexity(jcli._build_parser().parse_args(argv + ["--tp", "1"]))
    want = _values(capsys.readouterr().out)
    cli.main(argv + ["--device", "cpu"])
    got = _values(capsys.readouterr().out)
    assert set(got) == set(want) == {"nTokens", "nScored", "nll", "perplexity"}
    assert got["nTokens"] == want["nTokens"] and got["nScored"] == want["nScored"]
    for key in ("nll", "perplexity"):
        assert abs(got[key] - want[key]) <= 1e-4 + REL * abs(want[key]), (got, want)
