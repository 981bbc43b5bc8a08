"""The port's ``chat`` CLI mode on CPU, f32, against the JAX CLI's
``run_chat`` on the same tiny Llama and chat-template tokenizer, both fed
the same user turns on stdin at temperature 0: everything printed from
the chat banner on (prompts, the assistant's streamed text, the explicit
stop when the context is full) is equal, character for character. And a
generation that fails resets the conversation: the next turn prints what
a fresh chat's first turn prints."""

import io

import pytest

from dllama_tpu import cli as jcli
from dllama_tpu_torch import cli
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=128)
TURNS = "hello there\nand one more thing\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("chat")
    mp, tp = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, cfg=CFG)
    make_tiny_tokenizer(tp, chat_template="<|start_header_id|>", pad_to=CFG["vocab_size"])
    return mp, tp


def _argv(files):
    mp, tp = files
    return ["chat", "--model", mp, "--tokenizer", tp, "--temperature", "0", "--dtype", "f32",
            "--weight-format", "q40", "--chat-template", "llama3"]


def _chat(run, monkeypatch, capsys, turns=TURNS) -> str:
    monkeypatch.setattr("sys.stdin", io.StringIO(turns))
    run()
    out = capsys.readouterr().out
    return out[out.index("💬 Chat mode"):]


def test_chat_matches_jax_run_chat(files, monkeypatch, capsys):
    argv = _argv(files)
    want = _chat(lambda: jcli.run_chat(jcli._build_parser().parse_args(argv + ["--tp", "1"])),
                 monkeypatch, capsys)
    got = _chat(lambda: cli.main(argv + ["--device", "cpu"]), monkeypatch, capsys)
    assert got == want
    # the first turn's reply runs the context to its end; the second stops explicitly
    assert "🤖 Assistant: " in got and got.count("👱 You: ") == 2
    assert got.rstrip().endswith("restart the chat to continue.")
    assert f"Context window full ({CFG['seq_len']} tokens)" in got


def test_chat_resets_after_failed_generation(files, monkeypatch, capsys):
    argv = _argv(files) + ["--device", "cpu"]
    fresh = _chat(lambda: cli.main(argv), monkeypatch, capsys, "hello there\n")
    real = InferenceEngine.generate
    calls = []

    def failing_once(self, *a, **kw):
        calls.append(kw.get("start_pos"))
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(self, *a, **kw)

    monkeypatch.setattr(InferenceEngine, "generate", failing_once)
    got = _chat(lambda: cli.main(argv), monkeypatch, capsys, "first\nhello there\n")
    assert "🚫 Generation failed (injected); conversation reset." in got
    assert calls == [0, 0]  # the turn after the failure starts a fresh conversation
    tail = got[got.index("conversation reset.") + len("conversation reset.") + 1:]
    assert tail == fresh[fresh.index("\n👱 You: "):]
