"""The port's chat templates, EOS detector and per-lane stream decoder
(dllama_tpu_torch.tokenizer) against the JAX package's, for every chat
template type."""

import pytest

from dllama_tpu import tokenizer as jtok
from dllama_tpu_torch import tokenizer as ttok

from helpers import make_tiny_tokenizer

CHATS = [
    [("user", "hello")],
    [("system", "be brief"), ("user", "hi"), ("assistant", "hey"), ("user", "more")],
    [("user", "a"), ("assistant", "b")],
]
SOURCES = {  # template source text -> the type it is detected as
    "[INST]": "LLAMA2", "<|start_header_id|>": "LLAMA3", "<｜Assistant｜>": "DEEP_SEEK3",
    "<|im_start|>": "CHATML",
}


@pytest.mark.parametrize("ttype", list(jtok.ChatTemplateType), ids=lambda t: t.name)
@pytest.mark.parametrize("gen_prompt", [True, False])
def test_chat_template_matches_jax(ttype, gen_prompt):
    # UNKNOWN detects the type from each template source; a given type
    # needs none
    sources = list(SOURCES) if ttype == jtok.ChatTemplateType.UNKNOWN else [None]
    for source in sources:
        for chat in CHATS:
            outs = []
            for mod in (jtok, ttok):
                gen = mod.ChatTemplateGenerator(mod.ChatTemplateType(int(ttype)), source, "</s>")
                g = gen.generate([mod.ChatItem(r, m) for r, m in chat], gen_prompt)
                outs.append((gen.type.name, g.content, g.public_prompt))
            assert outs[0] == outs[1]


@pytest.mark.parametrize("source", list(SOURCES) + ["plain"])
def test_detect_chat_template_matches_jax(source):
    outs = []
    for mod in (jtok, ttok):
        try:
            outs.append(mod.chat.detect_chat_template(source).name)
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    assert ttok.CHAT_TEMPLATE_NAMES.keys() == jtok.CHAT_TEMPLATE_NAMES.keys()


@pytest.mark.parametrize("stops,pad", [(["</s>"], 0), (["</s>", "STOP"], 4), (["ab"], 2)])
def test_eos_detector_matches_jax(stops, pad):
    pieces = ["x", " a", "b", "S", "TO", "P", "</", "s>", "q", None, "ab", "z"]
    tokens = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 99]
    traces = []
    for mod in (jtok, ttok):
        det = mod.EosDetector([99], stops, padding_left=pad, padding_right=pad)
        trace = []
        for t, p in zip(tokens, pieces):
            r = det.append(t, p)
            trace.append((int(r), det.get_delta(), det.eos_pos))
            if r != mod.EosResult.MAYBE_EOS:
                det.reset()
        traces.append(trace)
    assert traces[0] == traces[1]


def test_stream_decoder_matches_jax(tmp_path):
    tp = str(tmp_path / "t.t")
    make_tiny_tokenizer(tp)
    jt, tt = jtok.Tokenizer(tp), ttok.Tokenizer(tp)
    ids = jt.encode("héllo wörld ☃", is_start=True) + [jt.eos_token_ids[0]]
    jd, td = jt.stream_decoder(), tt.stream_decoder()
    assert [jd.decode(i) for i in ids] == [td.decode(i) for i in ids]
