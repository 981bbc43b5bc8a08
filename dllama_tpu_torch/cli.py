"""dllama-compatible CLI of the PyTorch port: the ``inference`` mode.

    python -m dllama_tpu_torch inference --model m.m --tokenizer t.t \\
        --prompt "..." --steps 64 [--temperature 0] [--device cuda|cpu]
        [--weight-format auto|q40|q40i8|q40i4|dense]

Flags follow the JAX package's CLI (reference: src/app.cpp:24-135). The
device defaults to ``cuda`` and the run fails without one; ``--device cpu``
runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dllama-tpu-torch", description="distributed-llama inference on PyTorch/CUDA"
    )
    p.add_argument("mode", choices=["inference"])
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument(
        "--weight-format", default="auto", choices=["auto", "q40", "q40i8", "q40i4", "dense"],
        help="q40: int8 values + f16 scales; q40i8: requantized to grouped int8 at load; "
        "q40i4: packed nibbles (0.5625 B/weight); auto: q40 on the card for a Q40 file",
    )
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=int(time.time()))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def load_engine(args):
    from .runtime.engine import InferenceEngine
    from .tokenizer import Tokenizer

    tok = Tokenizer(args.tokenizer)
    engine = InferenceEngine(
        args.model,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        max_seq_len=args.max_seq_len,
        temperature=args.temperature,
        topp=args.topp,
        seed=args.seed,
        weight_format=args.weight_format,
        device=args.device,
    )
    h = engine.header
    print(f"💡 Arch: {h.arch.name}")
    print(f"💡 Dim: {h.dim}")
    print(f"💡 HeadDim: {h.head_dim}")
    print(f"💡 HiddenDim: {h.hidden_dim}")
    print(f"💡 VocabSize: {h.vocab_size}")
    print(f"💡 nLayers: {h.n_layers}")
    print(f"💡 nHeads: {h.n_heads}")
    print(f"💡 nKvHeads: {h.n_kv_heads}")
    if h.n_experts:
        print(f"💡 nExperts: {h.n_experts}")
        print(f"💡 nActiveExperts: {h.n_active_experts}")
    print(f"💡 SeqLen: {h.seq_len}")
    dev = engine.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"💡 Device: {dev} ({name})")
    print(f"💡 WeightFormat: {engine.weight_format}")
    if engine.i8_group:
        print(f"💡 Int8Group: {engine.i8_group}")
    if tok.vocab_size != h.vocab_size:
        print(
            f"⚠️  tokenizer vocab ({tok.vocab_size}) != model vocab ({h.vocab_size}); "
            "decoding may fail for out-of-range tokens"
        )
    return engine, tok


def run_inference(args) -> dict:
    """(reference: dllama.cpp:13-116) Returns the run's tokens and times."""
    if args.prompt is None:
        raise SystemExit("Prompt is required")
    if args.steps == 0:
        raise SystemExit("Number of steps is required")
    t0 = time.perf_counter()
    engine, tok = load_engine(args)
    load_s = time.perf_counter() - t0
    tokens = tok.encode(args.prompt, is_start=True, add_special_tokens=True)
    if len(tokens) > engine.header.seq_len:
        raise SystemExit("The number of prompt tokens is greater than the sequence length")
    print(args.prompt)
    tok.reset_decoder()

    def on_token(t: int) -> None:
        piece = tok.decode(t)
        if piece is not None:
            sys.stdout.write(piece)
            sys.stdout.flush()

    out, eval_stats, pred_stats = engine.generate(tokens, max_steps=args.steps, on_token=on_token)
    n_eval = max(eval_stats.n_tokens, 1)
    n_pred = pred_stats.n_tokens
    print()
    print("Evaluation")
    print(f"    nTokens: {eval_stats.n_tokens}")
    print(
        f"   tokens/s: {n_eval * 1000 / max(eval_stats.time_ms, 1e-9):3.2f} "
        f"({eval_stats.time_ms / n_eval:3.2f} ms/tok)"
    )
    print("Prediction")
    print(f"    nTokens: {n_pred}")
    if n_pred:
        print(
            f"   tokens/s: {n_pred * 1000 / max(pred_stats.time_ms, 1e-9):3.2f} "
            f"({pred_stats.time_ms / n_pred:3.2f} ms/tok)"
        )
    return {
        "engine": engine,
        "prompt_tokens": tokens,
        "tokens": out,
        "load_s": load_s,
        "eval": eval_stats,
        "pred": pred_stats,
    }


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.mode == "inference":
        return run_inference(args)
    return None


if __name__ == "__main__":
    main()
