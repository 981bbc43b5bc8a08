"""dllama-compatible CLI of the PyTorch port: ``inference``, ``chat``, ``perplexity``.

    python -m dllama_tpu_torch inference --model m.m --tokenizer t.t \\
        --prompt "..." --steps 64 [--temperature 0] [--device cuda|cpu]
        [--weight-format auto|q40|q40i8|q40i4|dense] [--kv-dtype int8]
    python -m dllama_tpu_torch chat --model m.m --tokenizer t.t [--chat-template llama3]
    python -m dllama_tpu_torch perplexity --model m.m --tokenizer t.t --prompt "..."
    python -m dllama_tpu_torch inference ... --tp 2 [--sp 2] [--device cuda|cuda:N|cpu]
    python -m dllama_tpu_torch inference ... --pp 2 [--dp 2 --batch-size 2] [--tp 2]
    torchrun --nproc-per-node 2 -m dllama_tpu_torch inference ... --tp 2
    (each also takes --trace-out PATH, --timeline-out PATH, --postmortem-dir DIR,
    --nbatches N (prefill buckets 1, N and 512), --moe-decode-dedup auto|on|off;
    inference --profile DIR; --nthreads and --net-turbo are accepted and
    ignored, --gpu-index/--gpu-segments and the ``worker`` mode refused)

Flags follow the JAX package's CLI (reference: src/app.cpp:24-135). The
device defaults to ``cuda`` and the run fails without one; ``--device cpu``
runs the plain PyTorch versions of the kernels. `add_engine_args`,
`add_obs_args` and `load_engine` are shared with the API server
(runtime/api_server.py), whose lane and KV-pool flags they also carry.
`load_engine` prints the engine's memory report and the decode roofline
(obs/cost.py) and compares the memory with the card's allocator
(obs/device.py), as the JAX CLI does.

Tensor, sequence, pipeline and data parallelism (``--tp``, 0 = as many
ranks as the host's cards and the model allow, 1 under ``--pp``; ``--sp``;
``--pp`` stages; ``--dp`` lane shards, which ``--batch-size`` must divide;
``--workers N`` an alias of ``--tp``): ``pp * dp * sp * tp`` ranks, each an
engine on its slices (runtime/engine.py). Under
torchrun each process is a rank (parallel/mesh.py reads its environment);
without it the CLI starts its ranks itself (parallel/launch.py) and rank 0
alone prints. ``--device cuda`` puts rank r on ``cuda:r``, ``cuda:N`` every
rank on card N (the ranks then share it over gloo), ``cpu`` on the CPU.
``--buffer-float-type q80`` (the default) compresses the tp all-reduces only
when the ranks span hosts, as the JAX CLI applies it only across processes.
``inference`` and ``perplexity`` run one program on every rank and print the
JAX CLI's lines at the same tp and sp (Sent/Recv:
`utils.telemetry.ici_traffic_per_token`, the pipeline's hand-offs
included; Sync: the host ms of the step's collectives). ``chat`` runs on
rank 0, which reads stdin, and the other ranks follow its dispatches
(parallel/control.py); without torchrun the chat's own process is rank 0
(parallel/launch.lead). ``--sync-measure`` is accepted and ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from .tokenizer.chat import CHAT_TEMPLATE_NAMES


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The flags that build an engine (`load_engine`), and the serving
    flags of the lane path."""
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "f32", "int8"],
                   help="the KV cache's type: int8 is per-row quantized (about half of "
                   "bf16's bytes); a float type may differ from --dtype (default: --dtype)")
    p.add_argument("--nbatches", "--n-batches", type=int, default=32, dest="nbatches",
                   help="prefill chunk size: the engine's buckets are (1, nbatches, 512)")
    p.add_argument("--nthreads", type=int, default=1,
                   help="accepted for CLI parity; PyTorch owns threading")
    p.add_argument("--net-turbo", type=int, default=1, help="accepted for CLI parity")
    p.add_argument("--gpu-index", type=int, default=None,
                   help="refused: the port runs on the card --device names")
    p.add_argument("--gpu-segments", default=None,
                   help="refused: the port runs on the card --device names")
    p.add_argument("--moe-decode-dedup", default="auto", nargs="?", const="on",
                   choices=["auto", "on", "off"],
                   help="two-tier Qwen3-MoE lane decode: the grouped kernel over the experts the "
                   "lanes share when they share at least half, chosen on the device "
                   "(ops/moe.py); auto: on at >= 8 lanes; a bare flag means on")
    p.add_argument(
        "--weight-format", default="auto", choices=["auto", "q40", "q40i8", "q40i4", "dense"],
        help="q40: int8 values + f16 scales; q40i8: requantized to grouped int8 at load; "
        "q40i4: packed nibbles (0.5625 B/weight); auto: q40 on the card for a Q40 file",
    )
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=int(time.time()))
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r of a tp x sp run on cuda:r), cuda:N (every rank on card "
                   "N), or cpu")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ranks (default 0: as many as the host's cards and the "
                   "model allow; 1 on the CPU)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks: the KV cache's sequence axis shards over them "
                   "(ring prefill, merged-stats decode); ranks = tp x sp")
    p.add_argument("--workers", nargs="*", default=None,
                   help="alias for --tp: a rank count (host:port lists are a LAN-cluster "
                   "concept)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages: each holds nLayers/pp layers + that range's KV cache "
                   "— fits models past the tp <= nKvHeads ceiling; composes with --tp (stages "
                   "of tp groups; ranks = pp x tp), --dp, --sp and --batch-size lanes")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks: batch lanes shard across dp (requires batch-size "
                   "%% dp == 0); the throughput axis for pp")
    p.add_argument("--sync-measure", default="auto", choices=["auto", "off"],
                   help="accepted for parity with the JAX CLI and ignored: the port measures "
                   "each step's collectives as they run (parallel/collectives.STATS)")
    p.add_argument("--buffer-float-type", default="q80", choices=["q80", "f32"],
                   help="the tp all-reduce payload: q80 (int8 + a scale a 32-block) when the "
                   "ranks span hosts, exact f32 within one host")
    p.add_argument("--batch-size", type=int, default=1, dest="batch_size",
                   help="lanes: concurrent streams decoded together (the server's default 1 "
                   "serves one request at a time, with its NaiveCache)")
    p.add_argument("--kv-page-size", type=int, default=None,
                   help="rows a KV pool page holds (default: $DLLAMA_KV_PAGE_SIZE, else 16); "
                   "negative: lanes with no pool (no prefix reuse)")
    p.add_argument("--kv-pool-pages", type=int, default=None,
                   help="pool pages (default: $DLLAMA_KV_POOL_PAGES, else two sequences' worth, "
                   "2 * seq_len / page size + 1, for slab lanes and (batch-size + 2) sequences "
                   "+ the scratch page for pool-native lanes)")
    p.add_argument("--kv-native", type=int, default=None, choices=[0, 1], metavar="0|1",
                   help="1: pool-native lanes (KV in the pool through a page table; adoption "
                   "moves no bytes); 0: slab lanes (adopt and publish by copies) (default: "
                   "$DLLAMA_KV_NATIVE, else 0)")
    p.add_argument("--lane-block-size", "--lane-block", type=int, default=None,
                   dest="lane_block_size", help="decode steps a lane block runs (default 8)")
    p.add_argument("--admission-chunk", type=int, default=None,
                   help="prompt tokens prefilled a scheduler tick (default: the largest bucket)")
    p.add_argument("--chat-template", default=None, choices=sorted(CHAT_TEMPLATE_NAMES),
                   help="chat template of the server (default: detected from the tokenizer)")
    p.add_argument("--replica-id", default=None, dest="replica_id", metavar="NAME",
                   help="name the server as a fleet replica: reported in /v1/health and the "
                   "chaos plane's op filter, so 'sse_flush:op=r1:nth=3' targets one replica "
                   "(fleet/launch.py sets it)")
    p.add_argument("--admission-predict", action="store_true", default=None,
                   help="predictive admission: forecast each request's TTFT and TPOT from the "
                   "engine's step costs and the lanes' load, refuse deadline-hinted work that "
                   "cannot meet its budget before it queues, admit in EDF order and preempt "
                   "for deadlines (runtime/admission.py; default: $DLLAMA_ADMISSION_PREDICT, "
                   "else off)")
    p.add_argument("--admission-max-wait-ms", type=int, default=None,
                   help="cap on the predicted queue drain a Retry-After quotes (default: "
                   "$DLLAMA_ADMISSION_MAX_WAIT_MS, else 30000)")
    p.add_argument("--deadline-default-ms", type=int, default=None,
                   help="effective deadline of a request with no deadline_ms/ttft_budget_ms "
                   "hint, anchoring the EDF order (default: $DLLAMA_DEADLINE_DEFAULT_MS, "
                   "else 600000)")
    p.add_argument("--deadline-priority-step-ms", type=int, default=None,
                   help="deadline offset a priority rung for unhinted requests: high one step "
                   "earlier, low one step later (default: $DLLAMA_DEADLINE_PRIORITY_STEP_MS, "
                   "else 60000)")


def add_obs_args(p: argparse.ArgumentParser) -> None:
    """The observability flags the CLI and the server share (obs/)."""
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="append one JSON line a finished request or generation (request id, "
                   "queue wait, prefill, TTFT, token counts, finish reason) to PATH "
                   "(obs/trace.py)")
    p.add_argument("--timeline-out", default=None, metavar="PATH",
                   help="write the span timeline as Chrome-trace JSON to PATH (obs/spans.py; "
                   "the server rewrites it throttled a finished request, the CLI once at exit)")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="write the flight recorder's event ring as a JSON postmortem into DIR "
                   "when a dispatch or the scheduler loop raises (obs/recorder.py; default: "
                   "$DLLAMA_POSTMORTEM_DIR)")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dllama-tpu-torch", description="distributed-llama inference on PyTorch/CUDA"
    )
    p.add_argument("mode", choices=["inference", "chat", "perplexity", "worker"])
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run (CPU, and CUDA on the card) "
                   "as Chrome-trace JSON into DIR")
    add_engine_args(p)
    add_obs_args(p)
    return p


def _refuse_gpu_flags(args) -> None:
    """The reference's Vulkan device flags (dllama_tpu's ``_resolve_tp``
    refuses them the same way)."""
    for flag in ("gpu_index", "gpu_segments"):
        if getattr(args, flag, None) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is a Vulkan-backend option of the "
                             "reference; the port runs on one CUDA card: choose it with "
                             "--device (and CUDA_VISIBLE_DEVICES)")


def resolve_mesh_shape(args) -> tuple[int, int, int, int]:
    """(tp, sp, pp, dp) from ``--tp``/``--workers``/``--sp``/``--pp``/``--dp``,
    for every mode and the server alike, with the JAX CLI's rules: tp 0 is
    1 under ``--pp``, else `auto_tp` over the host's cards left once sp and
    dp have taken their share (1 without a card). A pp that does not divide
    the layers and a batch that dp does not divide are refused here, with
    the JAX engine's reasons, before any rank starts."""
    from .formats.model_file import read_llm_header
    from .parallel.mesh import validate_pp

    tp = getattr(args, "tp", 0) or 0
    workers = getattr(args, "workers", None)
    if not tp and workers:
        if len(workers) == 1 and workers[0].isdigit():
            tp = int(workers[0])
        else:
            print(f"⚠️  --workers host:port lists are a LAN-cluster concept; using "
                  f"tp={len(workers)} ranks instead")
            tp = len(workers)
    sp = getattr(args, "sp", 1) or 1
    pp = getattr(args, "pp", 1) or 1
    dp = getattr(args, "dp", 1) or 1
    batch = getattr(args, "batch_size", 1)
    if dp > 1 and batch % dp:
        raise SystemExit(f"batch_size {batch} must divide over dp={dp} lanes")
    if pp > 1:
        try:
            validate_pp(read_llm_header(args.model), pp)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if pp > 1 and not tp:
        tp = 1  # with --pp, tp scales explicitly (ranks = pp x tp)
    if not tp:
        from .parallel.mesh import auto_tp

        # the JAX CLI's rule: the cards left for tp once sp and dp have
        # taken their share
        cards = max(torch.cuda.device_count(), 1) // (sp * dp)
        tp = 1 if str(args.device) == "cpu" else auto_tp(args.model, max(cards, 1))
    return tp, sp, pp, dp


def _rank_mesh(args, tp: int, sp: int, pp: int, dp: int):
    """This process's Mesh under world > 1: a rank that parallel/launch.py
    started (its process group is up), or a torchrun process."""
    import torch.distributed as dist

    from .parallel.mesh import init_distributed, make_mesh

    if dist.is_initialized():
        return make_mesh(tp, sp, torch.device(args.device), dist.get_backend(), pp=pp, dp=dp)
    return init_distributed(tp, sp, args.device, pp=pp, dp=dp)


def load_engine(args):
    """The engine and tokenizer of ``args`` on this rank (the CLI's and the
    server's)."""
    from .runtime.engine import InferenceEngine
    from .tokenizer import Tokenizer

    _refuse_gpu_flags(args)
    tok = Tokenizer(args.tokenizer)
    tp, sp, pp, dp = resolve_mesh_shape(args)
    mesh = _rank_mesh(args, tp, sp, pp, dp) if tp * sp * pp * dp > 1 else None
    from .parallel.mesh import spans_hosts

    engine = InferenceEngine(
        args.model,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        max_seq_len=args.max_seq_len,
        temperature=args.temperature,
        topp=args.topp,
        seed=args.seed,
        weight_format=args.weight_format,
        batch_size=args.batch_size,
        kv_dtype=args.kv_dtype,
        prefill_buckets=tuple(sorted({1, args.nbatches, 512})),
        moe_decode_dedup={"on": True, "off": False}.get(args.moe_decode_dedup, "auto"),
        tp=tp, sp=sp, pp=pp, dp=dp, mesh=mesh,
        device=mesh.device if mesh is not None else args.device,
        buffer_float_type=(getattr(args, "buffer_float_type", "f32") if spans_hosts()
                           else "f32"),
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
    if engine.batch_size > 1:
        print(f"💡 Lanes: {engine.batch_size}")
    if mesh is not None:
        print(f"💡 Tp: {tp} rank(s) [{mesh.backend}]")
        print(f"💡 Sp: {sp} sequence shard(s)")
        if dp > 1:
            print(f"💡 Dp: {dp} lane shards")
        if pp > 1:
            print(f"💡 Pp: {pp} pipeline stages")
    dev = engine.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"💡 Device: {dev} ({name})")
    print(f"💡 WeightFormat: {engine.weight_format}")
    if engine.kv_dtype != engine.dtype:
        print(f"💡 KvDtype: {str(engine.kv_dtype).removeprefix('torch.')}")
    if engine.i8_group:
        print(f"💡 Int8Group: {engine.i8_group}")
    if tok.vocab_size != h.vocab_size:
        print(
            f"⚠️  tokenizer vocab ({tok.vocab_size}) != model vocab ({h.vocab_size}); "
            "decoding may fail for out-of-range tokens"
        )
    from .obs.cost import print_roofline_report
    from .obs.device import compare_with_analytic, memory_report, sample_device_memory
    from .obs.recorder import get_recorder

    mem = memory_report(engine)
    if mesh is not None:  # the JAX CLI's report, from this rank's slices
        from .utils.telemetry import memory_report as mesh_memory_report

        mesh_memory_report(engine.params, engine.cache, tp, sp, pp, dp).print()
    else:
        mem.print()
    # the analytic decode floor beside the memory report: what "as fast as
    # the card allows" means in ms/token for this model and format (a rank's
    # params are its slices: the bytes a rank reads)
    print_roofline_report(h, engine.weight_format, i8_group=engine.i8_group or 512,
                          params=engine.params, dtype_bytes=engine.dtype.itemsize, device=dev)
    # the card's allocator against the analytic figure: a gap past 10% logs
    # a warning (a leak, or an analytic model gone stale)
    compare_with_analytic(mem.per_device_bytes, sample_device_memory(engine.obs, dev))
    if getattr(args, "postmortem_dir", None):
        get_recorder().postmortem_dir = args.postmortem_dir
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
    if engine.world > 1:
        return _run_inference_ranks(args, engine, tok, tokens, load_s)
    from .obs.spans import get_span_tracker
    from .obs.trace import NULL_SPAN, Tracer

    # one JSON line for the whole generation, the server's --trace-out
    # schema (obs/trace.py), and its request-attributed timeline span
    trace_out = getattr(args, "trace_out", None)
    tracer = Tracer(sink_path=trace_out) if trace_out else None
    span = tracer.span(path="cli") if tracer is not None else NULL_SPAN
    span.mark_admitted()
    spans = get_span_tracker()
    gen_span = spans.begin("generate", component="cli", request_id=span.request_id,
                           n_prompt=len(tokens), steps=args.steps)
    print(args.prompt)
    tok.reset_decoder()

    def on_token(t: int) -> None:
        span.mark_first_token()  # single-shot
        piece = tok.decode(t)
        if piece is not None:
            sys.stdout.write(piece)
            sys.stdout.flush()

    with _profiled(getattr(args, "profile", None), engine.device):
        out, eval_stats, pred_stats = engine.generate(tokens, max_steps=args.steps,
                                                      on_token=on_token)
    engine.settle_costs()
    span.set_prefill_seconds(eval_stats.time_ms / 1000.0)
    spans.end(gen_span, n_completion=len(out))
    span.finish("length", n_prompt=len(tokens), n_completion=len(out))
    if tracer is not None:
        tracer.close()
    if getattr(args, "timeline_out", None):
        n_spans = spans.export_file(args.timeline_out)
        print(f"🧭 timeline: {n_spans} spans -> {args.timeline_out}")
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


def _run_inference_ranks(args, engine, tok, tokens: list[int], load_s: float) -> dict:
    """`run_inference` on a rank of a multi-rank run, printed as the JAX CLI
    prints a multi-chip run: the prefill's Eval line and one Pred line a
    decoded token (decode_step), each with its Sync ms (the host ms of the
    step's collectives, parallel/collectives.STATS) and Sent/Recv kB (the
    analytic traffic, `utils.telemetry.ici_traffic_per_token`)."""
    from .parallel.collectives import STATS
    from .utils.telemetry import ici_traffic_per_token as ici

    act_bytes = 1.125 if engine.sync_quant else 4.0
    # the pipeline's hand-offs move the model's activation type, uncompressed
    kw = dict(activation_bytes=act_bytes, pp=engine.pp,
              pp_activation_bytes=float(engine.dtype.itemsize))
    per_tok = ici(engine.header, engine.tp, include_logits=False, **kw)
    logits_bytes = ici(engine.header, engine.tp, **kw) - per_tok
    print(args.prompt)
    STATS.reset()
    eval_stats = engine.prefill(tokens)
    eval_kb = (per_tok * max(eval_stats.n_tokens, 1) + logits_bytes) // 1024
    print(f"🔷️ Eval{eval_stats.time_ms:5.0f} ms Sync{STATS.seconds * 1000:5.1f} ms | "
          f"Sent{eval_kb:6d} kB Recv{eval_kb:6d} kB | ({eval_stats.n_tokens} tokens)")
    tok.reset_decoder()
    pos = len(tokens) - 1
    token = tokens[-1]
    max_pos = min(engine.header.seq_len, args.steps)
    pred_ms, out = 0.0, []
    step_kb = (per_tok + logits_bytes) // 1024
    while pos < max_pos:
        STATS.reset()
        token, stats = engine.decode_step(token, pos)
        pos += 1
        pred_ms += stats.time_ms
        out.append(token)
        piece = tok.decode(token)
        print(f"🔶 Pred{stats.time_ms:5.0f} ms Sync{STATS.seconds * 1000:5.1f} ms | "
              f"Sent{step_kb:6d} kB Recv{step_kb:6d} kB | "
              f"{piece if piece is not None else chr(126)}")
        sys.stdout.flush()
    n_eval = max(len(tokens) - 1, 1)
    print()
    print("Evaluation")
    print(f"   nBatches: {args.nbatches}")
    print(f"    nTokens: {n_eval}")
    print(f"   tokens/s: {n_eval * 1000 / max(eval_stats.time_ms, 1e-9):3.2f} "
          f"({eval_stats.time_ms / n_eval:3.2f} ms/tok)")
    print("Prediction")
    print(f"    nTokens: {len(out)}")
    if out:
        print(f"   tokens/s: {len(out) * 1000 / max(pred_ms, 1e-9):3.2f} "
              f"({pred_ms / len(out):3.2f} ms/tok)")
    return {"engine": engine, "prompt_tokens": tokens, "tokens": out, "load_s": load_s,
            "eval": eval_stats}


@contextlib.contextmanager
def _profiled(out_dir: str | None, device):
    """A ``torch.profiler`` trace of the body (CPU activity, and CUDA on
    the card) written as ``trace.json`` into ``out_dir``; nothing when
    ``out_dir`` is None."""
    if not out_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"🔬 profile: {path}")


def run_chat(args):
    """Interactive REPL on stdin (reference: dllama.cpp:174-258; dllama_tpu's
    ``run_chat``): each user turn through the chat template, the reply
    streamed until an EOS token or stop string, an explicit stop when the
    context is full, and a fresh conversation after a failed generation.
    Under world > 1 rank 0 reads stdin and runs the loop, and the other
    ranks follow its dispatches (parallel/control.py)."""
    from .parallel.control import lead_or_follow

    engine, tok = load_engine(args)
    ctl = lead_or_follow(engine)
    if isinstance(ctl, dict):  # a follower rank, after rank 0's stop
        return ctl
    try:
        return _chat_loop(args, engine, tok)
    finally:
        if ctl is not None:
            ctl.stop()


def _chat_loop(args, engine, tok) -> None:
    """`run_chat`'s loop on rank 0 (or the one rank)."""
    from .tokenizer import (
        CHAT_TEMPLATE_NAMES, ChatItem, ChatTemplateGenerator, ChatTemplateType, EosDetector,
        EosResult,
    )

    stops = [tok.vocab[t].decode("utf-8", "replace") for t in tok.eos_token_ids]
    ttype = (CHAT_TEMPLATE_NAMES[args.chat_template] if args.chat_template
             else ChatTemplateType.UNKNOWN)
    gen = ChatTemplateGenerator(ttype, tok.chat_template, stops[0] if stops else "")
    pos = 0
    is_start = True
    print("💬 Chat mode. Type your message (Ctrl-D to exit).")
    while True:
        try:
            user = input("\n👱 You: ")
        except EOFError:
            break
        if not user.strip():
            continue
        chat = gen.generate([ChatItem("user", user)], append_generation_prompt=True)
        tokens = tok.encode(chat.content, is_start=is_start, add_special_tokens=True)
        is_start = False
        if pos + len(tokens) >= engine.header.seq_len:
            print(f"\n🚫 Context window full ({engine.header.seq_len} tokens); "
                  "restart the chat to continue.")
            break
        detector = EosDetector(tok.eos_token_ids, stops, padding_left=2, padding_right=2)
        print("\n🤖 Assistant: ", end="", flush=True)
        tok.reset_decoder()

        def on_token(t: int):
            res = detector.append(t, tok.decode(t))
            if res in (EosResult.NOT_EOS, EosResult.EOS):
                delta = detector.get_delta()
                if delta:
                    print(delta, end="", flush=True)
                if res == EosResult.EOS:
                    return False
                detector.reset()
            return True

        try:
            out, _, _ = engine.generate(tokens, max_steps=engine.header.seq_len - 1 - pos,
                                        on_token=on_token, start_pos=pos)
        except KeyboardInterrupt:
            raise
        except Exception as e:
            # the cache holds a partial turn: start the conversation afresh
            print(f"\n🚫 Generation failed ({e}); conversation reset.")
            engine.reset()
            pos, is_start = 0, True
            continue
        pos += len(tokens) - 1 + len(out)
        print()


def run_perplexity(args) -> None:
    """Teacher-forced NLL over the prompt (`InferenceEngine.perplexity`: one
    scalar a chunk), printed as dllama_tpu's ``run_perplexity`` prints it."""
    engine, tok = load_engine(args)
    if args.prompt is None:
        raise SystemExit("Prompt is required")
    tokens = tok.encode(args.prompt, is_start=True, add_special_tokens=True)
    if len(tokens) < 2:
        raise SystemExit("Prompt too short for perplexity")
    nll, ppl, n_scored = engine.perplexity(tokens)
    print(f"    nTokens: {len(tokens)}")
    print(f"    nScored: {n_scored}")
    print(f"        nll: {nll:.4f}")
    print(f" perplexity: {ppl:.4f}")


def _spawn_ranks(argv: list[str], args, tp: int, sp: int, pp: int, dp: int):
    """Start the ranks of this command (parallel/launch.py) and return rank
    0's summary; rank 0 prints."""
    from .parallel.launch import cli_target, spawn
    from .parallel.mesh import pick_backend, shape_str

    world = tp * sp * pp * dp
    backend = pick_backend(args.device, world)
    print(f"🔗 Ranks: {world} ({shape_str(tp, sp, pp, dp)}), backend {backend}, device "
          f"{args.device}", flush=True)
    return spawn(cli_target, world, args.device, backend, args=(list(argv),),
                 timeout_s=24 * 3600.0)[0]


def main(argv=None):
    # the worker mode explains itself before the other flags are required
    mode = argparse.ArgumentParser(add_help=False)
    mode.add_argument("mode", nargs="?")
    if mode.parse_known_args(argv)[0].mode == "worker":
        raise SystemExit(
            "worker mode is a LAN-cluster concept of the reference: as in the JAX package's "
            "SPMD launch, one identical program runs on every rank (the command starts its "
            "ranks, or torchrun does) — run the root command with --tp N instead")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _build_parser().parse_args(argv)
    tp, sp, pp, dp = resolve_mesh_shape(args)
    if tp * sp * pp * dp > 1:
        import torch.distributed as dist

        from .parallel.mesh import torchrun_env

        if not dist.is_initialized() and not torchrun_env():
            if args.mode == "chat":  # this process is rank 0: it reads stdin
                from .parallel.launch import lead_command

                return lead_command(lambda: run_chat(args), "cli", argv, args.device, tp, sp,
                                    pp, dp)
            return _spawn_ranks(argv, args, tp, sp, pp, dp)
        rank = dist.get_rank() if dist.is_initialized() else int(os.environ["RANK"])
        if rank != 0:  # rank 0 alone prints
            with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
                return _run_mode(args)
    return _run_mode(args)


def _run_mode(args):
    if args.mode == "inference":
        return run_inference(args)
    if args.mode == "chat":
        return run_chat(args)
    return run_perplexity(args)


if __name__ == "__main__":
    main()
