#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each fatal on failure (a non-zero exit and no result line):

1. The card (``nvidia-smi`` name and power limit, torch's device name) and
   the build of the seven CUDA sources from csrc/ (one nvcc each, in
   parallel), with its seconds, and each source's ptxas registers, static
   shared memory and spills (a line a kernel, with ptxas's warnings, for
   the two Q40 sources, the int8 source, the two attention sources and the
   two MoE sources).
2. Each kernel against its plain PyTorch version on the card at main-path
   shapes: Llama-8B (D 4096, F 14336, 32 heads, 8 KV heads, head dim 128,
   vocab 128256) for the three matmul kernels (Q40, packed nibbles, grouped
   int8 at G 512, and at Qwen3-30B-A3B's G 256) and attention; the three
   matmul kernels also at the tiles' other prefill buckets (m = 32, 128),
   a ragged m = 100, and Qwen3-30B-A3B's attention projections at m = 512
   (k 2048 n 4096, k 2048 n 512, k 4096 n 2048), the int8 one at m = 1
   there too; the GEMVs also at m = 4 (the serving lanes) and m = 8, at
   w1's shape (and the Q40 ones at the classifier's), and the int8 GEMV
   untimed at its edges (`I8_EDGE`: n = 200, every m from 1 to 8); attention
   again at Qwen3-30B-A3B's 4 KV heads and at head dim 64 (decode at pos 0,
   511, 563 and 4095; every attention kernel launched twice on the same
   inputs must repeat its bits), attention's edge shapes (a ragged T = 100
   with a parked lane, decode with a parked lane, 32 heads on one KV head:
   `check_attention_edges`), and the four MoE kernels at A3B's
   D 2048, F 768, 128 experts, 8 active, with random routing (the active
   ones also at m = 4, the grouped Q40 one also with every token on the
   same 8 experts, and all four at an edge shape, `MOE_EDGE`; each launched
   twice and required to repeat its bits: `check_moe`). Each row: max
   normalized error max|k - p| / max|p|, kernel ms, plain ms, the bound
   (bytes over 3.35 TB/s or operations over the H100 SXM datasheet peak of
   their type) and one PyTorch library call's ms as a yardstick
   (torch.matmul on the dequantized weight, scaled_dot_product_attention;
   none for the MoE kernels: no single PyTorch call computes a routed
   SwiGLU MoE). The packed-nibble rows must also give the bits of the Q40
   kernel on the unpacked twin (the same code but for the weight fetch),
   and the int8 rows the bits of their plain version; the int8 rows at
   m = 512 also time ``torch._int_mm`` (cuBLASLt's int8 product, no group
   scales). The rows of the int8 GEMV and the MoE kernels also read
   `time_clean` (the L2 left clean) beside `time_ms` (the L2 flushed by a
   memset, whose dirty lines a byte-bound kernel writes back in its time).
   The int8 KV cache's instantiations of both attention kernels
   (`check_kv8`: QuantKV leaves of int8 values and f32 row scales, the
   kernels' ``*_kv8`` counters): prefill stats at H 32 over KH 8 (hd 128
   and 64, bf16 and f32) and KH 4 (bf16), T 512 over S 4096 at pos 3584
   and S 512 at pos 0; slab decode at pos 0, 563, 4095 (4095 only for the
   other shapes); paged decode at B 4, pos 0, 15, 16, 4095, and the paged
   stats at T 128, KH 8 in bf16 and f32 and KH 4 in bf16, through a
   shuffled table and with the identity table's bits equal to the slab
   entries'; a parked lane in stats and in both decodes; 32 query heads a KV head. Each within TOL
   (f32 outputs) or TOL_BF16_OUT (bf16) of its plain version (the cache
   dequantized in f32), equal bits on two runs, its launches counted under
   its ``*_kv8`` counter; ``ms``, ``ms_clean``, ``plain_ms``, the bound of
   the int8 bytes, ``library_ms`` none (no single PyTorch call attends over
   int8 K/V) and ``composite_ms``, the dequantization then SDPA (two calls).
   The shapes of a speculative verify pass (`check_verify_stats`): the
   paged stats kernel at B 4 live lanes (pos 0, 15, 16, 4090) and one
   parked at -T, T 2, 3 and 5, bf16, f32 and an int8 pool, each twice with
   equal bits, within TOL on the live lanes, the parked lane's state empty,
   the identity table's bits equal to the slab entry's, timed beside SDPA on
   the gathered view; and the Q40 tile at a verify pass's m = 12 and 20.
3. End to end, seven runs on three random Q40 ``.m`` files (max_seq_len
   4096; each with a padded byte-level ``.t``, written with the port's
   writers to a temp dir of its own, deleted before the next), each the
   port's ``inference`` CLI path: a ~500-token prompt and 128 greedy
   tokens, every forward a CUDA graph (each shape eager on its first use,
   then captured and replayed: `dllama_tpu_torch/runtime/graphs.py`).
   llama-8b (`N_LAYERS`, 32 layers) with ``--weight-format q40`` (also with
   ``--kv-dtype int8``), ``q40i4`` and ``q40i8``; qwen3-30b-a3b (`MOE_LAYERS`,
   8 of 48 layers) with ``auto`` (Q40 on the card) and ``q40i8`` (experts stay
   Q40); qwen3-30b-a3b at 4 layers with ``dense`` (bf16 experts: full
   depth would be 60 GB of them). Load s, prefill ms,
   decode ms/token and tok/s, each kernel's launches in that run (the
   path's kernels must be > 0, and all equal what the shapes imply; a
   replay counts its graph's captured tally), the
   weight-read bound per token, the weight bytes and
   ``torch.cuda.memory_allocated`` on the card. Then graphs against the
   eager path on the same engine (`graphs_vs_eager`): a second
   ``generate`` with ``cuda_graphs=False`` must give the same greedy
   stream and launch counts; `HOST_RUNS` runs a side, in turns, of the
   prompt's 512-row prefill chunk and `HOST_BLOCKS` decode blocks (host ms,
   graph replays a token), and a device profile of each side (device ms
   and kernel launches a token or chunk, busy share, the grouped MoE
   kernels' share of a prefill chunk; decode profiles for the quantized
   runs). On llama-8b q40 a sampled stream (temperature 0.8, top-p 0.9, a
   fixed seed) must repeat on two graphed runs and equal the eager one; on
   llama-8b q40 and qwen3-30b-a3b q40 the engine's ``perplexity`` of the
   prompt must give the same bits graphed and eager. Whether the q40i4 and
   q40i8 greedy streams equal the q40 one is printed, not gated. After the
   llama-8b runs, on the same file, the serving phase (`serving`): the
   port's lane server in process, 4 lanes over the paged pool, every
   lane-prefill bucket and both lane decode blocks captured before the
   first request (`rehearse_admission`: graph count, seconds and pool
   bytes printed), seven greedy requests (four at once, three
   queued; two share a page-aligned 256-token prefix, one diverges
   mid-page; one repetitive), each replayed alone; TTFT and decode
   ms/token per request,
   aggregate decode tok/s against the single-stream q40 run, pool pages,
   radix hits and COW forks, with gates on all of it (see `serving`), and
   a 4-lane decode step's host ms, graphed and eager in turns. Then the
   speculation round on the same engine (`serving_spec`: ``speculation
   shared``, spec_k 4, the same requests, each equal to its solo replay,
   >= 1 verify pass, the stats kernel n_layers times a verify pass and a
   prefill chunk; acceptance, tokens a pass, lane tok/s against the
   spec-off round, where each answer parts from its spec-off answer, and
   a verify pass's graphed host ms at T 2, 3 and 5 against a decode step,
   with a device profile of the T = 5 pass). The serving
   phase runs once more on an int8 pool (``kv_dtype="int8"``, the same
   1,537 pages; its bytes and /v1/health's page bytes printed), with the
   same gates on the int8 kernels' launches and answers. The resilience
   round (`serving_resilience`) serves the seven requests again on the
   serving engine under the chaos plane: fault-free, transient faults,
   a decode poison, an admission poison, park/resume at max_streams 7,
   and a drain; no graph captured and the pool in place throughout, each
   resumed stream's K/V rows held to its rows before; on the int8 pool
   fault-free and the decode poison; and on an f32 engine over the
   `PAR_LAYERS`-layer file (`resilience_f32`) fault-free, both poisons and park/resume, every
   answer equal to the fault-free one; each resilience round's registry
   deltas (retries, recovered lanes, injected faults by site) equal its
   /v1/health deltas. The observability round (`serving_obs`) serves the
   seven requests again with ``/metrics`` scraped before and after: every
   line parses, the request, TTFT, TPOT and decode_lanes step counts move
   as the round's own tallies say, the decode_lanes and prefill_lane_chunk
   roofline fractions lie in (0, 1.05], ``/v1/debug/memory`` reads within
   10% of the engine's analytic memory, the timelines hold each request's
   spans; then the mix with the registry off and on in turns (lane tok/s
   printed), and the mix once more with a 1 s ``POST /v1/debug/profile``
   whose trace must name the Q40 GEMV and the paged decode kernel and link
   launches to their kernels, all
   inside the watchdog's gate (no stall over the fault-free rounds; the
   profiler's stop is a pause the server declares). The admission round
   (`serving_admission`) serves the mix with predictive admission off and
   on in turns (every answer equal), prints the load predictor's
   calibration (its forecast errors gated finite and counted, its step
   costs the engine's device seconds, its TTFT correction off its clamp),
   refuses a
   ``ttft_budget_ms: 1`` request as ``infeasible`` with a Retry-After that
   does not fall when the queue is 3 deeper, and preempts one of four
   ``low`` streams for a ``high`` request whose deadline the forecasts
   bracket (`admission_preemption`: one preemption, the victim resumed;
   answers equal in f32 on the resilience f32 engine). Each CLI run prints
   its decode_block roofline fraction from the registry (gated to (0,
   1.05] too).
   llama-8b also runs ``q40`` with ``--kv-dtype int8`` (``q40 kv-int8``):
   the same gates, launches under the ``*_kv8`` counters, the cache's bytes
   against a bf16 cache's, and where its greedy stream leaves the bf16-KV
   q40 stream (printed, not gated).
4. End-to-end parity for each path: one prefill and one decode step
   through the kernel path and through the plain path (``forward(...,
   plain=True)``) on the same weights: logits' normalized error and top-1
   agreement, and for Qwen3-MoE how many (layer, token) top-k expert sets
   the two paths chose differently. The float32 comparison is the gate; the
   bfloat16 ones are printed beside it. The float32 kernel path again as
   CUDA graph replays must give its eager logits' bits (`graphed_logits`;
   the dense run's cuBLAS products included), and the prompt's NLL from
   the float32 prefill's logits, kernel path against plain path, must lie
   within `nll_tolerance` of each other (printed, not gated, for q40i8,
   whose all-plain pair differs by design). For q40i8 the gated plain run takes
   the kernel run's int8 activations, and the inputs of its int8 matmuls
   are gated too (see `parity`). For the serving phase, pool-native lanes
   against the slab path and the paged path's kernels against its plain
   versions, f32 (`lane_parity`; int8 caches and pool for the int8 pass),
   and verify against stepwise decode at 4 layers in f32 (`spec_parity`:
   the verify grid equal to stepwise greedy decode, verify-row logits within
   TOL_E2E of the decode steps').
   An int8-KV run holds every cache of its parity runs in int8.
   This slice's paths (all at full width): the mixed-type attention
   entries' rows (`check_mixed`: decode for (q, cache) in (f32, bf16), (f32,
   f16), (bf16, f16), (bf16, f32), slab and paged, identity-table bits; the
   prefill stats' one tensor-core body for those pairs and f32 over f32 and
   over int8, slab on random and adversarial inputs, paged with the identity
   table's bits, strided, with the passes each pair takes) and the two-tier MoE decode's rows (`check_moe_tiers`: 4 lanes,
   k 8, cap 16, u 8 on the grouped tier and u 32 on the active one); the
   draft rounds once the parallel rounds' worlds have started
   (`serving_draft`: llama-8b q40 at `PAR_LAYERS` layers
   with a llama-1b draft, off and draft in turns; an f32 `ACCEPT_LAYERS`-layer target as
   its own draft, accepted drafts, answers equal to spec-off's, a failed
   draft step resetting only the draft cache); the mixed-KV runs on the
   llama-8b file (`mixed_kv`: an f32 engine over a bf16 cache with its
   kernel-vs-plain parity, a bf16 engine over an f16 cache, single stream
   and 4 native lanes); and on the qwen3-30b-a3b q40 file the dedup
   round (`moe_dedup`: identical prompts on the grouped tier at every
   layer-step, distinct prompts' share, dedup-on streams equal dedup-off's
   in f32, a decode step's device ms on against off in turns). Every CLI
   run's prefill buckets must be (1, 32, 512) (`--nbatches` 32). The
   replica fleet (`serving_fleet`, after the mixed-KV runs, on the same
   file): two bf16 replicas of 4 slab lanes behind the router, the mix
   equal to the serving round's solo replays, affinity, a bf16 failover,
   the router's re-export, fleet timeline and drain; three f32 `ACCEPT_LAYERS`-layer
   replicas, pool-native, a byte-identical failover and a chaos mix; and
   ``python -m dllama_tpu_torch.fleet.launch`` with two replica processes. Depth cuts
   for the time (PR 18): llama-8b ``q40 kv-int8``, ``q40i4`` and ``q40i8``
   at `CUT_LAYERS` (4) of 32 layers, qwen3-30b-a3b ``q40i8`` on
   the 4-layer file; qwen3-30b-a3b ``q40`` and its dedup round at
   `MOE_LAYERS` (8 of 48, for the parallel rounds' time); each
   path's seconds are printed; a child process writes
   those files (`start_prewrite`) while the card runs the llama-8b paths,
   and another, from the start, the whole llama-8b file and the smaller
   files of the rounds after it while the kernels build and run. Each
   phase's seconds also go to stderr with the seconds since the start
   (`mark`), and every background world and CLI run is stopped at
   `DEADLINE_S` at the latest, so a stopped or hung run names its phase.
   The parallel round (`parallel_round`, on the llama-8b files kept for
   it, started after the fleet: its one-rank references there, its worlds
   and CLI runs on background threads, `Worker`, while the draft round and
   the smaller paths above run, its checks once they end): tensor and sequence parallelism, the ranks
   (parallel/launch.py) sharing the one card over gloo (NCCL runs no two
   ranks on one device). Phase 2 adds the two kernel options of sequence
   parallelism at llama-8b's tp 2 x sp 2 shard shapes (H 16, KH 4, a
   2048-row cyclic shard): the stats kernel with ``s_stride`` 2 and 4 at T
   256, 1, 3 and 5 (`check_attention_strided`) and the decode kernel
   emitting its state (`check_decode_stats`: s_pos0 0 and 1, stride 2, a
   shard wholly in the future), bf16 and f32, and the Q40 kernel at the tp
   = 2 slices of llama-8b's weights (`check_q40_tp`); and the kernels of
   serving at the lane shard shapes (`check_lane_shards`: the paged decode
   and the paged verify stats at tp = 2 heads, the slab decode at KH 4
   with a parked lane, the decode stats over an sp = 2 shard of the lanes'
   slab with a parked lane, the Q40 GEMV at m = 4 on the tp = 2 slices).
   Both strided entries run again over an int8 shard (their ``_q8``
   instantiations, counted under ``*_kv8``, ``composite_ms`` the
   dequantization then SDPA under the strided mask), and the MoE kernels
   on a tp rank's expert slices of qwen3-30b-a3b (`check_moe_tp`: F/tp 384
   and 192, the active kernel at m 1, the grouped one at N 512, the
   two-tier decode at 4 lanes, Q40 and dense bf16), and the kernels of a
   pipeline stage at the waves' shapes (`check_pp_waves`: the Q40 tile at
   m 64, the prefill stats at T 64, the grouped Q40 experts at N 64). The
   attention sources must build with 0 B of spill stores.
   The one-rank references run first (and the f32 servers' and the chat's
   answers at tp = 1), then one spawned world of 2 ranks takes every
   2-rank job in turn on one thread, and on the other the three CLI runs
   at once, then one world of 4 the 2 x 2 jobs. (b) llama-8b q40
   bf16, `PAR_LAYERS` layers, tp = 2: each rank holds half of the layer bytes, and
   the first decode step's logits after a 512-row chunk lie within
   `TOL_TP_BF16` of one rank's (where the greedy streams part is printed);
   (c) the `ACCEPT_LAYERS`-layer llama-8b file in f32, sp = 2 (2 ranks) and tp 2 x sp 2
   (4 ranks): the greedy streams equal one rank's, the logits within
   `TOL_TP_F32`, the strided and decode-stats entries launched on every
   rank; (d) tp = 2 with the q80 sync buffer: an all-reduce within
   `Q80_BOUND` of the exact sum, the logits' error printed; (e) ``python
   -m dllama_tpu_torch inference --tp 2 --device cuda:0``: exit 0, the
   backend line naming gloo, rank 0's lines; (f) each rank's decode token:
   device ms, its collectives' host ms and bytes against
   ``ici_traffic_per_token``, its launches; (g) serving at tp = 2 on the
   `PAR_LAYERS`-layer bf16 file (parallel/launch.serve_target: rank 0 serves the
   seven-request mix over 4 pool-native lanes and controls, the other rank
   follows, parallel/control.py): every request completes, every rank's
   control digest and kernel launches equal rank 0's, each rank's pool
   holds half the KV heads (half of tp = 1's page bytes); where each answer
   parts from the serving phase's tp = 1 answer and the lane tok/s are
   printed, not gated; (h) the `ACCEPT_LAYERS`-layer file in f32: native lanes at tp 2,
   slab lanes at sp 2 and tp 2 x sp 2, n-gram and draft speculation, an
   int8 pool and the serialized server at tp 2, and a decode poison at tp
   2 (``cache_epoch`` 1 on every rank): every answer byte-equal to the tp =
   1 server's, and the int8 mix at sp 2 over slab lanes byte-equal to the
   one-rank int8 slab server's; ``chat --tp 2`` on stdin prints the
   one-rank chat's transcript; (j) qwen3-30b-a3b q40 at full width on a
   `PP_MOE_LAYERS`-layer file: bf16 at tp 2 (a rank's expert bytes exactly half of one
   rank's, the first decode step's logits within `TOL_TP_BF16`, the stream
   printed) and f32 at tp 2, sp 2 and tp 2 x pp 2, and the `ACCEPT_LAYERS`-layer
   llama-8b file with an int8 cache at sp 2 and tp 2 x sp 2 in f32: streams
   equal to one rank's, logits within `TOL_PAR_F32` (`TOL_TP_F32` over the
   int8 cache), both MoE kernels or both int8 strided entries launched on
   every rank. The pipeline round (`pipeline_round`, started after it, its
   worlds on the second thread, on the same files and its one-rank
   references, `PAR_REFS`): (i) llama-8b q40 bf16
   at full width and `PAR_LAYERS` layers, pp = 2 (each rank holds half the layers' bytes,
   exactly half), the first decode step's logits within `TOL_TP_BF16` of
   one rank's and where the greedy streams part printed (bit-equal logits
   said so); (ii) the `ACCEPT_LAYERS`-layer f32 file at pp 2, pp 2 x dp 2, pp 2 x tp 2 and
   pp 2 x sp 2 (tokens equal one rank's, logits within `TOL_TP_F32`),
   ``generate_batch`` of two prompts at pp 2 x dp 2, perplexity at pp 2;
   (iii) servers of the f32 mix, byte-equal to the tp = 1 server's: pp 2
   over slab lanes, dp 2 over pool-native lanes (a prefix page one dp group
   wrote read by a lane of the other: ``kv_cross_dp_pages``), pp 2 x dp 2
   over slab lanes; (iv) qwen3-30b-a3b q40 at full width, `PP_MOE_LAYERS` of 48 layers,
   pp = 2 in f32: its stream equals one rank's, both MoE kernels launched
   on both ranks; (v) ``python -m dllama_tpu_torch inference --pp 2
   --device cuda:0``: exit 0, its ``Pp`` line; (vi) each rank's decode
   token: device ms, its hand-offs' host ms and bytes against
   ``ici_traffic_per_token`` at pp = 2, its launches.
The captured-graph lint runs through all of it: ``DLLAMA_XLALINT=strict``
is set before the first engine, so every graph any phase captures is read
and linted as it lands (analysis/graphlint.py) and a new finding fails
that phase. After phase 2, `graph_lint_faults` plants one fault a graph
rule on a small bf16 engine (a copy into pinned host memory, a clone of a
KV plane, a kernel-made copy of one kept past the capture, an f32
``torch.matmul`` on a bf16 weight, a step over its launch budget), and
each must raise naming its rule and its finding; after each path's runs, the
serving rounds and the draft round, `graph_lint` prints every key's census
(``graphlint`` lines: nodes by kind, kernel nodes a token, the launch
budget, the seconds reading and linting added to its capture) and
requires zero new findings.
5. A ``{"kernels": [...]}`` JSON line, the int8-KV entries
   (``flash_attention_stats_kv8``, ``flash_decode_kv8``,
   ``paged_flash_decode_kv8``, whose ``replaces`` names the TPU kernel's
   QuantKV branch or the JAX route) and the mixed-type entries
   (``*_mixed``, whose ``replaces`` names the TPU kernels' upcast) with
   ``composite_ms`` beside the contract's keys; last, the device JSON line.

Imports nothing of JAX or dllama_tpu.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections.abc import Callable

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
BF16_FLOPS = 989e12  # H100 SXM datasheet, dense
F32_FLOPS = 67e12  # H100 SXM datasheet, outside the tensor cores
INT8_OPS = 1979e12  # H100 SXM datasheet, dense
# normalized error of kernels with f32 outputs from f32 inputs, or from
# bf16 inputs where no bf16 rounding follows a sum: kernel and plain version
# share every rounding and differ in sum order only. The largest reading on
# an H100 was 2.1e-5 (q40_matmul bf16 m=512 k=14336, the tensor-core tile:
# its k16 sums run in another order than the plain matmul's over 14336
# terms; 5.6e-6 on the f32-FMA tile); a kernel that kept the dequantized
# weight in f32 where the plain version rounds it to bf16 reads ~1e-3
TOL = 1e-4
TOL_BF16_OUT = 2.0**-7  # bf16 outputs: one rounding step
# the MoE kernels' bf16 runs, whose f32 outputs follow a bf16 rounding of
# the SwiGLU hidden after a sum whose order differs: a few hidden units flip
# by one bf16 step. Set between the largest sound reading and what a kernel
# that skips a bf16 rounding reads (check_moe prints and gates both; the
# readings are in PERF.md)
TOL_MOE_BF16 = 5e-4
TOL_E2E = 2e-2  # f32 logits after the whole model (and q40i8's int8 inputs), kernel vs plain path
# a resumed stream's re-prefilled K/V rows against its rows before the
# fault or the park (`serving_resilience`), by the pool's type: f32 is held
# like f32 logits after the whole model; bf16 rows (and int8 ones, rounded
# from bf16) re-made by other kernels through 32 bf16 layers are held an
# order above one rounding step, as far as the model's bf16 logits move
# between two kernel paths (the bf16 parity lines: 4-6e-2), where a lost,
# zeroed or misplaced row reads ~1
TOL_KV_RESUME = {"torch.float32": TOL_E2E, "torch.bfloat16": 0.1, "torch.int8": 0.1}
SEED = 0
HOST_RUNS = 3  # host-timed runs a side, graphed and eager in turns
HOST_BLOCKS = 4  # decode blocks of BLOCK tokens in a timed run
BLOCK = 8  # the engine's decode block (generate's default block_size)
SAMPLED_TOKENS = 32  # tokens of each sampled stream
PROMPT_TOKENS = 500
DECODE_TOKENS = 128
# the whole llama-8b depth: cut to 16 layers the serving phase's watchdog
# gate counted a 5.9 s decode gap (the decode-stall threshold, 20 x the p99
# decode block, falls to its 5 s floor there; the gap's source is not found)
N_LAYERS = 32
# the qwen3-30b-a3b q40 path and its dedup round: 8 of the 48 layers, cut
# to keep the smoke inside its time with the parallel rounds (the same
# kernels at the same widths, each layer a repeat of the first); a child
# process writes the file while the llama-8b phases run
# (`start_prewrite`)
MOE_LAYERS = 8
MOE_DENSE_LAYERS = 4  # dense path: bf16 experts are 1.26 GB a layer
# model file -> (its label, preset, layers, the runs on it: a weight format,
# " kv-int8" added for the int8 KV cache)
# the llama-8b runs of the packed-nibble and int8 formats and of the int8 KV
# cache, and qwen3-30b-a3b's q40i8 run, depth cut (PR 18) to keep the smoke
# inside its time with this slice's phases: they hold the same kernels at
# the same widths, each layer a repeat of the first (the serving phase still
# serves the int8 pool at full depth)
CUT_LAYERS = 4
MODELS = [
    ("llama-8b", "llama-8b", N_LAYERS, ("q40",)),
    ("llama-8b", "llama-8b", CUT_LAYERS, ("q40 kv-int8", "q40i4", "q40i8")),
    ("qwen3-30b-a3b", "qwen3-30b-a3b", MOE_LAYERS, ("auto",)),
    ("qwen3-30b-a3b", "qwen3-30b-a3b", MOE_DENSE_LAYERS, ("dense", "q40i8")),
]

Q40_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
# more x rows for the Q40 and int8 tiles (bf16): the other prefill buckets and a ragged m
Q40_TILE_M = {(4096, 14336): (32, 128), (4096, 4096): (100,)}
# more x rows for the Q40 tiles (bf16): a speculative verify pass of 4 lanes at
# T = 3 and 5 (m = 8, T = 2, takes the GEMV's row)
Q40_VERIFY_M = {(4096, 14336): (12, 20)}
# more x rows for the Q40 GEMVs (bf16): the serving lanes (m = 4) and a full N of 8
Q40_GEMV_M = {(4096, 14336): (4, 8), (4096, 128256): (4, 8)}
QWEN_ATTN_SHAPES = [(2048, 4096), (2048, 512), (4096, 2048)]  # qwen3-30b-a3b wq, wk/wv, wo
REPLACES = {
    "q40_matmul": "dllama_tpu/ops/quant_matmul.py:289",
    "q40i4_matmul": "dllama_tpu/ops/quant_matmul.py:334",
    "i8_matmul": "dllama_tpu/ops/int8_matmul.py:157",
    "flash_attention_stats": "dllama_tpu/ops/flash_attention.py:166",
    "flash_decode": "dllama_tpu/ops/flash_attention.py:404",
    "paged_flash_decode": "dllama_tpu/ops/flash_attention.py:630",
    "moe_active_experts": "dllama_tpu/ops/moe_kernel.py:213",
    "moe_active_experts_q40": "dllama_tpu/ops/moe_kernel.py:250",
    "moe_grouped_experts": "dllama_tpu/ops/moe_kernel.py:449",
    "moe_grouped_experts_q40": "dllama_tpu/ops/moe_kernel.py:563",
    # the int8 KV cache: the QuantKV branches of the two TPU kernels (the
    # lines that scale the K tile), and the JAX engine's int8 slab decode
    # (dequant_kv, then XLA attention)
    "flash_attention_stats_kv8": "dllama_tpu/ops/flash_attention.py:124",
    "flash_decode_kv8": "dllama_tpu/models/transformer.py:218",
    "paged_flash_decode_kv8": "dllama_tpu/ops/flash_attention.py:595",
    # a float cache type unlike q's: the TPU kernels' upcast of q, K and V to
    # f32 inside the kernel (the lines that read the q and K tiles)
    "flash_attention_stats_mixed": "dllama_tpu/ops/flash_attention.py:121",
    "flash_decode_mixed": "dllama_tpu/ops/flash_attention.py:349",
    "paged_flash_decode_mixed": "dllama_tpu/ops/flash_attention.py:592",
    # sequence parallelism: the prefill stats kernel's s_stride option (its
    # strided mask and frontier, :175 :182 :237) and the decode kernel's
    # emit_stats (surface flash_decode_stats, :534)
    "flash_attention_stats_strided": "dllama_tpu/ops/flash_attention.py:166",
    "flash_decode_stats": "dllama_tpu/ops/flash_attention.py:404",
    # the int8 cache under sequence parallelism: the prefill stats kernel's
    # QuantKV branch with s_stride (its QuantKV test beside the strided kv
    # index map, :191 :230-237), and the JAX engine's int8 sp decode
    # (dequant_kv, then jnp stats over the shard)
    "flash_attention_stats_strided_kv8": "dllama_tpu/ops/flash_attention.py:191",
    "flash_decode_stats_kv8": "dllama_tpu/models/transformer.py:341",
}
SOURCES = {
    "q40_matmul": "dllama_tpu_torch/csrc/q40_matmul.cu",
    "q40i4_matmul": "dllama_tpu_torch/csrc/q40i4_matmul.cu",
    "i8_matmul": "dllama_tpu_torch/csrc/i8_matmul.cu",
    "flash_attention_stats": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode": "dllama_tpu_torch/csrc/flash_decode.cu",
    "paged_flash_decode": "dllama_tpu_torch/csrc/flash_decode.cu",
    "moe_active_experts": "dllama_tpu_torch/csrc/moe_active.cu",
    "moe_active_experts_q40": "dllama_tpu_torch/csrc/moe_active.cu",
    "moe_grouped_experts": "dllama_tpu_torch/csrc/moe_grouped.cu",
    "moe_grouped_experts_q40": "dllama_tpu_torch/csrc/moe_grouped.cu",
    "flash_attention_stats_kv8": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode_kv8": "dllama_tpu_torch/csrc/flash_decode.cu",
    "paged_flash_decode_kv8": "dllama_tpu_torch/csrc/flash_decode.cu",
    "flash_attention_stats_mixed": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode_mixed": "dllama_tpu_torch/csrc/flash_decode.cu",
    "paged_flash_decode_mixed": "dllama_tpu_torch/csrc/flash_decode.cu",
    "flash_attention_stats_strided": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode_stats": "dllama_tpu_torch/csrc/flash_decode.cu",
    "flash_attention_stats_strided_kv8": "dllama_tpu_torch/csrc/flash_attention.cu",
    "flash_decode_stats_kv8": "dllama_tpu_torch/csrc/flash_decode.cu",
}
# the row of phase 2 whose times stand in the kernels line
KERNEL_ROW_SHAPE = {
    "q40_matmul": "m=1 k=4096 n=14336",
    "q40i4_matmul": "m=1 k=4096 n=14336",
    "i8_matmul": "m=1 k=4096 n=14336 G=512",
    "flash_attention_stats": "H=32 KH=8 T=512 S=4096 pos=3584",
    "flash_decode": "H=32 KH=8 S=4096 pos=4095",
    "paged_flash_decode": "bf16 H=32 KH=8 B=4 pos=0,15,16,4095",
    "moe_active_experts": "bf16 m=1",
    "moe_active_experts_q40": "bf16 m=1",
    "moe_grouped_experts": "bf16 N=512",
    "moe_grouped_experts_q40": "bf16 N=512",
    "flash_attention_stats_kv8": "bf16 H=32 KH=8 T=512 S=4096 pos=3584",
    "flash_decode_kv8": "bf16 H=32 KH=8 S=4096 pos=4095",
    "paged_flash_decode_kv8": "bf16 H=32 KH=8 B=4 pos=0,15,16,4095",
    "flash_attention_stats_mixed": "f32/bf16 H=32 KH=8 T=512 S=4096 pos=3584",
    "flash_decode_mixed": "f32/bf16 H=32 KH=8 S=4096 pos=4095",
    "paged_flash_decode_mixed": "bf16/f16 H=32 KH=8 B=4 pos=0,15,16,4095",
    "flash_attention_stats_strided": "bfloat16 H=16 KH=4 T=256 S=2048 stride=2 pos=3833",
    "flash_decode_stats": "bfloat16 H=16 KH=4 S=2048 stride=2 pos=4095 s_pos0=1",
    "flash_attention_stats_strided_kv8": "int8 bfloat16 H=16 KH=4 T=256 S=2048 stride=2 pos=3833",
    "flash_decode_stats_kv8": "int8 bfloat16 H=16 KH=4 S=2048 stride=2 pos=4095 s_pos0=1",
}
MOE_SHAPE = dict(e=128, d=2048, f=768, k=8)  # Qwen3-30B-A3B experts
# the MoE kernels' edges at about A3B's widths: D and F not multiples of a
# 64-value block pair (nor of the grouped kernels' 128-value Q40 stage, 64
# hidden units or 128 outputs a block), k past the 8 blocks of the active
# down projection's cluster
MOE_EDGE = dict(e=16, d=2016, f=736, k=10)


class SmokeError(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


T_START = time.perf_counter()
# the smoke's own deadline, inside its 1,200 s limit: a background world or
# CLI run still going then is stopped and named (`left_s`), so that a hang
# fails the smoke with its name instead of running into the limit
DEADLINE_S = 1100.0


def left_s(cap: float) -> float:
    """``cap`` seconds, or fewer: what is left before `DEADLINE_S` (at
    least 30)."""
    return max(30.0, min(cap, DEADLINE_S - (time.perf_counter() - T_START)))


def mark(msg: str) -> None:
    """Print a phase's line, and on stderr with the seconds since the
    start, so that the end of stderr shows how far a stopped run got."""
    print(msg, flush=True)
    print(f"chip_smoke {time.perf_counter() - T_START:.1f} s: {msg}", file=sys.stderr, flush=True)


def bound(n_bytes: float, ops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) for n_bytes moved and ops done at ``peak``."""
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def norm_err(a, b) -> tuple[float, float]:
    """(max normalized error, max absolute error) of a against reference b."""
    d = (a.float() - b.float()).abs().max().item()
    return d / max(b.float().abs().max().item(), 1e-30), d


def time_ms(fn, device, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events. A 256 MB memset
    before each call evicts the 50 MB L2 (the main path finds its weights
    cold) and keeps the card busy while the host enqueues the call."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    fn()
    torch.cuda.synchronize(device)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_clean(fn, device, reps: int = 20) -> float:
    """`time_ms` with a clean L2: after the memset that evicts the cache, a
    read of another 256 MB evicts the memset's dirty lines too, so the
    timed call writes none of them back (which costs a byte-bound launch
    ~7 us under `time_ms`)."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    clean = torch.ones(64 << 20, dtype=torch.float32, device=device)
    fn()
    torch.cuda.synchronize(device)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        clean.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def random_q40(n: int, k: int, device, gen):
    """A random Q40 weight [n, k]: values in [-8, 7], f16 scales of either sign."""
    import torch

    from dllama_tpu_torch.ops.quant_matmul import QuantWeight

    q = torch.randint(-8, 8, (n, k), dtype=torch.int8, device=device, generator=gen)
    d = ((torch.rand((n, k // 32), device=device, generator=gen) + 0.5) * 0.004).half()
    d = torch.where(torch.rand_like(d.float()) < 0.5, -d, d).contiguous()
    return QuantWeight(q, d)


def random_q40_experts(e: int, d: int, f: int, device, gen) -> list:
    """Random Q40 experts [w1, w2, w3] (w1/w3 [E, F, D], w2 [E, D, F]) as
    `random_q40` makes a weight, each contiguous."""
    import torch

    from dllama_tpu_torch.ops.quant_matmul import QuantWeight

    def q40(rows, cols):
        q = torch.randint(-8, 8, (e, rows, cols), dtype=torch.int8, device=device, generator=gen)
        sc = (torch.rand((e, rows, cols // 32), device=device, generator=gen) + 0.5) * 0.004
        sc = torch.where(torch.rand(sc.shape, device=device, generator=gen) < 0.5, -sc, sc)
        return QuantWeight(q, sc.half().contiguous())

    return [q40(f, d), q40(d, f), q40(f, d)]


def _q40_cases(f32: bool) -> list[tuple[int, int, list]]:
    """(k, n, [(m, dtype), ...]) of the Q40 kernels' rows: `_x_cases` (f32
    x only if ``f32``) at llama-8b's shapes, the GEMV at m = 4 and 8, the
    tile at a verify pass's m = 12 and 20, the tile's other prefill buckets
    (m = 32, 128) and a ragged m = 100 in bf16, and qwen3-30b-a3b's
    attention projections at m = 512."""
    import torch

    bf = torch.bfloat16
    cases = []
    for k, n in Q40_SHAPES:
        xs = [c for c in _x_cases(k, n) if f32 or c[1] == bf]
        more = (Q40_GEMV_M.get((k, n), ()) + Q40_VERIFY_M.get((k, n), ())
                + Q40_TILE_M.get((k, n), ()))
        cases.append((k, n, xs + [(m, bf) for m in more]))
    return cases + [(k, n, [(512, bf)]) for k, n in QWEN_ATTN_SHAPES]


def check_q40(device, gen, timed: bool = True, cases=None, tag: str = "") -> list[dict]:
    """The Q40 kernel's rows at ``cases`` (default `_q40_cases`), each
    shape's label followed by ``tag``."""
    import torch

    from dllama_tpu_torch.ops.quant_matmul import dequant, qmatmul, qmatmul_ref

    rows = []
    for k, n, x_cases in cases or _q40_cases(f32=False):
        w = random_q40(n, k, device, gen)
        w_bf16 = dequant(w, torch.bfloat16)  # the library yardstick's operand
        for m, _ in x_cases:
            x = torch.randn((m, k), device=device, generator=gen).to(torch.bfloat16)
            kern, plain = qmatmul(x, w), qmatmul_ref(x, w)
            torch.cuda.synchronize(device)
            rel, absd = norm_err(kern, plain)
            require(rel <= TOL, f"q40_matmul m={m} k={k} n={n}: error {rel:.3e} > {TOL}")
            n_bytes = m * k * 2 + n * k + n * (k // 32) * 2 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k)
            row = dict(
                name="q40_matmul", shape=f"m={m} k={k} n={n}{tag}", err=rel, max_abs_err=absd,
                bound_ms=b_ms, bound_by=b_by,
            )
            if timed:
                row["ms"] = time_ms(lambda: qmatmul(x, w), device)
                row["plain_ms"] = time_ms(lambda: qmatmul_ref(x, w), device, reps=5)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, w_bf16.t()), device)
            rows.append(row)
        del w, w_bf16
    return rows


def _x_cases(k: int, n: int):
    """(m, dtype) of the matmul rows at one shape: bf16 x at m = 1 and 512,
    and f32 x too at llama-8b's w1/w3 shape."""
    import torch

    dtypes = [torch.bfloat16] + ([torch.float32] if (k, n) == (4096, 14336) else [])
    return [(m, dtype) for dtype in dtypes for m in (1, 512)]


def check_q40i4(device, gen, timed: bool = True) -> list[dict]:
    """The packed-nibble kernel against its plain version at the Q40 shapes,
    and against the Q40 kernel on the unpacked twin: the two share every
    line but the weight fetch, so their bits must be equal."""
    import torch

    from dllama_tpu_torch.ops.quant_matmul import (
        dequant,
        pack_nibbles,
        qmatmul,
        qmatmul_i4,
        qmatmul_ref,
    )

    rows = []
    for k, n, x_cases in _q40_cases(f32=True):
        w = random_q40(n, k, device, gen)
        pw = pack_nibbles(w)
        for m, dtype in x_cases:
            f32 = dtype == torch.float32
            x = torch.randn((m, k), device=device, generator=gen).to(dtype)
            kern, plain, twin = qmatmul_i4(x, pw), qmatmul_ref(x, pw), qmatmul(x, w)
            torch.cuda.synchronize(device)
            rel, absd = norm_err(kern, plain)
            shape = f"{'f32 ' if f32 else ''}m={m} k={k} n={n}"
            require(rel <= TOL, f"q40i4_matmul {shape}: error {rel:.3e} > {TOL}")
            require(torch.equal(kern, twin),
                    f"q40i4_matmul {shape}: bits differ from q40_matmul on the unpacked twin")
            n_bytes = m * k * x.element_size() + n * k // 2 + n * (k // 32) * 2 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, F32_FLOPS if f32 else BF16_FLOPS)
            row = dict(
                name="q40i4_matmul", shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                bound_by=b_by, twin_err=norm_err(kern, twin)[0], twin_equal=torch.equal(kern, twin),
            )
            if timed:
                dense = dequant(w, dtype)  # the library yardstick's operand
                row["ms"] = time_ms(lambda: qmatmul_i4(x, pw), device)
                row["plain_ms"] = time_ms(lambda: qmatmul_ref(x, pw), device, reps=5)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, dense.t()), device)
                del dense
            rows.append(row)
        del w, pw
    return rows


def _i8_cases() -> list[tuple[int, int, int, list]]:
    """(k, n, G, [(m, dtype), ...]) of the timed int8 rows: G 512 at the Q40
    shapes (`_x_cases`, the tile's other prefill buckets and a ragged m at
    `Q40_TILE_M`, the GEMV's m = 4 and 8 at `Q40_GEMV_M`'s w1) and G 256
    (Qwen3-30B-A3B's) at its attention projections, m = 1 and 512."""
    import torch

    bf = torch.bfloat16
    cases = []
    for k, n in Q40_SHAPES:
        more = Q40_TILE_M.get((k, n), ()) + (Q40_GEMV_M[k, n] if (k, n) == (4096, 14336) else ())
        cases.append((k, n, 512, _x_cases(k, n) + [(m, bf) for m in more]))
    return cases + [(k, n, 256, [(1, bf), (512, bf)]) for k, n in QWEN_ATTN_SHAPES]


# the int8 GEMV's edge shapes (k, G) at n = 200 (a partial 16-row tile) and
# every m from 1 to 8: k of one group at G 32, 192 and 512 (lane runs of 8,
# 16 and 128 bytes; G 192 cuts a group into 3 items), 64 groups of 32
# (two windows of the reduction, over a cluster of 8 blocks), and groups
# whose parts span the 32 items of a cluster's round: 64 of G 224 (7 parts)
# and 4 of G 544 (17)
I8_EDGE = [(32, 32), (192, 192), (512, 512), (2048, 32), (14336, 224), (2176, 544)]


def check_i8(device, gen, timed: bool = True) -> list[dict]:
    """The grouped-int8 kernel against its plain version on the same
    quantized operands at `_i8_cases`, and untimed at `I8_EDGE`. Both form
    the same exact group dots, scaled alike and added in group order, so
    they must give the same bits. The GEMV rows (m <= 8) are timed with the
    L2 flushed (`time_ms`, the comparison with earlier runs) and clean
    (`time_clean`); the m = 512 rows also time torch._int_mm on xq and q
    (cuBLASLt's int8 product without the group scales), a yardstick that is
    printed, not gated."""
    import torch

    from dllama_tpu_torch.ops.int8_matmul import (
        i8matmul_2d,
        i8matmul_2d_ref,
        quantize_acts,
        requantize_q40,
    )

    bf = torch.bfloat16
    cases = [(k, n, g, xs, timed) for k, n, g, xs in _i8_cases()]
    cases += [(k, 200, g, [(m, bf) for m in range(1, 9)], False) for k, g in I8_EDGE]
    rows = []
    for k, n, group, x_cases, timed_case in cases:
        w = requantize_q40(random_q40(n, k, device, gen), group)
        ng = k // group
        for m, dtype in x_cases:
            f32 = dtype == torch.float32
            x = torch.randn((m, k), device=device, generator=gen).to(dtype)
            xq, sx = quantize_acts(x, group)
            kern, plain = i8matmul_2d(xq, sx, w), i8matmul_2d_ref(xq, sx, w)
            torch.cuda.synchronize(device)
            rel, absd = norm_err(kern, plain)
            shape = f"{'f32 ' if f32 else ''}m={m} k={k} n={n} G={group}"
            require(rel <= TOL, f"i8_matmul {shape}: error {rel:.3e} > {TOL}")
            require(torch.equal(kern, plain), f"i8_matmul {shape}: bits differ from the plain version")
            n_bytes = m * k + m * ng * 4 + n * k + n * ng * 4 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, INT8_OPS)
            row = dict(
                name="i8_matmul", shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                bound_by=b_by, plain_equal=torch.equal(kern, plain),
            )
            if timed_case:
                dense = (w.q.float().view(n, ng, group) * w.s[..., None]).view(n, k).to(dtype)
                row["ms"] = time_ms(lambda: i8matmul_2d(xq, sx, w), device)
                if m <= 8:
                    row["ms_clean"] = time_clean(lambda: i8matmul_2d(xq, sx, w), device)
                row["plain_ms"] = time_ms(lambda: i8matmul_2d_ref(xq, sx, w), device, reps=5)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, dense.t()), device)
                del dense
                if m == 512:
                    qt = w.q.t()
                    row["int_mm_ms"] = time_ms(lambda: torch._int_mm(xq, qt), device)
            rows.append(row)
        del w
    return rows


def _sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call, with GQA in the call."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def twice_equal(fn, what: str):
    """Run ``fn`` twice on the same inputs and require equal bits (no
    atomics, no order that changes between runs); returns the first result."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    a_t, b_t = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    require(all(torch.equal(x, y) for x, y in zip(a_t, b_t)), f"{what}: two runs differ in bits")
    return a


def check_attention(device, gen, timed: bool = True, h: int = 32, kh: int = 8,
                    hd: int = 128) -> list[dict]:
    """Both attention kernels at h query heads over kh KV heads (llama-8b:
    32 / 8; qwen3-30b-a3b: 32 / 4) and head dim hd; each launched twice on
    the same inputs, with equal bits required. Decode at pos 0 (all but one
    block of a cluster empty), 511, 563 (the middle of the main path's
    500 + 128-token run) and 4095."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_ref,
        flash_decode,
        flash_decode_ref,
    )

    t = 512
    heads = f"H={h} KH={kh}" if hd == 128 else f"hd={hd} H={h} KH={kh}"
    rows = []

    def cache(s):
        kk = torch.randn((1, kh, s, hd), device=device, generator=gen).to(torch.bfloat16)
        vv = torch.randn((1, kh, s, hd), device=device, generator=gen).to(torch.bfloat16)
        return kk, vv

    for s, pos in ((512, 0), (4096, 3584)):
        q = torch.randn((1, t, h, hd), device=device, generator=gen).to(torch.bfloat16)
        k, v = cache(s)
        got = twice_equal(lambda: flash_attention_stats(q, k, v, pos),
                          f"flash_attention_stats {heads} S={s} pos={pos}")
        ref = flash_attention_stats_ref(q, k, v, pos)
        torch.cuda.synchronize(device)
        errs = [norm_err(a, b) for a, b in zip(got, ref)]
        rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= TOL, f"flash_attention_stats {heads} S={s} pos={pos}: error {rel:.3e} > {TOL}")
        vis = sum(min(s, pos + i + 1) for i in range(t))
        n_bytes = q.numel() * 2 + 2 * kh * min(s, pos + t) * hd * 2 + h * t * (hd + 2) * 4
        b_ms, b_by = bound(n_bytes, 4.0 * hd * h * vis)
        row = dict(
            name="flash_attention_stats", shape=f"{heads} T={t} S={s} pos={pos}", err=rel,
            max_abs_err=absd, bound_ms=b_ms, bound_by=b_by,
        )
        if timed:
            qpos = pos + torch.arange(t, device=device)
            mask = torch.arange(pos + t, device=device)[None, :] <= qpos[:, None]
            qs = q.transpose(1, 2)
            ks, vs = k[:, :, : pos + t], v[:, :, : pos + t]
            row["ms"] = time_ms(lambda: flash_attention_stats(q, k, v, pos), device)
            row["plain_ms"] = time_ms(lambda: flash_attention_stats_ref(q, k, v, pos), device, 5)
            row["library_ms"] = time_ms(lambda: _sdpa(qs, ks, vs, mask), device)
        rows.append(row)

    k, v = cache(4096)
    for pos in (0, 511, 563, 4095):
        q = torch.randn((1, 1, h, hd), device=device, generator=gen).to(torch.bfloat16)
        got = twice_equal(lambda: flash_decode(q, k, v, pos), f"flash_decode {heads} pos={pos}")
        ref = flash_decode_ref(q, k, v, pos)
        torch.cuda.synchronize(device)
        rel, absd = norm_err(got, ref)
        require(rel <= TOL_BF16_OUT,
                f"flash_decode {heads} pos={pos}: error {rel:.3e} > {TOL_BF16_OUT}")
        n_bytes = q.numel() * 2 * 2 + 2 * kh * (pos + 1) * hd * 2
        b_ms, b_by = bound(n_bytes, 4.0 * hd * h * (pos + 1))
        row = dict(
            name="flash_decode", shape=f"{heads} S=4096 pos={pos}", err=rel, max_abs_err=absd,
            bound_ms=b_ms, bound_by=b_by,
        )
        if timed:
            qs = q.transpose(1, 2)
            ks, vs = k[:, :, : pos + 1], v[:, :, : pos + 1]
            row["ms"] = time_ms(lambda: flash_decode(q, k, v, pos), device)
            row["plain_ms"] = time_ms(lambda: flash_decode_ref(q, k, v, pos), device, 5)
            row["library_ms"] = time_ms(lambda: _sdpa(qs, ks, vs, None), device)
        rows.append(row)
    return rows


PAGE = 16  # the serving path's pool page size
PAGED_POS = (0, 15, 16, 4095)  # one lane each: a page's first row, its last, the next, the full table


def _paged_case(device, gen, h: int, kh: int, dtype, s: int = 4096, b: int = 4):
    """A pool of 1 + b * s/PAGE pages and a shuffled page table [b, s/PAGE]
    in which lanes 0 and 1 share their first 4 pages; and the slab [b, KH,
    s, hd] of random K/V with the pool that holds it page for page under
    the identity table (page 0 scratch)."""
    import torch

    hd, nb = 128, s // PAGE
    n_pages = 1 + b * nb
    perm = torch.randperm(n_pages - 1, device=device, generator=gen) + 1
    pt = perm.reshape(b, nb).to(torch.int32)
    pt[1, :4] = pt[0, :4]
    pool = [torch.randn((n_pages, kh, PAGE, hd), device=device, generator=gen).to(dtype)
            for _ in range(2)]
    slab = [torch.randn((b, kh, s, hd), device=device, generator=gen).to(dtype) for _ in range(2)]
    ident = [torch.cat([torch.zeros_like(x[:1, :, :PAGE]).reshape(1, kh, PAGE, hd),
                        x.reshape(b, kh, nb, PAGE, hd).transpose(1, 2).reshape(b * nb, kh, PAGE,
                                                                               hd)])
             for x in slab]
    pt_ident = (1 + torch.arange(b * nb, device=device, dtype=torch.int32)).reshape(b, nb)
    return pool, pt, slab, ident, pt_ident


def check_paged_decode(device, gen, timed: bool = True) -> list[dict]:
    """The paged decode kernel against `paged_flash_decode_ref` at llama-8b
    heads (H 32, KH 8) and qwen3-30b-a3b heads (H 32, KH 4), hd 128, page
    16, B = 4 lanes at positions PAGED_POS, bf16 and f32, through a
    shuffled page table with two lanes sharing pages; with an identity
    table it must give `flash_decode`'s bits on the same rows. Then the
    paged prefill stats (the stats kernel with paged addressing) against
    `attention_stats` on the gathered view, and its identity-table bits
    against `flash_attention_stats` (required). Each kernel launched twice
    on the same inputs must give the same bits. The library yardstick is
    scaled_dot_product_attention on the gathered contiguous view: it leaves
    the gather out."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_decode,
        paged_flash_attention_stats,
        paged_flash_attention_stats_ref,
        paged_flash_decode,
        paged_flash_decode_ref,
    )
    from dllama_tpu_torch.ops.kv_cache import lane_views

    rows = []
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device=device)
    for h, kh in ((32, 8), (32, 4)):
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            (kp, vp), pt, (ks, vs), (ki, vi), pt_ident = _paged_case(device, gen, h, kh, dtype)
            q = torch.randn((4, 1, h, 128), device=device, generator=gen).to(dtype)
            before = paged_flash_decode.launches
            shape = f"{tag} H={h} KH={kh} B=4 pos={','.join(map(str, PAGED_POS))}"
            got = twice_equal(lambda: paged_flash_decode(q, kp, vp, pt, pos),
                              f"paged_flash_decode {shape}")
            ref = paged_flash_decode_ref(q, kp, vp, pt, pos)
            ident = paged_flash_decode(q, ki, vi, pt_ident, pos)
            slab = flash_decode(q, ks, vs, pos)
            torch.cuda.synchronize(device)
            require(paged_flash_decode.launches == before + 3,
                    "paged_flash_decode: the wrapper did not launch its kernel")
            rel, absd = norm_err(got, ref)
            tol = TOL if dtype == torch.float32 else TOL_BF16_OUT
            require(rel <= tol, f"paged_flash_decode {shape}: error {rel:.3e} > {tol}")
            require(torch.equal(ident, slab),
                    f"paged_flash_decode {shape}: identity table differs from flash_decode")
            n_bytes = (2 * kh * sum(p + 1 for p in PAGED_POS) * 128 * q.element_size()
                       + 2 * q.numel() * q.element_size() + pt.numel() * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * 128 * h * sum(p + 1 for p in PAGED_POS),
                               F32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
            row = dict(name="paged_flash_decode", shape=shape, err=rel, max_abs_err=absd,
                       bound_ms=b_ms, bound_by=b_by, identity_bits_equal=True)
            if timed:
                kv_k, kv_v = lane_views(kp, pt), lane_views(vp, pt)
                mask = (torch.arange(4096, device=device)[None, :] <= pos[:, None])[:, None, None]
                qs = q.transpose(1, 2)
                row["ms"] = time_ms(lambda: paged_flash_decode(q, kp, vp, pt, pos), device)
                row["plain_ms"] = time_ms(lambda: paged_flash_decode_ref(q, kp, vp, pt, pos),
                                          device, 5)
                row["library_ms"] = time_ms(lambda: _sdpa(qs, kv_k, kv_v, mask), device)
                del kv_k, kv_v
            rows.append(row)

            # admission chunks: T rows per lane through the page table
            t = 128
            q_pos0 = torch.tensor([256, 3000, 0, 4096 - t], dtype=torch.int32, device=device)
            qc = torch.randn((4, t, h, 128), device=device, generator=gen).to(dtype)
            shape = f"{tag} H={h} KH={kh} B=4 T={t} paged"
            got = twice_equal(lambda: paged_flash_attention_stats(qc, kp, vp, pt, q_pos0),
                              f"flash_attention_stats {shape}")
            ref = paged_flash_attention_stats_ref(qc, kp, vp, pt, q_pos0)
            ident = paged_flash_attention_stats(qc, ki, vi, pt_ident, q_pos0)
            slab = flash_attention_stats(qc, ks, vs, q_pos0)
            torch.cuda.synchronize(device)
            errs = [norm_err(a, b) for a, b in zip(got, ref)]
            rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
            require(rel <= TOL, f"flash_attention_stats {shape}: error {rel:.3e} > {TOL}")
            require(all(torch.equal(a, b) for a, b in zip(ident, slab)),
                    f"flash_attention_stats {shape}: identity table differs from the slab entry")
            vis = sum(min(4096, int(p) + i + 1) for p in q_pos0.tolist() for i in range(t))
            n_bytes = (qc.numel() * qc.element_size() + 2 * kh * 128 * qc.element_size()
                       * sum(min(4096, int(p) + t) for p in q_pos0.tolist())
                       + h * 4 * t * (128 + 2) * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * 128 * h * vis)  # the tensor cores, any type
            rows.append(dict(
                name="flash_attention_stats", shape=shape, err=rel, max_abs_err=absd,
                bound_ms=b_ms, bound_by=b_by,
                identity_bits_equal=True,
            ))
            del kp, vp, ks, vs, ki, vi
    return rows


VERIFY_T = (2, 3, 5)  # verify widths at spec_k 4: 1 + each draft bucket (1, 2, 4)
VERIFY_POS = (0, 15, 16, 4090)  # four live lanes; a fifth parked at -T


def check_verify_stats(device, gen, timed: bool = True) -> list[dict]:
    """The paged stats kernel at the shapes of a speculative verify pass
    (`InferenceEngine.verify_lanes`, llama-8b heads H 32 over KH 8, hd 128,
    page 16): T in VERIFY_T rows a lane at VERIFY_POS and one lane parked at
    -T, with a bf16, an f32 and an int8 pool (bf16 q). Each is launched
    twice with equal bits required (its launches counted under
    flash_attention_stats or flash_attention_stats_kv8), held within TOL of
    its plain version on the live lanes, the parked lane's state must be m =
    -1e30, l = 0, acc = 0, and the identity table must give the slab entry's
    bits. Timed: the kernel, its plain version, and scaled_dot_product_attention
    on the gathered view (SDPA after the gather and the dequantization, two
    calls, as ``composite_ms`` for the int8 pool, whose ``library_ms`` is none)."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_kv8,
        paged_flash_attention_stats,
        paged_flash_attention_stats_ref,
    )
    from dllama_tpu_torch.ops.kv_cache import dequant_kv, lane_views

    h, kh, hd, s, b = 32, 8, 128, 4096, len(VERIFY_POS) + 1
    nb = s // PAGE
    rows = []
    for tag in ("bf16", "f32", "int8"):
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        kv8 = tag == "int8"
        counter = flash_attention_stats_kv8 if kv8 else flash_attention_stats
        perm = torch.randperm(b * nb, device=device, generator=gen) + 1
        pt = perm.reshape(b, nb).to(torch.int32)
        pt_ident = (1 + torch.arange(b * nb, device=device, dtype=torch.int32)).reshape(b, nb)
        if kv8:
            kp, vp = (random_kv8((1 + b * nb, kh, PAGE, hd), device, gen) for _ in range(2))
            ks, vs = (random_kv8((b, kh, s, hd), device, gen) for _ in range(2))
            ki, vi = _ident_pages(ks, b, kh, nb), _ident_pages(vs, b, kh, nb)
        else:
            kp, vp = (torch.randn((1 + b * nb, kh, PAGE, hd), device=device,
                                  generator=gen).to(dtype) for _ in range(2))
            ks, vs = (torch.randn((b, kh, s, hd), device=device, generator=gen).to(dtype)
                      for _ in range(2))
            ki, vi = _ident_pages(ks, b, kh, nb), _ident_pages(vs, b, kh, nb)
        for t in VERIFY_T:
            q_pos0 = torch.tensor(VERIFY_POS + (-t,), dtype=torch.int32, device=device)
            q = torch.randn((b, t, h, hd), device=device, generator=gen).to(dtype)
            shape = f"{tag} H={h} KH={kh} B=4+1 T={t} verify"
            before = counter.launches
            got = twice_equal(lambda: paged_flash_attention_stats(q, kp, vp, pt, q_pos0),
                              f"{counter.__name__} {shape}")
            require(counter.launches == before + 2,
                    f"{counter.__name__} {shape}: the wrapper did not count its launches")
            ref = paged_flash_attention_stats_ref(q, kp, vp, pt, q_pos0)
            ident = paged_flash_attention_stats(q, ki, vi, pt_ident, q_pos0)
            slab = flash_attention_stats(q, ks, vs, q_pos0)
            torch.cuda.synchronize(device)
            require(all(torch.equal(x, y) for x, y in zip(ident, slab)),
                    f"{counter.__name__} {shape}: identity table differs from the slab entry")
            acc, m, l = got
            require(bool((acc[-1] == 0).all() and (l[-1] == 0).all() and (m[-1] <= -1e29).all()),
                    f"{counter.__name__} {shape}: the parked lane's state is not empty")
            errs = [norm_err(x[:-1], y[:-1]) for x, y in zip(got, ref)]
            rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
            require(rel <= TOL, f"{counter.__name__} {shape}: error {rel:.3e} > {TOL}")
            vis = sum(p + i + 1 for p in VERIFY_POS for i in range(t))
            row_bytes = (hd + 4) if kv8 else hd * (4 if tag == "f32" else 2)
            n_bytes = (q.numel() * q.element_size()
                       + 2 * kh * row_bytes * sum(p + t for p in VERIFY_POS)
                       + h * b * t * (hd + 2) * 4 + pt.numel() * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * hd * h * vis)  # the tensor cores, any type
            row = dict(name=counter.__name__, shape=shape, err=rel, max_abs_err=absd,
                       bound_ms=b_ms, bound_by=b_by, identity_bits_equal=True)
            if timed:
                qs = q.transpose(1, 2)
                qpos = q_pos0[:, None] + torch.arange(t, device=device)[None, :]
                mask = (torch.arange(s, device=device)[None, None, :]
                        <= qpos[:, :, None])[:, None]
                row["ms"] = time_ms(lambda: paged_flash_attention_stats(q, kp, vp, pt, q_pos0),
                                    device)
                row["plain_ms"] = time_ms(
                    lambda: paged_flash_attention_stats_ref(q, kp, vp, pt, q_pos0), device, 5)
                if kv8:
                    def composite(q=qs, kp=kp, vp=vp, pt=pt, mask=mask):
                        return _sdpa(q, dequant_kv(lane_views(kp, pt), q.dtype),
                                     dequant_kv(lane_views(vp, pt), q.dtype), mask)

                    row["library_ms"] = None
                    row["composite_ms"] = time_ms(composite, device)
                else:
                    kv_k, kv_v = lane_views(kp, pt), lane_views(vp, pt)
                    row["library_ms"] = time_ms(lambda: _sdpa(qs, kv_k, kv_v, mask), device)
                    del kv_k, kv_v
            rows.append(row)
        del kp, vp, ks, vs, ki, vi
    return rows


SLAB_PAD = 512  # the lanes' slab padding rows: the largest prefill bucket (engine._lane_pad)
SLAB_DECODE_POS = (0, 15, 16, 4095, -1)  # four live lanes and one parked
SLAB_CHUNK_POS = (0, 1024, 2560, 3584)  # a 512-row lane chunk's four live lanes; one parked at -T


def check_slab_lanes(device, gen, timed: bool = True) -> list[dict]:
    """The slab entries of both attention kernels at the slab lanes' shapes
    (`InferenceEngine.decode_lanes` / ``verify_lanes`` / a lane chunk with
    ``kv_native`` off): llama-8b heads (H 32 over KH 8, hd 128) over the
    lanes' slab of 4096 + `SLAB_PAD` rows, B = 5 lanes, one of them parked.
    Decode at `SLAB_DECODE_POS` (the parked lane at -1 must read nothing and
    give zeros); stats at the verify widths T = 2, 3, 5 (lanes at
    `VERIFY_POS`) and a 512-row chunk (lanes at `SLAB_CHUNK_POS`), the
    parked lane at -T (its state m = -1e30, l = 0, acc = 0); each in bf16,
    f32 and int8 (bf16 q). Each row: within TOL (f32 outputs: the stats, the
    f32 decode) or TOL_BF16_OUT (bf16 outputs) of its plain version, the
    same bits on two launches, its launches counted under its wrapper's
    counter (``*_kv8`` for int8), and the paged entry's bits through the
    identity page table over the same rows (pages of 16). Timed: the kernel,
    its plain version, and scaled_dot_product_attention on the slab with the
    causal mask (SDPA after a dequantization, two calls, as ``composite_ms``
    for int8, whose ``library_ms`` is none)."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_kv8,
        flash_attention_stats_ref,
        flash_decode,
        flash_decode_kv8,
        flash_decode_ref,
        paged_flash_attention_stats,
        paged_flash_decode,
    )
    from dllama_tpu_torch.ops.kv_cache import dequant_kv

    h, kh, hd, s = 32, 8, 128, 4096 + SLAB_PAD
    b, nb = len(SLAB_DECODE_POS), s // PAGE
    pt_ident = (1 + torch.arange(b * nb, device=device, dtype=torch.int32)).reshape(b, nb)
    rows = []
    for tag in ("bf16", "f32", "int8"):
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        kv8 = tag == "int8"
        peak = F32_FLOPS if tag == "f32" else BF16_FLOPS
        row_bytes = (hd + 4) if kv8 else hd * (4 if tag == "f32" else 2)
        if kv8:
            k, v = (random_kv8((b, kh, s, hd), device, gen) for _ in range(2))
        else:
            k, v = (torch.randn((b, kh, s, hd), device=device, generator=gen).to(dtype)
                    for _ in range(2))
        ki, vi = _ident_pages(k, b, kh, nb), _ident_pages(v, b, kh, nb)

        def library(q, qpos, k=k, v=v):
            """SDPA over the slab (the int8 slab dequantized first)."""
            mask = (torch.arange(s, device=device)[None, None, :] <= qpos[:, :, None])[:, None]
            qs = q.transpose(1, 2)
            if kv8:
                return lambda: _sdpa(qs, dequant_kv(k, q.dtype), dequant_kv(v, q.dtype), mask)
            return lambda: _sdpa(qs, k, v, mask)

        # decode: B lanes at their own positions, one parked
        counter = flash_decode_kv8 if kv8 else flash_decode
        pos = torch.tensor(SLAB_DECODE_POS, dtype=torch.int32, device=device)
        q = torch.randn((b, 1, h, hd), device=device, generator=gen).to(dtype)
        shape = f"{tag} H={h} KH={kh} B=4+1 S={s} pos={','.join(map(str, SLAB_DECODE_POS))} slab"
        before = counter.launches
        got = twice_equal(lambda: flash_decode(q, k, v, pos), f"{counter.__name__} {shape}")
        require(counter.launches == before + 2,
                f"{counter.__name__} {shape}: the wrapper did not count its launches")
        ident = paged_flash_decode(q, ki, vi, pt_ident, pos)
        ref = flash_decode_ref(q, k, v, pos)
        torch.cuda.synchronize(device)
        require(torch.equal(ident, got),
                f"{counter.__name__} {shape}: the paged entry's identity-table bits differ")
        require(bool((got[-1] == 0).all()), f"{counter.__name__} {shape}: the parked lane "
                "is not zero")
        rel, absd = norm_err(got, ref)
        tol = TOL if tag == "f32" else TOL_BF16_OUT
        require(rel <= tol, f"{counter.__name__} {shape}: error {rel:.3e} > {tol}")
        live = sum(p + 1 for p in SLAB_DECODE_POS if p >= 0)
        b_ms, b_by = bound(2 * kh * live * row_bytes + 2 * q.numel() * q.element_size(),
                           4.0 * hd * h * live, peak)
        row = dict(name=counter.__name__, shape=shape, err=rel, max_abs_err=absd,
                   bound_ms=b_ms, bound_by=b_by, identity_bits_equal=True)
        if timed:
            row["ms"] = time_ms(lambda: flash_decode(q, k, v, pos), device)
            row["plain_ms"] = time_ms(lambda: flash_decode_ref(q, k, v, pos), device, 5)
            lib = library(q, pos[:, None])
            row["library_ms"] = None if kv8 else time_ms(lib, device)
            if kv8:
                row["composite_ms"] = time_ms(lib, device)
        rows.append(row)

        # stats: verify widths and a 512-row lane chunk, one lane parked at -T
        counter = flash_attention_stats_kv8 if kv8 else flash_attention_stats
        for t, live_pos in [(t, VERIFY_POS) for t in VERIFY_T] + [(512, SLAB_CHUNK_POS)]:
            q_pos0 = torch.tensor(live_pos + (-t,), dtype=torch.int32, device=device)
            q = torch.randn((b, t, h, hd), device=device, generator=gen).to(dtype)
            shape = (f"{tag} H={h} KH={kh} B=4+1 T={t} S={s} "
                     f"pos={','.join(map(str, live_pos))},-{t} slab")
            before = counter.launches
            got = twice_equal(lambda: flash_attention_stats(q, k, v, q_pos0),
                              f"{counter.__name__} {shape}")
            require(counter.launches == before + 2,
                    f"{counter.__name__} {shape}: the wrapper did not count its launches")
            ident = paged_flash_attention_stats(q, ki, vi, pt_ident, q_pos0)
            ref = flash_attention_stats_ref(q, k, v, q_pos0)
            torch.cuda.synchronize(device)
            require(all(torch.equal(x, y) for x, y in zip(ident, got)),
                    f"{counter.__name__} {shape}: the paged entry's identity-table bits differ")
            acc, m, l = got
            require(bool((acc[-1] == 0).all() and (l[-1] == 0).all() and (m[-1] <= -1e29).all()),
                    f"{counter.__name__} {shape}: the parked lane's state is not empty")
            errs = [norm_err(x[:-1], y[:-1]) for x, y in zip(got, ref)]
            rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
            require(rel <= TOL, f"{counter.__name__} {shape}: error {rel:.3e} > {TOL}")
            vis = sum(p + i + 1 for p in live_pos for i in range(t))
            n_bytes = (q.numel() * q.element_size()
                       + 2 * kh * row_bytes * sum(p + t for p in live_pos)
                       + h * b * t * (hd + 2) * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * hd * h * vis)  # the stats: tensor cores
            row = dict(name=counter.__name__, shape=shape, err=rel, max_abs_err=absd,
                       bound_ms=b_ms, bound_by=b_by, identity_bits_equal=True)
            if timed:
                row["ms"] = time_ms(lambda: flash_attention_stats(q, k, v, q_pos0), device)
                row["plain_ms"] = time_ms(lambda: flash_attention_stats_ref(q, k, v, q_pos0),
                                          device, 5)
                lib = library(q, q_pos0[:, None] + torch.arange(t, device=device)[None, :])
                row["library_ms"] = None if kv8 else time_ms(lib, device)
                if kv8:
                    row["composite_ms"] = time_ms(lib, device)
            rows.append(row)
            del q, got, ident, ref
        del k, v, ki, vi
    return rows


def random_kv8(shape, device, gen):
    """A random int8 cache leaf: normal rows quantized as the engine writes
    them (`quantize_kv_rows`: int8 values, one f32 scale a row)."""
    import torch

    from dllama_tpu_torch.ops.kv_cache import QuantKV, quantize_kv_rows

    return QuantKV(*quantize_kv_rows(torch.randn(shape, device=device, generator=gen)))


def _ident_pages(x, b: int, kh: int, nb: int):
    """The slab leaf x [b, KH, nb * PAGE, last] as pool pages [1 + b * nb, KH,
    PAGE, last] under the identity table (page 0 scratch); QuantKV leaf by leaf."""
    import torch

    from dllama_tpu_torch.ops.kv_cache import QuantKV

    if isinstance(x, QuantKV):
        return QuantKV(*(_ident_pages(t, b, kh, nb) for t in x))
    last = x.shape[-1]
    pages = x.reshape(b, kh, nb, PAGE, last).transpose(1, 2).reshape(b * nb, kh, PAGE, last)
    return torch.cat([torch.zeros_like(pages[:1]), pages]).contiguous()


def _kv8_bytes(kh: int, rows: int, hd: int) -> int:
    """Bytes of ``rows`` K and V rows of kh heads in the int8 cache (values
    and f32 scales)."""
    return 2 * kh * rows * (hd + 4)


def check_kv8(device, gen, timed: bool = True) -> list[dict]:
    """The int8-KV instantiations of both attention kernels (``--kv-dtype
    int8``: QuantKV leaves of int8 values and f32 row scales, made by
    `random_kv8`) against their plain versions (the cache dequantized in
    f32, then `attention_stats`): prefill stats at H 32 over KH 8 and 4, hd
    128 and 64, T 512 over S 4096 at pos 3584 (and S 512 at pos 0), bf16
    and f32; the paged stats on a shuffled table and on the identity table
    (bits equal to the slab entry); slab decode at pos 0, 563 and 4095;
    paged decode at B 4, pos 0, 15, 16, 4095 (identity-table bits equal to
    the slab entry); a parked lane in stats (q_pos0 -T), slab and paged
    decode (pos -1); 32 query heads a KV head (the CUDA-core decode body).
    Every kernel launched twice on the same inputs must repeat its bits, and
    each wrapper must count its launches under its ``*_kv8`` counter. No
    single PyTorch call attends over int8 K/V: ``library_ms`` is none, and
    ``composite_ms`` times the dequantization of the visible rows and
    scaled_dot_product_attention on them (two calls) for reference."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_kv8,
        flash_attention_stats_ref,
        flash_decode,
        flash_decode_kv8,
        flash_decode_ref,
        paged_flash_attention_stats,
        paged_flash_attention_stats_ref,
        paged_flash_decode,
        paged_flash_decode_kv8,
        paged_flash_decode_ref,
    )
    from dllama_tpu_torch.ops.kv_cache import QuantKV, dequant_kv, paged_view, slice_kv

    rows = []

    def counted(fn, counter, n_calls, what):
        """fn() run twice (equal bits required), counting n_calls launches a run."""
        before = counter.launches
        out = twice_equal(fn, what)
        require(counter.launches == before + 2 * n_calls,
                f"{what}: {counter.launches - before} launches under {counter.__name__}, "
                f"wanted {2 * n_calls}")
        return out

    def record(name, shape, got, ref, tol, n_bytes, ops, dtype, times=None, **extra):
        got_t, ref_t = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        errs = [norm_err(a, b) for a, b in zip(got_t, ref_t)]
        rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= tol, f"{name} {shape}: error {rel:.3e} > {tol}")
        # the stats run on the tensor cores for every type, decode on CUDA cores in f32
        f32_cores = dtype == torch.float32 and not name.startswith("flash_attention_stats")
        b_ms, b_by = bound(n_bytes, ops, F32_FLOPS if f32_cores else BF16_FLOPS)
        row = dict(name=name, shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                   bound_by=b_by, **extra)
        if timed and times is not None:
            kernel, plain, composite = times
            row["ms"] = time_ms(kernel, device)
            row["ms_clean"] = time_clean(kernel, device)
            row["plain_ms"] = time_ms(plain, device, 5)
            row["library_ms"] = None
            row["composite_ms"] = time_ms(composite, device)
        rows.append(row)

    def randn(dtype, *shape):
        return torch.randn(shape, device=device, generator=gen).to(dtype)

    t = 512
    for h, kh, hd, dtypes in ((32, 8, 128, (torch.bfloat16, torch.float32)),
                              (32, 4, 128, (torch.bfloat16,)),
                              (32, 8, 64, (torch.bfloat16, torch.float32))):
        for dtype in dtypes:
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            heads = f"{tag} H={h} KH={kh}" + ("" if hd == 128 else f" hd={hd}")
            size = torch.tensor([], dtype=dtype).element_size()
            tol_out = TOL if dtype == torch.float32 else TOL_BF16_OUT
            k, v = random_kv8((1, kh, 4096, hd), device, gen), random_kv8((1, kh, 4096, hd),
                                                                          device, gen)
            for s, pos in ((512, 0), (4096, 3584)):
                q = randn(dtype, 1, t, h, hd)
                ks, vs = (QuantKV(*(x.contiguous() for x in slice_kv(leaf, s))) for leaf in (k, v))
                shape = f"{heads} T={t} S={s} pos={pos}"
                got = counted(lambda: flash_attention_stats(q, ks, vs, pos),
                              flash_attention_stats_kv8, 1, f"flash_attention_stats_kv8 {shape}")
                ref = flash_attention_stats_ref(q, ks, vs, pos)
                vis = sum(min(s, pos + i + 1) for i in range(t))
                n_bytes = (q.numel() * size + _kv8_bytes(kh, min(s, pos + t), hd)
                           + h * t * (hd + 2) * 4)
                qpos = pos + torch.arange(t, device=device)
                mask = torch.arange(pos + t, device=device)[None, :] <= qpos[:, None]
                qs = q.transpose(1, 2)

                def composite(q=qs, k=ks, v=vs, n=pos + t, mask=mask):
                    return _sdpa(q, dequant_kv(slice_kv(k, n), q.dtype),
                                 dequant_kv(slice_kv(v, n), q.dtype), mask)

                record("flash_attention_stats_kv8", shape, got, ref, TOL, n_bytes,
                       4.0 * hd * h * vis, dtype,
                       (lambda: flash_attention_stats(q, ks, vs, pos),
                        lambda: flash_attention_stats_ref(q, ks, vs, pos), composite))
            for pos in ((0, 563, 4095) if dtype == torch.bfloat16 and kh == 8 and hd == 128
                        else (4095,)):
                q = randn(dtype, 1, 1, h, hd)
                shape = f"{heads} S=4096 pos={pos}"
                got = counted(lambda: flash_decode(q, k, v, pos), flash_decode_kv8, 1,
                              f"flash_decode_kv8 {shape}")
                ref = flash_decode_ref(q, k, v, pos)
                n_bytes = 2 * q.numel() * size + _kv8_bytes(kh, pos + 1, hd)
                qs = q.transpose(1, 2)

                def composite(q=qs, k=k, v=v, n=pos + 1):
                    return _sdpa(q, dequant_kv(slice_kv(k, n), q.dtype),
                                 dequant_kv(slice_kv(v, n), q.dtype), None)

                record("flash_decode_kv8", shape, got, ref, tol_out, n_bytes,
                       4.0 * hd * h * (pos + 1), dtype,
                       (lambda: flash_decode(q, k, v, pos),
                        lambda: flash_decode_ref(q, k, v, pos), composite))
            del k, v

    # paged: B 4 lanes at PAGED_POS through a shuffled table, two lanes sharing
    # pages; the identity table must give the slab entries' bits
    b, s, hd = 4, 4096, 128
    nb = s // PAGE
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device=device)
    for kh, dtypes in ((8, (torch.bfloat16, torch.float32)), (4, (torch.bfloat16,))):
        for dtype in dtypes:
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            size = torch.tensor([], dtype=dtype).element_size()
            tol_out = TOL if dtype == torch.float32 else TOL_BF16_OUT
            perm = torch.randperm(b * nb, device=device, generator=gen) + 1
            pt = perm.reshape(b, nb).to(torch.int32)
            pt[1, :4] = pt[0, :4]
            kp, vp = (random_kv8((1 + b * nb, kh, PAGE, hd), device, gen) for _ in range(2))
            ks, vs = (random_kv8((b, kh, s, hd), device, gen) for _ in range(2))
            ki, vi = _ident_pages(ks, b, kh, nb), _ident_pages(vs, b, kh, nb)
            pt_ident = (1 + torch.arange(b * nb, device=device, dtype=torch.int32)).reshape(b, nb)
            q = randn(dtype, b, 1, 32, hd)
            shape = f"{tag} H=32 KH={kh} B=4 pos={','.join(map(str, PAGED_POS))}"
            got = counted(lambda: paged_flash_decode(q, kp, vp, pt, pos), paged_flash_decode_kv8,
                          1, f"paged_flash_decode_kv8 {shape}")
            ref = paged_flash_decode_ref(q, kp, vp, pt, pos)
            ident = paged_flash_decode(q, ki, vi, pt_ident, pos)
            slab = flash_decode(q, ks, vs, pos)
            torch.cuda.synchronize(device)
            require(torch.equal(ident, slab),
                    f"paged_flash_decode_kv8 {shape}: identity table differs from flash_decode_kv8")
            n_rows = sum(p + 1 for p in PAGED_POS)
            n_bytes = _kv8_bytes(kh, n_rows, hd) + 2 * q.numel() * size + pt.numel() * 4
            mask = (torch.arange(s, device=device)[None, :] <= pos[:, None])[:, None, None]
            qs = q.transpose(1, 2)

            def composite(q=qs, kp=kp, vp=vp, pt=pt, mask=mask):
                kk = torch.stack([paged_view(kp, pt[i], q.dtype) for i in range(b)])
                vv = torch.stack([paged_view(vp, pt[i], q.dtype) for i in range(b)])
                return _sdpa(q, kk, vv, mask)

            record("paged_flash_decode_kv8", shape, got, ref, tol_out, n_bytes,
                   4.0 * hd * 32 * n_rows, dtype,
                   (lambda: paged_flash_decode(q, kp, vp, pt, pos),
                    lambda: paged_flash_decode_ref(q, kp, vp, pt, pos), composite),
                   identity_bits_equal=True)

            tc = 128
            q_pos0 = torch.tensor([256, 3000, 0, s - tc], dtype=torch.int32, device=device)
            qc = randn(dtype, b, tc, 32, hd)
            shape = f"{tag} H=32 KH={kh} B=4 T={tc} paged"
            got = counted(lambda: paged_flash_attention_stats(qc, kp, vp, pt, q_pos0),
                          flash_attention_stats_kv8, 1, f"flash_attention_stats_kv8 {shape}")
            ref = paged_flash_attention_stats_ref(qc, kp, vp, pt, q_pos0)
            ident = paged_flash_attention_stats(qc, ki, vi, pt_ident, q_pos0)
            slab = flash_attention_stats(qc, ks, vs, q_pos0)
            torch.cuda.synchronize(device)
            require(all(torch.equal(x, y) for x, y in zip(ident, slab)),
                    f"flash_attention_stats_kv8 {shape}: identity table differs from the slab "
                    "entry")
            vis = sum(min(s, int(p) + i + 1) for p in q_pos0.tolist() for i in range(tc))
            n_bytes = (qc.numel() * size + _kv8_bytes(kh, sum(min(s, int(p) + tc)
                                                              for p in q_pos0.tolist()), hd)
                       + 32 * b * tc * (hd + 2) * 4)
            record("flash_attention_stats_kv8", shape, got, ref, TOL, n_bytes,
                   4.0 * hd * 32 * vis, dtype, identity_bits_equal=True)

            # parked lanes: stats at q_pos0 -T, decode (slab and paged) at pos -1
            starts = (300, -RAGGED_T, 0)
            q_par = torch.tensor(starts, dtype=torch.int32, device=device)
            qe, ke, ve = randn(dtype, 3, RAGGED_T, 32, hd), *(random_kv8((3, kh, 512, hd), device,
                                                                         gen) for _ in range(2))
            shape = f"{tag} H=32 KH={kh} B=3 T={RAGGED_T} q_pos0={','.join(map(str, starts))}"
            got = counted(lambda: flash_attention_stats(qe, ke, ve, q_par),
                          flash_attention_stats_kv8, 1, f"flash_attention_stats_kv8 {shape}")
            acc, m, l = got
            require(bool((acc[1] == 0).all() and (l[1] == 0).all() and (m[1] <= -1e29).all()),
                    f"flash_attention_stats_kv8 {shape}: the parked lane's state is not empty")
            vis = sum(min(512, max(0, p + i + 1)) for p in starts for i in range(RAGGED_T))
            n_bytes = (qe.numel() * size + _kv8_bytes(kh, sum(min(512, max(0, p + RAGGED_T))
                                                              for p in starts), hd)
                       + 32 * 3 * RAGGED_T * (hd + 2) * 4)
            record("flash_attention_stats_kv8", shape, got,
                   flash_attention_stats_ref(qe, ke, ve, q_par), TOL, n_bytes,
                   4.0 * hd * 32 * vis, dtype)
            pos2 = torch.tensor([-1, 563], dtype=torch.int32, device=device)
            qd = randn(dtype, 2, 1, 32, hd)
            ks2, vs2 = (random_kv8((2, kh, 1024, hd), device, gen) for _ in range(2))
            pt2 = pt[:2, : 1024 // PAGE].contiguous()
            shape = f"{tag} H=32 KH={kh} B=2 pos=-1,563"
            n_bytes = _kv8_bytes(kh, 564, hd) + 2 * qd.numel() * size
            for name, fn, ref_fn, counter, args in (
                ("flash_decode_kv8", flash_decode, flash_decode_ref, flash_decode_kv8,
                 (qd, ks2, vs2, pos2)),
                ("paged_flash_decode_kv8", paged_flash_decode, paged_flash_decode_ref,
                 paged_flash_decode_kv8, (qd, kp, vp, pt2, pos2)),
            ):
                got = counted(lambda: fn(*args), counter, 1, f"{name} {shape}")
                require(bool((got[0] == 0).all()), f"{name} {shape}: the parked lane is not zero")
                record(name, shape, got, ref_fn(*args), tol_out, n_bytes, 4.0 * hd * 32 * 564,
                       dtype)
            del kp, vp, ks, vs, ki, vi

    # 32 query heads on one KV head: bf16 decode past the tensor-core body's 16
    q = randn(torch.bfloat16, 1, 1, 32, 128)
    k, v = (random_kv8((1, 1, 1024, 128), device, gen) for _ in range(2))
    shape = "bf16 H=32 KH=1 S=1024 pos=563"
    got = counted(lambda: flash_decode(q, k, v, 563), flash_decode_kv8, 1,
                  f"flash_decode_kv8 {shape}")
    record("flash_decode_kv8", shape, got, flash_decode_ref(q, k, v, 563), TOL_BF16_OUT,
           _kv8_bytes(1, 564, 128) + 2 * q.numel() * 2, 4.0 * 128 * 32 * 564, torch.bfloat16)
    return rows


# the mixed-type entries' pairs (q's type, the cache's type): a float cache
# type unlike the model's (`--kv-dtype`), each pair a ``_mx`` instantiation
MIXED_PAIRS = (("f32", "bf16"), ("f32", "f16"), ("bf16", "f16"), ("bf16", "f32"))
MIXED_DECODE_POS = (0, 563, 4095)
# the prefill stats' pairs beyond bf16 q over a bf16 or int8 cache (the
# mixed pairs, f32 over f32 and f32 over int8): each enters the tensor
# cores as bf16 parts of its operands
STATS_PAIRS = MIXED_PAIRS + (("f32", "f32"), ("f32", "int8"))
# the bf16 wgmma passes a key tile of the stats body (QK^T, PV) for each
# (q, cache) pair: csrc/flash_attention.cu's table, which its C entry
# `flash_attention_stats_plan` must report
STATS_PASSES = {("bf16", "bf16"): (1, 2), ("bf16", "int8"): (1, 2), ("bf16", "f16"): (2, 3),
                ("bf16", "f32"): (3, 3), ("f32", "bf16"): (3, 2), ("f32", "int8"): (3, 2),
                ("f32", "f16"): (5, 3), ("f32", "f32"): (6, 3)}
TYPE_CODES = {"f32": 0, "bf16": 1, "f16": 2, "int8": 3}  # csrc/common.cuh TypeCode


def stats_passes(qn: str, kn: str) -> tuple[int, int]:
    """(QK^T, PV) passes the stats body issues a key tile for q in ``qn``
    over a cache in ``kn``, as the compiled source reports them."""
    from dllama_tpu_torch.ops import _build

    code = _build.load("flash_attention_stats_plan")(TYPE_CODES[qn], TYPE_CODES[kn])
    require(code > 0, f"flash_attention_stats_plan {qn}/{kn}: no body takes the pair ({code})")
    return divmod(code, 16)


def adversarial_leaf(name: str, shape: tuple, role: str, device, gen):
    """Inputs that stress the stats body's bf16 parts (the CPU twin is
    tests/test_torch_stats_parts.py): q rows (``role`` "q") and V rows
    scaled by 2^12 or 2^-12, K by 2^-12 (some rows 2^-24), so that no score
    leaves a softmax's working range; in f32 a quarter of the values halfway
    between two bf16 values; in f16, V values near 65504 and subnormal; in
    int8 (a QuantKV leaf) a quarter of the values at +-127, K's row scales
    2^-20 .. 2^-18 and V's 2^8 .. 2^12."""
    import torch

    from dllama_tpu_torch.ops.kv_cache import QuantKV

    def rand(shp):
        return torch.rand(shp, device=device, generator=gen)

    def ints(lo, hi, shp):
        return torch.randint(lo, hi, shp, device=device, generator=gen)

    if name == "int8":
        edge = torch.where(rand(shape) < 0.5, -127, 127)
        vals = torch.where(rand(shape) < 0.25, edge, ints(-127, 128, shape)).to(torch.int8)
        lo, hi = (-20.0, -18.0) if role == "k" else (8.0, 12.0)
        return QuantKV(vals.contiguous(), torch.exp2(lo + (hi - lo) * rand(shape[:-1] + (1,))))
    x = torch.randn(shape, device=device, generator=gen)
    r = ints(0, 8, shape[:-1] + (1,))
    if role == "k":
        x = x * torch.where(r == 0, 2.0**-24, 2.0**-12)
    else:
        x = x * torch.where(r == 0, 2.0**12, torch.where(r == 1, 2.0**-12, 1.0))
    if name == "f32":
        b = x.bfloat16().float()
        ulp = torch.exp2(torch.floor(torch.log2(b.abs() + 1e-38)) - 7)
        x = torch.where(rand(shape) < 0.25, b + ulp / 2, x)
    if name == "f16" and role == "v":
        pick, sign = rand(shape), torch.where(rand(shape) < 0.5, -1.0, 1.0)
        big = (65504.0 - 32.0 * ints(0, 4, shape)) * sign
        tiny = ints(1, 1024, shape) * 2.0**-24 * sign
        x = torch.where(pick < 1 / 32, big, torch.where(pick < 1 / 16, tiny, x))
    types = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    return x.to(types[name]).contiguous()


def _shuffled_pages(x, perm):
    """Pool pages x [1 + n, ...] (page 0 scratch) with page i + 1 moved to
    page perm[i] + 1; QuantKV leaf by leaf."""
    from dllama_tpu_torch.ops.kv_cache import QuantKV

    if isinstance(x, QuantKV):
        return QuantKV(*(_shuffled_pages(t, perm) for t in x))
    y = x.clone()
    y[1 + perm] = x[1:]
    return y


def check_mixed(device, gen, timed: bool = True) -> list[dict]:
    """The prefill stats for every pair of `STATS_PAIRS` and the mixed-type
    decode entries (``*_mx``: q and the cache each in its own float type)
    for every pair of `MIXED_PAIRS`, at llama-8b heads (H 32, KH 8, hd
    128). Stats, one tensor-core body for every pair (`stats_passes` must
    report the passes of `STATS_PASSES`, printed with the body): slab at T
    512 over S 4096 at pos 3584 on random inputs and on `adversarial_leaf`
    inputs, through a shuffled page table (page 16, B 4, T 128) with the
    identity table giving the slab entry's bits, and over a cyclic shard (H
    16, KH 4, T 256, S 2048, stride 2); each within TOL of its plain version,
    launched twice with equal bits, counted under its counter (the mixed
    pairs' ``flash_attention_stats_mixed``, f32 over f32
    ``flash_attention_stats``, f32 over int8 ``flash_attention_stats_kv8``,
    the shards ``flash_attention_stats_strided`` and ``_kv8``). Bound: 4 hd
    operations a visible (query, key) pair at the bf16 tensor-core peak,
    the f32 peak's figure (``bound_f32_ms``) printed beside it. Decode: slab
    at `MIXED_DECODE_POS` and through a shuffled page table (B 4 at
    `PAGED_POS`), the identity table giving the slab entry's bits, within
    TOL (f32 q) or TOL_BF16_OUT (bf16 outputs). Timed: the kernel, its
    plain version and ``composite_ms``, the cast (or dequantization) of the
    cache to q's type then SDPA (two calls; ``library_ms`` none: no single
    PyTorch call attends over a cache of another type or int8), for f32
    over f32 ``library_ms`` SDPA in f32."""
    import torch

    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops.kv_cache import dequant_kv, lane_views

    types = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    h, kh, hd, t, s = 32, 8, 128, 512, 4096
    rows = []

    def row(name, shape, got, ref, n_bytes, pairs, out_bf16, counter, launches, heads=h,
            stats=False):
        torch.cuda.synchronize(device)
        got_t, ref_t = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        errs = [norm_err(a, b) for a, b in zip(got_t, ref_t)]
        rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        tol = TOL_BF16_OUT if out_bf16 else TOL
        require(rel <= tol, f"{name} {shape}: error {rel:.3e} > {tol}")
        require(counter.launches == launches,
                f"{name} {shape}: {counter.launches} launches, wanted {launches}")
        # the stats run on the tensor cores for every pair; decode's mixed
        # bodies on the CUDA cores
        ops = 4.0 * hd * heads * pairs
        b_ms, b_by = bound(n_bytes, ops, BF16_FLOPS if stats else F32_FLOPS)
        r = dict(name=name, shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
        if stats:
            r["bound_f32_ms"] = bound(n_bytes, ops, F32_FLOPS)[0]
        return r

    for qn, kn in MIXED_PAIRS:
        qt, kt = types[qn], types[kn]
        tag, qb, kb = f"{qn}/{kn}", qt.itemsize, kt.itemsize

        # slab decode
        k, v = (torch.randn((1, kh, s, hd), device=device, generator=gen).to(kt)
                for _ in range(2))
        c = fa.flash_decode_mixed
        for p in MIXED_DECODE_POS:
            q = torch.randn((1, 1, h, hd), device=device, generator=gen).to(qt)
            n0 = c.launches
            got = twice_equal(lambda: fa.flash_decode(q, k, v, p), f"flash_decode_mixed {tag}")
            ref = fa.flash_decode_ref(q, k, v, p)
            n_bytes = 2 * q.numel() * qb + 2 * kh * (p + 1) * hd * kb
            r = row("flash_decode_mixed", f"{tag} H={h} KH={kh} S={s} pos={p}", got, ref,
                    n_bytes, p + 1, qt == torch.bfloat16, c, n0 + 2)
            if timed:
                qs, ks, vs = q.transpose(1, 2), k[:, :, : p + 1], v[:, :, : p + 1]
                r["ms"] = time_ms(lambda: fa.flash_decode(q, k, v, p), device)
                r["plain_ms"] = time_ms(lambda: fa.flash_decode_ref(q, k, v, p), device, 5)
                r["composite_ms"] = time_ms(lambda: _sdpa(qs, ks.to(qt), vs.to(qt), None),
                                            device)
            rows.append(r)
        del k, v

        # paged decode, with the identity table's bits
        (kp, vp), pt, (ks_, vs_), (ki, vi), pt_ident = _paged_case(device, gen, h, kh, kt)
        posv = torch.tensor(PAGED_POS, dtype=torch.int32, device=device)
        q = torch.randn((4, 1, h, hd), device=device, generator=gen).to(qt)
        c = fa.paged_flash_decode_mixed
        n0 = c.launches
        shape = f"{tag} H={h} KH={kh} B=4 pos={','.join(map(str, PAGED_POS))}"
        got = twice_equal(lambda: fa.paged_flash_decode(q, kp, vp, pt, posv),
                          f"paged_flash_decode_mixed {shape}")
        ref = fa.paged_flash_decode_ref(q, kp, vp, pt, posv)
        ident = fa.paged_flash_decode(q, ki, vi, pt_ident, posv)
        slab = fa.flash_decode(q, ks_, vs_, posv)
        torch.cuda.synchronize(device)
        require(torch.equal(ident, slab),
                f"paged_flash_decode_mixed {shape}: identity table differs from flash_decode")
        live = sum(p + 1 for p in PAGED_POS)
        n_bytes = 2 * kh * live * hd * kb + 2 * q.numel() * qb + pt.numel() * 4
        r = row("paged_flash_decode_mixed", shape, got, ref, n_bytes, live,
                qt == torch.bfloat16, c, n0 + 3)
        r["identity_bits_equal"] = True
        if timed:
            lk, lv = lane_views(kp, pt), lane_views(vp, pt)
            mask = (torch.arange(s, device=device)[None, :] <= posv[:, None])[:, None, None]
            qs = q.transpose(1, 2)
            r["ms"] = time_ms(lambda: fa.paged_flash_decode(q, kp, vp, pt, posv), device)
            r["plain_ms"] = time_ms(lambda: fa.paged_flash_decode_ref(q, kp, vp, pt, posv),
                                    device, 5)
            r["composite_ms"] = time_ms(lambda: _sdpa(qs, lk.to(qt), lv.to(qt), mask), device)
            del lk, lv
        rows.append(r)
        del kp, vp, ks_, vs_, ki, vi
        gc.collect()

    for qn, kn in STATS_PAIRS:
        qt, tag = types[qn], f"{qn}/{kn}"
        quant = kn == "int8"
        qk, pv = stats_passes(qn, kn)
        require((qk, pv) == STATS_PASSES[(qn, kn)],
                f"flash_attention_stats {tag}: the body issues {qk} + {pv} passes, the source's "
                f"table states {STATS_PASSES[(qn, kn)]}")
        counter = (fa.flash_attention_stats_kv8 if quant else fa.flash_attention_stats
                   if qn == kn else fa.flash_attention_stats_mixed)
        strided = fa.flash_attention_stats_strided_kv8 if quant else fa.flash_attention_stats_strided
        row_bytes = hd + 4 if quant else hd * types[kn].itemsize  # a K or V row

        def cache(shape, adversarial=False):
            if adversarial:
                return (adversarial_leaf(kn, shape, "k", device, gen),
                        adversarial_leaf(kn, shape, "v", device, gen))
            if quant:
                return random_kv8(shape, device, gen), random_kv8(shape, device, gen)
            return tuple(torch.randn(shape, device=device, generator=gen).to(types[kn])
                         for _ in range(2))

        # slab, random then adversarial inputs
        pos = s - t
        vis = sum(min(s, pos + i + 1) for i in range(t))
        n_bytes = t * h * hd * qt.itemsize + 2 * kh * s * row_bytes + h * t * (hd + 2) * 4
        for adv in (False, True):
            q = (adversarial_leaf(qn, (1, t, h, hd), "q", device, gen) if adv else
                 torch.randn((1, t, h, hd), device=device, generator=gen).to(qt))
            k, v = cache((1, kh, s, hd), adv)
            shape = f"{tag}{' adversarial' if adv else ''} H={h} KH={kh} T={t} S={s} pos={pos}"
            n0 = counter.launches
            got = twice_equal(lambda: fa.flash_attention_stats(q, k, v, pos),
                              f"{counter.__name__} {shape}")
            ref = fa.flash_attention_stats_ref(q, k, v, pos)
            r = row(counter.__name__, shape, got, ref, n_bytes, vis, False, counter, n0 + 2,
                    stats=True)
            r.update(body="flash_stats_tc_kernel (wgmma)", passes=(qk, pv))
            if timed and not adv:
                qpos = pos + torch.arange(t, device=device)
                mask = torch.arange(s, device=device)[None, :] <= qpos[:, None]
                qs = q.transpose(1, 2)
                r["ms"] = time_ms(lambda: fa.flash_attention_stats(q, k, v, pos), device)
                r["plain_ms"] = time_ms(lambda: fa.flash_attention_stats_ref(q, k, v, pos),
                                        device, 5)
                if qn == kn:  # one library call: SDPA in f32
                    r["library_ms"] = time_ms(lambda: _sdpa(qs, k, v, mask), device)
                else:  # the cache cast (dequantized) to q's type, then SDPA
                    r["composite_ms"] = time_ms(
                        lambda: _sdpa(qs, dequant_kv(k, qt).to(qt), dequant_kv(v, qt).to(qt),
                                      mask), device)
                    if quant:  # SDPA in f32 on a cache dequantized ahead
                        kd, vd = dequant_kv(k, qt), dequant_kv(v, qt)
                        r["sdpa_f32_ms"] = time_ms(lambda: _sdpa(qs, kd, vd, mask), device)
                        del kd, vd
            rows.append(r)
            del q, k, v

        # paged: a shuffled table over the slab's pages, and the identity table
        b_, tc, nb = 4, 128, s // PAGE
        k, v = cache((b_, kh, s, hd))
        ki, vi = (_ident_pages(x, b_, kh, nb) for x in (k, v))
        pt_ident = (1 + torch.arange(b_ * nb, device=device, dtype=torch.int32)).reshape(b_, nb)
        perm = torch.randperm(b_ * nb, device=device, generator=gen)
        kp, vp = (_shuffled_pages(x, perm) for x in (ki, vi))
        pt = (1 + perm[pt_ident.long() - 1]).to(torch.int32)
        q_pos0 = torch.tensor([256, 3000, 0, s - tc], dtype=torch.int32, device=device)
        qc = torch.randn((b_, tc, h, hd), device=device, generator=gen).to(qt)
        shape = f"{tag} H={h} KH={kh} B={b_} T={tc} paged"
        n0 = counter.launches
        got = twice_equal(lambda: fa.paged_flash_attention_stats(qc, kp, vp, pt, q_pos0),
                          f"{counter.__name__} {shape}")
        ref = fa.flash_attention_stats_ref(qc, k, v, q_pos0)
        ident = fa.paged_flash_attention_stats(qc, ki, vi, pt_ident, q_pos0)
        slab = fa.flash_attention_stats(qc, k, v, q_pos0)
        torch.cuda.synchronize(device)
        require(all(torch.equal(a, b) for a, b in zip(ident, slab)),
                f"{counter.__name__} {shape}: identity table differs from the slab entry")
        vis = sum(min(s, int(p) + i + 1) for p in q_pos0.tolist() for i in range(tc))
        n_bytes = (qc.numel() * qt.itemsize + 2 * kh * row_bytes
                   * sum(min(s, int(p) + tc) for p in q_pos0.tolist())
                   + h * b_ * tc * (hd + 2) * 4 + pt.numel() * 4)
        r = row(counter.__name__, shape, got, ref, n_bytes, vis, False, counter, n0 + 4,
                stats=True)
        r.update(identity_bits_equal=True, body="flash_stats_tc_kernel (wgmma)", passes=(qk, pv))
        rows.append(r)
        del k, v, ki, vi, kp, vp, qc

        # a cyclic shard: key row j at position j * 2
        c = SP_SHAPE
        ts, stride, s_loc = c["t"], 2, c["s_local"]
        pos = s_loc * stride - ts - 7
        q = torch.randn((1, ts, c["h"], c["hd"]), device=device, generator=gen).to(qt)
        k, v = cache((1, c["kh"], s_loc, c["hd"]))
        shape = f"{tag} H={c['h']} KH={c['kh']} T={ts} S={s_loc} stride={stride} pos={pos}"
        n0 = strided.launches
        got = twice_equal(lambda: fa.flash_attention_stats(q, k, v, pos, 0, s_stride=stride),
                          f"{strided.__name__} {shape}")
        ref = fa.flash_attention_stats_ref(q, k, v, pos, 0, s_stride=stride)
        vis = sum(max(0, min(s_loc, (pos + i) // stride + 1)) for i in range(ts))
        n_keys = min(s_loc, (pos + ts - 1) // stride + 1)
        n_bytes = (q.numel() * qt.itemsize + 2 * c["kh"] * n_keys * row_bytes
                   + c["h"] * ts * (c["hd"] + 2) * 4)
        r = row(strided.__name__, shape, got, ref, n_bytes, vis, False, strided, n0 + 2,
                heads=c["h"], stats=True)
        r.update(body="flash_stats_tc_kernel (wgmma)", passes=(qk, pv))
        rows.append(r)
        del q, k, v
        gc.collect()
        print(f"flash_attention_stats {tag}: body flash_stats_tc_kernel (wgmma, bf16 parts), "
              f"passes a key tile QK^T {qk} + PV {pv} (flash_attention_stats_plan)")
    for pair in (("bf16", "bf16"), ("bf16", "int8")):
        got = stats_passes(*pair)
        require(got == STATS_PASSES[pair], f"flash_attention_stats {pair}: passes {got}")
        print(f"flash_attention_stats {pair[0]}/{pair[1]}: body flash_stats_tc_kernel (wgmma), "
              f"passes a key tile QK^T {got[0]} + PV {got[1]} (flash_attention_stats_plan)")
    return rows


MOE_DECODE_LANES = 4  # the serving lanes of a decode step


def check_moe_tiers(device, gen, timed: bool = True) -> list[dict]:
    """The two-tier decode (`moe_decode_tiers`, ``--moe-decode-dedup``) at
    A3B's experts (E 128, D 2048, F 768, k 8) and a 4-lane decode step (n 4,
    cap (4 * 8) // 2 = 16), dense bf16 and Q40 experts, bf16 and f32 x:
    with every lane on the same 8 experts (u 8 <= cap) the grouped kernel
    takes the step under the cap's schedule (ceil(32 / 64) + 16 = 17 runs)
    and the active one returns at once; held within TOL_MOE_BF16 (bf16) or
    TOL (f32) of `moe_experts_ref`, printed against the active kernel alone
    on the same inputs, launched twice with equal bits, and the tier tally
    moved by one grouped step each. With 32 distinct experts (u 32 > cap)
    the grouped grid does nothing, the output has the active kernel's bits
    alone, and nothing faults (the capped schedule's rows are clamped into
    its grid). Timed: the tiered call against the active kernel alone on
    the identical-routing inputs (``library_ms`` none), and `tier_times`:
    each tier's kernel alone on a schedule built ahead, and the wrapper
    replayed from a CUDA graph."""
    import torch

    from dllama_tpu_torch.ops import moe
    from dllama_tpu_torch.ops.quant_matmul import QuantWeight, dequant

    e, d, f, k = (MOE_SHAPE[key] for key in ("e", "d", "f", "k"))
    n = MOE_DECODE_LANES
    cap = moe.dedup_cap(n, k, True)

    def q40(rows, cols):
        q = torch.randint(-8, 8, (e, rows, cols), dtype=torch.int8, device=device, generator=gen)
        sc = ((torch.rand((e, rows, cols // 32), device=device, generator=gen) + 0.5) * 0.004)
        sc = torch.where(torch.rand(sc.shape, device=device, generator=gen) < 0.5, -sc, sc)
        return QuantWeight(q, sc.half().contiguous())

    qw = [q40(f, d), q40(d, f), q40(f, d)]
    tally = moe.tier_tally(device)
    rows = []
    for quant in (True, False):
        for dtype in (torch.bfloat16, torch.float32):
            ws = qw if quant else [dequant(w, dtype) for w in qw]
            grouped = moe.moe_grouped_experts_q40 if quant else moe.moe_grouped_experts
            active = moe.moe_active_experts_q40 if quant else moe.moe_active_experts
            tag = "f32" if dtype == torch.float32 else "bf16"
            x = torch.randn((n, d), device=device, generator=gen).to(dtype)
            wts = torch.rand((n, k), device=device, generator=gen) + 0.1
            wts = wts / wts.sum(-1, keepdim=True)
            chosen = torch.randperm(e, device=device, generator=gen)[:k].int()
            shared = chosen[torch.rand((n, k), device=device, generator=gen).argsort(-1)]
            distinct = torch.randperm(e, device=device, generator=gen)[: n * k].int().view(n, k)
            for routing, top_i in (("u=8", shared), ("u=32", distinct)):
                label = f"{tag} decode n={n} cap={cap} {routing}"
                g0, a0 = grouped.launches, active.launches
                tally.zero_()
                got = twice_equal(lambda: moe.moe_decode_tiers(x, *ws, top_i, wts, cap),
                                  f"{grouped.__name__} {label}")
                alone = active(x, *ws, top_i, wts)
                ref = moe.moe_experts_ref(x, *ws, top_i, wts)
                torch.cuda.synchronize(device)
                require(grouped.launches == g0 + 2 and active.launches == a0 + 3,
                        f"{label}: the tiers did not launch both kernels")
                took, steps = tally.tolist()
                want = 2 if routing == "u=8" else 0
                require((took, steps) == (want, 2),
                        f"{label}: {took} of {steps} steps took the grouped tier, wanted {want}")
                rel, absd = norm_err(got, ref)
                tol = TOL if dtype == torch.float32 else TOL_MOE_BF16
                require(rel <= tol, f"{label}: error {rel:.3e} > {tol}")
                vs_active = norm_err(got, alone)[0]
                if routing == "u=32":
                    require(torch.equal(got, alone),
                            f"{label}: the active tier's output is not the active kernel's bits")
                    continue
                w_bytes = sum((w.q.numel() + w.d.numel() * 2) if quant
                              else w.numel() * w.element_size() for w in ws) // e
                n_bytes = k * w_bytes + x.numel() * x.element_size() + n * d * 4 + n * k * 8
                b_ms, b_by = bound(n_bytes, 6.0 * n * k * d * f,
                                   F32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
                r = dict(name=grouped.__name__, shape=label, err=rel, max_abs_err=absd,
                         bound_ms=b_ms, bound_by=b_by, experts=k, library_ms=None,
                         vs_active=vs_active)
                if timed:
                    r["ms"] = time_ms(lambda: moe.moe_decode_tiers(x, *ws, top_i, wts, cap),
                                      device)
                    r["active_ms"] = time_ms(lambda: active(x, *ws, top_i, wts), device)
                    r["plain_ms"] = time_ms(lambda: moe.moe_experts_ref(x, *ws, top_i, wts),
                                            device, 5)
                    r.update(tier_times(quant, x, ws, top_i, wts, cap, device))
                rows.append(r)
            del ws
            gc.collect()
    return rows


def tier_times(quant: bool, x, ws, top_i, wts, cap: int, device) -> dict:
    """The two-tier decode on device time: the capped grouped kernel alone
    and the active tier alone (its blocks return at the device predicate),
    each launched from its C entry on a schedule, predicate and buffers
    built ahead of the timed window (uncounted: these are no main-path
    launches), and the whole `moe_decode_tiers` wrapper (the schedule's
    torch ops, both kernels, the select) replayed from one CUDA graph, the
    way a captured decode step runs it."""
    import torch

    from dllama_tpu_torch.ops import _build, moe

    n, d = x.shape
    e, f, k = MOE_SHAPE["e"], MOE_SHAPE["f"], top_i.shape[1]
    sched = moe.grouped_schedule(top_i, wts, e, max_segments=cap)
    fits = sched.n_used <= cap
    n_tiles, skip = torch.where(fits, sched.n_tiles, 0), fits.to(torch.int32)
    max_tiles = sched.tile_expert.shape[0]
    hidden = torch.empty((max_tiles * moe.GROUP_ROWS, f), dtype=x.dtype, device=device)
    rows_out = torch.empty((max_tiles * moe.GROUP_ROWS, d), dtype=torch.float32, device=device)
    ti, wt = top_i.to(torch.int32).contiguous(), wts.float().contiguous()
    a_hidden = torch.empty((n, k, f), dtype=torch.float32, device=device)
    a_out = torch.empty((n, d), dtype=torch.float32, device=device)
    ptrs = moe._pointers(quant, ws[0], ws[2], ws[1])
    bf16, stream = int(x.dtype == torch.bfloat16), _build.stream(device)
    grouped, tier = _build.load("moe_grouped"), _build.load("moe_active_tier")

    def grouped_alone():
        _build.check(grouped(x.data_ptr(), *ptrs, sched.row_token.data_ptr(),
                             sched.row_weight.data_ptr(), sched.tile_expert.data_ptr(),
                             n_tiles.data_ptr(), hidden.data_ptr(), rows_out.data_ptr(),
                             max_tiles, d, f, bf16, int(quant), stream), "moe_grouped")

    def active_alone():
        _build.check(tier(x.data_ptr(), *ptrs, ti.data_ptr(), wt.data_ptr(), a_hidden.data_ptr(),
                          a_out.data_ptr(), skip.data_ptr(), n, k, d, f, bf16, int(quant),
                          stream), "moe_active_tier")

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # first use off the capture
        moe.moe_decode_tiers(x, *ws, top_i, wts, cap)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        moe.moe_decode_tiers(x, *ws, top_i, wts, cap)
    out = dict(grouped_kernel_ms=time_ms(grouped_alone, device),
               active_tier_ms=time_ms(active_alone, device), graphed_ms=time_ms(graph.replay, device))
    del graph
    return out


RAGGED_T = 100  # a prefill chunk that fills no tile


def check_attention_edges(device, gen) -> list[dict]:
    """Both attention kernels at edge shapes, H 32 over KH 8 and 4, bf16 and
    f32, each launched twice with equal bits required: prefill stats with a
    ragged T = 100 over three lanes, one parked at q_pos0 = -T, whose state
    must be m = -1e30, l = 0, acc = 0; decode, slab and paged, over two
    lanes, one parked at pos -1, whose output must be zeros; and bf16
    decode at 32 query heads a KV head (the CUDA-core body). Untimed."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats,
        flash_attention_stats_ref,
        flash_decode,
        flash_decode_ref,
        paged_flash_decode,
        paged_flash_decode_ref,
    )

    hd, s, t, rows = 128, 512, RAGGED_T, []
    for kh in (8, 4):
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
            size = torch.tensor([], dtype=dtype).element_size()

            def randn(*shape):
                return torch.randn(shape, device=device, generator=gen).to(dtype)

            starts = (300, -t, 0)
            q_pos0 = torch.tensor(starts, dtype=torch.int32, device=device)
            q, k, v = randn(3, t, 32, hd), randn(3, kh, s, hd), randn(3, kh, s, hd)
            shape = f"{tag} H=32 KH={kh} B=3 T={t} q_pos0={','.join(map(str, starts))}"
            got = twice_equal(lambda: flash_attention_stats(q, k, v, q_pos0),
                              f"flash_attention_stats {shape}")
            ref = flash_attention_stats_ref(q, k, v, q_pos0)
            errs = [norm_err(a, b) for a, b in zip(got, ref)]
            rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
            require(rel <= TOL, f"flash_attention_stats {shape}: error {rel:.3e} > {TOL}")
            acc, m, l = got
            require(bool((acc[1] == 0).all() and (l[1] == 0).all() and (m[1] <= -1e29).all()),
                    f"flash_attention_stats {shape}: the parked lane's state is not empty")
            vis = sum(min(s, max(0, p + i + 1)) for p in starts for i in range(t))
            n_bytes = (q.numel() * size + 2 * kh * hd * size
                       * sum(min(s, max(0, p + t)) for p in starts) + 32 * 3 * t * (hd + 2) * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * hd * 32 * vis, peak)
            rows.append(dict(name="flash_attention_stats", shape=shape, err=rel,
                             max_abs_err=absd, bound_ms=b_ms, bound_by=b_by))

            pos = torch.tensor([-1, 563], dtype=torch.int32, device=device)
            qd = randn(2, 1, 32, hd)
            (kp, vp), pt, (ks, vs), _, _ = _paged_case(device, gen, 32, kh, dtype, s=1024, b=2)
            n_bytes = 2 * kh * 564 * hd * size + 2 * qd.numel() * size
            b_ms, b_by = bound(n_bytes, 4.0 * hd * 32 * 564, peak)
            tol = TOL if dtype == torch.float32 else TOL_BF16_OUT
            for name, fn, ref_fn, args in (
                ("flash_decode", flash_decode, flash_decode_ref, (qd, ks, vs, pos)),
                ("paged_flash_decode", paged_flash_decode, paged_flash_decode_ref,
                 (qd, kp, vp, pt, pos)),
            ):
                shape = f"{tag} H=32 KH={kh} B=2 pos=-1,563"
                got = twice_equal(lambda: fn(*args), f"{name} {shape}")
                rel, absd = norm_err(got, ref_fn(*args))
                require(rel <= tol, f"{name} {shape}: error {rel:.3e} > {tol}")
                require(bool((got[0] == 0).all()), f"{name} {shape}: the parked lane is not zero")
                rows.append(dict(name=name, shape=shape, err=rel, max_abs_err=absd,
                                 bound_ms=b_ms, bound_by=b_by))
            del q, k, v, kp, vp, ks, vs

    # 32 query heads on one KV head: bf16 decode past the tensor-core body's 16
    q = torch.randn((1, 1, 32, hd), device=device, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((1, 1, 1024, hd), device=device, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    shape = "bf16 H=32 KH=1 S=1024 pos=563"
    got = twice_equal(lambda: flash_decode(q, k, v, 563), f"flash_decode {shape}")
    rel, absd = norm_err(got, flash_decode_ref(q, k, v, 563))
    require(rel <= TOL_BF16_OUT, f"flash_decode {shape}: error {rel:.3e} > {TOL_BF16_OUT}")
    b_ms, b_by = bound(2 * 564 * hd * 2 + 2 * q.numel() * 2, 4.0 * hd * 32 * 564)
    rows.append(dict(name="flash_decode", shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms,
                     bound_by=b_by))
    return rows


def check_moe(device, gen, timed: bool = True) -> list[dict]:
    """The four MoE kernels against `moe_experts_ref` at the A3B expert
    shapes with random routing: active at m = 1, 4 and 16, grouped at N =
    17 and 512, bf16 x over dense bf16 and Q40 experts, and f32 x at m = 16
    and N = 512 (kernel and plain share every rounding there: TOL); the
    grouped Q40 kernel also at N = 512 with skewed routing (every token on
    the same 8 experts: 8 runs an expert, 120 experts idle); untimed at
    `MOE_EDGE`, the active kernels at m = 3 and the grouped ones at N = 17
    and 64. Every kernel runs twice on the same inputs and must repeat its
    bits, and each timed row reads both timers (`time_ms`, `time_clean`).
    Each bf16 row at the A3B shapes also reads the plain version with one
    of its bf16 roundings skipped (the hidden's; for Q40 the dequantized
    weight's) against the sound one: such a fault must read above
    TOL_MOE_BF16, or the limit could not catch it."""
    from unittest import mock

    import torch

    from dllama_tpu_torch.ops import moe
    from dllama_tpu_torch.ops.quant_matmul import QuantWeight, dequant

    def q40(e, rows, cols):
        q = torch.randint(-8, 8, (e, rows, cols), dtype=torch.int8, device=device, generator=gen)
        sc = ((torch.rand((e, rows, cols // 32), device=device, generator=gen) + 0.5) * 0.004)
        sc = torch.where(torch.rand(sc.shape, device=device, generator=gen) < 0.5, -sc, sc)
        return QuantWeight(q, sc.half().contiguous())

    def experts(e, d, f):
        qw = [q40(e, f, d), q40(e, d, f), q40(e, f, d)]  # w1, w2, w3
        dense = {torch.bfloat16: [dequant(w, torch.bfloat16) for w in qw]}
        dense[torch.float32] = [w.float() for w in dense[torch.bfloat16]]
        return qw, dense

    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        (name, n, dtype, MOE_SHAPE, False)
        for name, n, dtype in [
            ("moe_active_experts", 1, bf), ("moe_active_experts", 4, bf),
            ("moe_active_experts", 16, bf), ("moe_active_experts", 16, f32),
            ("moe_active_experts_q40", 1, bf), ("moe_active_experts_q40", 4, bf),
            ("moe_active_experts_q40", 16, bf), ("moe_active_experts_q40", 16, f32),
            ("moe_grouped_experts", 17, bf), ("moe_grouped_experts", 512, bf),
            ("moe_grouped_experts", 512, f32),
            ("moe_grouped_experts_q40", 17, bf), ("moe_grouped_experts_q40", 512, bf),
            ("moe_grouped_experts_q40", 512, f32),
        ]
    ] + [("moe_grouped_experts_q40", 512, bf, MOE_SHAPE, True)] + [
        (name, n, bf, MOE_EDGE, False)
        for name, n in [("moe_active_experts", 3), ("moe_active_experts_q40", 3),
                        ("moe_grouped_experts", 17), ("moe_grouped_experts", 64),
                        ("moe_grouped_experts_q40", 17), ("moe_grouped_experts_q40", 64)]
    ]
    rows, weights = [], {}
    for name, n, dtype, shape, skewed in cases:
        e, d, f, k = (shape[key] for key in ("e", "d", "f", "k"))
        if id(shape) not in weights:
            weights.clear()
            gc.collect()
            weights[id(shape)] = experts(e, d, f)
        qw, dense = weights[id(shape)]
        quant = name.endswith("_q40")
        active = "active" in name
        ws = qw if quant else dense[dtype]
        fn = getattr(moe, name)
        x = torch.randn((n, d), device=device, generator=gen).to(dtype)
        top_i = torch.rand((n, e), device=device, generator=gen).topk(k, dim=-1).indices.int()
        if skewed:  # the same k experts for every token, in a random order each
            chosen = torch.randperm(e, device=device, generator=gen)[:k].int()
            top_i = chosen[torch.rand((n, k), device=device, generator=gen).argsort(-1)]
        wts = torch.rand((n, k), device=device, generator=gen) + 0.1
        wts = wts / wts.sum(-1, keepdim=True)
        before = fn.launches
        tag = "f32" if dtype == torch.float32 else "bf16"
        label = f"{tag} {'m' if active else 'N'}={n}" + ("" if shape is MOE_SHAPE else
                                                          f" E={e} D={d} F={f} k={k}")
        label += " skewed" if skewed else ""
        got = twice_equal(lambda: fn(x, *ws, top_i, wts), f"{name} {label}")
        ref = moe.moe_experts_ref(x, *ws, top_i, wts)
        torch.cuda.synchronize(device)
        require(fn.launches == before + 2, f"{name}: the wrapper did not launch its kernel")
        rel, absd = norm_err(got, ref)
        tol = TOL if dtype == torch.float32 else TOL_MOE_BF16
        require(rel <= tol, f"{name} {label}: error {rel:.3e} > {tol}")
        unrounded = {}
        if dtype == torch.bfloat16 and shape is MOE_SHAPE:
            # x in f32 over the bf16-rounded weights: the hidden is not rounded
            faults = {"hidden": moe.moe_experts_ref(x.float(), *dense[dtype], top_i, wts)}
            if quant:  # the dequantized weight kept exact in f32
                expert = moe._expert
                with mock.patch.object(moe, "_expert", lambda w, i, _: expert(w, i, torch.float32)):
                    faults["weight"] = moe.moe_experts_ref(x, *ws, top_i, wts)
            for what, fault in faults.items():
                unrounded[what] = norm_err(fault, ref)[0]
                require(unrounded[what] > tol, f"{name} {label}: skipping the {what} rounding "
                        f"reads {unrounded[what]:.3e}, within the limit {tol}")
        n_exp = int(torch.unique(top_i).numel())
        w_bytes = sum((w.q.numel() + w.d.numel() * 2) if quant else w.numel() * w.element_size()
                      for w in ws) // e
        n_bytes = n_exp * w_bytes + x.numel() * x.element_size() + n * d * 4 + n * k * 8
        b_ms, b_by = bound(n_bytes, 6.0 * n * k * d * f)
        row = dict(
            name=name, shape=label, err=rel, max_abs_err=absd, bound_ms=b_ms, bound_by=b_by,
            experts=n_exp, library_ms=None, unrounded=unrounded,
        )
        if timed and shape is MOE_SHAPE:
            row["ms"] = time_ms(lambda: fn(x, *ws, top_i, wts), device)
            row["ms_clean"] = time_clean(lambda: fn(x, *ws, top_i, wts), device)
            row["plain_ms"] = time_ms(lambda: moe.moe_experts_ref(x, *ws, top_i, wts), device, 5)
        rows.append(row)
    return rows


def write_tokenizer_file(path: str, vocab_size: int) -> None:
    """Byte-level `.t`: 256 byte tokens, padding tokens up to the model's
    vocab, then BOS and two EOS specials."""
    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer

    specials = [b"<s>", b"</s>", b"<|eot|>"]
    vocab = [bytes([i]) for i in range(256)]
    vocab += [f"<pad{i}>".encode() for i in range(256, vocab_size - len(specials))]
    bos = len(vocab)
    vocab += specials
    write_tokenizer(
        path,
        TokenizerData(
            vocab=vocab, scores=[0.0] * len(vocab), bos_id=bos, add_bos=True,
            eos_token_ids=[bos + 1, bos + 2], chat_template=None,
            max_token_length=max(len(v) for v in vocab),
        ),
    )


def prompt_text(n_bytes: int) -> str:
    base = (
        "Distributed inference splits a large language model across devices so that "
        "each one holds a slice of every weight matrix and the slices meet again in "
        "an all-reduce after the attention and feed-forward blocks. "
    )
    return (base * (n_bytes // len(base) + 1))[:n_bytes]


def model_file_bytes(preset: str | dict, n_layers: int | None, max_seq_len: int) -> int:
    from dllama_tpu_torch.formats.model_file import tensor_plan
    from dllama_tpu_torch.models.synthetic import PRESETS, make_header

    cfg = dict(PRESETS[preset]) if isinstance(preset, str) else dict(preset)
    if n_layers:
        cfg["n_layers"] = n_layers
    last = tensor_plan(make_header(cfg, max_seq_len))[-1]
    return last.offset + last.nbytes


def start_prewrite(files: list[tuple], max_seq_len: int = 4096, seed: int = SEED):
    """Start a child process that writes model files the way `end_to_end`
    and the rounds after it would, one after another: each entry of
    ``files`` is (a directory, a preset, its layers[, its seed, ``seed``
    if left out]), written as the model
    under a temporary name, renamed to ``model.m`` once whole, and the
    tokenizer ``tok.t`` beside it, so that the host's writes overlap the
    card's earlier phases. Returns (the process, its start time);
    `finish_prewrite` waits for it."""
    files = [(d, preset, n, rest[0] if rest else seed) for d, preset, n, *rest in files]
    for d, *_ in files:
        os.makedirs(d, exist_ok=True)
    need = sum(model_file_bytes(preset, n, max_seq_len) for _, preset, n, _ in files)
    free = shutil.disk_usage(files[0][0]).free
    require(free > need + (16 << 30),
            f"{need / 1e9:.1f} GB of models written ahead, {free / 1e9:.1f} GB free")
    code = (
        "import json, os, sys\n"
        "import chip_smoke as c\n"
        "from dllama_tpu_torch.models.synthetic import write_synth_model\n"
        "s = int(sys.argv[2])\n"
        "for tmp, preset, n, seed in json.loads(sys.argv[1]):\n"
        "    os.makedirs(tmp, exist_ok=True)\n"
        "    part = os.path.join(tmp, 'model.m.part')\n"
        "    h = write_synth_model(part, preset, seed=seed, max_seq_len=s, n_layers=n)\n"
        "    c.write_tokenizer_file(os.path.join(tmp, 'tok.t'), h.vocab_size)\n"
        "    os.replace(part, os.path.join(tmp, 'model.m'))\n"
    )
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(files), str(max_seq_len)],
                            cwd=root)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def finish_prewrite(writer, label: str) -> None:
    """Wait for a `start_prewrite` child and print its time."""
    proc, t_start = writer
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    require(rc == 0, f"{label}: writing the model file ahead failed (exit {rc})")
    print(f"{label}: model file written ahead by a child process, done "
          f"{time.perf_counter() - t_start:.1f} s after its start; waited {time.perf_counter() - t0:.1f} s")


def end_to_end(device: str, preset: str | dict, n_layers: int | None, prompt_tokens: int,
               decode_tokens: int, max_seq_len: int, seed: int, tmp: str,
               weight_format: str = "auto", kv_dtype: str | None = None) -> dict:
    """Phase 3: write the model into tmp (unless a run before wrote it),
    run the port's inference CLI path (``--kv-dtype kv_dtype`` if given)."""
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    write_s = None
    if not os.path.exists(mp):
        need = model_file_bytes(preset, n_layers, max_seq_len)
        free = shutil.disk_usage(tmp).free
        require(free > need + (2 << 30),
                f"{preset}: {need / 1e9:.1f} GB model, {free / 1e9:.1f} GB free")
        t0 = time.perf_counter()
        h = write_synth_model(mp, preset, seed=seed, max_seq_len=max_seq_len, n_layers=n_layers)
        write_tokenizer_file(tp, h.vocab_size)
        write_s = time.perf_counter() - t0
    text = prompt_text(prompt_tokens - 1)  # one token per byte, plus BOS
    reset_launch_counts()
    res = cli.main([
        "inference", "--model", mp, "--tokenizer", tp, "--prompt", text,
        "--steps", str(prompt_tokens - 1 + decode_tokens), "--temperature", "0",
        "--device", device, "--seed", str(seed), "--weight-format", weight_format,
    ] + (["--kv-dtype", kv_dtype] if kv_dtype else []))
    counts = launch_counts()
    res.update(header=res["engine"].header, write_s=write_s, counts=counts, model_path=mp)
    return res


# the CLI's prefill buckets under its default --nbatches 32: (1, nbatches, 512)
CLI_BUCKETS = (1, 32, 512)


def forward_rows(n_prompt: int, n_decode: int, buckets=CLI_BUCKETS) -> list[int]:
    """Rows of each forward the engine runs: the padded prefill buckets of
    all but the last prompt token, then one row a decoded token."""
    rows, left = [], n_prompt - 1
    while left > 0:
        bucket = next((b for b in buckets if left <= b), buckets[-1])
        rows.append(bucket)
        left -= min(bucket, left)
    return rows + [1] * n_decode


# weight format -> the kernel of its attention, FFN and classifier matmuls
MATMUL_KERNEL = {"q40": "q40_matmul", "q40i4": "q40i4_matmul", "q40i8": "i8_matmul"}


def expected_launches(h, n_prompt: int, n_decode: int, weight_format: str,
                      kv8: bool = False) -> dict:
    """Launches the shapes imply. Per forward of n rows and L layers: the
    format's matmul kernel 7 a layer + the classifier (4 a layer for
    Qwen3-MoE, whose experts are not matmuls), none with dense weights; one
    attention a layer (stats for n > 1, decode for 1; their int8-KV
    instantiations, ``*_kv8``, when ``kv8``); for Qwen3-MoE one MoE
    kernel a layer, the active-experts one for n <= 16, else the grouped
    one, on Q40 experts under every quantized format."""
    from dllama_tpu_torch.ops import KERNELS
    from dllama_tpu_torch.ops.moe import MOE_KERNEL_MAX_TOKENS

    moe, n_l = h.is_moe, h.n_layers
    matmul = MATMUL_KERNEL.get(weight_format)
    want = dict.fromkeys(KERNELS, 0)
    for n in forward_rows(n_prompt, n_decode):
        if matmul:
            want[matmul] += (4 if moe else 7) * n_l + 1
        attn = "flash_attention_stats" if n > 1 else "flash_decode"
        want[attn + ("_kv8" if kv8 else "")] += n_l
        if moe:
            kind = "active" if n <= MOE_KERNEL_MAX_TOKENS else "grouped"
            want[f"moe_{kind}_experts{'_q40' if matmul else ''}"] += n_l
    return want


def nbytes(v) -> int:
    """Bytes of every tensor in v (`dllama_tpu_torch.obs.cost.nbytes`)."""
    from dllama_tpu_torch.obs.cost import nbytes as count

    return count(v)


def weight_bytes(params, h) -> int:
    """Weight bytes one decoded token reads: every non-expert matmul weight
    (values and scales) and, in a MoE layer, the f32 gate and k of the E
    experts, from the tensors (the engine's own count,
    `dllama_tpu_torch.obs.cost.weight_bytes_per_token`)."""
    from dllama_tpu_torch.obs.cost import weight_bytes_per_token

    return weight_bytes_per_token(h, "", params=params)


class ActTape:
    """The int8 activations of one forward through the kernel path, handed
    to the plain path (``forward(..., act_quant=...)``). `record` quantizes
    as the engine does and keeps each int8 matmul's input x with its (xq,
    sx), in call order; `replay` gives the plain path the recorded (xq, sx)
    of the same call, and measures how far its own x lies from the
    recorded one (max normalized error over the calls) and how many of its
    int8 values would have rounded otherwise."""

    def __init__(self):
        self.calls, self.at, self.err, self.flips, self.values = [], 0, 0.0, 0, 0

    def record(self, x, group):
        from dllama_tpu_torch.ops.int8_matmul import quantize_acts

        xq, sx = quantize_acts(x, group)
        self.calls.append((x, xq, sx))
        return xq, sx

    def replay(self, x, group):
        from dllama_tpu_torch.ops.int8_matmul import quantize_acts

        require(self.at < len(self.calls), "act tape: more int8 matmuls than were recorded")
        x_rec, xq, sx = self.calls[self.at]
        self.at += 1
        require(x.shape == x_rec.shape, f"act tape: call {self.at} takes {tuple(x.shape)}, "
                f"recorded {tuple(x_rec.shape)}")
        self.err = max(self.err, norm_err(x, x_rec)[0])
        self.flips += int((quantize_acts(x, group)[0] != xq).sum())
        self.values += xq.numel()
        return xq, sx


KERNEL, PLAIN, SHARED = "kernel", "plain", "plain, shared int8 activations"


def cast_params(engine, dtype) -> dict:
    """The engine's params with every tensor held in the engine's dtype (the
    embedding, and dense matmul weights and experts) cast to dtype."""
    import torch

    def leaf(v):
        return v.to(dtype) if torch.is_tensor(v) and v.dtype == engine.dtype else v

    out = {key: leaf(v) for key, v in engine.params.items() if key != "layers"}
    out["layers"] = [{key: leaf(v) for key, v in lp.items()} for lp in engine.params["layers"]]
    return out


def graphed_logits(params, h, toks, nxt, n_prompt: int, kv8: bool = False) -> list:
    """The float32 kernel path's prefill (every row, as `parity` runs it)
    and decode step as CUDA graphs (`StepGraphs`, the engine's helper), on
    a cache of their own (int8 when ``kv8``): each forward runs eagerly, is captured, and is
    replayed onto the same cache rows (its own values written again).
    Returns the last row's logits of each, [(eager, replay), ...]."""
    import torch

    from dllama_tpu_torch.models import forward, init_kv_cache
    from dllama_tpu_torch.runtime.graphs import StepGraphs

    dev = toks.device
    graphs = StepGraphs(dev)
    cache = init_kv_cache(h, 1, dtype=torch.int8 if kv8 else torch.float32, device=dev)
    out = []
    for key, tok, pos, mode in ((("prefill", toks.shape[1], False), toks, 0, "all"),
                                (("step", True), nxt, n_prompt, "last")):
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        last = torch.empty((1, h.vocab_size), dtype=torch.float32, device=dev)

        def step(tok=tok, pos_t=pos_t, mode=mode, last=last):
            logits, _ = forward(params, h, tok, pos_t, cache, mode)
            last.copy_(logits[:, -1])

        graphs.run(key, step)  # eager, then captured
        eager = last.clone()
        graphs.run(key, step)  # the replay
        require(graphs.replays == len(out) + 1, f"graphed logits: {key} did not replay")
        out.append((eager[0], last[0].clone()))
    return out


def nll_tolerance(plain_logits) -> float:
    """The NLL's limit, derived from the logits gate: the gate lets a logit
    move by TOL_E2E * max|plain logits|; a row's logsumexp and its target's
    logit each move by at most what the largest logit moves, so a row's
    NLL, and the mean over rows, by at most twice that."""
    return 2 * TOL_E2E * plain_logits.abs().max().item()


def parity(engine, prompt: list[int]) -> dict:
    """Phase 4: one prefill + one decode step through the kernel path and
    the plain path on the same weights, in float32 (where the two paths
    share every rounding and differ only in summation order) and in the
    engine's bfloat16. Returns the errors and top-1/top-5 agreement of
    each pair, and for a MoE model how many (layer, token) top-k expert
    sets the two paths chose differently (a near-tie flip swaps a whole
    expert's output). main() gates on the float32 pair only, since in
    bfloat16 a changed sum order flips roundings that the layers amplify
    to the size of bfloat16's own distance from float32 (printed as
    controls).

    With int8 weights (q40i8) the same happens in float32: each matmul
    quantizes its activations per group, a step function, so the last-bit
    differences of the attention and MoE kernels' sum order flip roundings
    that grow through the layers. For such an engine a third float32 run
    takes the plain path with the int8 activations of the kernel run
    (`ActTape`): the pair "f32 kernel vs plain, shared int8 activations" and
    the error of every int8 matmul's input x on that run (which the
    attention and MoE kernels' differences reach, but no flip amplifies)
    are the gate, and the count of roundings the plain path's own x would
    have flipped is printed. The all-plain pair is printed too.

    The float32 runs compute every prefill row's logits (the "last" row is
    compared as above) for the prompt's NLL, kernel path against plain path
    (`chunk_nll`, the engine's score); and the float32 kernel path runs
    again as CUDA graph replays (`graphed_logits`), whose logits must have
    the eager run's bits. An int8-KV engine's runs all hold their cache in
    int8 (rows quantized as they are written, the kernels and the plain
    versions reading the same int8 rows)."""
    import torch

    from dllama_tpu_torch.models import forward, init_kv_cache
    from dllama_tpu_torch.models import transformer
    from dllama_tpu_torch.ops.int8_matmul import Int8Weight, quantize_acts
    from dllama_tpu_torch.runtime.engine import chunk_nll

    h, dev = engine.header, engine.device
    toks = torch.tensor([prompt], device=dev)
    int8 = isinstance(engine.params["wcls"], Int8Weight)
    kv8 = engine.kv_dtype == torch.int8

    logits, routes, nxt = {}, {}, None
    route = transformer.moe_route
    tapes = {"prefill": ActTape(), "decode": ActTape()}

    def recording(key):
        def moe_route(x, gate, n_active):
            top_i, w = route(x, gate, n_active)
            routes.setdefault(key, []).append(top_i.sort(dim=-1).values)
            return top_i, w
        return moe_route

    def act_quant(dtype, kind, phase):
        if int8 and dtype == torch.float32 and kind != PLAIN:
            return tapes[phase].record if kind == KERNEL else tapes[phase].replay
        return quantize_acts

    runs = [(dtype, kind) for dtype in (torch.float32, torch.bfloat16) for kind in (KERNEL, PLAIN)]
    if int8:
        runs.append((torch.float32, SHARED))
    full = {}  # every prefill row's logits of the float32 runs, for the NLL
    with torch.inference_mode():
        for dtype, kind in runs:
            params = cast_params(engine, dtype)
            transformer.moe_route = recording((dtype, kind))
            plain = kind != KERNEL
            mode = "all" if dtype == torch.float32 else "last"
            try:
                cache = init_kv_cache(h, 1, dtype=torch.int8 if kv8 else dtype, device=dev)
                pre, cache = forward(params, h, toks, 0, cache, mode, plain=plain,
                                     act_quant=act_quant(dtype, kind, "prefill"))
                if nxt is None:  # every run decodes the same token
                    nxt = pre[:, -1].argmax(-1, keepdim=True)
                dec, _ = forward(params, h, nxt, len(prompt), cache, "last", plain=plain,
                                 act_quant=act_quant(dtype, kind, "decode"))
            finally:
                transformer.moe_route = route
            logits[dtype, kind] = (pre[0, -1].float(), dec[0, -1].float())
            if mode == "all":
                full[kind] = pre
            del cache, params, pre
        params = cast_params(engine, torch.float32)
        graphed = graphed_logits(params, h, toks, nxt, len(prompt), kv8)
        del params
    pairs = {
        "f32 kernel vs plain": ((torch.float32, KERNEL), (torch.float32, PLAIN)),
        "bf16 kernel vs plain": ((torch.bfloat16, KERNEL), (torch.bfloat16, PLAIN)),
        "bf16 plain vs f32 plain": ((torch.bfloat16, PLAIN), (torch.float32, PLAIN)),
        "bf16 kernel vs f32 plain": ((torch.bfloat16, KERNEL), (torch.float32, PLAIN)),
    }
    if int8:
        pairs[f"f32 kernel vs {SHARED}"] = ((torch.float32, KERNEL), (torch.float32, SHARED))

    def compare(a, b) -> dict:
        top5 = set(a.topk(5).indices.tolist()) & set(b.topk(5).indices.tolist())
        return dict(err=norm_err(a, b)[0], top1=int(a.argmax()) == int(b.argmax()),
                    top5_overlap=len(top5))

    res = {}
    for i, name in enumerate(("prefill", "decode")):
        for tag, (ka, kb) in pairs.items():
            res[name, tag] = compare(logits[ka][i], logits[kb][i])
        if int8:
            tape = tapes[name]
            require(tape.at == len(tape.calls),
                    f"act tape {name}: {tape.at} of {len(tape.calls)} recorded calls replayed")
            res[name, "int8 inputs"] = dict(err=tape.err, flips=tape.flips, values=tape.values,
                                            calls=len(tape.calls))
    del tapes
    for i, name in enumerate(("prefill", "decode")):
        eager, replay = graphed[i]
        kernel = logits[torch.float32, KERNEL][i]
        res["graphs", name] = dict(
            equal=torch.equal(replay, kernel) and torch.equal(eager, kernel),
            err=max(norm_err(replay, kernel)[0], norm_err(eager, kernel)[0]))
    n = len(prompt)
    tgt = torch.tensor([prompt[1:] + [0]], device=dev)
    mask = torch.tensor([[1.0] * (n - 1) + [0.0]], device=dev)
    nll = {kind: chunk_nll(f, tgt, mask).item() / (n - 1) for kind, f in full.items()}
    res["nll", "f32 kernel vs plain"] = dict(
        kernel=nll[KERNEL], plain=nll[PLAIN], diff=abs(nll[KERNEL] - nll[PLAIN]),
        tol=nll_tolerance(full[PLAIN]), logit_err=norm_err(full[KERNEL], full[PLAIN])[1])
    del full
    for tag, (ka, kb) in pairs.items():
        if ka in routes and kb in routes and ka[1] == KERNEL and ka[0] == kb[0]:
            res["routing", tag] = dict(
                differ=sum(int((a != b).any(-1).sum()) for a, b in zip(routes[ka], routes[kb])),
                of=sum(int(a.shape[0]) for a in routes[ka]),
            )
    return res


SERVE_LANES = 4
SERVE_MAX_TOKENS = 64
# the bf16 serving round's solo replays and its lane tok/s (`serving`), the
# fleet round's truth (`serving_fleet`)
SERVE_TRUTH: dict = {}
SHARED_PREFIX = 256  # tokens two requests share: BOS, the system turn and the user header


def lane_parity(engine, prompt: list[int]) -> dict:
    """One prefill and one decode step in float32 through the slab path
    (kernels), the pool-native paged path (kernels: the paged stats and
    paged decode kernels through a page table) and the paged path's plain
    versions, on the engine's weights, into a pool of its own (caches and
    pool in the engine's KV dtype when it is int8). Returns the logits
    errors of "lane vs slab" (the same arithmetic: expected 0) and "lane
    kernel vs plain"."""
    import torch

    from dllama_tpu_torch.models import forward, init_kv_cache
    from dllama_tpu_torch.ops.kv_cache import new_kv_leaf

    h, dev = engine.header, engine.device
    params = cast_params(engine, torch.float32)
    toks = torch.tensor([prompt], device=dev)
    n_blocks = -(-(len(prompt) + 1) // PAGE)
    pt = (1 + torch.arange(n_blocks, device=dev, dtype=torch.int32))[None]
    kv = torch.int8 if engine.kv_dtype == torch.int8 else torch.float32
    logits = {}
    with torch.inference_mode():
        for name in ("slab", "lane", "lane plain"):
            if name == "slab":
                cache, kw = init_kv_cache(h, 1, dtype=kv, device=dev), {}
            else:
                shape = (h.n_layers, n_blocks + 1, h.n_kv_heads, PAGE, h.head_dim)
                cache = {k: new_kv_leaf(shape, kv, dev) for k in ("k", "v")}
                kw = dict(page_table=pt, plain=name == "lane plain")
            pre, cache = forward(params, h, toks, 0, cache, "last", **kw)
            nxt = pre[:, -1].argmax(-1, keepdim=True)
            dec, _ = forward(params, h, nxt, len(prompt), cache, "last", **kw)
            logits[name] = (pre[0, -1], dec[0, -1])
            del cache
    del params
    return {
        (step, tag): norm_err(logits[a][i], logits[b][i])[0]
        for i, step in enumerate(("prefill", "decode"))
        for tag, (a, b) in (("lane vs slab", ("lane", "slab")),
                            ("lane kernel vs plain", ("lane", "lane plain")))
    }


def serving_payloads(tok) -> list[dict]:
    """The seven greedy chat requests of the serving phase. Requests 0, 4 and
    5 share a system prompt sized so that it, BOS and the user header make
    SHARED_PREFIX tokens (page-aligned); request 4's user text differs from
    request 0's at its first character (a whole-page match: adopted with no
    copy), request 5's at its sixth (a mid-page match: one COW fork).
    Request 3 is streamed. Request 6 is repetitive ("Repeat this list
    forever: ..."), the traffic n-gram speculation drafts from."""
    from dllama_tpu_torch.tokenizer import ChatItem, ChatTemplateGenerator, ChatTemplateType

    template = ChatTemplateGenerator(ChatTemplateType.LLAMA3, None, "</s>")

    def encode(system, user):
        items = ([ChatItem("system", system)] if system else []) + [ChatItem("user", user)]
        return tok.encode(template.generate(items).content)

    def shared(system):
        a, b = encode(system, "Alpha"), encode(system, "Bravo")
        return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)

    system = prompt_text(SHARED_PREFIX)
    system = system[: len(system) + SHARED_PREFIX - shared(system)]
    require(shared(system) == SHARED_PREFIX, "serving: the shared prefix is not page-aligned")
    users = [
        (system, "Alpha: summarise the text above in one line."),
        (None, prompt_text(100)),
        (None, "Explain " + prompt_text(300)),
        (None, "Stream: " + prompt_text(40)),
        (system, "Bravo: list three ideas from the text above."),
        (system, "Alpha, no: rewrite the text above as a question."),
        (None, "Repeat this list forever: " + ", ".join(["red", "green", "blue"] * 16)),
    ]
    out = []
    for i, (sys_text, user) in enumerate(users):
        msgs = ([{"role": "system", "content": sys_text}] if sys_text else []) + [
            {"role": "user", "content": user}]
        out.append({"messages": msgs, "max_tokens": SERVE_MAX_TOKENS, "temperature": 0,
                    "stream": i == 3})
    return out


def serve_thread(srv) -> None:
    """Run ``srv.serve_forever`` on a named daemon thread; the server's
    ``shutdown`` (which returns once serve_forever has) then joins it."""
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True, name="dllama-smoke-serve")
    t.start()
    shutdown = srv.shutdown

    def stop():
        shutdown()
        t.join()

    srv.shutdown = stop


def _request(url: str, payload: dict, allow_error: bool = False) -> dict:
    """POST one chat completion; its content, finish reason, ``dllama``
    metadata and wall time (streamed or not). With ``allow_error`` an
    error answer (an HTTP status, or an error event in a stream) returns
    ``dict(error=status or "stream", body=..., retry_after=...)``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read().decode()
    except urllib.error.HTTPError as e:
        if not allow_error:
            raise
        return dict(error=e.code, body=json.loads(e.read()).get("error", {}),
                    retry_after=e.headers.get("Retry-After"))
    wall = time.perf_counter() - t0
    if not payload["stream"]:
        body = json.loads(raw)
        choice = body["choices"][0]
        return dict(content=choice["message"]["content"], finish=choice["finish_reason"],
                    meta=body["dllama"], wall=wall, usage=body.get("usage"))
    content, finish, meta = "", None, None
    for line in raw.split("\r\n"):
        if not line.startswith("data: {"):
            continue
        chunk = json.loads(line[6:])
        if "error" in chunk and allow_error:
            return dict(error="stream", body=chunk["error"], retry_after=None)
        require("error" not in chunk, f"serving: stream error {chunk.get('error')}")
        choice = chunk["choices"][0]
        if choice["finish_reason"] is None:
            content += choice["delta"]["content"]
        else:
            finish, meta = choice["finish_reason"], chunk["dllama"]
    require(raw.rstrip().endswith("data: [DONE]"), "serving: the stream did not end in [DONE]")
    return dict(content=content, finish=finish, meta=meta, wall=wall)


def serving(device: str, tmp: str, single_tok_s: float | None, smi: str,
            kv_dtype: str | None = None) -> dict:
    """The serving phase: the port's lane server (`serve`, in process on
    127.0.0.1:0) over the model file in tmp, 4 lanes, pool page 16, the
    pool sized by default, in ``kv_dtype`` (None: the engine's bf16;
    "int8": the int8 pool, whose decode kernel is then
    paged_flash_decode_kv8). Seven greedy requests (`serving_payloads`):
    four at once, then three queued behind them; then each replayed alone.
    Gates: every request ends with stop or length; each concurrent answer
    equals its solo replay (text and token count); the manager counted >= 2
    radix hits and >= 1 COW fork; the pool type's paged decode kernel
    launched n_layers times a decode step, and no attention kernel but it
    and the pool type's stats kernel; lane vs slab and lane kernel vs plain
    f32 logits <= TOL_E2E. With the engine's bf16 pool, then the
    speculation round on the same engine (`serving_spec`), the
    observability round (`serving_obs`), the admission round
    (`serving_admission`), the resilience
    round (`serving_resilience`; on the int8 pool its fault-free round and
    the decode poison), its f32 pass (`resilience_f32`) and the f32 verify
    parity (`spec_parity`). Returns the launch counts by label: the serving
    run's, the speculation, observability and admission rounds' and the
    resilience rounds'."""
    import threading

    import torch

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import ChatTemplateType, Tokenizer

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    stalls0 = watchdog_stalls()
    t0 = time.perf_counter()
    engine = InferenceEngine(mp, temperature=0.0, seed=SEED, weight_format="q40",
                             device=device, batch_size=SERVE_LANES, kv_dtype=kv_dtype)
    tok = Tokenizer(tp)
    load_s = time.perf_counter() - t0
    h = engine.header
    t0 = time.perf_counter()
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True)
    g = engine.graphs
    rehearsal = dict(graphs=g.n_graphs, lanes=g.count("lane_prefill_paged")
                     + g.count("lane_block_paged"), capture_s=g.capture_s,
                     pool=g.pool_bytes(), s=time.perf_counter() - t0)
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sched, kv = srv.state.scheduler, srv.state.kv_manager
    # time every decode block: its readback waits for the card
    decode = {"s": 0.0, "tokens": 0, "blocks": 0, "shared_max": 0, "used_max": 0}
    inner = engine.decode_lanes

    def timed_decode(tokens, pos, n_steps, active, *args, **kw):
        t = time.perf_counter()
        rows = inner(tokens, pos, n_steps, active, *args, **kw)
        decode["s"] += time.perf_counter() - t
        decode["tokens"] += len(rows) * sum(map(bool, active))
        decode["blocks"] += 1
        st = kv.pool.stats()  # this thread is the only writer of the accounting
        decode["shared_max"] = max(decode["shared_max"], st.shared)
        decode["used_max"] = max(decode["used_max"], st.used)
        return rows

    engine.decode_lanes = timed_decode
    generated = _track_generated(sched)
    try:
        payloads = serving_payloads(tok)
        reset_launch_counts()
        engine.lane_decode_steps = 0
        results, t_conc = _concurrent(url, sched, payloads)
        conc_decode = dict(decode)
        pool = kv.debug()["pool"]
        mem = torch.cuda.memory_allocated() if device == "cuda" else 0
        solo = [_request(url, p) for p in payloads]
        counts = launch_counts()
        for r in results + solo:
            r["tokens"] = generated[r["meta"]["request_id"]]
            r["n"] = len(r["tokens"])
        steps = engine.lane_decode_steps
    finally:
        srv.shutdown()
        srv.server_close()
    kv_tag = f" kv-{kv_dtype}" if kv_dtype else ""
    print(f"obs anomaly after the serving{kv_tag} round: "
          f"{json.dumps(srv.state.anomaly.status())}")
    health = srv.state.health_snapshot()["kv"]
    print(f"== llama-8b q40{kv_tag} serving: {h.n_layers} layers, seq_len {h.seq_len}, "
          f"{SERVE_LANES} lanes, pool {kv.pool.n_pages} pages of {PAGE} rows "
          f"({nbytes(engine.kv_pool) / 1e9:.3f} GB, {health['dtype']}, /v1/health page_bytes "
          f"{health['page_bytes']}); {smi}; engine loaded in {load_s:.2f} s")
    for i, (r, s_) in enumerate(zip(results, solo)):
        ttft = r["meta"]["ttft_ms"]
        dec = (r["wall"] * 1e3 - ttft) / max(r["n"] - 1, 1)
        same = r["content"] == s_["content"] and r["n"] == s_["n"]
        print(f"serve r{i}: lane {r['meta']['lane']} reused {r['meta']['reused_prefix_tokens']} "
              f"finish {r['finish']} tokens {r['n']} ttft_ms {ttft} decode_ms_per_token "
              f"{dec:.3f}; solo reused {s_['meta']['reused_prefix_tokens']} ttft_ms "
              f"{s_['meta']['ttft_ms']}; equals solo {same}")
        require(r["finish"] in ("stop", "length") and s_["finish"] in ("stop", "length"),
                f"serving r{i}: finish {r['finish']} / solo {s_['finish']}")
        require(same, f"serving r{i}: the concurrent answer differs from its solo replay")
    n_tokens = sum(r["n"] for r in results)
    agg = conc_decode["tokens"] / conc_decode["s"]
    print(f"serve aggregate: {n_tokens} tokens in {t_conc:.2f} s wall ({n_tokens / t_conc:.2f} "
          f"tok/s, prefill included); decode {conc_decode['tokens']} lane tokens in "
          f"{conc_decode['blocks']} blocks, {conc_decode['s']:.3f} s: {agg:.2f} tok/s"
          + (f", {agg / single_tok_s:.2f}x the single-stream q40 run's {single_tok_s:.2f}"
             if single_tok_s else ""))
    print(f"serve pool: at most {conc_decode['used_max']} pages used and "
          f"{conc_decode['shared_max']} shared by a lane and the tree during the concurrent "
          f"requests; after them {json.dumps(pool)}; radix hits {kv.hits}, "
          f"shared tokens {kv.shared_tokens}, COW forks {kv.pool.stats().cow_forks}, "
          f"evictions {kv.evictions}; torch.cuda.memory_allocated {mem / 1e9:.3f} GB")
    print(f"serve{kv_tag} launches {json.dumps(counts)}; decode steps {steps}")
    print(f"serve graphs: rehearsal captured {rehearsal['lanes']} lane graphs (every "
          f"lane-prefill bucket, the greedy and the sampled block) in {rehearsal['capture_s']:.2f} "
          f"s of capture ({rehearsal['s']:.2f} s with the pool and first uses), pool "
          f"{rehearsal['pool'] / 1e9:.3f} GB; after the requests {g.n_graphs} graphs, "
          f"{g.replays} replays, capture {g.capture_s:.2f} s")
    require(rehearsal["lanes"] == len(engine.prefill_buckets) + 2,
            f"serving: rehearsal captured {rehearsal['lanes']} lane graphs")
    require(kv.hits >= 2, f"serving: {kv.hits} radix hits, wanted >= 2")
    require(kv.pool.stats().cow_forks >= 1, "serving: no COW fork")
    decode_kernel = "paged_flash_decode_kv8" if kv_dtype == "int8" else "paged_flash_decode"
    require(counts[decode_kernel] == h.n_layers * steps and steps > 0,
            f"serving: {counts[decode_kernel]} {decode_kernel} launches, the steps imply "
            f"{h.n_layers * steps}")
    stats = "flash_attention_stats" + ("_kv8" if kv_dtype == "int8" else "")
    other = [name for name, c in counts.items() if c and "flash" in name
             and name not in (decode_kernel, stats)]
    require(counts[stats] > 0 and not other,
            f"serving: attention launches {counts}, wanted only {stats} and {decode_kernel}")
    lane_step_ms = None
    if device == "cuda" and not kv_dtype:
        lanes = lane_profile(engine, PROMPT_TOKENS)
        lane_step_ms = statistics.median(lanes["host"][True])
        for side, name in ((True, "graphed"), (False, "eager")):
            host_ms, prof = statistics.median(lanes["host"][side]), lanes["prof"][side]
            tok_s4 = SERVE_LANES * 1e3 / host_ms
            print(f"lane decode profile {name}, {SERVE_LANES} lanes at pos {PROMPT_TOKENS}: host "
                  f"ms/step {_ms(lanes['host'][side])} ({tok_s4:.2f} tok/s"
                  + (f", {tok_s4 / single_tok_s:.2f}x the single-stream run" if single_tok_s
                     else "")
                  + f"), device kernel ms/step {prof['device_ms_per_token']:.3f}, device "
                  f"launches/step {prof['launches_per_token']:.0f}, device busy share "
                  f"{prof['device_ms_per_token'] / host_ms:.3f}; from {prof['source']}")
            for kname, ms, count in prof["top"]:
                print(f"  {ms:8.4f} ms/step {count:5d}x {kname[:90]}")
            for kname, ms, count in prof["host_top"]:
                print(f"  host {ms:8.4f} ms/step {count:5d}x {kname[:80]}")
    out = {f"llama-8b q40{kv_tag} serving": counts}
    if not kv_dtype:
        SERVE_TRUTH.update(solo=solo, lane_tok_s=agg)
        out["llama-8b q40 serving slab"] = serving_slab(engine, tok, results, agg, smi)
        off = dict(results=results, lane_tok_s=agg, decode_s=conc_decode["s"],
                   tokens=conc_decode["tokens"])
        out["llama-8b q40 serving spec"] = serving_spec(engine, tok, off, lane_step_ms)
        out["llama-8b q40 serving obs"] = serving_obs(engine, tok, smi, lane_step_ms, tmp,
                                                      stalls0)
        for key, c in serving_admission(engine, tok, smi, stalls0).items():
            out[f"llama-8b q40 {key}"] = c
    else:
        gate_watchdog(stalls0, kv_tag, smi)
    out[f"llama-8b q40{kv_tag} serving resilience"] = serving_resilience(
        engine, tok, results, smi, "0b" if kv_dtype else "0abcde", f"llama-8b q40{kv_tag}")
    if not kv_dtype:
        # on the `PAR_LAYERS`-layer file: an f32 step costs ~5 bf16 ones
        out["llama-8b q40 f32 serving resilience"] = resilience_f32(
            device, os.path.join(tmp, "par", "model.m"), tp, smi)
    graph_lint(engine, f"llama-8b q40{kv_tag} serving")
    engine.kv_pool = None  # the pool's 3 GB, before the f32 parity runs
    prompt = tok.encode(prompt_text(PROMPT_TOKENS - 1))
    par = lane_parity(engine, prompt)
    for (step, tag), err in par.items():
        print(f"parity serving{kv_tag} {step} f32 {tag}: logits err {err:.3e}")
        require(err <= TOL_E2E, f"serving {step}: {tag} err {err:.3e} > {TOL_E2E}")
    if not kv_dtype:
        sp = spec_parity(engine, prompt)
        print(f"parity spec f32, {SPEC_PARITY_LAYERS} layers, {engine.batch_size} lanes at pos "
              f"{sp['pos']}: verify_lanes grid equals stepwise greedy decode_lanes {sp['equal']}; "
              f"verify-row logits vs the decode steps' err {sp['err']:.3e}")
        require(sp["equal"], f"spec parity: verify grid {sp['grid']} != stepwise {sp['want']}")
        require(sp["err"] <= TOL_E2E, f"spec parity: logits err {sp['err']:.3e} > {TOL_E2E}")
    return out


SLAB_POISON = "dispatch:op=decode_lanes:nth=3:kind=poison"  # the slab round's decode poison
ADOPT_PAGES = 64  # pages of the timed bucketed adopt (one bucket: 1,024 rows)


def _timed_mix(url: str, sched, engine, payloads: list[dict], **kw):
    """The mix through `_concurrent` with every decode block timed (its
    readback waits for the card): (results, wall seconds, lane tok/s)."""
    timer = {"s": 0.0, "tokens": 0}
    inner = engine.decode_lanes

    def timed(tokens, pos, n_steps, active, *args, **kwargs):
        t = time.perf_counter()
        try:
            rows = inner(tokens, pos, n_steps, active, *args, **kwargs)
        finally:
            timer["s"] += time.perf_counter() - t
        timer["tokens"] += len(rows) * sum(map(bool, active))
        return rows

    engine.decode_lanes = timed
    try:
        results, wall = _concurrent(url, sched, payloads, **kw)
    finally:
        engine.decode_lanes = inner
    return results, wall, timer["tokens"] / timer["s"] if timer["s"] else 0.0


def _parts(results: list[dict], truth: list[dict]) -> list[str]:
    """Where each answer parts from its truth (text or tokens); a failed
    request (an ``error`` result) is left out."""
    out = []
    for i, (r, want) in enumerate(zip(results, truth)):
        if "error" in r:
            continue
        if r["content"] != want["content"] or r["tokens"] != want["tokens"]:
            at = next((j for j, (x, y) in enumerate(zip(r["tokens"], want["tokens"])) if x != y),
                      min(len(r["tokens"]), len(want["tokens"])))
            out.append(f"r{i} at token {at} of {len(want['tokens'])}")
    return out


def serving_slab(engine, tok, native: list[dict], native_tok_s: float, smi: str) -> dict:
    """The slab round of the serving phase (the JAX server's default lanes,
    ``kv_native=False``): a `serve` over the serving engine with slab lanes
    and a page pool of `PAGE`-row pages (the engine frees its native pool,
    allocates the lanes' slab of 4 x (4096 + `SLAB_PAD`) rows and the
    default slab-mode pool, 2 * 4096 / 16 + 1 pages; the rehearsal captures
    every lane-prefill bucket for every lane and both blocks). The seven
    requests, four at once, then each alone. Gates: each answer equals its
    solo replay and the native round's answer (``native``) for the same
    request, text and tokens, byte for byte (the slab and paged entries give
    the same bits for the same rows; the adopt and publish copies move rows
    exactly); >= 2 radix hits, a whole-page and a mid-page adoption
    (``kv.match`` lengths), adopt and publish copies both > 0 pages; the
    slab decode kernel launched n_layers times a decode step, the stats
    kernel > 0 and no paged kernel. Prints the lane tok/s of the slab mix
    against the native one in turns (native, slab, slab, native; not
    gated), a 4-lane slab step's device profile with the slab decode's
    launches a step, and one bucketed adopt of `ADOPT_PAGES` pages timed by
    CUDA events, its GB/s (each row read and written once) against 3.35
    TB/s. Then the decode poison `SLAB_POISON`: the pool's epoch must not
    move and ``cache_epoch`` must; the lanes recover by re-adopting their
    published prefixes (re-matched tokens > 0); every stream finishes with
    stop or length; where a bf16 answer parts from the slab mix's is
    printed (re-made rows come from the prefill kernels). Returns the
    launch counts of the gated mix and its replays."""
    import threading

    import torch

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.runtime.faults import set_fault_plane
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    h = engine.header
    t0 = time.perf_counter()
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=False)
    g = engine.graphs
    n_lane_graphs = g.count("lane_prefill") + g.count("lane_block")
    setup_s = time.perf_counter() - t0
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    state, sched, kv = srv.state, srv.state.scheduler, srv.state.kv_manager
    matched: list = []
    match = kv.match

    def tracked_match(lane, tokens):
        m, pages = match(lane, tokens)
        matched.append(m)
        return m, pages

    kv.match = tracked_match
    generated = _track_generated(sched)
    payloads = serving_payloads(tok)
    try:
        reset_launch_counts()
        engine.lane_decode_steps = 0
        a0, p0 = engine.kv_adopt_pages, engine.kv_publish_pages
        results, _, slab_tok_s = _timed_mix(url, sched, engine, payloads)
        solo = [_request(url, p) for p in payloads]
        counts, steps = launch_counts(), engine.lane_decode_steps
        adopted, published = engine.kv_adopt_pages - a0, engine.kv_publish_pages - p0
        for r in results + solo:
            r["tokens"] = generated[r["meta"]["request_id"]]
        kv.reset()  # the turn's mix starts on an empty tree, as each native one does
        _, _, slab_tok_s2 = _timed_mix(url, sched, engine, payloads)
        # the decode poison: the lanes' slab is zeroed, the pool is not
        pool_epoch, cache_epoch = engine.kv_pool_epoch, engine.cache_epoch
        c0 = {k: getattr(sched, k) for k in ("lanes_recovered", "resume_reused_tokens",
                                             "resume_prefill_tokens")}
        plane = set_fault_plane(SLAB_POISON)
        try:
            poisoned, _, _ = _timed_mix(url, sched, engine, payloads)
        finally:
            fired = plane.counts()
            set_fault_plane("")
        deadline = time.perf_counter() + 30
        while (any(sched.lanes) or sched.admitting or sched.pending) and (
                time.perf_counter() < deadline):
            time.sleep(0.01)
        for r in poisoned:
            r["tokens"] = generated[r["meta"]["request_id"]]
        d = {k: getattr(sched, k) - v for k, v in c0.items()}
        epochs = (engine.kv_pool_epoch - pool_epoch, engine.cache_epoch - cache_epoch)
        kv.check()
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"== llama-8b q40 serving slab: {h.n_layers} layers, {SERVE_LANES} slab lanes of "
          f"{h.seq_len} + {engine._lane_pad} rows ({nbytes(engine.lane_cache) / 1e9:.3f} GB), "
          f"pool {kv.pool.n_pages} pages of {PAGE} rows ({nbytes(engine.kv_pool) / 1e9:.3f} GB); "
          f"set-up with the rehearsal {setup_s:.2f} s, {n_lane_graphs} lane graphs; {smi}")
    for i, (r, s_, n_) in enumerate(zip(results, solo, native)):
        same = r["content"] == s_["content"] and r["tokens"] == s_["tokens"]
        same_native = r["content"] == n_["content"] and r["tokens"] == n_["tokens"]
        print(f"serve slab r{i}: lane {r['meta']['lane']} reused "
              f"{r['meta']['reused_prefix_tokens']} finish {r['finish']} tokens "
              f"{len(r['tokens'])} ttft_ms {r['meta']['ttft_ms']}; equals solo {same}, equals "
              f"the native round's {same_native}")
        require(r["finish"] in ("stop", "length"), f"serving slab r{i}: finish {r['finish']}")
        require(same, f"serving slab r{i}: the concurrent answer differs from its solo replay")
        require(same_native, f"serving slab r{i}: the answer differs from the native round's")
    whole = [m for m in matched if m > 0 and m % PAGE == 0]
    mid = [m for m in matched if m % PAGE]
    print(f"serve slab copies: adopt {adopted} pages, publish {published} pages; matches "
          f"{sorted(set(matched))} (whole-page {len(whole)}, mid-page {len(mid)}); radix hits "
          f"{kv.hits}, COW forks {kv.pool.stats().cow_forks}; launches {json.dumps(counts)}; "
          f"decode steps {steps}")
    require(kv.hits >= 2, f"serving slab: {kv.hits} radix hits, wanted >= 2")
    require(whole and mid, f"serving slab: matches {matched}: wanted a whole-page and a "
            "mid-page adoption")
    require(adopted > 0 and published > 0,
            f"serving slab: adopt {adopted} and publish {published} pages, wanted both > 0")
    require(n_lane_graphs == SERVE_LANES * len(engine.prefill_buckets) + 2,
            f"serving slab: the rehearsal captured {n_lane_graphs} lane graphs")
    require(counts["flash_decode"] == h.n_layers * steps and steps > 0,
            f"serving slab: {counts['flash_decode']} flash_decode launches, the steps imply "
            f"{h.n_layers * steps}")
    other = [n for n, c in counts.items() if c and "flash" in n
             and n not in ("flash_decode", "flash_attention_stats")]
    require(counts["flash_attention_stats"] > 0 and not other,
            f"serving slab: attention launches {counts}, wanted the slab entries only")
    parts = _parts(poisoned, results)
    print(f"serve slab decode poison {SLAB_POISON}: faults fired {json.dumps(fired)}; epochs "
          f"moved: pool {epochs[0]}, cache {epochs[1]}; {json.dumps(d)}; every stream finished "
          f"{all(r['finish'] in ('stop', 'length') for r in poisoned)}; answers equal to the "
          f"slab mix's {not parts}{'' if not parts else ' (parts: ' + ', '.join(parts) + ')'}")
    require(epochs == (0, 1), f"serving slab poison: epochs moved {epochs}, wanted (0, 1)")
    require(d["lanes_recovered"] >= 1 and d["resume_reused_tokens"] > 0,
            f"serving slab poison: {d}: wanted a recovery that re-adopted published prefixes")
    require(all(r["finish"] in ("stop", "length") for r in poisoned),
            "serving slab poison: a stream did not finish")

    lanes = lane_profile(engine, PROMPT_TOKENS)
    reset_launch_counts()
    engine.decode_lanes([1] * SERVE_LANES, [PROMPT_TOKENS] * SERVE_LANES, BLOCK,
                        [True] * SERVE_LANES, [0.0] * SERVE_LANES)
    per_step = launch_counts()["flash_decode"] / BLOCK
    for side, name in ((True, "graphed"), (False, "eager")):
        host_ms, prof = statistics.median(lanes["host"][side]), lanes["prof"][side]
        print(f"lane decode profile slab {name}, {SERVE_LANES} lanes at pos {PROMPT_TOKENS}: host "
              f"ms/step {_ms(lanes['host'][side])}, device kernel ms/step "
              f"{prof['device_ms_per_token']:.3f}, device launches/step "
              f"{prof['launches_per_token']:.0f}, flash_decode launches/step {per_step:.0f}, "
              f"device busy share {prof['device_ms_per_token'] / host_ms:.3f}; from "
              f"{prof['source']}; {smi}")
        for kname, ms, count in prof["top"][:6]:
            print(f"  {ms:8.4f} ms/step {count:5d}x {kname[:90]}")
    require(per_step == h.n_layers, f"serving slab: {per_step} flash_decode launches a step")

    ids = list(range(1, 1 + ADOPT_PAGES))
    engine.kv_adopt(0, ids)  # warm
    ms = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        engine.kv_adopt(0, ids)
        e1.record()
        torch.cuda.synchronize(engine.device)
        ms.append(e0.elapsed_time(e1))
    moved = ADOPT_PAGES * engine.kv_page_bytes()
    adopt_ms = statistics.median(ms)
    print(f"serve slab adopt: {ADOPT_PAGES} pages ({moved / 1e6:.1f} MB, one bucket) in "
          f"{adopt_ms:.4f} ms (median of 5, CUDA events): {2 * moved / adopt_ms / 1e6:.1f} GB/s "
          f"read + write, {2 * moved / adopt_ms * 1e3 / HBM_BYTES_PER_S:.4f} of 3.35 TB/s; "
          f"bound {2 * moved / HBM_BYTES_PER_S * 1e3:.4f} ms; {smi}")

    # the native mix once more, for the turns
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True)
    serve_thread(srv)
    try:
        _, _, native_tok_s2 = _timed_mix(f"http://127.0.0.1:{srv.server_address[1]}",
                                         srv.state.scheduler, engine, payloads)
    finally:
        srv.shutdown()
        srv.server_close()
    turns = [native_tok_s, slab_tok_s, slab_tok_s2, native_tok_s2]
    print(f"serve slab vs native lane tok/s in turns (native, slab, slab, native): "
          f"{', '.join(f'{x:.2f}' for x in turns)}; slab / native "
          f"{(turns[1] + turns[2]) / (turns[0] + turns[3]):.4f}; {smi}")
    return counts


def serving_single(device: str, tmp: str, smi: str) -> dict:
    """The serialized server (``--batch-size 1``, the JAX CLI's default),
    bf16, on the serving file: a batch-1 engine and `serve` with no lanes.
    (a) A chat of `SERVE_MAX_TOKENS` greedy tokens (`serving_payloads`'s
    request 1): its token ids must equal `InferenceEngine.generate` on the
    same prompt tokens from a reset cache. (b) Its continuation (the reply
    and a new user turn) must hit the NaiveCache: its reused prefix equals
    the first turn's end position (the cut's KV-only step included); then
    the same conversation cold (after an unrelated request reset the
    cache), then the chat and its continuation once more: every shape's
    graph is captured by then, so these two give the steady TTFTs (the
    continuation's warm against the cold one's, and whether the two answers
    agree: not gated, cached rows came from the decode kernels, cold ones
    from prefill's) and the chat's decode ms/token. (c) A streamed request:
    its SSE text equals the same request's non-stream text. Gates: every
    finish stop or length; both continuations reused the first turn's end
    position; the slab decode and stats kernels launched, no paged kernel.
    Returns the launch counts."""
    import threading

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import ChatTemplateType, Tokenizer

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    t0 = time.perf_counter()
    engine = InferenceEngine(mp, temperature=0.0, seed=SEED, weight_format="q40", device=device)
    tok = Tokenizer(tp)
    load_s = time.perf_counter() - t0
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3)
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    state = srv.state
    calls: list = []
    generate = engine.generate

    def tracked(prompt, max_steps, **kw):
        out = generate(prompt, max_steps, **kw)
        calls.append((list(prompt), max_steps, kw.get("start_pos", 0), list(out[0])))
        return out

    engine.generate = tracked
    chat = dict(serving_payloads(tok)[1], stream=False)
    try:
        reset_launch_counts()
        first = _request(url, chat)
        prompt, max_steps, start, served = calls[-1]
        end_pos = state.naive_cache.items[-1].end_pos
        follow = dict(chat, messages=chat["messages"] + [
            {"role": "assistant", "content": first["content"]},
            {"role": "user", "content": "Go on, in two lines."}])
        warm = _request(url, follow)
        _request(url, dict(chat, messages=[{"role": "user", "content": "Unrelated: hello."}],
                           max_tokens=4))
        cold = _request(url, follow)
        again = _request(url, chat)
        warm2 = _request(url, follow)
        plain = _request(url, serving_payloads(tok)[3] | {"stream": False})
        streamed = _request(url, serving_payloads(tok)[3])
        counts = launch_counts()
    finally:
        engine.generate = generate
        srv.shutdown()
        srv.server_close()
    engine.reset()
    want = generate(prompt, max_steps, start_pos=start)[0]
    print(f"== llama-8b q40 serving single: batch 1, {engine.header.n_layers} layers, the "
          f"serialized path; engine loaded in {load_s:.2f} s; {smi}")
    for name, r in (("chat", first), ("continuation", warm), ("continuation cold", cold),
                    ("chat again", again), ("continuation again", warm2), ("plain", plain),
                    ("streamed", streamed)):
        print(f"serve single {name}: finish {r['finish']} reused "
              f"{r['meta']['reused_prefix_tokens']} ttft_ms {r['meta']['ttft_ms']} wall_s "
              f"{r['wall']:.3f}")
        require(r["finish"] in ("stop", "length"), f"serving single {name}: {r['finish']}")
    n_dec = len(served)
    dec_ms = (again["wall"] * 1e3 - again["meta"]["ttft_ms"]) / max(n_dec - 1, 1)
    print(f"serve single chat again (graphs replayed): ttft_ms {again['meta']['ttft_ms']} over "
          f"{len(prompt)} prompt tokens, decode_ms_per_token {dec_ms:.3f} over {n_dec} tokens "
          f"(client wall after the first token; the cut's KV-only step included; the first "
          f"chat's {first['meta']['ttft_ms']} ms TTFT paid its shapes' captures); {smi}")
    print(f"serve single chat: {n_dec} tokens equal engine.generate's on the same "
          f"{len(prompt)} prompt tokens {want[:n_dec] == served}; continuation reused "
          f"{warm2['meta']['reused_prefix_tokens']} of end position {end_pos}, ttft_ms "
          f"{warm2['meta']['ttft_ms']} against {cold['meta']['ttft_ms']} cold (answers equal "
          f"{warm2['content'] == cold['content']}); streamed text equals the non-stream text "
          f"{streamed['content'] == plain['content']}; launches {json.dumps(counts)}")
    require(n_dec > 0 and want[:n_dec] == served,
            f"serving single: the {n_dec} served tokens differ from engine.generate's")
    for r in (warm, warm2):
        require(r["meta"]["reused_prefix_tokens"] == end_pos > 0,
                f"serving single: a continuation reused {r['meta']['reused_prefix_tokens']} "
                f"tokens, the first turn ended at {end_pos}")
    require(cold["meta"]["reused_prefix_tokens"] == 0, "serving single: the cold turn hit")
    require(streamed["content"] == plain["content"],
            "serving single: the streamed text differs from the non-stream text")
    other = [n for n, c in counts.items() if c and "flash" in n
             and n not in ("flash_decode", "flash_attention_stats")]
    require(counts["flash_decode"] > 0 and counts["flash_attention_stats"] > 0 and not other,
            f"serving single: attention launches {counts}")
    engine.params = engine.cache = None
    return {"llama-8b q40 serving single": counts}


OBS_PROFILE_S = 1.0  # seconds of the profile capture during the observability round's mix
OBS_TURNS = (False, True, True, False)  # the mix with the registry off and on, in turns
OBS_ROOF_MAX = 1.05  # a roofline fraction past this means the step's bytes are miscounted
OBS_MEM_TOL = 0.10  # the JAX package's divergence warning (obs/device.py)


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _post_json(url: str, payload: dict) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def scrape(url: str) -> dict:
    """``GET /metrics`` parsed: every sample line a name (labels included)
    and a number, every other line a HELP or TYPE comment, else a fault."""
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=120) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            require(line.startswith(("# HELP ", "# TYPE ")), f"obs: a bad /metrics line {line!r}")
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            require(False, f"obs: a /metrics sample that does not parse: {line!r}")
    return out


def metric_sum(samples: dict, family: str) -> float:
    """The sum of a family's samples (every label set), histograms' _count
    or _sum named in full."""
    return sum(v for k, v in samples.items() if k == family or k.startswith(family + "{"))


def _recorder_events(kind: str) -> list[dict]:
    from dllama_tpu_torch.obs.recorder import get_recorder

    return get_recorder().events(kind)


def watchdog_stalls() -> float:
    from dllama_tpu_torch.obs.metrics import get_registry

    fam = get_registry().counter("dllama_watchdog_stalls_total", labelnames=("reason",))
    return sum(fam.child_values().values())


def set_obs(on: bool) -> None:
    """The port's registry, flight recorder and span tracker on or off."""
    from dllama_tpu_torch.obs.metrics import get_registry
    from dllama_tpu_torch.obs.recorder import get_recorder
    from dllama_tpu_torch.obs.spans import get_span_tracker

    for x in (get_registry(), get_recorder(), get_span_tracker()):
        x.enable() if on else x.disable()


def _timeline_ttft(full: dict, rid: str) -> float | None:
    """A request's TTFT read off the span timeline (ms): from its queue
    span's start to the end of the first decode_lanes engine span that
    began after its decode span did (that block's readback carried its
    first token)."""
    xs = [e for e in full["traceEvents"] if e["ph"] == "X"]
    mine = {e["name"]: e for e in xs if e["args"].get("request_id") == rid
            and e["name"] in ("queue", "decode")}
    if "queue" not in mine or "decode" not in mine:
        return None
    start = mine["decode"]["ts"]
    blocks = [e for e in xs if e["name"] == "decode_lanes" and e["ts"] >= start]
    if not blocks:
        return None
    first = min(blocks, key=lambda e: e["ts"])
    return (first["ts"] + first["dur"] - mine["queue"]["ts"]) / 1e3


def gate_watchdog(stalls0: float, label: str, smi: str) -> None:
    """The watchdog counted no stall since ``stalls0`` (its reasons printed)."""
    stalls = watchdog_stalls() - stalls0
    recent = _recorder_events("watchdog_stall")[-int(stalls):] if stalls else []
    print(f"obs watchdog: {stalls:.0f} stalls over the fault-free serving{label} rounds"
          + "".join(f"; {e['reason']}: {e['detail']}" for e in recent) + f"; {smi}")
    require(stalls == 0, f"obs: the watchdog counted {stalls} stalls over the fault-free rounds")


def serving_obs(engine, tok, smi: str, lane_step_ms: float | None, tmp: str,
                stalls0: float) -> dict:
    """The observability round of the serving phase: a fourth `serve` over
    the serving engine (speculation off; the pool made anew) and the seven
    requests, four at once, ``/metrics`` scraped before and after.
    Gates: every /metrics line parses; ``dllama_requests_finished_total``
    and the TTFT histogram's count move by 7, the decode_lanes step
    histogram's count and the TPOT histogram's (one a decode block, as in
    the JAX server) by the decode blocks the round ran, and the paged
    decode kernel launched n_layers times a decode step;
    ``dllama_step_roofline_fraction`` is set for decode_lanes and
    prefill_lane_chunk, each in (0, `OBS_ROOF_MAX`]; ``/v1/debug/memory``
    reads ``bytes_in_use`` within `OBS_MEM_TOL` of the engine's analytic
    memory; each request's timeline holds its queue, adopt and decode
    spans and the full timeline the engine's spans. Then lane tok/s with
    the registry, the recorder and the spans off and on, `OBS_TURNS` (each
    turn on an empty pool, printed), and the watchdog's gate: no stall
    since ``stalls0`` (the fault-free rounds before this one and this
    one), which covers a last mix with ``POST /v1/debug/profile``
    ({"seconds": `OBS_PROFILE_S`}) during it: the profile answers 200 with
    a trace naming the Q40 GEMV (``gemv_mma_kernel``) and the paged decode
    kernel (``flash_decode_mma_kernel<KV, HD, true, false>``), with launches linked
    to their kernels by correlation id (``n_flows``). The profiler's stop
    holds the interpreter for seconds; the server declares it to the
    watchdog as a pause, so it is no stall. Printed: the seconds the
    profile's start, stop and export took (and those the start and stop
    held the scheduler thread), the scheduler's longest tick during the
    profile and the largest gap between two tokens of a stream, which is
    what a client sees of the stop. Printed too: each
    request's TTFT from its response and from the timeline, each
    timeline's coverage, the fractions beside the share the lane decode
    profile's host ms implies (``lane_step_ms``), the memory's parts and
    the anomaly monitor's status, with the card's name and power limit.
    Returns the round's launch counts."""
    import threading

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    engine.__dict__.pop("decode_lanes", None)
    h = engine.header
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True)
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    state, sched, kv = srv.state, srv.state.scheduler, srv.state.kv_manager
    timer = {"s": 0.0, "tokens": 0, "blocks": 0}
    inner = engine.decode_lanes

    def timed_decode(tokens, pos, n_steps, active, *args, **kw):
        t = time.perf_counter()
        rows = inner(tokens, pos, n_steps, active, *args, **kw)
        timer["s"] += time.perf_counter() - t
        timer["tokens"] += len(rows) * sum(map(bool, active))
        timer["blocks"] += 1
        return rows

    engine.decode_lanes = timed_decode
    payloads = serving_payloads(tok)
    prof: dict = {}

    def during():
        prof["status"], prof["body"] = _post_json(url + "/v1/debug/profile", {
            "seconds": OBS_PROFILE_S, "out_dir": os.path.join(tmp, "profile")})

    def idle():
        deadline = time.perf_counter() + 30
        while (any(sched.lanes) or sched.admitting or sched.pending) and (
                time.perf_counter() < deadline):
            time.sleep(0.01)

    turns = {True: [], False: []}
    # the profiled mix: each scheduler tick's span and each token's time
    ticks, times = [], {}
    tick, consume = sched._tick, sched._consume_token

    def timed_tick():
        t = time.perf_counter()
        try:
            return tick()
        finally:
            ticks.append((t, time.perf_counter()))

    def timed_consume(lane, t):
        ls = sched.lanes[lane]
        if ls is not None:
            times.setdefault(ls.job.request_id, []).append(time.perf_counter())
        return consume(lane, t)

    def profiled():
        w0 = time.perf_counter()
        during()
        prof["span"] = (w0, time.perf_counter())

    try:
        reset_launch_counts()
        engine.lane_decode_steps = 0
        before = scrape(url)
        results, wall = _concurrent(url, sched, payloads)
        idle()
        after = scrape(url)
        counts, steps, blocks = launch_counts(), engine.lane_decode_steps, timer["blocks"]
        full = _get_json(url + "/v1/debug/timeline")
        lines = [_get_json(url + f"/v1/debug/timeline?request_id={r['meta']['request_id']}")
                 for r in results]
        memory = _get_json(url + "/v1/debug/memory")
        cost = _get_json(url + "/v1/debug/compile")["cost"]
        anomaly = state.anomaly.status()
        for on in OBS_TURNS:
            set_obs(on)
            kv.reset()
            timer.update(s=0.0, tokens=0)
            _concurrent(url, sched, payloads)
            idle()
            turns[on].append(timer["tokens"] / timer["s"])
        set_obs(True)
        stalls1 = watchdog_stalls()
        kv.reset()
        sched._tick, sched._consume_token = timed_tick, timed_consume
        try:
            _concurrent(url, sched, payloads, during=profiled)
            idle()
        finally:
            sched.__dict__.pop("_tick", None)
            sched.__dict__.pop("_consume_token", None)
        profile_stalls = watchdog_stalls() - stalls1
        gate_watchdog(stalls0, "", smi)
    finally:
        set_obs(True)
        srv.shutdown()
        srv.server_close()
        engine.__dict__.pop("decode_lanes", None)

    def delta(family):
        return metric_sum(after, family) - metric_sum(before, family)

    n = len(payloads)
    print(f"== llama-8b q40 serving obs: {n} requests, {SERVE_LANES} lanes, {len(after)} samples "
          f"in /metrics, every line parsed; {wall:.2f} s wall; {smi}")
    finished, ttft_n = delta("dllama_requests_finished_total"), delta("dllama_ttft_seconds_count")
    step_n = delta('dllama_engine_step_seconds_count{kind="decode_lanes"}')
    tpot_n = delta("dllama_tpot_seconds_count")
    print(f"serve obs counters: requests finished +{finished:.0f}, TTFT count +{ttft_n:.0f}, "
          f"decode_lanes steps +{step_n:.0f} and TPOT count +{tpot_n:.0f} against {blocks} "
          f"decode blocks ({steps} decode steps); prefill chunks "
          f"+{delta('dllama_admission_chunks_total'):.0f}, admissions "
          f"+{delta('dllama_admissions_total'):.0f}, prefix hits "
          f"+{delta('dllama_prefix_cache_hits_total'):.0f}")
    require(finished == n and ttft_n == n,
            f"obs: {finished} requests finished and {ttft_n} TTFTs counted for {n} requests")
    require(step_n == blocks and tpot_n == blocks and blocks > 0,
            f"obs: decode_lanes steps +{step_n}, TPOT +{tpot_n}, the round ran {blocks} blocks")
    require(counts["paged_flash_decode"] == h.n_layers * steps and steps > 0,
            f"obs: {counts['paged_flash_decode']} paged decode launches, the steps imply "
            f"{h.n_layers * steps}")
    for i, (r, tl) in enumerate(zip(results, lines)):
        rid = r["meta"]["request_id"]
        names = {e["name"] for e in tl["traceEvents"] if e["ph"] == "X"}
        summ = tl["dllama"]["summary"]
        tl_ttft = _timeline_ttft(full, rid)
        print(f"serve obs r{i}: ttft_ms response {r['meta']['ttft_ms']}, timeline "
              + ("none" if tl_ttft is None else f"{tl_ttft:.3f}")
              + f"; timeline coverage {summ['coverage']} over {summ['wall_ms']} ms, phases "
              f"{json.dumps({k: v['total_ms'] for k, v in summ['phases'].items()})}")
        require({"queue", "adopt", "decode"} <= names,
                f"obs r{i}: the timeline holds {sorted(names)}")
    engine_spans = {e["name"] for e in full["traceEvents"] if e["ph"] == "X"}
    require({"decode_lanes", "decode_lanes.device", "prefill_lane_chunk"} <= engine_spans,
            f"obs: the timeline's engine spans {sorted(engine_spans)}")
    peak = cost["hbm_peak_bytes_per_s"]
    for kind in ("decode_lanes", "prefill_lane_chunk"):
        k = cost["kinds"].get(kind) or {}
        frac = k.get("roofline_fraction")
        implied = ""
        if kind == "decode_lanes" and lane_step_ms and k:
            n_steps = k["key"][1]
            implied = (f"; the lane decode profile's {lane_step_ms:.3f} host ms a step implies "
                       f"{k['bytes_accessed'] / n_steps / (lane_step_ms / 1e3) / peak:.4f}")
        print(f"roofline {kind}: key {k.get('key')}, {k.get('bytes_accessed', 0) / 1e9:.4f} GB "
              f"and {k.get('flops', 0) / 1e12:.4f} TFLOP a dispatch over "
              f"{(k.get('mean_step_s') or 0) * 1e3:.3f} device ms (mean of "
              f"{k.get('dispatches')}), fraction {frac}{implied}; {smi}")
        require(frac is not None and 0 < frac <= OBS_ROOF_MAX,
                f"obs: {kind} roofline fraction {frac}")
    comp, ana = memory["comparison"], memory["analytic"]
    dev = (memory["devices"] or [{}])[0]
    print(f"obs memory: bytes_in_use {dev.get('bytes_in_use')} (peak "
          f"{dev.get('peak_bytes_in_use')}, limit {dev.get('bytes_limit')}) against analytic "
          f"{ana['total_bytes']} (params {ana['params_bytes']}, cache {ana['cache_bytes']}, "
          f"pool {ana['pool_bytes']}, graphs {ana['graph_bytes']}): divergence "
          f"{comp['max_divergence_fraction']}, limit {OBS_MEM_TOL}; {smi}")
    require(comp["available"] and abs(comp["max_divergence_fraction"]) < OBS_MEM_TOL,
            f"obs: memory divergence {comp['max_divergence_fraction']}")
    body = prof.get("body", {})
    kernels = body.get("kernels", [])
    gemv = [k for k in kernels if "gemv_mma_kernel" in k]
    # the paged instantiation: template arguments <KV, HD, PAGED, SP>
    paged = [k for k in kernels if (m := re.search(r"flash_decode_mma_kernel<([^>]*)>", k))
             and m.group(1).split(", ")[2:3] == ["true"]]
    w0, w1 = prof.get("span", (0.0, 0.0))
    tick_max = max((b - a for a, b in ticks if b > w0 and a < w1), default=0.0)
    gap_max = max((b - a for ts in times.values() for a, b in zip(ts, ts[1:])), default=0.0)
    print(f"obs profile: {prof.get('status')} in {body.get('seconds')} s, {body.get('n_events')} "
          f"events, {len(kernels)} kernel names, the GEMV {gemv[:1]}, the paged decode "
          f"{paged[:1]}; {body.get('n_flows')} launches linked to their kernels; seconds {json.dumps(body.get('timings_s'))}; inside the watchdog's "
          f"gate, which counted {profile_stalls:.0f} stalls during the profiled mix; the "
          f"scheduler's longest tick during the profile {tick_max:.3f} s; the largest gap "
          f"between two tokens of a stream {gap_max:.3f} s; {smi}")
    require(prof.get("status") == 200 and gemv and paged and body.get("n_flows", 0) > 0,
            f"obs: the profile answered {prof.get('status')} {str(body)[:300]}")
    print(f"obs anomaly after the observability round: {json.dumps(anomaly)}")
    on, off = statistics.median(turns[True]), statistics.median(turns[False])
    print(f"obs overhead: lane tok/s with obs on {_ms(turns[True])}, off {_ms(turns[False])} "
          f"(in turns {list(OBS_TURNS)}): on/off {on / off:.4f}; {smi}")
    return counts


ADMISSION_TURNS = (False, True, True, False)  # the mix with predictive mode off and on, in turns
PREEMPT_MAX_TOKENS = 96  # the four low streams of the preemption case
PREEMPT_HIGH = {"messages": [{"role": "user", "content": "Urgent: one line on the deadline."}],
                "max_tokens": 16, "temperature": 0, "stream": False, "priority": "high"}


def _retry_after_ok(value, floor: int) -> bool:
    """A Retry-After the server derived from its predicted queue drain: whole
    seconds, at least the JAX server's ``floor``, at most the default
    ``--admission-max-wait-ms`` (30 s)."""
    return value is not None and str(value).isdigit() and floor <= int(value) <= 30


def _admission_server(engine, tok):
    """`serve` over the engine with predictive admission on, started."""
    import threading

    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True,
                admission_predict=True)
    serve_thread(srv)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _wait_idle(sched) -> None:
    deadline = time.perf_counter() + 60
    while (any(sched.lanes) or sched.admitting or sched.pending) and (
            time.perf_counter() < deadline):
        time.sleep(0.01)


def _held(sched):
    """Hold the scheduler thread between two ticks (`run_between_ticks`)
    until the returned release is called: no lane steps, the queue stays as
    it is, the cv stays free for the handler threads."""
    import threading

    entered, release = threading.Event(), threading.Event()

    def hold():
        entered.set()
        release.wait(60)

    t = threading.Thread(target=sched.run_between_ticks, args=(hold,), kwargs={"timeout": 60},
                         daemon=True, name="dllama-smoke-hold")
    t.start()
    require(entered.wait(60), "admission: the scheduler ran no tick to hold")

    def done():
        release.set()
        t.join(60)

    return done


def _forecasts(snap: dict, n_tok: int, chunk: int, block: int) -> tuple[float, float]:
    """The two TTFT forecasts (ms) `_maybe_preempt` weighs for a queued
    head of ``n_tok`` prompt tokens while every lane decodes, from
    ``/v1/debug/admission``'s numbers (runtime/admission.py's arithmetic):
    waiting behind the full lanes with itself in the queue, and on a lane
    freed now with no queue."""
    pr = snap["predictor"]
    chunk_s, step_s, corr = pr["prefill_chunk_s"], pr["decode_step_s"], pr["ttft_correction"]
    n_chunks = max(1, -(-n_tok // chunk))
    prefill = n_chunks * (chunk_s + step_s)
    drain = (chunk_s + max(1, block) * step_s * 0.5) * corr
    return (drain + prefill) * 1000.0 * corr, prefill * 1000.0 * corr


def admission_preemption(engine, tok, smi: str, label: str, exact: bool) -> dict:
    """Case (e) of `serving_admission` on its own server over ``engine``:
    four ``low`` streams (the mix's requests 0-3, `PREEMPT_MAX_TOKENS`
    tokens) decoding on the four lanes past the park floor, then a ``high``
    request whose ``deadline_ms`` lies between the two forecasts
    `_maybe_preempt` weighs (`_forecasts`, from ``/v1/debug/admission``):
    infeasible while it waits, feasible on a lane freed now. Gates:
    ``dllama_preemptions_total`` moves by one, with a ``stream_preempt``,
    a park and a resume recorded; every stream finishes with stop or
    length; with ``exact`` (f32) every answer equals its run without the
    high request (the lows alone, the high alone). In bf16 the victim's
    re-made page tail comes from the prefill kernels, so where an answer
    parts is printed, not gated. Returns the case's numbers."""
    import threading

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts

    srv, url = _admission_server(engine, tok)
    state, sched = srv.state, srv.state.scheduler
    generated = _track_generated(sched)
    lows = [dict(p, max_tokens=PREEMPT_MAX_TOKENS, priority="low")
            for p in serving_payloads(tok)[:SERVE_LANES]]
    try:
        alone, _ = _concurrent(url, sched, lows)
        _wait_idle(sched)
        high_alone = _request(url, PREEMPT_HIGH)
        _wait_idle(sched)
        for r in alone + [high_alone]:
            r["tokens"] = generated[r["meta"]["request_id"]]
        state.kv_manager.reset()
        pre0 = dict(state.m_preemptions.child_values())
        seq0 = state.recorder.total_recorded
        reset_launch_counts()
        out: dict = {}

        def during():
            deadline = time.perf_counter() + 60
            while time.perf_counter() < deadline:
                with sched.cv:
                    busy = all(ls is not None and sched._progress[i] > sched.block_size
                               for i, ls in enumerate(sched.lanes))
                if busy:
                    break
                time.sleep(0.002)
            require(busy, f"{label} preemption: the four low streams never all decoded")
            snap = _get_json(url + "/v1/debug/admission")
            n_tok = state.estimate_prompt_tokens(_params_of(PREEMPT_HIGH))
            wait_ms, now_ms = _forecasts(snap, n_tok, sched.admission_chunk, sched.block_size)
            # near the waiting forecast: the margin below it is for the
            # seconds between the request's arrival and the next tick
            out.update(snap=snap, wait_ms=wait_ms, now_ms=now_ms,
                       budget=now_ms + 0.9 * (wait_ms - now_ms))
            out["high"] = _request(url, dict(PREEMPT_HIGH, deadline_ms=out["budget"]))

        results, wall = _concurrent(url, sched, lows, during=during)
        _wait_idle(sched)
        out["counts"] = launch_counts()
        out["high"]["tokens"] = generated[out["high"]["meta"]["request_id"]]
        for r in results:
            r["tokens"] = generated[r["meta"]["request_id"]]
        pre = {k[0]: v - pre0.get(k, 0) for k, v in state.m_preemptions.child_values().items()}
        kinds = [e["kind"] for e in state.recorder.events() if e["seq"] > seq0]
        preempt = [e for e in state.recorder.events("stream_preempt") if e["seq"] > seq0]
        state.kv_manager.check()
    finally:
        srv.shutdown()
        srv.server_close()
    parts = []
    for i, (r, want) in enumerate(zip(results + [out["high"]], alone + [high_alone])):
        require(r["finish"] in ("stop", "length"), f"{label} preemption r{i}: {r['finish']}")
        if r["tokens"] != want["tokens"] or r["content"] != want["content"]:
            at = next((j for j, (x, y) in enumerate(zip(r["tokens"], want["tokens"])) if x != y),
                      min(len(r["tokens"]), len(want["tokens"])))
            parts.append(f"{'high' if i == len(results) else f'low r{i}'} at token {at} of "
                         f"{len(want['tokens'])}")
    n_pre = sum(pre.values())
    victim = preempt[0] if preempt else {}
    print(f"admission preemption ({label}, {SERVE_LANES} low streams): forecasts for the high "
          f"request waiting {out['wait_ms']:.1f} ms, on a freed lane {out['now_ms']:.1f} ms, its "
          f"deadline_ms {out['budget']:.1f} (from /v1/debug/admission: prefill_chunk_s "
          f"{out['snap']['predictor']['prefill_chunk_s']}, decode_step_s "
          f"{out['snap']['predictor']['decode_step_s']}, ttft_correction "
          f"{out['snap']['predictor']['ttft_correction']}); preemptions {json.dumps(pre)}; "
          f"victim lane {victim.get('lane')} ({victim.get('reason')}), head remaining "
          f"{victim.get('head_remaining_ms')} ms; high TTFT {out['high']['meta']['ttft_ms']} ms "
          f"(alone {high_alone['meta']['ttft_ms']}); answers equal to their runs without the "
          f"high request {not parts}" + ("" if not parts else f" (parts: {', '.join(parts)})")
          + f"; {wall:.2f} s wall; {smi}")
    require(n_pre == 1, f"{label} preemption: dllama_preemptions_total moved by {n_pre}")
    require({"stream_preempt", "stream_park", "stream_resume"} <= set(kinds),
            f"{label} preemption: recorded {sorted(set(kinds))}")
    require(not exact or not parts, f"{label} preemption: answers parted: {parts}")
    return out["counts"]


def _params_of(payload: dict):
    from dllama_tpu_torch.runtime.api_server import ChatMessage, InferenceParams

    return InferenceParams(messages=[ChatMessage(m["role"], m["content"])
                                     for m in payload["messages"]],
                           max_tokens=payload["max_tokens"], temperature=0.0,
                           priority=payload.get("priority", "normal"))


def serving_admission(engine, tok, smi: str, stalls0: float) -> dict:
    """The admission round of the serving phase (runtime/admission.py), on
    the serving engine with predictive admission on (a fifth `serve`, the
    pool made anew):

    (b) the seven-request mix with predictive mode off and on in turns
    (`ADMISSION_TURNS`, each on an empty pool, unhinted requests): every
    answer of an "on" turn equals the same request's "off" answer, text and
    tokens; lane tok/s of each turn printed;
    (c) ``/v1/debug/admission`` after those turns: the predictor's
    prefill-chunk and decode-step seconds beside the step histograms'
    medians and the analytic bound (the kind's bytes over the card's
    peak), the TTFT forecast error's p50 and p95, the corrections; gated:
    both errors counted (``dllama_admission_predict_error_ms`` by signal)
    and finite, on the card each step cost the engine's device mean
    (`InferenceEngine.device_step_seconds`), and the TTFT correction below
    its clamp;
    (d) the mix once more, and once its four lanes decode and three wait,
    with the scheduler held between ticks: a request with ``ttft_budget_ms:
    1`` answers 429 ``infeasible`` (``dllama_admission_rejected_total``
    +1, the queue as it was) with a Retry-After >= 1, and again once three
    unhinted requests queued behind (accepted: they finish), its
    Retry-After no lower;
    (e) `admission_preemption` (bf16: partings printed);
    then the watchdog's gate over every fault-free round so far. Returns
    the round's launch counts."""
    from dllama_tpu_torch.obs.cost import hbm_peak_bytes_per_s
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.admission import _CORR_MAX as CORR_MAX
    from dllama_tpu_torch.runtime.admission import LoadPredictor
    from dllama_tpu_torch.runtime.api_server import RETRY_AFTER

    engine.__dict__.pop("decode_lanes", None)
    srv, url = _admission_server(engine, tok)
    state, sched, kv = srv.state, srv.state.scheduler, srv.state.kv_manager
    timer = {"s": 0.0, "tokens": 0}
    inner = engine.decode_lanes

    def timed_decode(tokens, pos, n_steps, active, *args, **kw):
        t = time.perf_counter()
        rows = inner(tokens, pos, n_steps, active, *args, **kw)
        timer["s"] += time.perf_counter() - t
        timer["tokens"] += len(rows) * sum(map(bool, active))
        return rows

    engine.decode_lanes = timed_decode
    generated = _track_generated(sched)
    payloads = serving_payloads(tok)
    turns: dict = {True: [], False: []}
    answers: dict = {True: [], False: []}
    refused: list = []
    extra: list = []
    extra_threads: list = []
    try:
        reset_launch_counts()
        err0 = {sig: state.m_predict_error.labels(signal=sig).count for sig in ("ttft", "tpot")}
        for on in ADMISSION_TURNS:
            state.admission_predict = on
            kv.reset()
            timer.update(s=0.0, tokens=0)
            results, _ = _concurrent(url, sched, payloads)
            _wait_idle(sched)
            turns[on].append(timer["tokens"] / timer["s"])
            answers[on].append([(r["content"], generated[r["meta"]["request_id"]])
                                for r in results])
        state.admission_predict = True
        snap = _get_json(url + "/v1/debug/admission")
        errs = {sig: state.m_predict_error.labels(signal=sig).count - err0[sig]
                for sig in ("ttft", "tpot")}
        p50 = {k: engine._m_step.labels(kind=k).percentile(0.5)
               for k in ("prefill_lane_chunk", "decode_lanes")}
        timed = {k: engine.device_step_seconds(k) for k in p50}
        cost, peak = engine.cost_report(), hbm_peak_bytes_per_s(engine.device)
        analytic = {k: (cost["kinds"].get(k) or {}).get("bytes_accessed", 0) / peak
                    for k in p50} if peak else {}
        rejected0 = state.m_admission_rejected.labels(reason="infeasible").value
        kv.reset()

        def during():
            # every lane decoding first: a hold taken while a tick has
            # popped requests it has not begun to admit would show their
            # lanes free
            deadline = time.perf_counter() + 60
            while time.perf_counter() < deadline:
                with sched.cv:
                    if all(ls is not None for ls in sched.lanes):
                        break
                time.sleep(0.002)
            release = _held(sched)
            try:
                depth = len(sched.pending)
                hinted = dict(payloads[1], ttft_budget_ms=1)
                refused.append((depth, _request(url, hinted, allow_error=True)))
                require(len(sched.pending) == depth, "admission: the refused request queued")
                import threading

                for p in payloads[:3]:
                    th = threading.Thread(  # dlint: disable=thread-hygiene — joined after _concurrent returns, through extra_threads
                        target=lambda p=p: extra.append(_request(url, p)),
                        daemon=True, name="dllama-smoke-extra")
                    th.start()
                    extra_threads.append(th)
                deadline = time.perf_counter() + 30
                while len(sched.pending) < depth + 3 and time.perf_counter() < deadline:
                    time.sleep(0.002)
                refused.append((len(sched.pending), _request(url, hinted, allow_error=True)))
            finally:
                release()

        _concurrent(url, sched, payloads, during=during)
        for th in extra_threads:
            th.join(300)
        _wait_idle(sched)
        rejected = state.m_admission_rejected.labels(reason="infeasible").value - rejected0
        counts = launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        engine.__dict__.pop("decode_lanes", None)
    on, off = statistics.median(turns[True]), statistics.median(turns[False])
    same = all(a == answers[False][0] for a in answers[True] + answers[False])
    print(f"== llama-8b q40 serving admission: predictive mode on against off, in turns "
          f"{list(ADMISSION_TURNS)}: lane tok/s on {_ms(turns[True])}, off {_ms(turns[False])}: "
          f"on/off {on / off:.4f}; every answer equal to the off turn's {same}; {smi}")
    require(same, "admission (b): an answer with predictive mode on differs from off")
    pr, pe = snap["predictor"], snap["prediction_error"]
    print(f"admission calibration: predictor prefill_chunk_s {pr['prefill_chunk_s']} (device "
          f"mean {timed['prefill_lane_chunk']} (dispatches, s); host histogram p50 "
          f"{p50['prefill_lane_chunk']:.6f}, analytic bound "
          f"{analytic.get('prefill_lane_chunk', 0):.6f}), decode_step_s {pr['decode_step_s']} "
          f"(device mean {timed['decode_lanes']}; p50 {p50['decode_lanes']:.6f}, a block of "
          f"{BLOCK} steps; analytic {analytic.get('decode_lanes', 0):.6f}); TTFT error p50 {pe['p50_ms']} ms, p95 "
          f"{pe['p95_ms']} ms over {pe['n']}; corrections ttft {pr['ttft_correction']}, tpot "
          f"{pr['tpot_correction']}; errors counted {json.dumps(errs)}; occupancy "
          f"{json.dumps(snap['occupancy'])}; {smi}")
    require(all(v > 0 for v in errs.values()) and pe["n"] > 0
            and all(math.isfinite(pe[k]) for k in ("p50_ms", "p95_ms")),
            f"admission (c): forecast errors {errs}, {pe}")
    # on the card the predictor's step costs are the engine's device seconds
    # (a lane prefill chunk's host seconds are its enqueue), and calibrated
    # on them the TTFT correction stays off its clamp
    for k, field in (("prefill_lane_chunk", "prefill_chunk_s"), ("decode_lanes", "decode_step_s")):
        if engine.device.type != "cuda":
            break
        n_timed, mean_s = timed[k] or (0, 0.0)
        require(n_timed >= LoadPredictor.MIN_STEP_SAMPLES and abs(pr[field] - mean_s) < 1e-6,
                f"admission (c): predictor {field} {pr[field]}, device mean {timed[k]}")
    require(pr["ttft_correction"] < CORR_MAX,
            f"admission (c): the TTFT correction {pr['ttft_correction']} at its clamp {CORR_MAX}")
    (d0, r0), (d1, r1) = refused
    ra = [r.get("retry_after") for r in (r0, r1)]
    print(f"admission infeasible: ttft_budget_ms 1 with the lanes busy and {d0} queued: "
          f"{r0.get('error')} {r0.get('body', {}).get('message')}, Retry-After {ra[0]}; with "
          f"{d1} queued: {r1.get('error')}, Retry-After {ra[1]}; rejected +{rejected:.0f}; the "
          f"three unhinted requests queued behind answered "
          f"{[x.get('finish') for x in extra]}; {smi}")
    for r in (r0, r1):
        require(r.get("error") == 429 and "infeasible" in r["body"].get("message", ""),
                f"admission (d): {r}")
    require(d1 >= d0 + 3 and _retry_after_ok(ra[0], RETRY_AFTER) and _retry_after_ok(
        ra[1], int(ra[0])),
            f"admission (d): Retry-After {ra} at depths {d0}, {d1}")
    require(rejected == 2, f"admission (d): {rejected} infeasible rejections counted")
    require(len(extra) == 3 and all(x["finish"] in ("stop", "length") for x in extra),
            f"admission (d): the unhinted requests answered {extra}")
    pre_counts = admission_preemption(engine, tok, smi, "llama-8b q40", exact=False)
    gate_watchdog(stalls0, " admission", smi)
    return {"serving admission": counts, "serving admission preemption": pre_counts}


def _track_generated(sched) -> dict:
    """Each finished request's generated tokens, by request id (a stream
    carries no usage): the scheduler's ``_finish`` wrapped."""
    generated: dict = {}
    finish = sched._finish

    def tracked(lane, reason):
        ls = sched.lanes[lane]
        generated[ls.job.request_id] = list(ls.history[ls.job.n_prompt_tokens:])
        finish(lane, reason)

    sched._finish = tracked
    return generated


def _concurrent(url: str, sched, payloads: list[dict], allow_error: bool = False,
                during=None) -> tuple[list, float]:
    """Send every payload at once, in order (the lanes take the first four,
    the rest queue); returns the results and the wall seconds. ``during``,
    if given, is called once every request is in the queue, before the
    joins."""
    import threading

    results: list = [None] * len(payloads)
    errors: list = []

    def send(i):
        try:
            results[i] = _request(url, payloads[i], allow_error)
        except Exception as e:  # reported below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=send, args=(i,), daemon=True,
                                name=f"dllama-smoke-send-{i}") for i in range(len(payloads))]
    n0, t0 = sched.n_submitted, time.perf_counter()
    for i, th in enumerate(threads):
        th.start()
        deadline = time.perf_counter() + 60
        while sched.n_submitted < n0 + i + 1 and time.perf_counter() < deadline:
            time.sleep(0.001)  # submit in order: requests 4.. queue behind 0-3
    if during is not None:
        during()
    for th in threads:
        th.join(timeout=600)
    require(not errors and all(r is not None for r in results), f"serving: {errors}")
    return results, time.perf_counter() - t0


SPEC_K = 4  # the JAX package's default draft length (runtime/spec.py DEFAULT_SPEC_K)


def serving_spec(engine, tok, off: dict, lane_step_ms: float | None) -> dict:
    """The speculation round of the serving phase: a second `serve` over the
    serving engine (the spec-off round shut down; its pool made anew) with
    ``speculation="shared"``, spec_k SPEC_K: the seven requests, four at
    once, then each replayed alone. Gates: every answer ends with stop or
    length and equals its solo replay (text and tokens); at least one verify
    pass ran, with drafted tokens > 0; the rehearsal captured one verify
    graph a draft bucket; the stats kernel launched n_layers times for each
    verify pass and each prefill chunk, the paged decode kernel n_layers
    times a decode step, and no other attention kernel. Prints the
    acceptance, tokens a verify pass, drafted tokens by source, lane tok/s
    against the spec-off round's (``off``), where each answer parts from
    its spec-off answer (not gated: bf16 verify rows run the stats kernel
    and the Q40 tile, decode steps the decode kernel and the GEMV), and a
    verify pass's graphed host ms at each T against a 4-lane decode step
    (``lane_step_ms``), with a device profile of the T = 5 pass on the
    card. Returns the round's launch counts."""
    import threading

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.runtime.spec import spec_buckets
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    engine.__dict__.pop("decode_lanes", None)  # the spec-off round's timer
    h, b = engine.header, engine.batch_size
    t0 = time.perf_counter()
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True,
                speculation="shared", spec_k=SPEC_K)
    g = engine.graphs
    rehearsal = dict(verify=g.count("lane_verify_paged"), graphs=g.n_graphs,
                     s=time.perf_counter() - t0)
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sched = srv.state.scheduler
    timer = {"decode_s": 0.0, "decode_tokens": 0, "verify_s": 0.0, "chunks": 0}
    inner = {name: getattr(engine, name)
             for name in ("decode_lanes", "verify_lanes", "prefill_lane_chunk")}

    def timed_decode(tokens, pos, n_steps, active, *args, **kw):
        t = time.perf_counter()
        rows = inner["decode_lanes"](tokens, pos, n_steps, active, *args, **kw)
        timer["decode_s"] += time.perf_counter() - t
        timer["decode_tokens"] += len(rows) * sum(map(bool, active))
        return rows

    def timed_verify(rows, pos, active):
        t = time.perf_counter()
        grid = inner["verify_lanes"](rows, pos, active)
        timer["verify_s"] += time.perf_counter() - t
        return grid

    def counted_chunk(*args, **kw):
        timer["chunks"] += 1
        return inner["prefill_lane_chunk"](*args, **kw)

    engine.decode_lanes, engine.verify_lanes = timed_decode, timed_verify
    engine.prefill_lane_chunk = counted_chunk
    generated = _track_generated(sched)
    try:
        payloads = serving_payloads(tok)
        reset_launch_counts()
        engine.lane_decode_steps = engine.lane_verify_steps = 0
        results, t_conc = _concurrent(url, sched, payloads)
        conc, conc_spec = dict(timer), sched.spec_stats()
        conc_emitted = sched.spec_accepted + sched.spec_accept_len_count
        solo = [_request(url, p) for p in payloads]
        counts = launch_counts()
        for r in results + solo:
            r["tokens"] = generated[r["meta"]["request_id"]]
        steps, passes, chunks = engine.lane_decode_steps, engine.lane_verify_steps, timer["chunks"]
        spec = sched.spec_stats()
    finally:
        srv.shutdown()
        srv.server_close()
        for name in inner:
            engine.__dict__.pop(name, None)
    print(f"obs anomaly after the speculation round: {json.dumps(srv.state.anomaly.status())}")
    print(f"== llama-8b q40 serving spec: speculation shared, spec_k {SPEC_K}, "
          f"{len(payloads)} requests, {b} lanes; rehearsal captured {rehearsal['verify']} verify "
          f"graphs ({rehearsal['graphs']} in all, {rehearsal['s']:.2f} s with the pool)")
    for i, (r, s_, o) in enumerate(zip(results, solo, off["results"])):
        same = r["content"] == s_["content"] and r["tokens"] == s_["tokens"]
        part = next((j for j, (x, y) in enumerate(zip(r["tokens"], o["tokens"])) if x != y),
                    None if len(r["tokens"]) == len(o["tokens"]) else
                    min(len(r["tokens"]), len(o["tokens"])))
        print(f"serve spec r{i}: lane {r['meta']['lane']} reused "
              f"{r['meta']['reused_prefix_tokens']} finish {r['finish']} tokens "
              f"{len(r['tokens'])} ttft_ms {r['meta']['ttft_ms']}; equals solo {same}; "
              f"equals spec-off {part is None}"
              + ("" if part is None else f" (parts at token {part} of {len(o['tokens'])})"))
        require(r["finish"] in ("stop", "length") and s_["finish"] in ("stop", "length"),
                f"serving spec r{i}: finish {r['finish']} / solo {s_['finish']}")
        require(same, f"serving spec r{i}: the concurrent answer differs from its solo replay")
    lane_s = conc["decode_s"] + conc["verify_s"]
    spec_tok_s = (conc["decode_tokens"] + conc_emitted) / lane_s
    print(f"serve spec aggregate: {conc['decode_tokens']} lane tokens from decode blocks in "
          f"{conc['decode_s']:.3f} s and {conc_emitted} from {conc_spec['verify_passes']} verify "
          f"passes in {conc['verify_s']:.3f} s: {spec_tok_s:.2f} lane tok/s against the spec-off "
          f"round's {off['lane_tok_s']:.2f} ({spec_tok_s / off['lane_tok_s']:.2f}x; "
          f"{t_conc:.2f} s wall)")
    print(f"serve spec acceptance: accepted {spec['accepted']} of {spec['drafted']} drafted "
          f"({spec['accepted'] / max(spec['drafted'], 1):.3f}); {spec['verify_passes']} verify "
          f"passes, {(sched.spec_accepted + sched.spec_accept_len_count) / max(passes, 1):.2f} "
          f"tokens a pass, {spec['tokens_per_lane_pass']:.2f} a lane a pass; drafted by source "
          f"{json.dumps(spec['sources'])}; store {json.dumps(spec['store'])}")
    print(f"serve spec launches {json.dumps(counts)}; decode steps {steps}, verify passes "
          f"{passes}, prefill chunks {chunks}")
    require(rehearsal["verify"] == len(spec_buckets(SPEC_K)),
            f"serving spec: rehearsal captured {rehearsal['verify']} verify graphs")
    require(passes >= 1 and spec["drafted"] > 0,
            f"serving spec: {passes} verify passes, {spec['drafted']} drafted tokens")
    require(counts["flash_attention_stats"] == h.n_layers * (chunks + passes),
            f"serving spec: {counts['flash_attention_stats']} stats launches, the chunks and "
            f"verify passes imply {h.n_layers * (chunks + passes)}")
    require(counts["paged_flash_decode"] == h.n_layers * steps,
            f"serving spec: {counts['paged_flash_decode']} decode launches, the steps imply "
            f"{h.n_layers * steps}")
    other = [name for name, c in counts.items() if c and "flash" in name
             and name not in ("paged_flash_decode", "flash_attention_stats")]
    require(not other, f"serving spec: attention launches {counts}")
    graph_lint(engine, "llama-8b q40 serving spec")
    verify_cost(engine, lane_step_ms)
    return counts


def verify_cost(engine, lane_step_ms: float | None) -> None:
    """A verify pass's host ms at each T in VERIFY_T, every lane live at
    PROMPT_TOKENS on private pages (`HOST_RUNS` runs each after a warm one,
    graphed where graphs run), against a 4-lane decode step's; on the card
    a device profile of the T = 5 pass too, graphed and eager."""
    import torch

    b, nb = engine.batch_size, engine._kv_n_blocks
    for lane in range(b):
        engine.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
    pos, act = [PROMPT_TOKENS] * b, [True] * b
    for t in VERIFY_T:
        rows = [[1] * t] * b
        engine.verify_lanes(rows, pos, act)  # warm
        runs = []
        for _ in range(HOST_RUNS):
            t0 = time.perf_counter()
            engine.verify_lanes(rows, pos, act)
            runs.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(runs)
        print(f"verify pass T={t}, {b} lanes at pos {PROMPT_TOKENS} (m = {b * t} rows a "
              f"projection), {'graphed' if engine.graphs.active else 'eager'}: host ms "
              f"{_ms(runs)}"
              + (f"; {ms / lane_step_ms:.2f}x a 4-lane decode step's {lane_step_ms:.3f} ms, "
                 f"break-even at {ms / lane_step_ms:.2f} tokens a lane a pass"
                 if lane_step_ms else ""))
    if engine.device.type == "cuda":
        rows = [[1] * VERIFY_T[-1]] * b
        prof = profile_both(engine, lambda: engine.verify_lanes(rows, pos, act), 1)
        for side, name in ((True, "graphed"), (False, "eager")):
            p = prof[side]
            print(f"verify profile {name}, T={VERIFY_T[-1]}, {b} lanes: device kernel ms/pass "
                  f"{p['device_ms_per_token']:.3f}, device launches/pass "
                  f"{p['launches_per_token']:.0f}; from {p['source']}")
            for kname, ms, count in p["top"]:
                print(f"  {ms:8.4f} ms/pass {count:5d}x {kname[:90]}")
        torch.cuda.synchronize(engine.device)


# (spec, what must hold), by round: (0) fault-free, (a) transient faults,
# (b) a decode poison, (c) an admission poison, (d) park/resume at
# max_streams 7 on 4 lanes, (e) a drain with streams in flight
RESILIENCE_ROUNDS = {
    "0": ("fault-free", None),
    "a": ("transient", "dispatch:every=7:seed=1"),
    "b": ("decode poison", "dispatch:op=decode_lanes:nth=2:kind=poison"),
    "c": ("admission poison", "dispatch:op=prefill_lane_chunk:nth=2:kind=poison"),
    "d": ("park/resume", None),
    "e": ("drain", None),
}
PARK_STREAMS = 7  # --max-streams of round (d): the seven requests over 4 lanes


def resilience_f32(device: str, mp: str, tp: str, smi: str) -> dict:
    """Rounds 0, (b), (c) and (d) of `serving_resilience` on an f32 engine
    over the model file ``mp`` (f32 activations and pool, the Q40 weights as
    they are): a re-prefilled row differs from the decoded one by sum order
    only, so every answer must equal round 0's. Then the admission round's
    preemption (`admission_preemption`) on the same engine, each answer
    gated equal to its run without the preempting request. Returns the
    launch counts of both."""
    import torch

    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import Tokenizer

    engine = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=SEED,
                             weight_format="q40", device=device, batch_size=SERVE_LANES)
    tok = Tokenizer(tp)
    print(f"== llama-8b q40 f32 resilience: {engine.header.n_layers} layers, f32, "
          f"{SERVE_LANES} lanes")
    try:
        counts = serving_resilience(engine, tok, None, smi, "0bcd", "llama-8b q40 f32",
                                    exact=True)
        pre = admission_preemption(engine, tok, smi, "llama-8b q40 f32", exact=True)
        return {k: counts[k] + pre[k] for k in counts}
    finally:
        engine.kv_pool = engine.params = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def _lane_kv(engine, lane: int, n: int):
    """Rows [0, n) of ``lane``'s K and V in every layer, read through the
    engine's host page table, in f32 (an int8 pool's rows dequantized):
    [2, n_layers, n_kv_heads, n, head_dim]."""
    import torch

    from dllama_tpu_torch.ops.kv_cache import QuantKV

    ps = engine._kv_page_size
    pages = torch.as_tensor(engine._page_table[lane][: -(-n // ps)].astype("int64"),
                            device=engine.device)
    out = []
    for leaf in engine.kv_pool.values():
        if isinstance(leaf, QuantKV):
            v = leaf.q[:, pages].float() * leaf.s[:, pages]
        else:
            v = leaf[:, pages].float()
        n_l, n_p, kh, _, hd = v.shape
        out.append(v.permute(0, 2, 1, 3, 4).reshape(n_l, kh, n_p * ps, hd)[:, :, :n])
    return torch.stack(out)


def _pool_ptrs(engine) -> list[int]:
    from dllama_tpu_torch.ops.kv_cache import kv_tensors

    return [t.data_ptr() for leaf in engine.kv_pool.values() for t in kv_tensors(leaf)]


def _resilience_metrics() -> dict:
    """The registry's retries, recovered lanes and injected faults by site."""
    from dllama_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    out = {"retries": reg.counter("dllama_dispatch_retries_total").value,
           "recovered": reg.counter("dllama_lanes_recovered_total").value}
    faults = reg.counter("dllama_faults_injected_total", labelnames=("site",))
    out.update({("faults", k[0]): v for k, v in faults.child_values().items()})
    return out


def serving_resilience(engine, tok, truth: list[dict] | None, smi: str,
                       rounds: str = "0abcde", label: str = "llama-8b q40",
                       exact: bool = False) -> dict:
    """The resilience round of the serving phase: a third `serve` over the
    serving engine (speculation off; the pool made anew and the rehearsal's
    graphs captured again) and the seven requests, four at once, in each of
    ``rounds`` (`RESILIENCE_ROUNDS`), each schedule armed through the chaos
    plane (`set_fault_plane`) and each round on an empty pool (`kv.reset`,
    in place), as the spec-off round began, so every round prefills what
    that round prefilled. Truth is each request's answer in the spec-off
    round (``truth``: equal to its solo replay, gated there).
    ``truth`` None: round 0's answers are the truth. Gates, in every round:
    every answer that did not fail ends with stop or length; in rounds 0,
    (a) and (e) it equals its truth (text and tokens), and in (b), (c) and
    (d), where a stream's rows are re-prefilled, only with ``exact`` (f32):
    in bf16 the tile and the stats kernel re-make rows that the GEMV and
    the decode kernel wrote, in other sum orders, and near-tied random
    logits turn that into other tokens (PERF.md §6), so there the
    round prints where answers part and gates instead each resumed
    stream's K/V rows against the rows it had before the fault or the park
    (`_lane_kv`: max|after - before| / max|before| within `TOL_KV_RESUME`
    of the pool's type); no graph was captured
    (the graph count and ``capture_s`` as after the rehearsal); the pool's
    ``data_ptr`` did not move; ``kv.check()`` passes; the scheduler is idle
    after it. By round: (a) dispatch retries > 0; (b) lanes recovered >= 1;
    (c) exactly one request failed, retryable (503 with the predicted
    Retry-After, at least 1, or an error event in its stream), and one
    recovery ran; (d) parks >= 1 and resumes equal to parks; (e) ``POST
    /v1/drain`` once every request is queued: a new request answers 503
    with the predicted Retry-After, at least 5, the seven finish,
    ``drained`` is set. The decode kernel launched n_layers times a
    decode step, and no attention kernel but it and the stats kernel.
    Prints each round's lane tok/s against the fault-free round's, the
    largest gap between two tokens of a stream, for (b) and (c) the time
    from the fault to the last resumed lane's next token, the tokens the
    resumes re-prefilled against those they re-matched, with the card's
    name and power limit. Returns the round's launch counts."""
    import threading
    import urllib.request

    import torch

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.api_server import RETRY_AFTER, RETRY_AFTER_DRAINING, serve
    from dllama_tpu_torch.runtime.faults import set_fault_plane
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    h = engine.header
    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True)
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    state, sched, kv, g = srv.state, srv.state.scheduler, srv.state.kv_manager, engine.graphs
    graphs0, ptrs0 = (g.n_graphs, g.capture_s), _pool_ptrs(engine)
    # the scheduler's hooks: decode time and lane tokens, each token's time
    # by request, each recovery's start with the requests it resumed, and
    # each live stream's K/V rows before a pool reset or a park, held
    # against its rows once its resume re-prefilled them
    timer = {"s": 0.0, "tokens": 0}
    times: dict = {}
    recs: list = []
    before: dict = {}
    restored: list = []
    inner, consume, recover = engine.decode_lanes, sched._consume_token, sched._recover
    reset_pool, park, finish_adm = (engine.reset_kv_pool, sched._park_stream,
                                    sched._finish_admission)

    def snapshot(lane):
        ls = sched.lanes[lane]
        before[ls.job.request_id] = _lane_kv(engine, lane, ls.pos)

    def snapshot_reset():
        for lane, ls in enumerate(sched.lanes):
            if ls is not None:
                snapshot(lane)
        reset_pool()

    def snapshot_park(lane):
        snapshot(lane)
        park(lane)

    def check_resume(lane, adm):
        finish_adm(lane, adm)
        ls = adm.resume_state
        was = None if ls is None else before.pop(ls.job.request_id, None)
        if was is not None:
            now = _lane_kv(engine, lane, ls.pos)
            same_rows = int((now == was).all(dim=4).all(dim=2).all(dim=1).all(dim=0).sum())
            restored.append(((now - was).abs().max().item() / was.abs().max().item(),
                             ls.pos, same_rows))

    def timed_decode(tokens, pos, n_steps, active, *args, **kw):
        t = time.perf_counter()
        try:
            rows = inner(tokens, pos, n_steps, active, *args, **kw)
        finally:
            timer["s"] += time.perf_counter() - t
        timer["tokens"] += len(rows) * sum(map(bool, active))
        return rows

    def timed_consume(lane, t):
        ls = sched.lanes[lane]
        if ls is not None:
            times.setdefault(ls.job.request_id, []).append(time.perf_counter())
        return consume(lane, t)

    def timed_recover(e, culprit):
        resumed = [ls.job.request_id for lane, ls in enumerate(sched.lanes)
                   if ls is not None and lane != culprit]
        recs.append((time.perf_counter(), resumed))
        recover(e, culprit)

    engine.decode_lanes, sched._consume_token, sched._recover = (timed_decode, timed_consume,
                                                                 timed_recover)
    engine.reset_kv_pool, sched._park_stream, sched._finish_admission = (
        snapshot_reset, snapshot_park, check_resume)
    generated = _track_generated(sched)
    payloads = serving_payloads(tok)
    base: dict = {}
    truth_name = None
    try:
        reset_launch_counts()
        engine.lane_decode_steps = 0
        for key in rounds:
            name, spec = RESILIENCE_ROUNDS[key]
            timer.update(s=0.0, tokens=0)
            times.clear()
            recs.clear()
            before.clear()
            restored.clear()
            c0 = {k: getattr(sched, k) for k in ("dispatch_retries", "recoveries",
                                                 "lanes_recovered", "parks", "resumes",
                                                 "resume_reused_tokens", "resume_prefill_tokens")}
            m0 = _resilience_metrics()
            drain: dict = {}
            kv.reset()
            before.clear()  # the reset's own snapshot: no lane was live

            def during():
                if key == "e":
                    req = urllib.request.Request(url + "/v1/drain", data=b"", method="POST")
                    with urllib.request.urlopen(req, timeout=60) as r:
                        drain["begin"] = json.loads(r.read())
                    drain["late"] = _request(url, payloads[0], allow_error=True)

            plane = set_fault_plane(spec or "")
            sched.max_streams = PARK_STREAMS if key == "d" else 0
            try:
                results, wall = _concurrent(url, sched, payloads, allow_error=True, during=during)
            finally:
                fired = plane.counts()
                set_fault_plane("")
                sched.max_streams = 0
            deadline = time.perf_counter() + 30
            while (any(sched.lanes) or sched.admitting or sched.pending) and (
                    time.perf_counter() < deadline):
                time.sleep(0.01)  # the last _finish clears its lane after "done"
            d = {k: getattr(sched, k) - v for k, v in c0.items()}
            m1 = _resilience_metrics()
            md = {k: m1.get(k, 0) - m0.get(k, 0) for k in set(m0) | set(m1)}
            md = {k: v for k, v in md.items() if v}
            want = {"retries": d["dispatch_retries"], "recovered": d["lanes_recovered"],
                    **{("faults", site): c for site, c in fired.items() if c}}
            want = {k: v for k, v in want.items() if v}
            print(f"obs resilience {key}: registry deltas {sorted(md.items(), key=str)}, "
                  f"/v1/health deltas {sorted(want.items(), key=str)}; {smi}")
            require(md == want, f"resilience {key}: registry deltas {md}, health deltas {want}")
            failed = [i for i, r in enumerate(results) if "error" in r]
            for r in results:
                if "error" not in r:
                    r["tokens"] = generated[r["meta"]["request_id"]]
            truth_name = truth_name or ("the spec-off round's" if truth else "round 0's")
            truth = truth or results
            for i, r in enumerate(results):
                if "error" not in r:
                    require(r["finish"] in ("stop", "length"),
                            f"resilience {key} r{i}: finish {r['finish']}")
            parts = _parts(results, truth)
            gaps = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])]
            tok_s = timer["tokens"] / timer["s"] if timer["s"] else 0.0
            base = base or dict(tok_s=tok_s, gap=max(gaps, default=0.0))
            rec_s = [min((t for t in times.get(rid, []) if t > t0), default=t0) - t0
                     for t0, resumed in recs for rid in resumed]
            print(f"resilience {key} {name}{'' if spec is None else ' ' + spec} ({label}, "
                  f"{SERVE_LANES} lanes): {len(payloads) - len(failed)} of {len(payloads)} "
                  f"answered, failed {failed}; answers equal to {truth_name} "
                  f"{not parts}{'' if not parts else ' (parts: ' + ', '.join(parts) + ')'}; "
                  f"faults fired {json.dumps(fired)}; {json.dumps(d)}; lane tok/s {tok_s:.2f} "
                  f"({tok_s / base['tok_s']:.3f}x the fault-free round's {base['tok_s']:.2f}); "
                  f"largest token gap {max(gaps, default=0.0) * 1e3:.1f} ms (fault-free "
                  f"{base['gap'] * 1e3:.1f} ms); {wall:.2f} s wall; {smi}")
            if recs:
                print(f"resilience {key} recovery: {len(recs)} recoveries resumed "
                      f"{sum(len(r) for _, r in recs)} streams; fault to the last resumed "
                      f"lane's next token {max(rec_s, default=0.0) * 1e3:.1f} ms; re-prefilled "
                      f"{d['resume_prefill_tokens']} tokens, re-matched "
                      f"{d['resume_reused_tokens']}; {smi}")
            if key == "d":
                print(f"resilience d resume: {d['parks']} parks, {d['resumes']} resumes; "
                      f"re-prefilled {d['resume_prefill_tokens']} tokens against "
                      f"{d['resume_reused_tokens']} re-matched from the radix tree; {smi}")
            kv_tol = TOL_KV_RESUME[str(engine.kv_dtype)]
            if key in "bcd":
                err = max((e for e, _, _ in restored), default=0.0)
                print(f"resilience {key} K/V restored: {len(restored)} resumed streams, "
                      f"{sum(n for _, n, _ in restored)} rows, "
                      f"{sum(m for _, _, m in restored)} of them bit-equal; max|after - before| "
                      f"/ max|before| {err:.3e} (limit {kv_tol:.3e}); {smi}")
                require(len(restored) == d["lanes_recovered"] + d["resumes"] and restored,
                        f"resilience {key}: {len(restored)} resumes checked, "
                        f"{d['lanes_recovered'] + d['resumes']} ran")
                require(err <= kv_tol, f"resilience {key}: K/V restored with err {err:.3e}")
            require(not parts or (key in "bcd" and not exact),
                    f"resilience {key}: answers part from {truth_name}: {parts}")
            require((g.n_graphs, g.capture_s) == graphs0,
                    f"resilience {key}: graphs {g.n_graphs} / capture {g.capture_s:.3f} s after "
                    f"the round, {graphs0} after the rehearsal")
            require(_pool_ptrs(engine) == ptrs0, f"resilience {key}: the pool moved")
            kv.check()
            require(not (any(sched.lanes) or sched.admitting or sched.pending),
                    f"resilience {key}: the scheduler is not idle after the round")
            if key == "a":
                require(d["dispatch_retries"] > 0 and fired.get("dispatch", 0) > 0,
                        f"resilience a: {d['dispatch_retries']} retries, faults {fired}")
            if key == "b":
                require(d["lanes_recovered"] >= 1, f"resilience b: {d['lanes_recovered']} "
                        "lanes recovered")
            if key == "c":
                require(len(failed) == 1 and d["recoveries"] == 1,
                        f"resilience c: failed {failed}, {d['recoveries']} recoveries")
                for r in (results[i] for i in failed):
                    require(r["body"].get("retryable") is True
                            and (r["error"] == "stream" or (r["error"] == 503 and _retry_after_ok(
                                r["retry_after"], RETRY_AFTER))),
                            f"resilience c: the culprit's answer {r}")
            elif key in "0abde":
                require(not failed, f"resilience {key}: failed {failed}")
            if key == "d":
                require(d["parks"] >= 1 and d["resumes"] == d["parks"] and not sched._n_parked,
                        f"resilience d: {d['parks']} parks, {d['resumes']} resumes")
            if key == "e":
                late = drain["late"]
                print(f"resilience e drain: POST /v1/drain {json.dumps(drain['begin'])}; a new "
                      f"request answered {late.get('error')} Retry-After "
                      f"{late.get('retry_after')}; drained {state.drained.wait(timeout=60)}")
                require(drain["begin"]["status"] == "draining"
                        and drain["begin"]["in_flight"] >= 1,
                        f"resilience e: drain answered {drain['begin']}")
                require(late.get("error") == 503
                        and _retry_after_ok(late.get("retry_after"), RETRY_AFTER_DRAINING),
                        f"resilience e: a request during the drain got {late}")
                require(state.drained.is_set(), "resilience e: drained was not set")
        counts = launch_counts()
        steps = engine.lane_decode_steps
    finally:
        set_fault_plane("")
        srv.shutdown()
        srv.server_close()
        engine.__dict__.pop("decode_lanes", None)
        engine.__dict__.pop("reset_kv_pool", None)
    print(f"obs anomaly after the resilience rounds ({label}): "
          f"{json.dumps(srv.state.anomaly.status())}")
    kv8 = "_kv8" if engine.kv_dtype == torch.int8 else ""
    decode_kernel, stats = "paged_flash_decode" + kv8, "flash_attention_stats" + kv8
    print(f"resilience launches ({label}) {json.dumps(counts)}; decode steps {steps}; health "
          f"{json.dumps(srv.state.health_snapshot()['resilience'])}")
    require(counts[decode_kernel] == h.n_layers * steps and steps > 0,
            f"resilience: {counts[decode_kernel]} {decode_kernel} launches, the steps imply "
            f"{h.n_layers * steps}")
    other = [k for k, c in counts.items() if c and "flash" in k and k not in (decode_kernel, stats)]
    require(counts[stats] > 0 and not other, f"resilience: attention launches {counts}")
    return counts


SPEC_PARITY_LAYERS = 4


def spec_parity(engine, prompt: list[int]) -> dict:
    """Verify parity in float32 at SPEC_PARITY_LAYERS layers of the
    engine's weights: a copy of the engine (the same quantized leaves, f32
    activations, an f32 pool of its own, int8 for an int8 engine; graphs as
    the engine's) prefills its lanes at ragged lengths and decodes 5 greedy
    steps with decode_lanes; verify_lanes over [pending, the first 4 of
    them] must give the 5 tokens, and the logits of one forward of those 5
    rows must equal the 5 decode steps' (T = 1 forwards). Returns the
    grids, whether they are equal, the positions and the logits error."""
    import copy
    import dataclasses

    import torch

    from dllama_tpu_torch.models import forward
    from dllama_tpu_torch.runtime.graphs import StepGraphs

    e = copy.copy(engine)
    e.params = cast_params(engine, torch.float32)
    e.params["layers"] = e.params["layers"][:SPEC_PARITY_LAYERS]
    e.header = dataclasses.replace(engine.header, n_layers=SPEC_PARITY_LAYERS)
    e.dtype = torch.float32
    e.kv_dtype = torch.int8 if engine.kv_dtype == torch.int8 else torch.float32
    e.graphs = StepGraphs(engine.device, engine.cuda_graphs)
    e.kv_pool = None
    b, n = e.batch_size, 5
    e.init_kv_pool(PAGE, 1 + b * -(-e.header.seq_len // PAGE), native=True)
    nb, dev = e._kv_n_blocks, e.device
    prompts = [prompt[: len(prompt) - 37 * lane] for lane in range(b)]
    for lane, p in enumerate(prompts):
        e.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
        e.prefill_lane(lane, p)
    pos, pend = [len(p) - 1 for p in prompts], [p[-1] for p in prompts]
    steps = e.decode_lanes(pend, pos, n, [True] * b)
    want = [[steps[i][lane] for i in range(n)] for lane in range(b)]
    rows = [[pend[lane]] + want[lane][: n - 1] for lane in range(b)]
    grid = e.verify_lanes(rows, pos, [True] * b)
    with torch.inference_mode():
        pt = e._page_table_dev()
        toks = torch.tensor(rows, device=dev)
        posv = torch.tensor(pos, dtype=torch.int32, device=dev)
        verify, _ = forward(e.params, e.header, toks, posv, e.kv_pool, "all", page_table=pt)
        stepwise = torch.stack([
            forward(e.params, e.header, toks[:, i: i + 1], posv + i, e.kv_pool, "last",
                    page_table=pt)[0][:, -1] for i in range(n)], dim=1)
        err = norm_err(verify, stepwise)[0]
    e.kv_pool = None
    return dict(equal=grid == want, grid=grid, want=want, pos=pos, err=err)


def in_turns() -> list[bool]:
    """The sides of `HOST_RUNS` timed runs each in turns: graphed (True),
    eager, eager, graphed, graphed, eager, ..."""
    return [i % 4 in (0, 3) for i in range(2 * HOST_RUNS)]


def profile_both(engine, run, n_steps: int) -> dict:
    """`device_profile` of ``run()`` with graphs on (True) and off (False).
    A replay launches the eager run's kernels, so where the profiler
    reports fewer launches inside the replays than in the eager run (none
    at all, or a part: CUPTI has shown both), the graphed side takes the
    eager side's device figures, and ``source`` says so."""
    out = {}
    for graphed in (True, False):
        engine.cuda_graphs = graphed
        out[graphed] = device_profile(engine, run, n_steps, allow_empty=graphed)
    engine.cuda_graphs = True
    out[False]["source"] = "eager run"
    seen, want = out[True]["launches_per_token"], out[False]["launches_per_token"]
    if seen >= want:
        out[True]["source"] = "graph replays"
    else:
        out[True] = dict(out[False], source=f"the eager run: the profiler reported {seen:.0f} "
                                            f"of its {want:.0f} launches inside the replays")
    return out


def decode_profile(engine, token: int, pos: int, n_steps: int = BLOCK) -> dict:
    """`profile_both` of one decode block: per-token device ms and the
    kernels that take it, graphed and eager."""
    return profile_both(engine, lambda: engine.decode_block(token, pos, n_steps), n_steps)


def lane_profile(engine, pos: int, n_steps: int = BLOCK) -> dict:
    """One greedy decode block of every lane at ``pos`` (pool-native: each
    lane on private pages; slab: its slab rows; the KV rows below pos are
    whatever they hold, which costs the same time): host ms a step of
    `HOST_RUNS` runs a side, graphed and eager in turns, unprofiled
    (``host``), and `profile_both` (``prof``)."""
    import torch

    b, nb = engine.batch_size, engine._kv_n_blocks
    if engine.kv_native:  # slab lanes decode on their slab rows
        for lane in range(b):
            engine.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))

    def run():
        engine.decode_lanes([1] * b, [pos] * b, n_steps, [True] * b, [0.0] * b)

    host = {True: [], False: []}
    for graphed in in_turns():
        engine.cuda_graphs = graphed
        run()  # warm
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(engine.device)
        host[graphed].append((time.perf_counter() - t0) * 1e3 / n_steps)
    engine.cuda_graphs = True
    return dict(host=host, prof=profile_both(engine, run, n_steps))


def device_profile(engine, run, n_steps: int, allow_empty: bool = False) -> dict:
    """Device kernel time of ``run()`` (n_steps decode steps, or one
    prefill) under torch.profiler: device ms and launches a step, the
    kernels that take the time (``top``; every kernel in ``kernels``), and
    the host ops with the most self CPU time (profiled, so inflated; for
    where the host time goes, not how much). An empty device profile fails
    unless ``allow_empty`` (the caller then reads ``kernels`` itself)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(engine.device)
    rows, host = [], []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            # a host op: its device time is its kernels', listed too
            host.append((e.self_cpu_time_total, e.key, e.count))
            continue
        if e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    require(bool(rows) or allow_empty, "decode profile: the profiler reported no device time")
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {
        "device_ms_per_token": total / 1e3 / n_steps,
        "launches_per_token": sum(r[2] for r in rows) / n_steps,
        "top": [(k, us / 1e3 / n_steps, c // n_steps) for us, k, c in rows[:8]],
        "kernels": [(k, us / 1e3 / n_steps, c // n_steps) for us, k, c in rows],
        "host_top": [(k, us / 1e3 / n_steps, c // n_steps) for us, k, c in sorted(host)[::-1][:8]],
    }


def timed_runs(engine, prompt: list[int], token: int, pos: int) -> dict:
    """`HOST_RUNS` host-timed runs a side, graphed (True) and eager in
    turns: the prompt's prefill (host ms, each chunk synchronised) and
    `HOST_BLOCKS` decode blocks from ``pos`` (host ms a token; each block
    ends in its readback) with the graph replays a decoded token. Every
    shape ran before (the CLI run), so no run pays a first use or a
    capture. Rewrites the cache rows of the prompt and from ``pos`` on."""
    out = {side: dict(prefill=[], decode=[], replays=[]) for side in (True, False)}
    for graphed in in_turns():
        engine.cuda_graphs = graphed
        side = out[graphed]
        side["prefill"].append(engine.prefill(prompt).time_ms)
        r0, tok, p = engine.graphs.replays, token, pos
        t0 = time.perf_counter()
        for _ in range(HOST_BLOCKS):
            tok, p = engine.decode_block(tok, p, BLOCK)[-1], p + BLOCK
        side["decode"].append((time.perf_counter() - t0) * 1e3 / (BLOCK * HOST_BLOCKS))
        side["replays"].append((engine.graphs.replays - r0) / (BLOCK * HOST_BLOCKS))
    engine.cuda_graphs = True
    return out


# the graphed side's median host ms of the prompt's prefill, by run label
# (`graphs_vs_eager`), for the mixed-KV runs to print beside their own
PREFILL_GRAPHED_MS: dict[str, float] = {}


def steady_prefill_ms(engine, prompt: list[int]) -> float:
    """The median host ms of `HOST_RUNS` graphed runs of the prompt's
    prefill (each chunk synchronised; every chunk's graph captured by an
    earlier run)."""
    engine.cuda_graphs = True
    return statistics.median(engine.prefill(prompt).time_ms for _ in range(HOST_RUNS))


def _ms(values) -> str:
    return ", ".join(f"{v:.3f}" for v in values) + f" (median {statistics.median(values):.3f})"


def graphs_vs_eager(engine, res: dict, want: dict, label: str) -> float:
    """Graphs against the eager path on the CLI run's engine. Gates: a
    second ``generate`` with ``cuda_graphs=False`` gives the CLI run's
    greedy stream and the launch counts the shapes imply. Prints the host
    ms of `timed_runs` a side, graph replays a token, and for each side a
    device profile of a decode block (quantized runs) and of the prompt's
    prefill: device ms, kernel launches, busy share (device ms over the
    side's median host ms), the grouped MoE kernels' share of a chunk.
    Returns the graphed side's median decode host ms a token."""
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts

    prompt, tokens = res["prompt_tokens"], res["tokens"]
    n_dec, g = len(tokens), engine.graphs
    print(f"graphs {label}: {g.n_graphs} captured in {g.capture_s:.2f} s, pool "
          f"{g.pool_bytes() / 1e9:.3f} GB; the CLI run's host ms include each shape's "
          f"first use and capture (prefill {res['eval'].time_ms:.1f}, decode "
          f"{res['pred'].time_ms / n_dec:.3f} ms/token)")
    engine.cuda_graphs = False
    reset_launch_counts()
    eager, eager_eval, eager_pred = engine.generate(prompt, max_steps=len(prompt) - 1 + n_dec)
    counts = launch_counts()
    engine.cuda_graphs = True
    print(f"graphs {label}: eager generate equals the graphed greedy stream: {eager == tokens}; "
          f"eager prefill ms {eager_eval.time_ms:.1f}, decode ms/token "
          f"{eager_pred.time_ms / n_dec:.3f}; eager launches equal the shapes': {counts == want}")
    require(eager == tokens, f"{label}: the eager greedy stream differs from the graphed one")
    require(counts == want, f"{label}: eager launches {counts}, the shapes imply {want}")
    runs = timed_runs(engine, prompt, tokens[-1], len(prompt) - 1 + n_dec)
    PREFILL_GRAPHED_MS[label] = statistics.median(runs[True]["prefill"])
    for side, name in ((True, "graphed"), (False, "eager")):
        r = runs[side]
        print(f"graphs {label} {name}: decode host ms/token {_ms(r['decode'])}; graph replays "
              f"a token {statistics.median(r['replays']):.3f}; prefill host ms {_ms(r['prefill'])}")
    if engine.weight_format != "dense":
        prof = decode_profile(engine, tokens[-1], len(prompt) - 1 + n_dec)
        for side, name in ((True, "graphed"), (False, "eager")):
            p, host_ms = prof[side], statistics.median(runs[side]["decode"])
            print(f"decode profile {name}: device kernel ms/token {p['device_ms_per_token']:.3f}, "
                  f"device launches/token {p['launches_per_token']:.0f}, host ms/token "
                  f"{host_ms:.3f} (median of the unprofiled runs), device busy share "
                  f"{p['device_ms_per_token'] / host_ms:.3f}; from {p['source']}")
            for kname, ms, count in p["top"]:
                print(f"  {ms:8.4f} ms/token {count:5d}x {kname[:90]}")
            for kname, ms, count in p["host_top"]:
                print(f"  host {ms:8.4f} ms/token {count:5d}x {kname[:80]}")
    prof = profile_both(engine, lambda: engine.prefill(prompt), 1)
    for side, name in ((True, "graphed"), (False, "eager")):
        p, host_ms = prof[side], statistics.median(runs[side]["prefill"])
        dev_ms = p["device_ms_per_token"]
        grouped = sum(ms for kname, ms, _ in p["kernels"] if "grouped" in kname)
        print(f"prefill profile {name}: host ms {_ms(runs[side]['prefill'])}; device kernel ms "
              f"{dev_ms:.3f}, device launches {p['launches_per_token']:.0f}, grouped MoE kernels "
              f"ms {grouped:.3f} (share {grouped / dev_ms:.3f}), device busy share "
              f"{dev_ms / host_ms:.3f}; from {p['source']}")
        for kname, ms, count in p["top"]:
            print(f"  prefill {ms:8.4f} ms {count:5d}x {kname[:90]}")
    return statistics.median(runs[True]["decode"])


def sampled_streams(engine, prompt: list[int]) -> None:
    """Sampled decode blocks (temperature 0.8, top-p 0.9, seed `SEED`):
    `SAMPLED_TOKENS` tokens graphed twice and eagerly once, each from
    ``set_seed(SEED)``. Gates: the three streams are equal."""
    engine.temperature, engine.sampler.topp = 0.8, 0.9
    streams = []
    try:
        for graphed in (True, True, False):
            engine.cuda_graphs = graphed
            engine.set_seed(SEED)
            streams.append(engine.generate(prompt, max_steps=len(prompt) - 1 + SAMPLED_TOKENS)[0])
    finally:
        engine.temperature, engine.cuda_graphs = 0.0, True
    print(f"sampled stream (temperature 0.8, top-p 0.9, seed {SEED}, {SAMPLED_TOKENS} tokens): "
          f"two graphed runs equal {streams[0] == streams[1]}, graphed equals eager "
          f"{streams[0] == streams[2]}; {len(set(streams[0]))} distinct tokens; first "
          f"{streams[0][:8]}")
    require(len(streams[0]) == SAMPLED_TOKENS, "sampled stream: wrong length")
    require(streams[0] == streams[1], "sampled stream: two graphed runs differ")
    require(streams[0] == streams[2], "sampled stream: graphed and eager differ")


def perplexity_check(engine, prompt: list[int], label: str) -> None:
    """The engine's ``perplexity`` of the prompt graphed (a first call:
    eager first use and capture; a second: the replay) and eager. Gate:
    the replay's NLL has the eager one's bits."""
    engine.cuda_graphs = True
    first = engine.perplexity(prompt)
    t0 = time.perf_counter()
    graphed = engine.perplexity(prompt)
    graphed_ms = (time.perf_counter() - t0) * 1e3
    engine.cuda_graphs = False
    t0 = time.perf_counter()
    eager = engine.perplexity(prompt)
    eager_ms = (time.perf_counter() - t0) * 1e3
    engine.cuda_graphs = True
    print(f"perplexity {label} (engine dtype, {graphed[2]} scored): nll graphed {graphed[0]!r} "
          f"eager {eager[0]!r} first use {first[0]!r}, bits equal {graphed[0] == eager[0]}; "
          f"perplexity {graphed[1]:.4f}; host ms graphed {graphed_ms:.1f} eager {eager_ms:.1f}")
    require(graphed == eager and first == eager,
            f"{label}: perplexity graphed {graphed} / first {first}, eager {eager}")


def ptxas_kernels(log: str) -> list[str]:
    """One line a kernel of a ptxas -v report: its (mangled) name, registers,
    static shared memory and spill stores, and any ptxas warning or wgmma
    note about it (serialization among them)."""
    lines, name, notes, spill = [], None, [], "?"
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, notes, spill = m.group(1), [], "?"
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name[:72]}: registers {m.group(1)}, static smem "
                         f"{smem.group(1) if smem else 0} B, spill stores {spill} B"
                         + "".join(f"; {w}" for w in notes))
            name = None
        elif "Function properties" not in line and ("warning" in line.lower() or "wgmma" in line):
            notes.append(line.strip())
    return lines


# ---- the parallel round: tensor and sequence parallelism on one card ----

# sequence parallelism's two kernel options at llama-8b's shard shapes: tp 2
# x sp 2 gives each rank 16 query heads over 4 KV heads; S_LOCAL rows a
# shard, each global position p of a cyclic shard i at local row p // sp
SP_SHAPE = dict(h=16, kh=4, hd=128, t=256, s_local=2048)
SP_SMALL_T = (1, 3, 5)  # short chunks: a query row a block or fewer
# the Q40 kernels at the tp = 2 slices of llama-8b: wq/wo-in (k 4096 n 2048),
# wk/wv (n 512), w1/w3 (n 7168), wcls (n 64128); wo (k 2048) and w2 (k 7168)
TP_Q40_SHAPES = [(4096, 2048), (4096, 512), (4096, 7168), (4096, 64128), (2048, 4096),
                 (7168, 4096)]
TP_PROMPT = 513  # (b): one 512-row prefill chunk, then decode from its last token
TP_DECODE = 32  # (b): greedy tokens of the tp = 2 stream
SP_PROMPT = 544  # (c): 543 rows to fill: a 512-row chunk, then a 32-row one
SP_DECODE = 48  # (c): greedy tokens of each sp run
TIMED_STEPS = 8  # decode steps timed a rank for the (f) prints
# (b) the first decode step's logits of tp = 2 against tp = 1 on the bf16
# q40 llama-8b (normalized max error): the tp split sums each GEMV's
# partials in f32 in another order, so bf16 roundings of the activations
# flip here and there through 32 layers; held an order above one bf16 step
# at the logits' scale and as far as two kernel paths of the same bf16 model
# read apart (the parity lines: 4-6e-2), where a wrong slice or a lost
# all-reduce reads ~1
TOL_TP_BF16 = 0.1
# (c) f32 logits of sp = 2 and tp 2 x sp 2 against one rank after `ACCEPT_LAYERS` layers:
# sum order only (the GEMV partials, the ring's and the decode merge's
# order), f32 throughout; a shard read at a wrong position reads ~1
TOL_TP_F32 = 1e-3
Q80_BOUND = 2e-2  # tests/test_parallel.py's bound on the q80 all-reduce
# the bf16 llama-8b file of the parallel round's (b) and (g), the
# pipeline round's (i), the draft round's target and the f32 resilience
# rounds: 16 of 32 layers, a file of their own for the smoke's time (the
# same kernels at the same widths, each layer a repeat of the first; the
# watchdog-gated serving rounds and the fleet, which replays their answers,
# stay at 32: `N_LAYERS`)
PAR_LAYERS = 16
# (j) qwen3-30b-a3b's f32 rows against one rank after `PP_MOE_LAYERS` layers (tp 2, sp 2
# and tp 2 x pp 2): sum order only, as (c), whose readings were 1.7-2.3e-6
# (PERF.md). The int8 cache's rows (sp 2, tp 2 x sp 2) take `TOL_TP_F32`:
# each cache row is rounded to int8 once it is written, so a last-bit
# difference of a layer's input flips an int8 step (1/127 of the row's
# largest value) here and there in the next layers' rows, as q40i8's int8
# activations do; the streams stay gated equal
TOL_PAR_F32 = 3e-6


def _sp_case(device, gen, dtype, stride: int, t: int, pos: int, s_pos0: int, kv8: bool = False):
    """q [1, T, H, hd] in ``dtype`` and a cyclic shard's k and v [1, KH,
    S_LOCAL, hd]: in ``dtype``, or with ``kv8`` int8 leaves (`random_kv8`)."""
    import torch

    c = SP_SHAPE
    shape = (1, c["kh"], c["s_local"], c["hd"])
    q = torch.randn((1, t, c["h"], c["hd"]), device=device, generator=gen).to(dtype)
    if kv8:
        return q, random_kv8(shape, device, gen), random_kv8(shape, device, gen)
    k = torch.randn(shape, device=device, generator=gen).to(dtype)
    v = torch.randn(shape, device=device, generator=gen).to(dtype)
    return q, k, v


def _strided_composite(q, k, v, pos: int, s_pos0: int, stride: int, n_keys: int):
    """The two calls that compute the normalized output of a strided int8
    shard's stats with PyTorch: the visible rows dequantized, then SDPA
    under the strided causal mask (key j at s_pos0 + j * stride)."""
    import torch

    from dllama_tpu_torch.ops.kv_cache import dequant_kv, slice_kv

    n = max(n_keys, 1)
    qpos = pos + torch.arange(q.shape[1], device=q.device)
    mask = s_pos0 + torch.arange(n, device=q.device)[None, :] * stride <= qpos[:, None]
    qs = q.transpose(1, 2)
    return lambda: _sdpa(qs, dequant_kv(slice_kv(k, n), q.dtype),
                         dequant_kv(slice_kv(v, n), q.dtype), mask)


def _counted_twice(fn, counter, what: str):
    """fn() twice with equal bits, each run one launch on ``counter``."""
    before = counter.launches
    out = twice_equal(fn, what)
    require(counter.launches == before + 2, f"{what}: {counter.launches - before} launches "
            f"under {counter.__name__}, wanted 2")
    return out


def check_attention_strided(device, gen, timed: bool = True) -> list[dict]:
    """The stats kernel over a cyclic shard (``s_stride`` 2 and 4) against
    its plain version, bf16 and f32, at `SP_SHAPE` (T 256 near the shard's
    end, then T 1, 3, 5), each launched twice with equal bits; the same over
    an int8 shard (`random_kv8`: the ``_q8`` entry, its launches under
    ``flash_attention_stats_strided_kv8``, bytes the int8 values and f32
    scales). f32 outputs: TOL. No PyTorch call attends over a strided
    shard: library_ms is none; an int8 row's ``composite_ms`` times the
    dequantization of the visible rows and SDPA under the strided mask."""
    import torch

    from dllama_tpu_torch.ops import flash_attention as fa

    c = SP_SHAPE
    rows = []
    cases = [(dt, st, c["t"], c["s_local"] * st - c["t"] - 7, st - 1, kv8)
             for kv8 in (False, True) for dt in (torch.bfloat16, torch.float32) for st in (2, 4)]
    cases += [(torch.bfloat16, 2, t, 101, 1, kv8) for kv8 in (False, True) for t in SP_SMALL_T]
    for dt, stride, t, pos, s0, kv8 in cases:
        q, k, v = _sp_case(device, gen, dt, stride, t, pos, s0, kv8)
        name = "flash_attention_stats_strided" + ("_kv8" if kv8 else "")
        tag = ("int8 " if kv8 else "") + str(dt)[6:]
        what = f"{name} {tag} stride={stride} T={t} pos={pos} s_pos0={s0}"

        def kernel():
            return fa.flash_attention_stats(q, k, v, pos, s0, s_stride=stride)

        def plain():
            return fa.flash_attention_stats_ref(q, k, v, pos, s0, s_stride=stride)

        got = _counted_twice(kernel, getattr(fa, name), what)
        ref = plain()
        torch.cuda.synchronize(device)
        errs = [norm_err(a, b) for a, b in zip(got, ref)]
        rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= TOL, f"{what}: error {rel:.3e} > {TOL}")
        # visible keys of query row i: local rows j with s0 + j * stride <= pos + i
        vis = sum(max(0, min(c["s_local"], (pos + i - s0) // stride + 1)) for i in range(t))
        n_keys = max(0, min(c["s_local"], (pos + t - 1 - s0) // stride + 1))
        es = q.element_size()
        kv_bytes = (_kv8_bytes(c["kh"], n_keys, c["hd"]) if kv8
                    else 2 * c["kh"] * n_keys * c["hd"] * es)
        n_bytes = q.numel() * es + kv_bytes + c["h"] * t * (c["hd"] + 2) * 4
        b_ms, b_by = bound(n_bytes, 4.0 * c["hd"] * c["h"] * vis)  # tensor cores, any type
        row = dict(name=name,
                   shape=f"{tag} H={c['h']} KH={c['kh']} T={t} S={c['s_local']} "
                         f"stride={stride} pos={pos}", err=rel, max_abs_err=absd,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if timed:
            row["ms"] = time_ms(kernel, device)
            row["plain_ms"] = time_ms(plain, device, 5)
            if kv8:
                row["composite_ms"] = time_ms(
                    _strided_composite(q, k, v, pos, s0, stride, n_keys), device)
        rows.append(row)
    return rows


def check_decode_stats(device, gen, timed: bool = True) -> list[dict]:
    """The decode kernel emitting its state over a cyclic shard (stride 2,
    s_pos0 0 and 1), bf16 and f32, against its plain version: every row of
    the 2048-row shard visible (pos 4095: each block of the cluster holds
    its share of the tiles), a mid position, and a shard wholly in the
    query's future (pos 0, s_pos0 1: m = -1e30, l = 0, acc = 0, nothing
    read); each launched twice with equal bits; the same over an int8 shard
    (the ``_q8`` entry, counted under ``flash_decode_stats_kv8``). f32
    outputs: TOL. library_ms none (no PyTorch call returns the
    unnormalized state); an int8 row's ``composite_ms`` times the
    dequantization and SDPA (two calls) of the normalized output."""
    import torch

    from dllama_tpu_torch.ops import flash_attention as fa

    c = SP_SHAPE
    rows = []
    cases = [(dt, pos, s0, kv8) for kv8 in (False, True) for dt in (torch.bfloat16, torch.float32)
             for pos, s0 in ((4095, 0), (4095, 1), (563, 1), (0, 1))]
    for dt, pos, s0, kv8 in cases:
        q, k, v = _sp_case(device, gen, dt, 2, 1, pos, s0, kv8)
        name = "flash_decode_stats" + ("_kv8" if kv8 else "")
        tag = ("int8 " if kv8 else "") + str(dt)[6:]
        what = f"{name} {tag} stride=2 pos={pos} s_pos0={s0}"

        def kernel():
            return fa.flash_decode_stats(q, k, v, pos, s0, 2)

        def plain():
            return fa.flash_decode_stats_ref(q, k, v, pos, s0, 2)

        counter = fa.flash_decode_stats_kv8 if kv8 else fa.flash_decode_stats
        got = _counted_twice(kernel, counter, what)
        ref = plain()
        torch.cuda.synchronize(device)
        n_keys = max(0, min(c["s_local"], (pos - s0) // 2 + 1))
        if n_keys == 0:
            require(float(got[1].max()) <= -1e29 and float(got[2].abs().max()) == 0.0
                    and float(got[0].abs().max()) == 0.0,
                    f"{what}: a shard in the future must give m = -1e30, l = 0, acc = 0")
            rel, absd = 0.0, 0.0
        else:
            errs = [norm_err(a, b) for a, b in zip(got, ref)]
            rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= TOL, f"{what}: error {rel:.3e} > {TOL}")
        es = q.element_size()
        kv_bytes = (_kv8_bytes(c["kh"], n_keys, c["hd"]) if kv8
                    else 2 * c["kh"] * n_keys * c["hd"] * es)
        n_bytes = q.numel() * es + kv_bytes + c["h"] * (c["hd"] + 2) * 4
        b_ms, b_by = bound(n_bytes, 4.0 * c["hd"] * c["h"] * n_keys,
                           BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        row = dict(name=name,
                   shape=f"{tag} H={c['h']} KH={c['kh']} S={c['s_local']} stride=2 "
                         f"pos={pos} s_pos0={s0}", err=rel, max_abs_err=absd,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if timed:
            row["ms"] = time_ms(kernel, device)
            row["plain_ms"] = time_ms(plain, device, 5)
            if kv8:
                row["composite_ms"] = time_ms(
                    _strided_composite(q, k, v, pos, s0, 2, n_keys), device)
        rows.append(row)
    return rows


def check_q40_tp(device, gen, timed: bool = True) -> list[dict]:
    """The Q40 kernel at the tp = 2 slices of llama-8b (`TP_Q40_SHAPES`), the
    GEMV (m 1) and the tile (m 512), bf16, under check_q40's gates."""
    import torch

    return check_q40(device, gen, timed,
                     cases=[(k, n, [(1, torch.bfloat16), (512, torch.bfloat16)])
                            for k, n in TP_Q40_SHAPES], tag=" tp=2")


MOE_TP = (2, 4)  # the tp sizes whose expert slices check_moe_tp runs: F/tp 384 and 192


def check_moe_tp(device, gen, timed: bool = True) -> list[dict]:
    """The MoE kernels on a tp rank's expert slices of qwen3-30b-a3b (E 128,
    D 2048, k 8; F/tp hidden units an expert: 384 at tp 2, 192 at tp 4,
    the grouped kernel's 128-value Q40 stage ending in a half stage; a
    slice's Q40 w2 scales 24 and 12 bytes a row, so rows start off 16-byte
    boundaries), contiguous as the loader makes them, bf16 over Q40 and
    dense bf16 experts: the active kernel at m 1, the grouped kernel at N
    512, and the two-tier decode at 4 lanes on 8 shared experts (the
    grouped tier under cap 16); each against `moe_experts_ref` on the same
    slices within TOL_MOE_BF16, launched twice with equal bits. library_ms
    none (no single PyTorch call computes a routed SwiGLU MoE)."""
    import torch

    from dllama_tpu_torch.ops import moe
    from dllama_tpu_torch.ops.quant_matmul import dequant

    e, d, f_all, k = (MOE_SHAPE[key] for key in ("e", "d", "f", "k"))
    rows = []
    for tp in MOE_TP:
        f = f_all // tp
        qw = random_q40_experts(e, d, f, device, gen)
        for quant in (True, False):
            ws = qw if quant else [dequant(w, torch.bfloat16) for w in qw]
            for kind, n in (("active", 1), ("grouped", 512), ("tiers", MOE_DECODE_LANES)):
                x = torch.randn((n, d), device=device, generator=gen).to(torch.bfloat16)
                top_i = torch.rand((n, e), device=device, generator=gen).topk(k, -1).indices.int()
                cap = moe.dedup_cap(n, k, True)
                if kind == "tiers":  # every lane on the same 8 experts: the grouped tier
                    chosen = torch.randperm(e, device=device, generator=gen)[:k].int()
                    top_i = chosen[torch.rand((n, k), device=device, generator=gen).argsort(-1)]
                wts = torch.rand((n, k), device=device, generator=gen) + 0.1
                wts = wts / wts.sum(-1, keepdim=True)
                name = f"moe_{'active' if kind == 'active' else 'grouped'}_experts" + (
                    "_q40" if quant else "")
                fn = getattr(moe, name)

                def kernel(fn=fn, x=x, ws=ws, top_i=top_i, wts=wts, cap=cap, kind=kind):
                    if kind == "tiers":
                        return moe.moe_decode_tiers(x, *ws, top_i, wts, cap)
                    return fn(x, *ws, top_i, wts)

                label = (f"bf16 {'m' if kind == 'active' else 'N'}={n} F/tp={f} tp={tp}"
                         + (f" two-tier cap={cap} u=8" if kind == "tiers" else ""))
                got = _counted_twice(kernel, fn, f"{name} {label}")
                ref = moe.moe_experts_ref(x, *ws, top_i, wts)
                torch.cuda.synchronize(device)
                rel, absd = norm_err(got, ref)
                require(rel <= TOL_MOE_BF16, f"{name} {label}: error {rel:.3e} > {TOL_MOE_BF16}")
                n_exp = int(torch.unique(top_i).numel())
                w_bytes = sum((w.q.numel() + w.d.numel() * 2) if quant
                              else w.numel() * w.element_size() for w in ws) // e
                n_bytes = n_exp * w_bytes + x.numel() * 2 + n * d * 4 + n * k * 8
                b_ms, b_by = bound(n_bytes, 6.0 * n * k * d * f)
                row = dict(name=name, shape=label, err=rel, max_abs_err=absd, bound_ms=b_ms,
                           bound_by=b_by, experts=n_exp, library_ms=None)
                if timed:
                    row["ms"] = time_ms(kernel, device)
                    row["plain_ms"] = time_ms(lambda: moe.moe_experts_ref(x, *ws, top_i, wts),
                                              device, 5)
                rows.append(row)
            del ws
        del qw
        gc.collect()
    return rows


PP_WAVE = 64  # a pipeline wave's rows: the 512-row chunk in 8 waves at pp 2
PP_WAVE_POS = 448  # the chunk's last wave


def check_pp_waves(device, gen, timed: bool = True) -> list[dict]:
    """The kernels of a pipeline stage at the waves' shapes (pp 2: a 512-row
    chunk in 8 waves of 64 rows, the last at pos 448): the Q40 tile at m 64
    (k 4096, n 14336), the prefill stats at T 64 (H 32 over KH 8, S 4096,
    bf16; library SDPA) and the grouped Q40 experts at N 64 (A3B), each
    against its plain version under its usual bound, launched twice with
    equal bits."""
    import torch

    from dllama_tpu_torch.ops import moe
    from dllama_tpu_torch.ops.flash_attention import (
        flash_attention_stats, flash_attention_stats_ref,
    )

    bf = torch.bfloat16
    rows = check_q40(device, gen, timed, cases=[(4096, 14336, [(PP_WAVE, bf)])], tag=" pp waves")
    h, kh, hd, t, pos = 32, 8, 128, PP_WAVE, PP_WAVE_POS
    q = torch.randn((1, t, h, hd), device=device, generator=gen).to(bf)
    k, v = (torch.randn((1, kh, 4096, hd), device=device, generator=gen).to(bf) for _ in range(2))
    shape = f"H={h} KH={kh} T={t} S=4096 pos={pos} pp waves"
    got = twice_equal(lambda: flash_attention_stats(q, k, v, pos), f"flash_attention_stats {shape}")
    ref = flash_attention_stats_ref(q, k, v, pos)
    errs = [norm_err(a, b) for a, b in zip(got, ref)]
    rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
    require(rel <= TOL, f"flash_attention_stats {shape}: error {rel:.3e} > {TOL}")
    vis = sum(pos + i + 1 for i in range(t))
    b_ms, b_by = bound(q.numel() * 2 + 2 * kh * (pos + t) * hd * 2 + h * t * (hd + 2) * 4,
                       4.0 * hd * h * vis)
    row = dict(name="flash_attention_stats", shape=shape, err=rel, max_abs_err=absd,
               bound_ms=b_ms, bound_by=b_by)
    if timed:
        qpos = pos + torch.arange(t, device=device)
        mask = torch.arange(pos + t, device=device)[None, :] <= qpos[:, None]
        qs, ks, vs = q.transpose(1, 2), k[:, :, : pos + t], v[:, :, : pos + t]
        row["ms"] = time_ms(lambda: flash_attention_stats(q, k, v, pos), device)
        row["plain_ms"] = time_ms(lambda: flash_attention_stats_ref(q, k, v, pos), device, 5)
        row["library_ms"] = time_ms(lambda: _sdpa(qs, ks, vs, mask), device)
    rows.append(row)
    del k, v
    e, d, f, kk = (MOE_SHAPE[key] for key in ("e", "d", "f", "k"))
    ws = random_q40_experts(e, d, f, device, gen)
    n = PP_WAVE
    x = torch.randn((n, d), device=device, generator=gen).to(bf)
    top_i = torch.rand((n, e), device=device, generator=gen).topk(kk, -1).indices.int()
    wts = torch.rand((n, kk), device=device, generator=gen) + 0.1
    wts = wts / wts.sum(-1, keepdim=True)
    label = f"bf16 N={n} pp waves"
    fn = moe.moe_grouped_experts_q40
    got = _counted_twice(lambda: fn(x, *ws, top_i, wts), fn, f"moe_grouped_experts_q40 {label}")
    ref = moe.moe_experts_ref(x, *ws, top_i, wts)
    rel, absd = norm_err(got, ref)
    require(rel <= TOL_MOE_BF16, f"moe_grouped_experts_q40 {label}: error {rel:.3e}")
    n_exp = int(torch.unique(top_i).numel())
    w_bytes = sum(w.q.numel() + w.d.numel() * 2 for w in ws) // e
    b_ms, b_by = bound(n_exp * w_bytes + x.numel() * 2 + n * d * 4 + n * kk * 8,
                       6.0 * n * kk * d * f)
    row = dict(name="moe_grouped_experts_q40", shape=label, err=rel, max_abs_err=absd,
               bound_ms=b_ms, bound_by=b_by, experts=n_exp, library_ms=None)
    if timed:
        row["ms"] = time_ms(lambda: fn(x, *ws, top_i, wts), device)
        row["plain_ms"] = time_ms(lambda: moe.moe_experts_ref(x, *ws, top_i, wts), device, 5)
    rows.append(row)
    return rows


LANE_TP = dict(h=16, kh=4)  # llama-8b's heads a rank at tp = 2
LANE_SP_S = (4096 + SLAB_PAD) // 2  # a rank's rows of the lanes' slab at sp = 2
LANE_SP_POS = (0, 15, 16, 4095, -1)  # four live lanes and one parked


def check_lane_shards(device, gen, timed: bool = True) -> list[dict]:
    """The kernels of serving under tp and sp at the lane shard shapes,
    each against its plain version, launched twice with equal bits: the
    paged decode at tp = 2 heads (H 16 over KH 4, hd 128, page 16, B = 4
    at `PAGED_POS`) and the paged stats at the verify widths (T 2, 3, 5,
    B = 4 + 1 parked at -T); the slab decode at KH 4 over the lanes' slab
    of 4096 + 512 rows, B = 4 + 1 parked; the decode stats over a rank's
    cyclic shard of that slab at sp = 2 (H 32 over KH 8, `LANE_SP_S` rows,
    stride 2, ``s_pos0`` 0 and 1, B = 4 + 1 parked at -1: the parked lane's
    state must be m = -1e30, l = 0, acc = 0 on every shard); and the Q40
    GEMV at m = 4 (the lanes) on the tp = 2 slices. bf16, as the tp = 2
    serving round runs; library_ms: SDPA on the gathered view or the slab
    where one call attends the same rows (the verify stats' too: SDPA over
    the five lanes' gathered view computes the normalized output the
    stats give), none for the decode stats over a strided shard."""
    import torch

    from dllama_tpu_torch.ops.flash_attention import (
        flash_decode, flash_decode_ref, flash_decode_stats, flash_decode_stats_ref,
        paged_flash_attention_stats, paged_flash_attention_stats_ref, paged_flash_decode,
        paged_flash_decode_ref,
    )
    from dllama_tpu_torch.ops.kv_cache import lane_views

    h, kh, hd, dt = LANE_TP["h"], LANE_TP["kh"], 128, torch.bfloat16
    es = 2
    rows = []

    def row(name, shape, got, ref, n_bytes, ops, fn, plain, lib=None):
        errs = [norm_err(a, b) for a, b in zip(*((got, ref) if isinstance(got, tuple)
                                                 else ((got,), (ref,))))]
        rel, absd = max(e[0] for e in errs), max(e[1] for e in errs)
        tol = TOL if isinstance(got, tuple) else TOL_BF16_OUT
        require(rel <= tol, f"{name} {shape}: error {rel:.3e} > {tol}")
        b_ms, b_by = bound(n_bytes, ops)
        r = dict(name=name, shape=shape, err=rel, max_abs_err=absd, bound_ms=b_ms, bound_by=b_by,
                 library_ms=None)
        if timed:
            r["ms"] = time_ms(fn, device)
            r["plain_ms"] = time_ms(plain, device, 5)
            if lib is not None:
                r["library_ms"] = time_ms(lib, device)
        rows.append(r)

    # the paged decode and the paged verify stats at tp = 2 heads
    (kp, vp), pt, _, _, _ = _paged_case(device, gen, h, kh, dt)
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device=device)
    q = torch.randn((4, 1, h, hd), device=device, generator=gen).to(dt)
    shape = f"bf16 H={h} KH={kh} B=4 pos={','.join(map(str, PAGED_POS))} tp=2"
    got = twice_equal(lambda: paged_flash_decode(q, kp, vp, pt, pos), f"paged_flash_decode {shape}")
    live = sum(p + 1 for p in PAGED_POS)
    kv_k, kv_v = lane_views(kp, pt), lane_views(vp, pt)
    mask = (torch.arange(4096, device=device)[None, :] <= pos[:, None])[:, None, None]
    row("paged_flash_decode", shape, got, paged_flash_decode_ref(q, kp, vp, pt, pos),
        2 * kh * live * hd * es + 2 * q.numel() * es + pt.numel() * 4, 4.0 * hd * h * live,
        lambda: paged_flash_decode(q, kp, vp, pt, pos),
        lambda: paged_flash_decode_ref(q, kp, vp, pt, pos),
        lambda: _sdpa(q.transpose(1, 2), kv_k, kv_v, mask))
    b = len(VERIFY_POS) + 1
    ptv = torch.cat([pt, pt[:1]])  # the parked fifth lane's row: any pages
    kvv_k, kvv_v = lane_views(kp, ptv), lane_views(vp, ptv)  # the gathered view of 5 lanes
    for t in VERIFY_T:
        q_pos0 = torch.tensor(VERIFY_POS + (-t,), dtype=torch.int32, device=device)
        qv = torch.randn((b, t, h, hd), device=device, generator=gen).to(dt)
        qpos = q_pos0[:, None] + torch.arange(t, device=device)[None, :]
        vmask = (torch.arange(4096, device=device)[None, None, :] <= qpos[:, :, None])[:, None]
        shape = f"bf16 H={h} KH={kh} B=4+1 T={t} verify tp=2"
        got = twice_equal(lambda: paged_flash_attention_stats(qv, kp, vp, ptv, q_pos0),
                          f"flash_attention_stats {shape}")
        acc, m, l = got
        require(bool((acc[-1] == 0).all() and (l[-1] == 0).all() and (m[-1] <= -1e29).all()),
                f"flash_attention_stats {shape}: the parked lane's state is not empty")
        ref = paged_flash_attention_stats_ref(qv, kp, vp, ptv, q_pos0)
        vis = sum(p + i + 1 for p in VERIFY_POS for i in range(t))
        row("flash_attention_stats", shape, tuple(x[:-1] for x in got),
            tuple(x[:-1] for x in ref),
            qv.numel() * es + 2 * kh * hd * es * sum(p + t for p in VERIFY_POS)
            + h * b * t * (hd + 2) * 4 + ptv.numel() * 4, 4.0 * hd * h * vis,
            lambda: paged_flash_attention_stats(qv, kp, vp, ptv, q_pos0),
            lambda: paged_flash_attention_stats_ref(qv, kp, vp, ptv, q_pos0),
            lambda: _sdpa(qv.transpose(1, 2), kvv_k, kvv_v, vmask))
    del kp, vp, kv_k, kv_v, kvv_k, kvv_v

    # the slab decode at KH 4 over the lanes' slab, one lane parked
    s = 4096 + SLAB_PAD
    k, v = (torch.randn((b, kh, s, hd), device=device, generator=gen).to(dt) for _ in range(2))
    pos = torch.tensor(SLAB_DECODE_POS, dtype=torch.int32, device=device)
    q = torch.randn((b, 1, h, hd), device=device, generator=gen).to(dt)
    shape = f"bf16 H={h} KH={kh} B=4+1 S={s} pos={','.join(map(str, SLAB_DECODE_POS))} slab tp=2"
    got = twice_equal(lambda: flash_decode(q, k, v, pos), f"flash_decode {shape}")
    require(bool((got[-1] == 0).all()), f"flash_decode {shape}: the parked lane is not zero")
    live = sum(p + 1 for p in SLAB_DECODE_POS if p >= 0)
    mask = (torch.arange(s, device=device)[None, :] <= pos[:, None])[:, None, None]
    row("flash_decode", shape, got, flash_decode_ref(q, k, v, pos),
        2 * kh * live * hd * es + 2 * q.numel() * es, 4.0 * hd * h * live,
        lambda: flash_decode(q, k, v, pos), lambda: flash_decode_ref(q, k, v, pos),
        lambda: _sdpa(q.transpose(1, 2), k, v, mask))
    del k, v

    # the decode stats over a rank's cyclic shard of the lanes' slab at sp = 2
    hs, khs = 32, 8
    k, v = (torch.randn((b, khs, LANE_SP_S, hd), device=device, generator=gen).to(dt)
            for _ in range(2))
    pos = torch.tensor(LANE_SP_POS, dtype=torch.int32, device=device)
    q = torch.randn((b, 1, hs, hd), device=device, generator=gen).to(dt)
    for s0 in (0, 1):
        shape = (f"bf16 H={hs} KH={khs} B=4+1 S={LANE_SP_S} stride=2 s_pos0={s0} "
                 f"pos={','.join(map(str, LANE_SP_POS))} sp=2")
        got = twice_equal(lambda: flash_decode_stats(q, k, v, pos, s0, 2),
                          f"flash_decode_stats {shape}")
        acc, m, l = got
        require(bool((acc[-1] == 0).all() and (l[-1] == 0).all() and (m[-1] <= -1e29).all()),
                f"flash_decode_stats {shape}: the parked lane's state is not empty")
        n_keys = sum(max(0, (p - s0) // 2 + 1) for p in LANE_SP_POS if p >= 0)
        row("flash_decode_stats", shape, got, flash_decode_stats_ref(q, k, v, pos, s0, 2),
            2 * khs * n_keys * hd * es + q.numel() * es + hs * b * (hd + 2) * 4,
            4.0 * hd * hs * n_keys, lambda: flash_decode_stats(q, k, v, pos, s0, 2),
            lambda: flash_decode_stats_ref(q, k, v, pos, s0, 2))
    del k, v
    # the Q40 GEMV at the lanes' m = 4 on the tp = 2 slices
    return rows + check_q40(device, gen, timed,
                            cases=[(kk, n, [(4, torch.bfloat16)]) for kk, n in TP_Q40_SHAPES],
                            tag=" tp=2 lanes")


def _tp_prompt(n: int, vocab: int) -> list[int]:
    """A fixed prompt of n token ids (BOS 1 first) below the vocabulary."""
    return [1] + [(i * 7919 + 13) % (vocab - 8) + 8 for i in range(n - 1)]


def _first_diff(a: list[int], b: list[int]):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _print_ranks(label: str, results: list, h, tp: int, sync_quant: bool = False) -> None:
    """(f): each rank's decode token on the shared card: device ms (CUDA
    events), its collectives' host ms and bytes against the analytic model
    (which counts tp's traffic only, none of sp's; the port's embedding
    all-reduce is exact f32 under q80 too), and its launches by wrapper
    counter."""
    from dllama_tpu_torch.utils.telemetry import ici_traffic_per_token

    model = ici_traffic_per_token(h, tp, activation_bytes=1.125 if sync_quant else 4.0)
    for r, res in enumerate(results):
        t = res["timed"]
        launches = {k: v for k, v in res["launches"].items() if v}
        print(f"parallel rank {label} rank {r} (ranks share one card over gloo): decode token "
              f"device_ms {t['device_ms']:.3f} collective_ms {t['collective_ms']:.3f} "
              f"({t['calls']} collectives) collective_bytes {int(t['collective_bytes'])} vs "
              f"ici_traffic_per_token {model}; launches {json.dumps(launches)}")


PAR_SERVE_TOKENS = 32  # (h): max_tokens of each request of the f32 servers' mix
PAR_CHAT_SEQ = 256  # (h): the chat's context; its first reply runs to the end
PAR_CHAT_TURNS = "hello there\nand one more thing\n"
PAR_POISON = "dispatch:op=decode_lanes:nth=3:kind=poison"  # (h): a decode poison at tp = 2


def _par_payloads(tok, max_tokens: int) -> list[dict]:
    """The serving phase's seven-request mix with ``max_tokens`` each, none
    streamed (each answer then counts its tokens)."""
    return [dict(p, max_tokens=max_tokens, stream=False) for p in serving_payloads(tok)]


def _par_serve_kw(**serve) -> dict:
    """`serve`'s arguments of the parallel serving round: the serving
    phase's model name, template and page size."""
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    return dict(model_name="llama-8b", chat_template_type=ChatTemplateType.LLAMA3,
                kv_page_size=PAGE, **serve)


def _par_job(model: str, tok: str, tp: int, sp: int, dtype: str, payloads: list[dict],
             batch_size: int = SERVE_LANES, kv_dtype: str | None = None, pp: int = 1,
             dp: int = 1, **serve) -> tuple:
    """A server job of parallel/launch.serve_target (rank 0 serves, the
    other ranks follow)."""
    return ("serve", dict(model=model, tokenizer=tok, tp=tp, sp=sp, pp=pp, dp=dp, dtype=dtype,
                          weight_format="q40", batch_size=batch_size, kv_dtype=kv_dtype,
                          requests=payloads, serve=_par_serve_kw(**serve)))


def _tp1_answers(model: str, tok: str, payloads: list[dict], batch_size: int = SERVE_LANES,
                 kv_dtype: str | None = None, **serve) -> list:
    """The one-rank f32 server's answers on the card: the truth of (h)."""
    import threading

    import torch

    from dllama_tpu_torch.parallel.launch import ask_all
    from dllama_tpu_torch.runtime.api_server import serve as serve_fn
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import Tokenizer

    eng = InferenceEngine(model, dtype=torch.float32, temperature=0.0, weight_format="q40",
                          device="cuda", batch_size=batch_size, kv_dtype=kv_dtype)
    srv = serve_fn(eng, Tokenizer(tok), host="127.0.0.1", port=0, **_par_serve_kw(**serve))
    serve_thread(srv)
    try:
        return ask_all(f"http://127.0.0.1:{srv.server_address[1]}", payloads)
    finally:
        srv.shutdown()
        srv.server_close()
        release_engine(eng)


def _chat_argv(model: str, tok: str) -> list[str]:
    return ["chat", "--model", model, "--tokenizer", tok, "--temperature", "0", "--dtype",
            "f32", "--weight-format", "q40", "--chat-template", "llama3", "--max-seq-len",
            str(PAR_CHAT_SEQ)]


def _chat_tp1(model: str, tok: str) -> str:
    """The one-rank chat's transcript from its banner on, run in process on
    the card with the two turns on stdin."""
    import io

    from dllama_tpu_torch import cli

    out, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO(PAR_CHAT_TURNS)
    try:
        with contextlib.redirect_stdout(out):
            cli.main(_chat_argv(model, tok) + ["--device", "cuda"])
    finally:
        sys.stdin = stdin
    text = out.getvalue()
    return text[text.index("💬 Chat mode"):]


def _same_ranks(label: str, results: list) -> dict:
    """Gate: every rank ran rank 0's commands and returned its tokens (the
    control plane's digest), launched the same kernels as often, and ended
    at the same cache epoch. Returns rank 0's result."""
    first = results[0]
    for r, x in enumerate(results[1:], 1):
        require(x["summary"] == first["summary"],
                f"{label}: rank {r}'s control summary {x['summary']} differs from rank 0's "
                f"{first['summary']}")
        require(x["launches"] == first["launches"],
                f"{label}: rank {r}'s kernel launches differ from rank 0's")
        require(x["cache_epoch"] == first["cache_epoch"],
                f"{label}: rank {r}'s cache_epoch {x['cache_epoch']} differs from rank 0's "
                f"{first['cache_epoch']}")
    return first


def _par_serving_report(world2: list, world4: list, jobs2: dict, jobs4: dict, truth: dict,
                        tok, h, h4, smi: str) -> dict:
    """(g) and (h) of the parallel round: the servers' answers and gates.
    ``jobs2``/``jobs4``: label -> (job index, truth key); returns the launch
    counts by label."""
    counts = {}
    label = "llama-8b q40 tp2 serving"
    i, _ = jobs2[label]
    res = [r[i] for r in world2]
    first = _same_ranks(label, res)
    answers = first["answers"][0]
    require(all(isinstance(a, str) for a in answers), f"{label}: requests failed: {answers}")
    page1 = 2 * h.n_layers * h.n_kv_heads * PAGE * h.head_dim * 2  # bf16, tp = 1
    for r, x in enumerate(res):
        require(x["pool_shape"][2] * 2 == h.n_kv_heads and x["page_bytes"] * 2 == page1,
                f"{label} rank {r}: pool {x['pool_shape']}, page {x['page_bytes']} B; want "
                f"{h.n_kv_heads // 2} heads and {page1 // 2} B, half of tp = 1's")
    n_tok = sum(first["tokens"][0])
    wall = first["wall_s"][0]
    parts = []
    # the serving phase's solo answers, where the file is the serving phase's
    solo = SERVE_TRUTH.get("solo") if h.n_layers == N_LAYERS else None
    for j, a in enumerate(answers):
        if solo:
            parts.append("equal" if a == solo[j]["content"] else
                         "parts at " + _parts_at(tok, solo[j]["tokens"], solo[j]["content"], a))
    print(f"== {label} (ranks share one card over gloo): {h.n_layers} layers, bf16, {SERVE_LANES} "
          f"pool-native lanes a rank, {len(answers)} requests greedy, every one completed; "
          f"pool {first['pool_shape']} a rank, page {first['page_bytes']} B against "
          f"{page1} B at tp = 1; control {first['summary']['commands']} commands, "
          f"digest equal on every rank; {smi}")
    print(f"parallel serve {label}: each answer against the tp = 1 answer (not gated: bf16 "
          f"partials sum in another order): "
          f"{parts if solo else 'no tp = 1 answers of this file this run'}")
    print(f"parallel serve {label}: lane tok/s {n_tok / wall:.3f} ({n_tok} tokens in "
          f"{wall:.3f} s; values only, ranks share one card over gloo), {smi}")
    counts[label] = first["launches"]

    print(f"== llama-8b q40 f32 parallel serving (ranks share one card over gloo): "
          f"{ACCEPT_LAYERS} layers at full width, f32, the mix at {PAR_SERVE_TOKENS} tokens a "
          f"request; every server's answers must equal the tp = 1 server's bytes")
    for jobs, world in ((jobs2, world2), (jobs4, world4)):
        for label, (i, key) in jobs.items():
            if key is None:
                continue
            res = [r[i] for r in world]
            first = _same_ranks(label, res)
            answers = first["answers"][0]
            bad = [j for j, (a, b) in enumerate(zip(answers, truth[key])) if a != b]
            epochs = [x["cache_epoch"] for x in res]
            print(f"parallel serve {label}: answers equal tp = 1 ({key}) "
                  f"{len(answers) - len(bad)} of {len(answers)}; {len(res)} ranks, control "
                  f"{first['summary']['commands']} commands, digest equal; cache_epoch "
                  f"{epochs}; wall {first['wall_s'][0]:.2f} s")
            require(not bad, f"{label}: answers {bad} differ from the tp = 1 server's")
            require(epochs == [1 if "poison" in label else 0] * len(res),
                    f"{label}: cache epochs {epochs}")
            if "sp2" in label:
                name = "flash_decode_stats" + ("_kv8" if "int8" in label else "")
                for r, x in enumerate(res):
                    require(x["launches"][name] > 0, f"{label} rank {r}: {name} was not launched")
            counts[label] = first["launches"]
    return counts


# the parallel round's one-rank references and files, which the pipeline
# round reuses (`pipeline_round`)
PAR_REFS: dict = {}


def _slice_report(world2: list, world4: list, idx: dict, q_want: dict, qh, h4, want_kv8,
                  want_kv8_stream, smi: str) -> dict:
    """(j) of the parallel round: qwen3-30b-a3b q40 at full width on its
    `PP_MOE_LAYERS`-layer file, bf16 at tp 2 (a rank's expert bytes exactly half of one
    rank's, the first decode step's logits within `TOL_TP_BF16` of one
    rank's, the stream printed) and f32 at tp 2, sp 2 and tp 2 x pp 2; the
    `ACCEPT_LAYERS`-layer llama-8b file with an int8 cache in f32 at sp 2 and tp 2 x sp 2.
    Every f32 row: the greedy stream equal to one rank's and the logits
    within `TOL_PAR_F32` (within `TOL_TP_F32` over an int8 cache); both MoE
    kernels, or both int8 strided entries, launched on every rank. Returns
    the launch counts by label."""
    import numpy as np
    import torch

    counts = {}
    print(f"== qwen3-30b-a3b expert slices and the int8 cache under sp (ranks share one card "
          f"over gloo): qwen3-30b-a3b q40 {PP_MOE_LAYERS} of 48 layers at full width (F/tp "
          f"{qh.ff_dim // 2} hidden units an expert at tp 2), a {PP_MOE_PROMPT}-token prompt; "
          f"llama-8b q40 {ACCEPT_LAYERS} layers with --kv-dtype int8, f32; {smi}")
    for label, (world, i) in idx.items():
        res = [r[i] for r in (world2 if world == 2 else world4)]
        moe = label.startswith("qwen3")
        bf16 = " f32 " not in label
        if moe:
            want, want_stream, whole = q_want[torch.bfloat16 if bf16 else torch.float32]
        else:
            want, want_stream, whole = want_kv8, want_kv8_stream, None
        x0 = res[0]
        pp = 2 if "pp2" in label else 1
        require(all(np.array_equal(x["step_logits"], x0["step_logits"]) for x in res[1:]),
                f"{label}: the ranks' logits differ")
        err = float(np.abs(x0["step_logits"] - want).max() / np.abs(want).max())
        stream = x0["generate"][0][0]
        first = _first_diff(stream, want_stream)
        if moe and "tp2" in label:
            for r, x in enumerate(res):
                require(x["expert_bytes"] * 2 * pp == whole,
                        f"{label} rank {r}: expert weights {x['expert_bytes']} B, wanted half "
                        f"of one rank's {whole} B" + (" over its stage" if pp > 1 else ""))
            print(f"parallel {label}: a rank's expert weights {x0['expert_bytes']} B of one "
                  f"rank's {whole} B (1/{2 * pp}), allocated "
                  f"{[round(x['allocated'] / 1e9, 2) for x in res]} GB")
        tol = TOL_TP_BF16 if bf16 else TOL_PAR_F32 if moe else TOL_TP_F32
        print(f"parallel {label}: first decode logits vs one rank err {err:.3e} (<= {tol}); "
              f"greedy stream equals one rank's: {stream == want_stream}"
              + ("" if first is None else f" (first of {len(stream)} tokens to differ: {first})")
              + (f"; stream {stream[-PP_MOE_DECODE:]}" if bf16 else ""))
        require(err <= tol, f"{label}: logits vs one rank {err:.3e} > {tol}")
        if not bf16:
            require(stream == want_stream, f"{label}: the greedy stream parts from one rank's "
                    f"at token {first}")
        names = (("moe_grouped_experts_q40", "moe_active_experts_q40") if moe else
                 ("flash_attention_stats_strided_kv8", "flash_decode_stats_kv8"))
        for r, x in enumerate(res):
            for name in names:
                require(x["launches"][name] > 0, f"{label} rank {r}: {name} was not launched")
        print(f"parallel {label}: launches " + json.dumps(
            [{name: x["launches"][name] for name in names} for x in res]))
        if "timed" in x0 and pp == 1:
            _print_ranks(label, res, qh if moe else h4, 2 if "tp2" in label else 1)
        counts[label] = x0["launches"]
    return counts


class Worker:
    """A daemon thread that runs the callables handed to `submit` one after
    another, each result in a future. The parallel and pipeline rounds'
    worlds and CLI runs go on two of these while the main thread runs the
    single-process paths: their ranks spend most of their time on the
    host (each collective crosses it over gloo), so the card has room for
    both. A daemon thread, so a failed phase ends the smoke at once; the
    worlds' ranks are daemonic children and the CLI runs are killed at
    exit."""

    def __init__(self, name: str):
        import queue
        import threading

        self._jobs: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, fn, *args):
        from concurrent.futures import Future

        fut: Future = Future()
        self._jobs.put((fut, fn, args))
        return fut

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fut, fn, args = job
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # the caller's `result()` re-raises it
                fut.set_exception(e)

    def close(self) -> None:
        self._jobs.put(None)
        self._thread.join(timeout=60)


def _spawn_world(world: int, jobs: list, timeout_s: float) -> tuple[list, float]:
    """One spawned world of ``world`` ranks on the card over gloo taking
    ``jobs`` in turn (parallel/launch.jobs_target), stopped after
    ``timeout_s`` or at `DEADLINE_S`; its results and seconds."""
    from dllama_tpu_torch.parallel.launch import jobs_target, spawn

    t0 = time.perf_counter()
    res = spawn(jobs_target, world, "cuda:0", "gloo", timeout_s=left_s(timeout_s), args=(jobs,))
    secs = time.perf_counter() - t0
    print(f"chip_smoke {time.perf_counter() - T_START:.1f} s: a {world}-rank world of "
          f"{len(jobs)} jobs ended in {secs:.1f} s", file=sys.stderr, flush=True)
    return res, secs


def _run_clis(cmds: dict, tmp: str) -> dict:
    """Run ``cmds`` (label -> (the arguments of ``python -m
    dllama_tpu_torch``, its stdin text or None, its timeout in seconds)) at
    once from the repository root, each with its ranks on the card; their
    output goes to files under tmp, so no pipe fills. Returns label ->
    (exit code, stdout, stderr, seconds). A run past its timeout or
    `DEADLINE_S` is killed (its ranks are daemons of it), and so is any
    still running at exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for label, (argv, stdin, timeout_s) in cmds.items():
        base = os.path.join(tmp, label.replace(" ", "_"))
        files = [open(base + ext, "w+b") for ext in (".in", ".out", ".err")]
        files[0].write((stdin or "").encode())
        files[0].flush()
        files[0].seek(0)
        proc = subprocess.Popen([sys.executable, "-m", "dllama_tpu_torch", *argv],
                                stdin=files[0], stdout=files[1], stderr=files[2], cwd=root)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        procs[label] = (proc, files, t0 + left_s(timeout_s))
    out: dict = {}
    while len(out) < len(procs):
        for label, (proc, files, deadline) in procs.items():
            if label in out or (proc.poll() is None and time.perf_counter() < deadline):
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            text = []
            for f in files[1:]:
                f.seek(0)
                text.append(f.read().decode("utf-8", errors="replace"))
            for f in files:
                f.close()
            out[label] = (proc.returncode, *text, time.perf_counter() - t0)
        time.sleep(0.05)
    return out


def parallel_round(tmp: str, smi: str, workers: tuple) -> Callable[[], dict]:
    """The parallel round (ranks share the one card over gloo: NCCL runs no
    two ranks on one device; the one-rank references first, then one world
    of 2 ranks for every 2-rank job and one of 4 for the 2 x 2 jobs): (b)
    llama-8b q40 bf16 at full width and depth, tp = 2 against tp = 1; (c)
    the `ACCEPT_LAYERS`-layer llama-8b file in f32, sp = 2 and tp 2 x sp 2 against one
    rank; (d) tp = 2 with the q80 sync buffer against f32; (e) the CLI at
    --tp 2; (f) each rank's decode token; (g) serving the seven-request mix
    at tp = 2 on the `PAR_LAYERS`-layer bf16 file over pool-native lanes, rank 0
    controlling and the other rank following (parallel/control.py): every
    request completes, each rank launches the same kernels as often, each
    pool holds half the heads; (h) the f32 `ACCEPT_LAYERS`-layer servers (native lanes at
    tp 2, slab lanes at sp 2 and 2 x 2, n-gram and draft speculation, an
    int8 pool and the serialized path at tp 2, a decode poison at tp 2, int8
    slab lanes at sp 2) and a two-turn chat at --tp 2, each byte-equal to tp
    = 1; (j) `_slice_report`: qwen3-30b-a3b's expert slices on its `PP_MOE_LAYERS`-layer
    file (the pipeline round reuses it) and the int8 cache under sp.

    The one-rank references run here, in this thread; then the 2-rank
    world goes to ``workers[0]``, and the CLI runs of (e), (h)'s chat and
    the pipeline round's (v) at once, then the 4-rank world, to
    ``workers[1]`` (`Worker`), and this returns. The returned function
    waits for them, checks and prints (b)-(j), and returns the launch
    counts of each run, by label. The files are written ahead
    (`start_prewrite`), or here when missing."""
    import numpy as np
    import torch

    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.obs.cost import param_bytes
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    dev = "cuda:0"
    counts = {}
    mp, tok = os.path.join(tmp, "par", "model.m"), os.path.join(tmp, "tok.t")
    if not os.path.exists(mp):
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        write_synth_model(mp, "llama-8b", seed=SEED, max_seq_len=4096, n_layers=PAR_LAYERS)

    # the one-rank references: (b) llama-8b q40 bf16, `PAR_LAYERS` layers; (c) the
    # `ACCEPT_LAYERS`-layer file in f32
    t0 = time.perf_counter()
    eng = InferenceEngine(mp, dtype=torch.bfloat16, temperature=0.0, weight_format="q40",
                          device="cuda")
    h = eng.header
    prompt_b = _tp_prompt(TP_PROMPT, h.vocab_size)
    eng.prefill(prompt_b)
    want_b = eng.step_logits(prompt_b[-1], len(prompt_b) - 1).numpy()
    eng.reset()
    want_b_stream = eng.generate(prompt_b, max_steps=TP_PROMPT - 1 + TP_DECODE,
                                 block_size=BLOCK)[0]
    whole_bytes = param_bytes(eng.params, h)["layers"]
    release_engine(eng)
    del eng
    ap = os.path.join(tmp, "accept", "model.m")
    if not os.path.exists(ap):
        os.makedirs(os.path.dirname(ap), exist_ok=True)
        write_synth_model(ap, "llama-8b", seed=SEED, max_seq_len=4096, n_layers=ACCEPT_LAYERS)
    prompt = _tp_prompt(SP_PROMPT, h.vocab_size)
    calls = [(prompt, SP_PROMPT - 1 + SP_DECODE, BLOCK, 0)]
    eng = InferenceEngine(ap, dtype=torch.float32, temperature=0.0, weight_format="q40",
                          device="cuda")
    h4 = eng.header
    eng.prefill(prompt)
    want_logits = eng.step_logits(prompt[-1], len(prompt) - 1).numpy()
    eng.reset()
    want_stream = eng.generate(prompt, max_steps=calls[0][1], block_size=BLOCK)[0]
    release_engine(eng)
    del eng
    # (j)'s one-rank references: the `ACCEPT_LAYERS`-layer file with an int8 cache in f32,
    # and qwen3-30b-a3b's `PP_MOE_LAYERS`-layer file in bf16 and f32 (its expert bytes)
    eng = InferenceEngine(ap, dtype=torch.float32, temperature=0.0, weight_format="q40",
                          device="cuda", kv_dtype="int8")
    eng.prefill(prompt)
    want_kv8 = eng.step_logits(prompt[-1], len(prompt) - 1).numpy()
    eng.reset()
    want_kv8_stream = eng.generate(prompt, max_steps=calls[0][1], block_size=BLOCK)[0]
    release_engine(eng)
    del eng
    qp = os.path.join(tmp, "qwen-pp", "model.m")
    if not os.path.exists(qp):
        os.makedirs(os.path.dirname(qp), exist_ok=True)
        write_synth_model(qp, "qwen3-30b-a3b", seed=SEED, max_seq_len=4096,
                          n_layers=PP_MOE_LAYERS)
    q_want = {}
    for dtype in (torch.bfloat16, torch.float32):
        eng = InferenceEngine(qp, dtype=dtype, temperature=0.0, weight_format="q40",
                              device="cuda")
        qh = eng.header
        q_prompt = _tp_prompt(PP_MOE_PROMPT, qh.vocab_size)
        q_call = (q_prompt, PP_MOE_PROMPT - 1 + PP_MOE_DECODE, BLOCK, 0)
        eng.prefill(q_prompt)
        logits = eng.step_logits(q_prompt[-1], len(q_prompt) - 1).numpy()
        eng.reset()
        q_want[dtype] = (logits, eng.generate(q_prompt, max_steps=q_call[1], block_size=BLOCK)[0],
                         param_bytes(eng.params, qh)["experts"])
        release_engine(eng)
        del eng
    # (h)'s truth: the one-rank f32 servers over the `ACCEPT_LAYERS`-layer file (pool-
    # native lanes, an int8 pool and int8 slab lanes, the serialized path)
    # and the chat
    from dllama_tpu_torch.tokenizer import Tokenizer

    tokz = Tokenizer(tok)
    pay_b = _par_payloads(tokz, SERVE_MAX_TOKENS)
    pay_c = _par_payloads(tokz, PAR_SERVE_TOKENS)
    truth = {"f32": _tp1_answers(ap, tok, pay_c, kv_native=True),
             "int8": _tp1_answers(ap, tok, pay_c, kv_dtype="int8", kv_native=True),
             "int8-slab": _tp1_answers(ap, tok, pay_c, kv_dtype="int8", kv_native=False),
             "single": _tp1_answers(ap, tok, pay_c, batch_size=1)}
    chat_tp1 = _chat_tp1(ap, tok)
    ref_s = time.perf_counter() - t0
    PAR_REFS.update(mp=mp, ap=ap, tok=tok, h=h, h4=h4, prompt_b=prompt_b, want_b=want_b,
                    want_b_stream=want_b_stream, whole_bytes=whole_bytes, prompt=prompt,
                    calls=calls, want_logits=want_logits, want_stream=want_stream, truth=truth,
                    pay_c=pay_c, qp=qp, q_call=q_call, want_q=q_want[torch.float32][1])

    # one world of two ranks for every 2-rank job, then one of four
    job_b = dict(model=mp, tp=2, sp=1, dtype="bf16", weight_format="q40", step_logits=prompt_b,
                 generate=[(prompt_b, TP_PROMPT - 1 + TP_DECODE, BLOCK, 0)],
                 timed_steps=TIMED_STEPS)
    base = dict(model=ap, dtype="f32", weight_format="q40", step_logits=prompt, generate=calls,
                timed_steps=TIMED_STEPS)
    rng = np.random.default_rng(SEED)
    x = (rng.standard_normal((2, 1, h.dim)) * rng.uniform(0.1, 10, (2, 1, 1))).astype(np.float32)
    # (g) and (h): the servers, label -> (job, the truth of its answers)
    serve2 = [
        ("llama-8b q40 tp2 serving", None, _par_job(mp, tok, 2, 1, "bf16", pay_b, kv_native=True)),
        ("llama-8b q40 f32 tp2 serving", "f32", _par_job(ap, tok, 2, 1, "f32", pay_c,
                                                         kv_native=True)),
        ("llama-8b q40 f32 sp2 serving slab", "f32", _par_job(ap, tok, 1, 2, "f32", pay_c,
                                                              kv_native=False)),
        ("llama-8b q40 f32 tp2 serving ngram", "f32", _par_job(
            ap, tok, 2, 1, "f32", pay_c, kv_native=True, speculation="ngram", spec_k=SPEC_K)),
        ("llama-8b q40 f32 tp2 serving draft", "f32", _par_job(
            ap, tok, 2, 1, "f32", pay_c, kv_native=True, speculation="draft", spec_k=SPEC_K,
            draft_model=ap)),
        ("llama-8b q40 f32 tp2 serving kv-int8", "int8", _par_job(
            ap, tok, 2, 1, "f32", pay_c, kv_dtype="int8", kv_native=True)),
        ("llama-8b q40 f32 tp2 serving single", "single", _par_job(ap, tok, 2, 1, "f32", pay_c,
                                                                   batch_size=1)),
        ("llama-8b q40 f32 tp2 serving poison", "f32", _par_job(
            ap, tok, 2, 1, "f32", pay_c, kv_native=True, faults=PAR_POISON)),
        ("llama-8b q40 f32 sp2 serving slab kv-int8", "int8-slab", _par_job(
            ap, tok, 1, 2, "f32", pay_c, kv_dtype="int8", kv_native=False)),
    ]
    serve4 = [("llama-8b q40 f32 tp2sp2 serving slab", "f32",
               _par_job(ap, tok, 2, 2, "f32", pay_c, kv_native=False))]
    # (j): qwen3-30b-a3b's expert slices and llama-8b's int8 cache under sp
    q_base = dict(model=qp, dtype="f32", weight_format="q40", step_logits=q_prompt,
                  generate=[q_call], timed_steps=TIMED_STEPS)
    kv8 = dict(base, kv_dtype="int8")
    slice2 = {"qwen3-30b-a3b q40 tp2": dict(q_base, tp=2, dtype="bf16"),
              "qwen3-30b-a3b q40 f32 tp2": dict(q_base, tp=2),
              "qwen3-30b-a3b q40 f32 sp2": dict(q_base, sp=2),
              "llama-8b q40 f32 sp2 kv-int8": dict(kv8, sp=2)}
    slice4 = {"qwen3-30b-a3b q40 f32 tp2pp2": dict(q_base, tp=2, pp=2),
              "llama-8b q40 f32 tp2sp2 kv-int8": dict(kv8, tp=2, sp=2)}
    jobs2 = [
        ("engine", job_b),
        ("engine", dict(base, tp=1, sp=2)),
        ("engine", dict(base, tp=2, sp=1)),
        ("engine", dict(base, tp=2, sp=1, buffer_float_type="q80")),
        ("collective", ("all_reduce", 2, True, x)),
        ("collective", ("all_reduce", 2, False, x)),
    ]
    slice_idx = {label: (2, len(jobs2) + i) for i, label in enumerate(slice2)}
    jobs2 += [("engine", job) for job in slice2.values()]
    serve_idx2 = {label: (len(jobs2) + i, key) for i, (label, key, _) in enumerate(serve2)}
    jobs4 = [("engine", dict(base, tp=2, sp=2))]
    slice_idx.update({label: (4, len(jobs4) + i) for i, label in enumerate(slice4)})
    jobs4 += [("engine", job) for job in slice4.values()]
    serve_idx4 = {label: (len(jobs4) + i, key) for i, (label, key, _) in enumerate(serve4)}
    # (e) and the pipeline round's (v): the CLI at --tp 2 and --pp 2; (h)'s chat at --tp 2
    cli = ["inference", "--model", ap, "--tokenizer", tok, "--prompt", prompt_text(40),
           "--steps", "56", "--temperature", "0", "--dtype", "f32", "--weight-format", "q40",
           "--device", dev]
    f2 = workers[0].submit(_spawn_world, 2, jobs2 + [job for _, _, job in serve2], 900)
    PAR_REFS["clis"] = workers[1].submit(_run_clis, {
        "chat tp2": (_chat_argv(ap, tok) + ["--tp", "2", "--device", dev], PAR_CHAT_TURNS, 600),
        "cli tp2": (cli + ["--tp", "2"], None, 300),
        "cli pp2": (cli + ["--pp", "2"], None, 300)}, os.path.join(tmp, "cli"))
    f4 = workers[1].submit(_spawn_world, 4, jobs4 + [j for _, _, j in serve4], 600)

    def finish() -> dict:
        world2, world2_s = f2.result()
        world4, world4_s = f4.result()
        # (b) llama-8b q40 bf16, `PAR_LAYERS` layers, tp = 2 against tp = 1
        res = [r[0] for r in world2]
        label = "llama-8b q40 tp2"
        print(f"== {label} (ranks share one card over gloo): {h.n_layers} layers, bf16, one "
              f"512-row chunk and {TP_DECODE} greedy tokens; the one-rank references (this, the "
              f"f32 file's and its servers' and chat's) {ref_s:.1f} s, the 2-rank world (its "
              f"jobs: this, sp2, tp2, tp2 q80, two all-reduces, the servers of (g) and (h)) "
              f"{world2_s:.1f} s, the 4-rank world (tp2sp2, its server) {world4_s:.1f} s, both "
              f"on background threads beside the other paths (their times are values only)")
        for r, x in enumerate(res):
            require(x["layer_bytes"] * 2 == whole_bytes,
                    f"{label} rank {r}: layer weights {x['layer_bytes']} B, half of "
                    f"{whole_bytes} B wanted")
            print(f"parallel {label} rank {r}: layer weights {x['layer_bytes']} B of "
                  f"{whole_bytes} B (one half), allocated {x['allocated'] / 1e9:.2f} GB")
        got = res[0]["step_logits"]
        err = float(np.abs(got - want_b).max() / np.abs(want_b).max())
        require(all(np.array_equal(x["step_logits"], got) for x in res[1:]),
                f"{label}: the ranks' logits differ")
        require(err <= TOL_TP_BF16,
                f"{label}: first decode logits vs tp = 1 {err:.3e} > {TOL_TP_BF16}")
        stream = res[0]["generate"][0][0]
        first = _first_diff(stream, want_b_stream)
        print(f"parallel {label}: first decode logits vs tp = 1 err {err:.3e} (<= {TOL_TP_BF16}); "
              f"greedy stream equals tp = 1's: {stream == want_b_stream}"
              + ("" if first is None else f" (first of {len(stream)} tokens to differ: {first})"))
        _print_ranks(label, res, h, 2)
        counts[label] = res[0]["launches"]

        # (c) the `ACCEPT_LAYERS`-layer f32 file at sp 2, tp 2 and tp 2 x sp 2 against one rank
        print(f"== llama-8b q40 f32 parallel (ranks share one card over gloo): {ACCEPT_LAYERS} "
              f"layers, {SP_PROMPT}-token prompt (chunks of 512 and 32 rows), {SP_DECODE} greedy "
              f"tokens")
        for label, results, tp in (("llama-8b q40 f32 sp2", [r[1] for r in world2], 1),
                                   ("llama-8b q40 f32 tp2", [r[2] for r in world2], 2),
                                   ("llama-8b q40 f32 tp2sp2", [r[0] for r in world4], 2)):
            got = results[0]
            require(all(np.array_equal(x["step_logits"], got["step_logits"]) for x in results[1:]),
                    f"{label}: the ranks' logits differ")
            err = float(np.abs(got["step_logits"] - want_logits).max() / np.abs(want_logits).max())
            stream = got["generate"][0][0]
            first = _first_diff(stream, want_stream)
            print(f"parallel {label}: first decode logits vs one rank err {err:.3e} "
                  f"(<= {TOL_TP_F32}); greedy stream equals one rank's: {stream == want_stream}"
                  + ("" if first is None else f" (first of {len(stream)} to differ: {first})"))
            require(err <= TOL_TP_F32, f"{label}: logits vs one rank {err:.3e} > {TOL_TP_F32}")
            require(stream == want_stream, f"{label}: the greedy stream parts from one rank's at "
                    f"token {first}")
            if "sp" in label:
                for r, x in enumerate(results):
                    for name in ("flash_attention_stats_strided", "flash_decode_stats"):
                        require(x["launches"][name] > 0,
                                f"{label} rank {r}: {name} was not launched")
            _print_ranks(label, results, h4, tp)
            counts[label] = got["launches"]
        # (d) the q80 sync buffer against the exact f32 all-reduce
        exact, q80 = world2[0][2]["step_logits"], world2[0][3]["step_logits"]
        lerr = float(np.abs(q80 - exact).max() / np.abs(exact).max())
        ar_q80, ar_exact = world2[0][4], world2[0][5]
        ar_err = float(np.abs(ar_q80 - ar_exact).max() / np.abs(ar_exact).max())
        print(f"parallel llama-8b q40 f32 tp2 q80: largest relative logit error vs f32 buffers "
              f"{lerr:.3e}; one [{h.dim}] all-reduce's error {ar_err:.3e} (<= {Q80_BOUND})")
        require(0 < ar_err < Q80_BOUND,
                f"q80 all-reduce error {ar_err:.3e} outside (0, {Q80_BOUND})")
        _print_ranks("llama-8b q40 f32 tp2 q80", [r[3] for r in world2], h4, 2, sync_quant=True)

        # (j) qwen3-30b-a3b's expert slices; the int8 cache under sp
        counts.update(_slice_report(world2, world4, slice_idx, q_want, qh, h4, want_kv8,
                                    want_kv8_stream, smi))

        # (g) serving llama-8b q40 bf16 at tp = 2; (h) the f32 servers and chat
        counts.update(_par_serving_report(world2, world4, serve_idx2, serve_idx4, truth, tokz, h,
                                          h4, smi))
        clis = PAR_REFS["clis"].result()
        rc, out, err_out, secs = clis["chat tp2"]
        chat = out[out.index("💬 Chat mode"):] if "💬 Chat mode" in out else ""
        print(f"parallel serve llama-8b q40 f32 tp2 chat: exit {rc}, two turns, "
              f"transcript equals tp = 1's {chat == chat_tp1} ({len(chat)} characters), "
              f"{secs:.1f} s (the three CLI runs at once)")
        require(rc == 0, f"chat at --tp 2 failed:\n{err_out[-4000:]}")
        require(chat == chat_tp1 and chat.count("👱 You: ") == 2,
                "chat at --tp 2: its transcript differs from the one-rank chat's")

        # (e) the CLI at --tp 2, its ranks on the one card
        rc, out, err_out, secs = clis["cli tp2"]
        pred = [l for l in out.splitlines() if l.startswith("🔶 Pred")]
        print(f"parallel cli --tp 2: exit {rc}, {len(pred)} Pred lines, {secs:.1f} s; "
              + " | ".join(l for l in out.splitlines()
                           if l.startswith(("🔗", "💡 Tp", "🔷️ Eval"))))
        if pred:
            print(f"parallel cli --tp 2: {pred[0]}")
        require(rc == 0, f"the CLI at --tp 2 failed:\n{err_out[-4000:]}")
        require("backend gloo" in out and len(pred) == 56 - 41 + 1 and "Prediction" in out,
                "the CLI at --tp 2: want its backend line naming gloo and rank 0's Pred lines")
        return counts

    return finish


# (iv) qwen3-30b-a3b at full width, 2 of its 48 layers (the smoke's
# time), under pp = 2: each stage holds 1 MoE layer whole
# (tp = sp = 1); the parallel round's (j) rows run on the same file
PP_MOE_LAYERS = 2
# the prompt's 129 fill rows take the 512-row bucket, 8 waves of 64 rows at pp
# 2: past the active-experts kernel's 16 rows, so the grouped kernel runs
PP_MOE_PROMPT = 130
PP_MOE_DECODE = 16  # decode steps: the active-experts kernel
# (ii) generate_batch at pp 2 x dp 2: two prompts of different lengths, one a lane
PP_BATCH = (100, 37)
PP_BATCH_DECODE = 24
PP_PPL_TOKENS = 300  # (ii) perplexity's tokens: a 256-row chunk in 8 waves, then a 32-row one
TOL_PPL_F32 = 1e-4  # (ii) f32 nll at pp 2 against one rank: the waves' narrower chunks sum otherwise


def _same_pipeline_ranks(label: str, results: list) -> dict:
    """Gate: every rank ran rank 0's commands and returned its tokens (the
    control digest), ended at the same cache epoch, and the stages of one
    dp group launched the same kernels as often (their layers split evenly
    and each computes the logits head; a lane's chunk runs on its own dp
    group alone). Returns rank 0's result."""
    first = results[0]
    for r, x in enumerate(results[1:], 1):
        require(x["summary"] == first["summary"],
                f"{label}: rank {r}'s control summary {x['summary']} differs from rank 0's "
                f"{first['summary']}")
        require(x["cache_epoch"] == first["cache_epoch"],
                f"{label}: rank {r}'s cache_epoch {x['cache_epoch']} differs from rank 0's")
    by_group: dict = {}
    for x in results:
        by_group.setdefault(x["dp_group"], []).append(x["launches"])
    for g, launches in by_group.items():
        require(all(x == launches[0] for x in launches),
                f"{label}: the stages of dp group {g} launched different kernels")
    return first


def pipeline_round(tmp: str, smi: str, workers: tuple) -> Callable[[], dict]:
    """The pipeline round (ranks share the one card over gloo, after the
    parallel round, reusing its one-rank references, `PAR_REFS`): (i)
    llama-8b q40 bf16 at full width and `PAR_LAYERS` layers, pp = 2 against one
    rank: each rank holds half the layer bytes, the first decode step's
    logits within `TOL_TP_BF16`, where the greedy streams part printed;
    (ii) the `ACCEPT_LAYERS`-layer f32 file at pp 2, pp 2 x dp 2, pp 2 x tp 2 and pp 2 x
    sp 2 (tokens equal one rank's, logits within `TOL_TP_F32`),
    ``generate_batch`` of two prompts at pp 2 x dp 2 and perplexity at pp 2
    (within `TOL_PPL_F32`); (iii) servers on the `ACCEPT_LAYERS`-layer f32 file, every
    answer byte-equal to the tp = 1 server's: the seven-request mix at pp 2
    over slab lanes, at dp 2 over pool-native lanes (a shared prefix one dp
    group wrote read by a lane of the other: ``kv_cross_dp_pages`` > 0) and
    at pp 2 x dp 2 over slab lanes; (iv) qwen3-30b-a3b q40 at full width, 4
    of 48 layers, pp = 2 in f32: its stream equals one rank's and both MoE
    kernels run on both ranks; (v) ``python -m dllama_tpu_torch inference
    --pp 2 --device cuda:0``; (vi) each rank's decode token of (i): device
    ms, its hand-offs' host ms and bytes against ``ici_traffic_per_token``
    at pp = 2, its launches. The one-rank references run here; the two
    worlds go to ``workers[1]`` after the parallel round's (`Worker`), and
    (v) ran with the parallel round's CLI runs. The returned function waits
    for them, checks and prints (i)-(vi) and returns the launch counts by
    label."""
    import numpy as np
    import torch

    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.utils.telemetry import ici_traffic_per_token

    R = PAR_REFS
    counts = {}
    mp, ap, tok, h, h4 = R["mp"], R["ap"], R["tok"], R["h"], R["h4"]

    # one-rank references past the parallel round's: two lanes' streams and
    # perplexity on the `ACCEPT_LAYERS`-layer file
    t0 = time.perf_counter()
    prompts = [_tp_prompt(n, h4.vocab_size) for n in PP_BATCH]
    steps = max(PP_BATCH) - 1 + PP_BATCH_DECODE
    eng = InferenceEngine(ap, dtype=torch.float32, temperature=0.0, weight_format="q40",
                          device="cuda", batch_size=2)
    want_batch = eng.generate_batch(prompts, steps)
    ppl_tokens = R["prompt"][:PP_PPL_TOKENS]
    want_ppl = eng.perplexity(ppl_tokens)
    release_engine(eng)
    del eng
    # the `PP_MOE_LAYERS`-layer qwen3 file and its one-rank stream, from the parallel round
    qp, q_call, want_q = R["qp"], R["q_call"], R["want_q"]
    ref_s = time.perf_counter() - t0

    base = dict(model=ap, dtype="f32", weight_format="q40", step_logits=R["prompt"],
                generate=R["calls"])
    pay_c, truth = R["pay_c"], R["truth"]
    serve2 = [("llama-8b q40 f32 pp2 serving slab",
               _par_job(ap, tok, 1, 1, "f32", pay_c, pp=2, kv_native=False)),
              ("llama-8b q40 f32 dp2 serving native",
               _par_job(ap, tok, 1, 1, "f32", pay_c, dp=2, kv_native=True))]
    serve4 = [("llama-8b q40 f32 pp2dp2 serving slab",
               _par_job(ap, tok, 1, 1, "f32", pay_c, pp=2, dp=2, kv_native=False))]
    jobs2 = [
        ("engine", dict(model=mp, pp=2, dtype="bf16", weight_format="q40",
                        step_logits=R["prompt_b"],
                        generate=[(R["prompt_b"], TP_PROMPT - 1 + TP_DECODE, BLOCK, 0)],
                        timed_steps=TIMED_STEPS)),
        ("engine", dict(base, pp=2, perplexity=ppl_tokens)),
        ("engine", dict(model=qp, pp=2, dtype="f32", weight_format="q40", generate=[q_call])),
    ] + [job for _, job in serve2]
    jobs4 = [
        ("engine", dict(base, pp=2, dp=2, batch_size=2)),
        ("engine", dict(base, pp=2, tp=2)),
        ("engine", dict(base, pp=2, sp=2)),
        ("engine", dict(model=ap, pp=2, dp=2, batch_size=2, dtype="f32", weight_format="q40",
                        generate_batch=(prompts, steps))),
    ] + [job for _, job in serve4]
    f2 = workers[1].submit(_spawn_world, 2, jobs2, 900)
    f4 = workers[1].submit(_spawn_world, 4, jobs4, 600)

    def finish() -> dict:
        world2, world2_s = f2.result()
        world4, world4_s = f4.result()
        # (i) llama-8b q40 bf16, `PAR_LAYERS` layers, pp = 2 against one rank
        res = [r[0] for r in world2]
        label = "llama-8b q40 pp2"
        print(f"== {label} (ranks share one card over gloo): {h.n_layers} layers, bf16, one "
              f"512-row chunk (in waves) and {TP_DECODE} greedy tokens; the one-rank references "
              f"past the parallel round's {ref_s:.1f} s, the 2-rank world (this, the f32 pp2 run, "
              f"the qwen3 pp2 run, two servers) {world2_s:.1f} s, the 4-rank world (pp2dp2, "
              f"pp2tp2, pp2sp2, generate_batch, a server) {world4_s:.1f} s, both on a background "
              f"thread beside the other paths (their times are values only); {smi}")
        whole = R["whole_bytes"]
        for r, x in enumerate(res):
            require(x["stage"] == r and x["layer_bytes"] * 2 == whole,
                    f"{label} rank {r}: stage {x['stage']}, layer weights {x['layer_bytes']} B, "
                    f"half of {whole} B wanted")
            print(f"pipeline {label} rank {r} (stage {x['stage']}): layer weights "
                  f"{x['layer_bytes']} B of {whole} B ({h.n_layers // 2} of {h.n_layers} layers), "
                  f"allocated "
                  f"{x['allocated'] / 1e9:.2f} GB")
        got, want_b = res[0]["step_logits"], R["want_b"]
        require(all(np.array_equal(x["step_logits"], got) for x in res[1:]),
                f"{label}: the stages' logits differ")
        err = float(np.abs(got - want_b).max() / np.abs(want_b).max())
        require(err <= TOL_TP_BF16, f"{label}: first decode logits vs one rank {err:.3e} > "
                f"{TOL_TP_BF16}")
        stream, want_stream = res[0]["generate"][0][0], R["want_b_stream"]
        first = _first_diff(stream, want_stream)
        print(f"pipeline {label}: first decode logits vs one rank err {err:.3e} (<= {TOL_TP_BF16})"
              f"{'; bits equal' if np.array_equal(got, want_b) else ''}; greedy stream equals one "
              f"rank's: {stream == want_stream}"
              + ("" if first is None else f" (first of {len(stream)} tokens to differ: {first})"))
        # (vi) each rank's decode token
        model = ici_traffic_per_token(h, 1, pp=2, pp_activation_bytes=2.0)
        for r, x in enumerate(res):
            t = x["timed"]
            launches = {k: v for k, v in x["launches"].items() if v}
            print(f"pipeline rank {label} rank {r} (ranks share one card over gloo): decode token "
                  f"device_ms {t['device_ms']:.3f} hand-off_ms {t['collective_ms']:.3f} "
                  f"({t['calls']} collectives) hand-off_bytes {int(t['collective_bytes'])} vs "
                  f"ici_traffic_per_token(pp=2) {model}; launches {json.dumps(launches)}; {smi}")
        counts[label] = res[0]["launches"]

        # (ii) the `ACCEPT_LAYERS`-layer f32 file at pp 2 and its compositions against one rank
        print(f"== llama-8b q40 f32 pipeline (ranks share one card over gloo): {ACCEPT_LAYERS} "
              f"layers, {SP_PROMPT}-token prompt, {SP_DECODE} greedy tokens")
        for label, results in (("llama-8b q40 f32 pp2", [r[1] for r in world2]),
                               ("llama-8b q40 f32 pp2dp2", [r[0] for r in world4]),
                               ("llama-8b q40 f32 pp2tp2", [r[1] for r in world4]),
                               ("llama-8b q40 f32 pp2sp2", [r[2] for r in world4])):
            x0 = results[0]
            require(all(np.array_equal(x["step_logits"], x0["step_logits"]) for x in results[1:]),
                    f"{label}: the ranks' logits differ")
            err = float(np.abs(x0["step_logits"] - R["want_logits"]).max()
                        / np.abs(R["want_logits"]).max())
            stream = x0["generate"][0][0]
            first = _first_diff(stream, R["want_stream"])
            print(f"pipeline {label}: first decode logits vs one rank err {err:.3e} "
                  f"(<= {TOL_TP_F32}); greedy stream equals one rank's: "
                  f"{stream == R['want_stream']}"
                  + ("" if first is None else f" (first of {len(stream)} to differ: {first})"))
            require(err <= TOL_TP_F32, f"{label}: logits vs one rank {err:.3e} > {TOL_TP_F32}")
            require(stream == R["want_stream"],
                    f"{label}: the greedy stream parts from one rank's at token {first}")
            counts[label] = x0["launches"]
        label = "llama-8b q40 f32 pp2dp2 generate_batch"
        got_batch = world4[0][3]["generate_batch"]
        require(all(r[3]["generate_batch"] == got_batch for r in world4),
                f"{label}: the ranks' lanes differ")
        print(f"pipeline {label}: prompts of {PP_BATCH} tokens, {PP_BATCH_DECODE}+ greedy tokens "
              f"a lane, each lane equals one rank's: {got_batch == want_batch}")
        require(got_batch == want_batch, f"{label}: the lanes' streams differ from one rank's")
        counts[label] = world4[0][3]["launches"]
        nll, ppl, n = world2[0][1]["perplexity"]
        perr = abs(nll - want_ppl[0]) / abs(want_ppl[0])
        print(f"pipeline llama-8b q40 f32 pp2 perplexity: {n} scored, nll {nll:.6f} vs one rank "
              f"{want_ppl[0]:.6f} (relative {perr:.2e} <= {TOL_PPL_F32}), perplexity {ppl:.4f}")
        require(n == want_ppl[2] and perr <= TOL_PPL_F32,
                f"pipeline perplexity: nll {nll} vs {want_ppl[0]} (relative {perr:.2e})")

        # (iii) the servers, every answer equal to the tp = 1 server's
        print(f"== llama-8b q40 f32 pipeline serving (ranks share one card over gloo): "
              f"{ACCEPT_LAYERS} layers, f32, the mix at {PAR_SERVE_TOKENS} tokens a request")
        for world, serve, off in ((world2, serve2, 3), (world4, serve4, 4)):
            for i, (label, _) in enumerate(serve):
                res = [r[off + i] for r in world]
                x0 = _same_pipeline_ranks(label, res)
                answers = x0["answers"][0]
                bad = [j for j, (a, b) in enumerate(zip(answers, truth["f32"])) if a != b]
                cross = x0["kv_cross_dp_pages"]
                print(f"pipeline serve {label}: answers equal tp = 1 {len(answers) - len(bad)} of "
                      f"{len(answers)}; {len(res)} ranks (stage, dp group) "
                      f"{[(x['stage'], x['dp_group']) for x in res]}, control "
                      f"{x0['summary']['commands']} commands, digest equal; pages read across dp "
                      f"groups {cross}; wall {x0['wall_s'][0]:.2f} s")
                require(not bad, f"{label}: answers {bad} differ from the tp = 1 server's")
                if "native" in label:
                    require(cross > 0,
                            f"{label}: no lane read a prefix page another dp group wrote")
                counts[label] = x0["launches"]

        # (iv) qwen3-30b-a3b, `PP_MOE_LAYERS` of 48 layers, pp = 2
        label = "qwen3-30b-a3b q40 f32 pp2"
        res = [r[2] for r in world2]
        stream = res[0]["generate"][0][0]
        first = _first_diff(stream, want_q)
        print(f"pipeline {label}: {PP_MOE_LAYERS} of 48 layers at full width "
              f"({PP_MOE_LAYERS // 2} a stage, experts whole), {PP_MOE_PROMPT}-token prompt, "
              f"greedy stream equals one rank's: {stream == want_q}" + ("" if first is None else f" (first to differ: {first})")
              + "; launches " + json.dumps([{k: x["launches"][k] for k in
                                             ("moe_grouped_experts_q40", "moe_active_experts_q40")}
                                            for x in res]))
        require(all(x["generate"][0][0] == stream for x in res),
                f"{label}: the ranks' streams differ")
        require(stream == want_q, f"{label}: the greedy stream parts from one rank's at {first}")
        for r, x in enumerate(res):
            for name in ("moe_grouped_experts_q40", "moe_active_experts_q40"):
                require(x["launches"][name] > 0, f"{label} rank {r}: {name} was not launched")
        counts[label] = res[0]["launches"]

        # (v) the CLI at --pp 2, its ranks on the one card, run with the
        # parallel round's CLI runs
        rc, out, err_out, secs = PAR_REFS["clis"].result()["cli pp2"]
        pred = [l for l in out.splitlines() if l.startswith("🔶 Pred")]
        print(f"pipeline cli --pp 2: exit {rc}, {len(pred)} Pred lines, {secs:.1f} s; "
              + " | ".join(l for l in out.splitlines()
                           if l.startswith(("🔗", "💡 Pp", "🔷️ Eval"))))
        if pred:
            print(f"pipeline cli --pp 2: {pred[0]}")
        require(rc == 0, f"the CLI at --pp 2 failed:\n{err_out[-4000:]}")
        require("💡 Pp: 2 pipeline stages" in out and len(pred) == 56 - 41 + 1,
                "the CLI at --pp 2: want its Pp line and rank 0's Pred lines")
        return counts

    return finish


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from dllama_tpu_torch.ops import _build

    # every capture of every engine below is linted as it lands, and any
    # new finding fails the phase that captured it (`graph_lint`)
    os.environ["DLLAMA_XLALINT"] = "strict"
    t_start = time.perf_counter()
    # the whole llama-8b file and the serving, parallel and draft rounds'
    # files beside it, kept to the end: a child writes them while the
    # kernels build and run
    llama_tmp = tempfile.TemporaryDirectory()
    llama_writer = start_prewrite([
        (llama_tmp.name, "llama-8b", N_LAYERS),
        (os.path.join(llama_tmp.name, "accept"), "llama-8b", ACCEPT_LAYERS),
        (os.path.join(llama_tmp.name, "fleet_sub"), "llama-8b", FLEET_SUB_LAYERS),
        (os.path.join(llama_tmp.name, "par"), "llama-8b", PAR_LAYERS),
        (os.path.join(llama_tmp.name, "draft"), DRAFT_PRESET, DRAFT_LAYERS, DRAFT_SEED),
        (os.path.join(llama_tmp.name, "qwen-pp"), "qwen3-30b-a3b", PP_MOE_LAYERS)])
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    mark(f"kernel build: {build_s:.1f} s")
    for name, log in _build.ptxas_log.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", log))
        smem = [int(w) for w in re.findall(r"(\d+) bytes smem", log)]
        print(f"  ptxas {name}: {len(regs)} kernels, registers <= {max(regs, default=0)}, "
              f"static smem <= {max(smem, default=0)} B, spill stores {spills} B")
        # the attention sources, every entry the int8 strided ones too: no spill
        require(not name.startswith("flash") or spills == 0,
                f"ptxas {name}: {spills} B of spill stores, wanted 0")
        if name.startswith(("q40", "flash", "i8", "moe")):
            for line in ptxas_kernels(log):
                print(f"    {line}")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    rows = (check_q40(device, gen) + check_q40i4(device, gen) + check_i8(device, gen)
            + check_attention(device, gen) + check_attention(device, gen, h=32, kh=4)
            + check_attention(device, gen, hd=64) + check_attention_edges(device, gen)
            + check_paged_decode(device, gen) + check_verify_stats(device, gen)
            + check_slab_lanes(device, gen) + check_kv8(device, gen) + check_moe(device, gen)
            + check_mixed(device, gen) + check_moe_tiers(device, gen)
            + check_attention_strided(device, gen) + check_decode_stats(device, gen)
            + check_q40_tp(device, gen) + check_lane_shards(device, gen)
            + check_moe_tp(device, gen) + check_pp_waves(device, gen))
    mark(f"kernel rows (phase 2): {time.perf_counter() - t0:.1f} s")
    for r in rows:
        times = "".join(
            f" {key} {'none' if r[key] is None else format(r[key], '.4f')}"
            for key in ("ms", "ms_clean", "plain_ms", "library_ms") if key in r
        )
        note = " (no single PyTorch call computes a routed SwiGLU MoE)" if "experts" in r else ""
        note += "".join(f"; {what} unrounded err {e:.2e}" for what, e in r.get("unrounded", {}).items())
        if "twin_err" in r:
            note += (f"; vs q40_matmul on the unpacked twin err {r['twin_err']:.2e}, "
                     f"bits equal {r['twin_equal']}")
        if "plain_equal" in r:
            note += f"; bits equal to plain {r['plain_equal']}"
        if "int_mm_ms" in r:
            note += f"; torch._int_mm {r['int_mm_ms']:.4f}"
        if "composite_ms" in r and r["name"].endswith("_mixed"):
            note += (f" (no single PyTorch call attends over a cache of another type); cast + "
                     f"SDPA, two calls, {r['composite_ms']:.4f}")
        elif r["name"] in ("flash_attention_stats_strided", "flash_decode_stats",
                           "flash_attention_stats_strided_kv8", "flash_decode_stats_kv8"):
            note += (" (no single PyTorch call attends over a strided shard"
                     + (")" if "strided" in r["name"] else " or returns the unnormalized state)"))
            if "composite_ms" in r:
                note += (f"; dequantize + SDPA under the strided mask, two calls, "
                         f"{r['composite_ms']:.4f}")
        elif "composite_ms" in r:
            note += (f" (no single PyTorch call attends over int8 K/V); dequantize + SDPA, two "
                     f"calls, {r['composite_ms']:.4f}")
        if "vs_active" in r:
            note += (f"; two-tier decode, grouped tier: vs the active kernel alone err "
                     f"{r['vs_active']:.2e}"
                     + (f", active kernel alone ms {r['active_ms']:.4f}" if "active_ms" in r
                        else ""))
        if "graphed_ms" in r:
            note += (f"; on a schedule built ahead: the capped grouped kernel alone ms "
                     f"{r['grouped_kernel_ms']:.4f}, the active tier alone ms "
                     f"{r['active_tier_ms']:.4f}; the wrapper replayed from a graph ms "
                     f"{r['graphed_ms']:.4f}")
        if "identity_bits_equal" in r:
            note += f"; identity table bits equal to the slab kernel {r['identity_bits_equal']}"
        if "passes" in r:
            note += (f"; {r['body']}, passes a key tile QK^T {r['passes'][0]} + PV "
                     f"{r['passes'][1]}")
        if "bound_f32_ms" in r:
            note += f"; bound at the f32 CUDA-core peak {r['bound_f32_ms']:.4f}"
        if "sdpa_f32_ms" in r:
            note += f"; SDPA in f32 on the cache dequantized ahead {r['sdpa_f32_ms']:.4f}"
        print(
            f"{r['name']:23s} {r['shape']:32s} err {r['err']:.2e}{times} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}){note}"
        )
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        graph_lint_faults(tmp)
    mark(f"graph lint faults phase: {time.perf_counter() - t0:.1f} s")

    from dllama_tpu_torch.models.synthetic import PRESETS

    counts, streams, tok_s, depths = {}, {}, {}, {}
    # the files of the paths after the llama-8b phases, a directory each,
    # written by a second child while the card runs those phases (stopped at
    # exit if a phase fails first)
    ahead_tmp = tempfile.TemporaryDirectory()
    ahead = {(model, n_layers): os.path.join(ahead_tmp.name, f"{model}-{n_layers}")
             for model, _, n_layers, _ in MODELS[1:]}
    writer = start_prewrite([(d, preset, n_layers) for (_, preset, n_layers, _), d
                             in zip(MODELS[1:], ahead.values())])
    finish_prewrite(llama_writer, f"llama-8b {N_LAYERS} layers and the serving, parallel and "
                    f"draft rounds' files")
    # the parallel and pipeline rounds' worlds and CLI runs, on two threads
    # beside the single-process paths after the fleet phase (`Worker`)
    workers = (Worker("smoke-ranks-a"), Worker("smoke-ranks-b"))
    finish_rounds = []
    for model, preset, n_layers, formats in MODELS:
        depth = PRESETS[preset]["n_layers"]
        if n_layers < depth:
            why = ("bf16 experts are 1.26 GB a layer: the whole model would not fit the "
                   "card; q40i8 for the smoke's time" if n_layers == MOE_DENSE_LAYERS
                   and model == "qwen3-30b-a3b" else
                   "the smoke's time: the same kernels at the same widths, each layer a "
                   "repeat of the first")
            print(f"{model} {', '.join(formats)}: depth cut to {n_layers} of {depth} layers "
                  f"({why})")
        whole_llama = model == "llama-8b" and n_layers == N_LAYERS
        tmp = llama_tmp.name if whole_llama else ahead[(model, n_layers)]
        if not whole_llama and writer is not None:
            finish_prewrite(writer, "the files of the paths after the llama-8b phases")
            writer = None
        for spec in formats:
            weight_format, _, kv_dtype = spec.partition(" kv-")
            t0 = time.perf_counter()
            label, counts_, tokens, tok_s[label] = run_path(model, preset, n_layers,
                                                            weight_format, tmp, kv_dtype or None)
            counts[label], streams[label], depths[label] = counts_, tokens, n_layers
            mark(f"path {label}: {time.perf_counter() - t0:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
        if whole_llama:  # the serving phase, same file
            for kv_dtype in (None, "int8"):
                t0 = time.perf_counter()
                tag = f" kv-{kv_dtype}" if kv_dtype else ""
                counts.update(serving("cuda", tmp, tok_s.get("llama-8b q40"), smi, kv_dtype))
                mark(f"serving phase{tag}: {time.perf_counter() - t0:.1f} s")
                gc.collect()
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            counts.update(serving_single("cuda", tmp, smi))
            mark(f"serving single phase: {time.perf_counter() - t0:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            counts.update(mixed_kv(tmp, smi, streams.get("llama-8b q40")))
            mark(f"mixed-kv phase: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            counts.update(serving_fleet(tmp, smi))
            mark(f"fleet phase: {time.perf_counter() - t0:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
            # the worlds start here, after every round the watchdog gates
            t0 = time.perf_counter()
            finish_rounds = [parallel_round(tmp, smi, workers),
                             pipeline_round(tmp, smi, workers)]
            mark(f"parallel and pipeline one-rank references: {time.perf_counter() - t0:.1f} s; "
                 f"their worlds and CLI runs go on beside the paths below")
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            counts.update(serving_draft(tmp, smi))
            mark(f"serving draft phase: {time.perf_counter() - t0:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
        if model == "qwen3-30b-a3b" and n_layers == MOE_LAYERS:
            t0 = time.perf_counter()
            counts.update(moe_dedup(tmp, smi))
            mark(f"dedup phase: {time.perf_counter() - t0:.1f} s")
        if not whole_llama:
            shutil.rmtree(tmp)
    # the parallel and pipeline rounds' reports, once their worlds end
    mark("waiting for the parallel and pipeline rounds' worlds and CLI runs")
    t0 = time.perf_counter()
    for name, finish in zip(("parallel", "pipeline"), finish_rounds):
        counts.update(finish())
        mark(f"{name} phase: its worlds and CLI runs ended {time.perf_counter() - t0:.1f} s "
             f"after the other paths")
    for w in workers:
        w.close()
    llama_tmp.cleanup()
    ahead_tmp.cleanup()
    for label in streams:
        model, fmt = label.split(" ", 1)
        if (fmt in ("q40i4", "q40i8", "q40 kv-int8") and f"{model} q40" in streams
                and depths[label] == depths[f"{model} q40"]):
            a, b = streams[f"{model} q40"], streams[label]
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            print(f"{label} greedy stream equals the q40 one: {a == b}"
                  + ("" if first is None else f" (first of {len(a)} tokens to differ: {first})"))

    kernels = []
    for name in REPLACES:
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["shape"] == KERNEL_ROW_SHAPE[name])
        by_path = {label: c[name] for label, c in counts.items() if c[name]}
        require(bool(by_path), f"{name} was launched on no path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            max_norm_err=max(r["err"] for r in mine), shape=rep["shape"],
            ms=rep.get("ms"), plain_ms=rep.get("plain_ms"), bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep.get("library_ms"),
            **({"composite_ms": rep["composite_ms"]} if "composite_ms" in rep else {}),
        ))
    print(f"smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def graph_lint(engine, label: str) -> dict:
    """The captured-graph lint over every key of ``engine`` once its graphs
    are captured (analysis/graphlint.py; ``DLLAMA_XLALINT=strict`` for the
    whole run, so each capture was linted as it landed): a line a key with
    its nodes by kind, kernel nodes and their count a token, the key's
    launch budget and the seconds reading and linting added to its
    capture; zero new findings and at least one graph."""
    rep = engine.xlalint_report()
    lint_s = [p["lint_seconds"] or 0.0 for p in rep["programs"]]
    for p in rep["programs"]:
        print(f"graphlint {label} {p['name']}: nodes {json.dumps(p['nodes'])}, kernel nodes "
              f"{p['kernel_nodes']} ({p['kernel_nodes_per_token']:.1f} a token of "
              f"{p['tokens']}), budget {p['kernel_budget']}, lint s {p['lint_seconds']:.4f}")
    print(f"graphlint {label}: mode {rep['mode']}, {rep['n_programs']} graphs, "
          f"{len(rep['skipped'])} keys with no graph {rep['skipped']}, new findings "
          f"{len(rep['new_findings'])}; lint s a capture: mean "
          f"{statistics.mean(lint_s) if lint_s else 0.0:.4f}, max {max(lint_s, default=0.0):.4f}, "
          f"sum {sum(lint_s):.3f}")
    require(rep["mode"] == "strict", f"graphlint {label}: mode {rep['mode']}, wanted strict")
    require(rep["n_programs"] > 0, f"graphlint {label}: no captured graph was read")
    require(not rep["new_findings"], f"graphlint {label}: {rep['new_findings']}")
    return rep


# the planted faults' engine: a KV plane of 128 MiB, above the pool-block
# check's floor (analysis/rules_graph.py `PLANE_BLOCK_MIN_BYTES`)
LINT_CFG = dict(dim=1024, hidden_dim=2048, n_layers=8, n_heads=8, n_kv_heads=8, head_dim=128,
                vocab_size=1024, seq_len=8192, rope_theta=500000.0)


def graph_lint_faults(tmp: str) -> None:
    """One planted fault per graph rule, each captured by a small bf16
    engine's `StepGraphs` under a key of its own and linted by the engine's
    capture hook in strict mode: it must raise `XlalintError` naming its
    rule and the finding's message, and count in
    ``dllama_xlalint_findings_total``. The counterparts of
    tests/test_xlalint.py's ``*_fires_on_real_executable``: a copy into
    pinned host memory (``hlo-host``), a clone of a KV plane (a memcpy node,
    ``hlo-donation``), a kernel-made copy of a KV plane kept past the
    capture (a plane-sized block in the graphs' pool, ``hlo-donation``), an
    f32 ``torch.matmul`` on a bf16 weight (``hlo-dtype``), a step over its
    launch budget (``hlo-cost-budget``)."""
    import torch

    from dllama_tpu_torch.analysis.graphlint import XlalintError, launch_budget, layer_launches
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    mp = os.path.join(tmp, "lint.m")
    write_synth_model(mp, LINT_CFG, max_seq_len=LINT_CFG["seq_len"])
    eng = InferenceEngine(mp, dtype=torch.bfloat16, weight_format="dense", device="cuda")
    dev = eng.device
    plane = eng.cache["k"]
    require(plane.numel() * plane.element_size() >= 128 << 20,
            f"graphlint faults: a KV plane of {plane.numel() * plane.element_size()} B")
    x = torch.ones(4096, device=dev)
    pinned = torch.empty(4096, pin_memory=True)
    rows = torch.ones(8, eng.header.dim, device=dev, dtype=torch.bfloat16)
    wq = eng.params["layers"][0]["wq"]
    kept: dict = {}
    over = launch_budget(1, eng.header.n_layers, layer_launches(eng.weight_format)) + 64

    def many():
        for _ in range(over):
            x.add_(1.0)

    faults = (  # (rule, what its message must say, the fault)
        ("hlo-host", "host-transfer memcpy 'device-to-host'",
         lambda: pinned.copy_(x, non_blocking=True)),
        ("hlo-donation", "a memcpy node moves a whole KV plane",
         lambda: kept.__setitem__("clone", plane.clone())),
        ("hlo-donation", "capture left a block of a KV plane's size",
         lambda: kept.__setitem__("product", plane * 1)),
        ("hlo-dtype", "upcast to an f32 GEMM",
         lambda: kept.__setitem__("y", torch.matmul(rows.float(), wq.float().t()))),
        ("hlo-cost-budget", "kernel nodes exceed", many),
    )
    counter = eng._m_xlalint
    for i, (rule, says, fault) in enumerate(faults):
        key = ("prefill", 1000 + i, False)  # a key of its own, budgeted as a prefill chunk
        n0 = counter.value
        t0 = time.perf_counter()
        try:
            eng.graphs.run(key, fault)
        except XlalintError as e:
            msg = str(e)
        else:
            msg = ""
        torch.cuda.synchronize()
        print(f"graphlint fault {rule} ({says}): {time.perf_counter() - t0:.3f} s, "
              f"dllama_xlalint_findings_total +{counter.value - n0}; {msg[:600]}")
        require(f"[{rule}] " in msg and says in msg,
                f"graphlint fault {rule} ({says}): strict mode raised {msg!r}")
        require(counter.value > n0 or not eng.obs.enabled,
                f"graphlint fault {rule}: the counter did not move")
    kept.clear()
    release_engine(eng)


def release_engine(engine) -> None:
    """Drop an engine's device tensors (params, caches, pool, the draft
    model's, its graphs and their pool): the registry's refresh hooks and
    the recorder's context providers hold the last engine and server alive
    past the phase that made them."""
    import torch

    engine.graphs.clear()
    for name in ("params", "cache", "lane_cache", "kv_pool", "_draft_params", "draft_cache"):
        setattr(engine, name, None)
    gc.collect()
    torch.cuda.empty_cache()


MIXED_DECODE_TOKENS = 32  # tokens the f32 engine over a bf16 cache decodes


def mixed_kv(tmp: str, smi: str, bf16_stream: list[int] | None) -> dict:
    """A float KV type unlike the model's on llama-8b q40 (the `N_LAYERS`-layer file
    in tmp), the kernels' ``_mx`` entries on the main path: (a) an f32
    engine over a bf16 cache (``kv_dtype="bf16"``) runs the CLI's path (the
    ~500-token prompt, `MIXED_DECODE_TOKENS` greedy tokens, graphed), every
    attention launch a mixed one (n_layers a forward), then one prefill and
    one decode step, kernel path against plain path on bf16 caches of their
    own, f32 logits within TOL_E2E (the gate of `parity`); (b) a bf16 engine
    over an f16 cache: its cache's bytes equal a bf16 cache's, its greedy
    stream (the CLI path's 128 tokens) printed against the bf16-cache q40
    stream (``bf16_stream``), then four pool-native lanes over an f16 pool
    (`generate_batch`), their paged stats and decode launches all mixed
    ones, lane 0's stream printed against the single stream's. Each engine
    prints the steady graphed host ms of the prompt's 512-row chunk (the
    median of `HOST_RUNS`) beside the bf16 main file's. Returns the launch
    counts by label."""
    import torch

    from dllama_tpu_torch.models import forward, init_kv_cache
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import Tokenizer

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    tok = Tokenizer(tp)
    prompt = tok.encode(prompt_text(PROMPT_TOKENS - 1), is_start=True, add_special_tokens=True)
    attn = ("flash_attention_stats", "flash_decode", "paged_flash_decode")
    out = {}

    def prefill_line(label, ms, n_chunks):
        main = PREFILL_GRAPHED_MS.get("llama-8b q40")
        print(f"mixed-kv prefill {label}: the prompt's {n_chunks} chunk(s) of "
              f"{len(prompt)} tokens, graphed host ms {ms:.3f} (median of {HOST_RUNS}); the "
              f"bf16 main file's (llama-8b q40, bf16 cache) "
              + ("not run" if main is None else f"{main:.3f}"))

    def only_mixed(label, counts, want):
        got = {name: counts[name] for name in counts if "flash" in name and counts[name]}
        print(f"mixed-kv {label} launches {json.dumps(got)}")
        require(got == want, f"{label}: attention launches {got}, wanted {want}")

    # (a) f32 model, bf16 cache
    t0 = time.perf_counter()
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=SEED,
                          weight_format="q40", device="cuda", kv_dtype="bf16")
    load_s, h, dev = time.perf_counter() - t0, eng.header, eng.device
    reset_launch_counts()
    toks, ev, pred = eng.generate(prompt, max_steps=len(prompt) - 1 + MIXED_DECODE_TOKENS)
    torch.cuda.synchronize()
    label = "llama-8b q40 f32 kv-bf16"
    out[label] = counts = launch_counts()
    n_chunks = len(forward_rows(len(prompt), 0, eng.prefill_buckets))
    print(f"== {label}: {h.n_layers} layers, f32 model over a bf16 cache "
          f"({nbytes(eng.cache)} B); engine loaded in {load_s:.2f} s; prefill_ms "
          f"{ev.time_ms:.1f} ({ev.n_tokens} tokens), decode_ms_per_token "
          f"{pred.time_ms / max(pred.n_tokens, 1):.3f} (graphed; first uses and captures "
          f"included); {smi}")
    only_mixed(label, counts, {"flash_attention_stats_mixed": h.n_layers * n_chunks,
                               "flash_decode_mixed": h.n_layers * len(toks)})
    prefill_line(label, steady_prefill_ms(eng, prompt), n_chunks)
    with torch.inference_mode():
        t = torch.tensor([prompt], device=dev)
        last, nxt = {}, None
        for plain in (False, True):
            cache = init_kv_cache(h, 1, dtype=torch.bfloat16, device=dev)
            pre, cache = forward(eng.params, h, t, 0, cache, "last", plain=plain)
            nxt = pre[:, -1].argmax(-1, keepdim=True) if nxt is None else nxt
            dec, _ = forward(eng.params, h, nxt, len(prompt), cache, "last", plain=plain)
            last[plain] = (pre[:, -1], dec[:, -1])
            del cache
        for i, step in enumerate(("prefill", "decode")):
            err = norm_err(last[False][i], last[True][i])[0]
            print(f"parity mixed-kv f32/bf16 {step}: kernel vs plain logits err {err:.3e}")
            require(err <= TOL_E2E, f"{label} {step}: kernel vs plain err {err:.3e} > {TOL_E2E}")
    release_engine(eng)

    # (b) bf16 model, f16 cache: the single stream, then native lanes
    eng = InferenceEngine(mp, temperature=0.0, seed=SEED, weight_format="q40", device="cuda",
                          kv_dtype="f16", batch_size=SERVE_LANES)
    label = "llama-8b q40 kv-f16"
    reset_launch_counts()
    toks, ev, pred = eng.generate(prompt, max_steps=len(prompt) - 1 + DECODE_TOKENS)
    torch.cuda.synchronize()
    out[label] = counts = launch_counts()
    bf16_bytes = 2 * h.n_layers * h.n_kv_heads * h.seq_len * h.head_dim * 2
    print(f"== {label}: bf16 model over an f16 cache ({nbytes(eng.cache)} B, a bf16 cache "
          f"{bf16_bytes} B); decode_ms_per_token {pred.time_ms / max(pred.n_tokens, 1):.3f}; "
          f"{smi}")
    require(nbytes(eng.cache) == bf16_bytes, f"{label}: cache bytes {nbytes(eng.cache)}")
    only_mixed(label, counts, {"flash_attention_stats_mixed": h.n_layers * n_chunks,
                               "flash_decode_mixed": h.n_layers * len(toks)})
    prefill_line(label, steady_prefill_ms(eng, prompt), n_chunks)
    if bf16_stream is not None:
        first = next((i for i, (a, b) in enumerate(zip(toks, bf16_stream)) if a != b), None)
        print(f"{label} greedy stream equals the bf16-cache q40 one: {toks == bf16_stream}"
              + ("" if first is None else f" (first of {len(toks)} tokens to differ: {first})"))
    eng.init_kv_pool(PAGE, native=True)
    prompts = [prompt[: len(prompt) - 7 * i] for i in range(SERVE_LANES)]
    reset_launch_counts()
    steps0 = eng.lane_decode_steps
    lanes = eng.generate_batch(prompts, max_steps=len(prompt) - 1 + BLOCK * 2)
    torch.cuda.synchronize()
    label = "llama-8b q40 kv-f16 lanes"
    out[label] = counts = launch_counts()
    steps = eng.lane_decode_steps - steps0
    chunks = sum(len(forward_rows(len(p), 0, eng.prefill_buckets)) for p in prompts)
    only_mixed(label, counts, {"flash_attention_stats_mixed": h.n_layers * chunks,
                               "paged_flash_decode_mixed": h.n_layers * steps})
    print(f"{label}: {SERVE_LANES} pool-native lanes over an f16 pool "
          f"({nbytes(eng.kv_pool) / 1e9:.3f} GB), {steps} decode steps; lane 0 equals the "
          f"single f16-cache stream's first {len(lanes[0])} tokens: "
          f"{lanes[0] == toks[:len(lanes[0])]}")
    release_engine(eng)
    return out


DEDUP_STEPS = 32  # decode steps of each 4-lane run of the dedup phase


def moe_dedup(tmp: str, smi: str) -> dict:
    """The two-tier MoE decode (``moe_decode_dedup``) on qwen3-30b-a3b q40
    (the `MOE_LAYERS`-layer file in tmp), 4 slab lanes, `DEDUP_STEPS` greedy steps
    after each lane's prefill: with dedup on, four identical prompts take
    the grouped tier at every layer-step of the decode (the device tally,
    read after the run, gated) and four distinct prompts print the tally's
    share; each run again with dedup off (the graphs captured anew),
    the bf16 streams printed against the dedup-off ones; on an f32 engine
    over the same file both prompt sets gated equal on and off. Then a
    4-lane decode block's device ms with dedup on against off, identical
    prompts, in turns (CUDA events around a graphed block). Returns the
    launch counts of the bf16 dedup-on runs."""
    import torch

    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.ops.moe import tier_tally
    from dllama_tpu_torch.runtime.engine import InferenceEngine, resolve_moe_decode_dedup
    from dllama_tpu_torch.tokenizer import Tokenizer

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    tok = Tokenizer(tp)
    same = [tok.encode(prompt_text(63), is_start=True, add_special_tokens=True)] * SERVE_LANES
    distinct = [tok.encode(f"Lane {i} asks: " + prompt_text(40 + 9 * i)[::-1], is_start=True,
                           add_special_tokens=True) for i in range(SERVE_LANES)]
    tally = tier_tally("cuda")
    out = {}

    def run(eng, prompts, dedup):
        eng.moe_decode_dedup = dedup
        eng.graphs.clear()  # the captured steps hold one tiering
        eng.reset()
        for lane, p in enumerate(prompts):
            eng.prefill_lane(lane, p)
        tally.zero_()
        pos, toks = [len(p) - 1 for p in prompts], [p[-1] for p in prompts]
        streams = [[] for _ in prompts]
        while len(streams[0]) < DEDUP_STEPS:
            for row in eng.decode_lanes(toks, pos, BLOCK):
                for lane, t in enumerate(row):
                    streams[lane].append(t)
                toks = row
            pos = [p + BLOCK for p in pos]
        if dedup:  # the two-tier decode's census (graphlint `MOE_DEDUP_LAYER_LAUNCHES`)
            graph_lint(eng, "qwen3-30b-a3b q40 dedup")
        took, steps = tally.tolist()
        return streams, took, steps

    def parts(a, b):
        return [next((j for j, (x, y) in enumerate(zip(p, q)) if x != y), None)
                for p, q in zip(a, b)]

    t0 = time.perf_counter()
    eng = InferenceEngine(mp, temperature=0.0, seed=SEED, weight_format="q40", device="cuda",
                          batch_size=SERVE_LANES, moe_decode_dedup=True)
    h = eng.header
    print(f"== qwen3-30b-a3b q40 dedup: {h.n_layers} layers, {SERVE_LANES} slab lanes, "
          f"moe_decode_dedup on (\"auto\" would be "
          f"{resolve_moe_decode_dedup('auto', h, SERVE_LANES)} at {SERVE_LANES} lanes), "
          f"engine loaded in {time.perf_counter() - t0:.2f} s; {smi}")
    reset_launch_counts()
    on_same, took, steps = run(eng, same, True)
    out["qwen3-30b-a3b q40 dedup"] = counts = launch_counts()
    print(f"dedup identical prompts: {took} of {steps} decode layer-steps took the grouped tier "
          f"({took / max(steps, 1):.3f}); launches {json.dumps({k: v for k, v in counts.items() if v})}")
    require(steps == h.n_layers * DEDUP_STEPS and took == steps,
            f"dedup: {took} of {steps} layer-steps took the grouped tier, wanted every one of "
            f"{h.n_layers * DEDUP_STEPS}")
    require(counts["moe_grouped_experts_q40"] > 0 and counts["moe_active_experts_q40"] > 0,
            "dedup: the two tiers were not both launched")
    on_div, took, steps = run(eng, distinct, True)
    print(f"dedup distinct prompts: {took} of {steps} decode layer-steps took the grouped tier "
          f"({took / max(steps, 1):.3f})")
    off_same, _, off_steps = run(eng, same, False)
    off_div, _, _ = run(eng, distinct, False)
    require(off_steps == 0, f"dedup off: {off_steps} layer-steps ran two-tier")
    print(f"dedup bf16 streams, on against off (where each lane parts, None: equal): identical "
          f"prompts {parts(on_same, off_same)}, distinct {parts(on_div, off_div)}")

    def block_ms(dedup):
        eng.moe_decode_dedup = dedup
        eng.graphs.clear()
        pos, toks = [len(p) - 1 for p in same], [p[-1] for p in same]
        eng.decode_lanes(toks, pos, BLOCK)  # first use and capture
        ms = []
        for _ in range(HOST_RUNS):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            eng.decode_lanes(toks, pos, BLOCK)
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e) / BLOCK)
        return ms

    timed = {True: [], False: []}
    for dedup in (True, False, False, True):
        timed[dedup] += block_ms(dedup)
    on_ms, off_ms = statistics.median(timed[True]), statistics.median(timed[False])
    print(f"dedup decode step, {SERVE_LANES} lanes, identical prompts, graphed, in turns: device "
          f"ms/step on {_ms(timed[True])}, off {_ms(timed[False])}: on/off "
          f"{on_ms / off_ms:.3f}; {smi}")
    release_engine(eng)

    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=SEED,
                          weight_format="q40", device="cuda", batch_size=SERVE_LANES)
    f32 = {}
    for name, prompts in (("identical", same), ("distinct", distinct)):
        on, took, steps = run(eng, prompts, True)
        off, _, _ = run(eng, prompts, False)
        f32[name] = on == off
        print(f"dedup f32 {name} prompts: streams on equal off {on == off} (parts "
              f"{parts(on, off)}); {took} of {steps} layer-steps took the grouped tier")
        require(on == off, f"dedup f32 {name}: the dedup-on streams differ from dedup-off")
    release_engine(eng)
    return out


DRAFT_PRESET, DRAFT_LAYERS = "llama-1b", 16  # the public draft of llama-8b, whole depth
DRAFT_SEED = SEED + 1  # the draft's own weights
# round (b): llama-8b's widths cut to 2 of 32 layers (the smoke's time),
# its own draft; the f32 file of the fleet's f32
# round and of the parallel and pipeline rounds' f32 runs
ACCEPT_LAYERS = 2
DRAFT_TURNS = (False, True, True, False)  # the mix with speculation off and draft, in turns


def _draft_timers(engine):
    """Wrap the engine's lane and draft entries with host timers (each
    ends in a readback or feeds one); returns the timer and a restore."""
    timer = {"decode_s": 0.0, "decode_tokens": 0, "verify_s": 0.0, "draft_s": 0.0}
    names = ("decode_lanes", "verify_lanes", "draft_prefill", "draft_propose")
    inner = {name: getattr(engine, name) for name in names}

    def wrap(name, key):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                res = inner[name](*args, **kw)
            finally:
                timer[key] += time.perf_counter() - t
            if name == "decode_lanes":
                timer["decode_tokens"] += len(res) * sum(map(bool, args[3]))
            return res
        return call

    for name, key in zip(names, ("decode_s", "verify_s", "draft_s", "draft_s")):
        setattr(engine, name, wrap(name, key))
    return timer, lambda: [engine.__dict__.pop(n, None) for n in names]


def _serve_mix(engine, tok, speculation: str, draft: str | None, payloads, solo=False,
               before=None, n_mixes: int = 1):
    """One `serve` over ``engine`` (pool-native lanes, page PAGE) with
    ``speculation`` (spec_k SPEC_K, the draft at ``draft``): the mix sent at
    once ``n_mixes`` times (``before(i)`` called before mix i) and, with
    ``solo``, each payload replayed alone after the first. Returns (the
    mixes' results, the solo results, the first mix's lane tok/s, the
    scheduler's spec stats after each mix)."""
    import threading

    from dllama_tpu_torch.runtime.api_server import serve
    from dllama_tpu_torch.tokenizer import ChatTemplateType

    srv = serve(engine, tok, host="127.0.0.1", port=0, model_name="llama-8b",
                chat_template_type=ChatTemplateType.LLAMA3, kv_page_size=PAGE, kv_native=True,
                speculation=speculation, spec_k=SPEC_K, draft_model=draft)
    serve_thread(srv)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sched = srv.state.scheduler
    generated = _track_generated(sched)
    mixes, specs, alone, tok_s = [], [], [], 0.0
    try:
        for i in range(n_mixes):
            if before is not None:
                before(i)
            timer, restore = _draft_timers(engine)
            try:
                results, _ = _concurrent(url, sched, payloads)
            finally:
                restore()
            if i == 0:
                lane_s = timer["decode_s"] + timer["verify_s"] + timer["draft_s"]
                emitted = sched.spec_accepted + sched.spec_accept_len_count
                tok_s = (timer["decode_tokens"] + emitted) / lane_s if lane_s else 0.0
                alone = [_request(url, p) for p in payloads] if solo else []
            mixes.append(results)
            specs.append(sched.spec_stats())
        for r in [r for res in mixes for r in res] + alone:
            r["tokens"] = generated[r["meta"]["request_id"]]
    finally:
        srv.shutdown()
        srv.server_close()
    return mixes, alone, tok_s, specs


def serving_draft(tmp: str, smi: str) -> dict:
    """Draft-model speculation (``--speculation draft``) in the serving
    phase. (a) The public pairing: the target is llama-8b q40 at full width
    (the `PAR_LAYERS`-layer file in tmp/par, for the smoke's time) over 4
    pool-native lanes, the draft llama-1b (16 layers, written as Q40 with
    its own seed into tmp/draft, ahead or here, loaded dense bf16); the seven-request
    mix with speculation off and draft in turns (`DRAFT_TURNS`), the first
    draft turn's answers each replayed alone. Gated: every request ends
    with stop or length, the draft model drafted. Printed: where each
    answer parts from its solo replay and from spec-off (bf16: a verify
    row's token comes from the stats kernel and the Q40 tile, at a width
    that the other lanes' drafts set, a decode step's from the decode
    kernel and the GEMV, so the path a token takes changes its rounding),
    the draft graphs' counts and device ms
    (`InferenceEngine.device_step_seconds`), drafted and accepted tokens,
    the tokens by source and lane tok/s against spec-off in turns. (b)
    Acceptance: llama-8b's widths cut to `ACCEPT_LAYERS` layers, f32, its
    own file as the draft: accepted tokens > 0 and every answer equal to
    the spec-off answer's bytes; then, on the same server, the mix again
    with one draft step made to fail (its graph's replay raises):
    ``draft_cache_epoch`` rises by one, the target's ``cache_epoch`` and
    ``kv_pool_epoch`` stay, and every answer is still spec-off's. Returns
    the launch counts of (a)'s first draft turn and of (b)'s draft mixes."""
    import torch

    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer import Tokenizer

    mp, tp = os.path.join(tmp, "par", "model.m"), os.path.join(tmp, "tok.t")
    tok = Tokenizer(tp)
    payloads = serving_payloads(tok)
    dp = os.path.join(tmp, "draft", "model.m")
    written = "written ahead"
    if not os.path.exists(dp):  # written ahead (`start_prewrite`)
        os.makedirs(os.path.dirname(dp), exist_ok=True)
        t0 = time.perf_counter()
        write_synth_model(dp, DRAFT_PRESET, seed=DRAFT_SEED, max_seq_len=4096,
                          n_layers=DRAFT_LAYERS)
        written = f"written in {time.perf_counter() - t0:.1f} s"
    engine = InferenceEngine(mp, temperature=0.0, seed=SEED, weight_format="q40",
                             device="cuda", batch_size=SERVE_LANES)
    out, tok_s, first, off_res = {}, {True: [], False: []}, None, None
    for draft in DRAFT_TURNS:
        if draft and first is None:
            reset_launch_counts()
        mixes, alone, rate, specs = _serve_mix(
            engine, tok, "draft" if draft else "off", dp if draft else None, payloads,
            solo=draft and first is None)
        tok_s[draft].append(rate)
        if draft and first is None:
            out["llama-8b q40 serving draft"] = launch_counts()
            graphs = {k: engine.graphs.count(k) for k in ("draft_prefill", "draft_step")}
            graph_lint(engine, "llama-8b q40 serving draft")
            first = (mixes[0], alone, specs[0])
        elif not draft and off_res is None:
            off_res = mixes[0]
    res, alone, spec = first
    dh = engine._draft_header
    print(f"== llama-8b q40 serving draft: {engine.header.n_layers} layers, speculation draft, "
          f"spec_k {SPEC_K}, draft "
          f"{DRAFT_PRESET} ({dh.n_layers} layers, dim {dh.dim}, head dim {dh.head_dim}, vocab "
          f"{dh.vocab_size}; Q40, {written}, loaded dense bf16: "
          f"{nbytes(engine._draft_params) / 1e9:.3f} GB, draft cache "
          f"{nbytes(engine.draft_cache) / 1e9:.3f} GB); {len(payloads)} requests, "
          f"{SERVE_LANES} lanes; {smi}")
    for i, (r, s_, o) in enumerate(zip(res, alone, off_res)):
        vs_solo, vs_off = _parts([r], [s_]), _parts([r], [o])
        print(f"serve draft r{i}: finish {r['finish']} tokens {len(r['tokens'])} ttft_ms "
              f"{r['meta']['ttft_ms']}; equals solo {not vs_solo}"
              + (f" ({vs_solo[0][3:]})" if vs_solo else "")
              + f"; equals spec-off {not vs_off}" + (f" ({vs_off[0][3:]})" if vs_off else ""))
        require(r["finish"] in ("stop", "length") and s_["finish"] in ("stop", "length"),
                f"serving draft r{i}: finish {r['finish']} / solo {s_['finish']}")
    for kind in ("draft_prefill", "draft_step"):
        dev_s = engine.device_step_seconds(kind)
        print(f"serve draft {kind}: {graphs[kind]} graphs in the first draft turn, "
              + ("no dispatch settled" if dev_s is None else
                 f"{dev_s[0]} dispatches settled, device ms {dev_s[1] * 1e3:.4f} a dispatch"))
    sources = spec["sources"]
    print(f"serve draft acceptance: accepted {spec['accepted']} of {spec['drafted']} drafted; "
          f"{spec['verify_passes']} verify passes, {spec['tokens_per_lane_pass']:.2f} tokens a "
          f"lane a pass; drafted by source {json.dumps(sources)}")
    print(f"serve draft lane tok/s in turns {DRAFT_TURNS}: draft {_ms(tok_s[True])}, off "
          f"{_ms(tok_s[False])}: draft/off "
          f"{statistics.median(tok_s[True]) / statistics.median(tok_s[False]):.3f}; {smi}")
    require(sources.get("draft", 0) > 0, f"serving draft: the draft model drafted nothing "
            f"({json.dumps(sources)})")
    release_engine(engine)

    # (b) acceptance: the target's own file as its draft, f32
    sub = os.path.join(tmp, "accept")
    os.makedirs(sub, exist_ok=True)
    ap = os.path.join(sub, "model.m")
    if not os.path.exists(ap):  # written ahead (`start_prewrite`)
        write_synth_model(ap, "llama-8b", seed=SEED, max_seq_len=4096, n_layers=ACCEPT_LAYERS)
    engine = InferenceEngine(ap, dtype=torch.float32, temperature=0.0, seed=SEED,
                             weight_format="q40", device="cuda", batch_size=SERVE_LANES)
    (truth,), _, _, _ = _serve_mix(engine, tok, "off", None, payloads)
    run, fired = engine.graphs.run, []

    def epochs():
        return engine.cache_epoch, engine.kv_pool_epoch, engine.draft_cache_epoch

    def failing(key, step):
        if key[0] == "draft_step" and not fired:
            fired.append((key, epochs()))  # the epochs as the step fails
            raise RuntimeError("injected draft step failure")
        return run(key, step)

    def poison_second(i):
        if i == 1:  # after the rehearsal and the first mix: the next draft step fails
            engine.graphs.run = failing

    reset_launch_counts()
    try:
        (got, poisoned), _, _, specs = _serve_mix(engine, tok, "draft", ap, payloads,
                                                 before=poison_second, n_mixes=2)
    finally:
        engine.graphs.__dict__.pop("run", None)
    out["llama-8b q40 f32 serving draft"] = launch_counts()
    spec = specs[0]
    part = _parts(got, truth)
    print(f"== llama-8b q40 f32 serving draft: {ACCEPT_LAYERS} of 32 layers at full width, its "
          f"own file as the draft (dense f32); accepted {spec['accepted']} of {spec['drafted']} "
          f"drafted, {spec['tokens_per_lane_pass']:.2f} tokens a lane a pass, by source "
          f"{json.dumps(spec['sources'])}; every answer equals spec-off's bytes {not part}"
          + (f" (parts: {', '.join(part)})" if part else ""))
    require(spec["accepted"] > 0, "serving draft f32: no draft accepted")
    require(not part, f"serving draft f32: answers part from spec-off: {part}")
    require(bool(fired), "serving draft f32: no draft step ran to fail")
    part = _parts(poisoned, truth)
    key, before = fired[0]
    now = epochs()
    print(f"serve draft f32 poison: draft step {key} failed; epochs (cache, kv pool, draft) "
          f"{before} as it failed, {now} after the mix; every answer equals spec-off's bytes "
          f"{not part}; accepted {specs[1]['accepted'] - spec['accepted']} of "
          f"{specs[1]['drafted'] - spec['drafted']} in that mix")
    require(now[:2] == before[:2] and now[2] == before[2] + 1,
            f"serving draft f32: epochs {before} -> {now}")
    require(not part, f"serving draft f32 poison: answers part from spec-off: {part}")
    release_engine(engine)
    return out


FLEET_REPLICAS = 2  # the bf16 in-process fleet's replicas, each SERVE_LANES lanes
# the f32 fleet's: a stream the chaos kills on both serving replicas still
# has a sibling (which stream a replica's nth flush belongs to is timing)
FLEET_F32_REPLICAS = 3
FLEET_FAULT = "sse_flush:op={}:nth=3:n=1"  # round (c)/(d): the serving replica's 3rd flush
# round (d): one flush killed on each of the two replicas the mix lands on
FLEET_CHAOS = "sse_flush:op={}:nth=2:n=1,sse_flush:op={}:nth=3:n=1"
FLEET_SUB_LAYERS = 2  # round (g): the subprocess fleet's llama-8b depth


def _fleet_mix(url: str, payloads: list[dict]) -> tuple[list, float]:
    """Every payload through the router at once; (results, wall seconds)."""
    import threading

    results: list = [None] * len(payloads)
    errors: list = []

    def send(i):
        try:
            results[i] = _request(url, payloads[i])
        except Exception as e:  # reported below
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,), daemon=True,
                                name=f"dllama-smoke-send-{i}") for i in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    require(not errors and all(r is not None for r in results), f"fleet: {errors}")
    return results, time.perf_counter() - t0


def _block_log(engines: dict):
    """Every replica's lane decode blocks timed (each ends in a readback):
    a list of (replica, start, end, lane tokens), and a restore."""
    log: list = []

    def wrap(name, inner):
        def timed(tokens, pos, n_steps, active, *args, **kw):
            t = time.perf_counter()
            rows = inner(tokens, pos, n_steps, active, *args, **kw)
            log.append((name, t, time.perf_counter(), len(rows) * sum(map(bool, active))))
            return rows
        return timed

    for name, engine in engines.items():
        engine.decode_lanes = wrap(name, engine.decode_lanes)
    return log, lambda: [e.__dict__.pop("decode_lanes", None) for e in engines.values()]


def _union_s(spans) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _device_block(engine) -> tuple[int, float]:
    """(settled decode_lanes dispatches, their summed device seconds); the
    replica must be idle (its scheduler thread settles the rest)."""
    engine.settle_costs()
    got = engine.device_step_seconds("decode_lanes")
    return (0, 0.0) if got is None else (got[0], got[0] * got[1])


def _parts_at(tok, want_ids: list[int], want: str, got: str) -> str:
    """Where ``got`` parts from ``want``: the character and the token of
    ``want_ids`` (whose text is ``want``) that holds it."""
    at = next((i for i, (x, y) in enumerate(zip(want, got)) if x != y), min(len(want), len(got)))
    dec, n = tok.stream_decoder(), 0
    for j, t in enumerate(want_ids):
        n += len(dec.decode(t) or "")
        if n > at:
            return f"character {at}, token {j} of {len(want_ids)}"
    return f"character {at}, past the {len(want_ids)} tokens"


def _free_port_base(n: int) -> int:
    """A base port whose n consecutive ports are free on 127.0.0.1."""
    import random
    import socket

    rng = random.Random(os.getpid())
    for _ in range(200):
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                sk.bind(("127.0.0.1", base + i))
                socks.append(sk)
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("fleet: no free ports")


def _gate_step(sched):
    """Hold the scheduler's next decode block until released: (entered,
    release, restore)."""
    import threading

    entered, release = threading.Event(), threading.Event()
    step = sched._step_block

    def gated():
        entered.set()
        release.wait(600)
        step()

    sched._step_block = gated
    return entered, release, lambda: sched.__dict__.pop("_step_block", None)


def serving_fleet(tmp: str, smi: str, device: str = "cuda") -> dict:
    """The replica fleet (dllama_tpu_torch/fleet/) on the card. (a)-(c), (f)
    on an in-process fleet of `FLEET_REPLICAS` llama-8b q40 replicas (the
    `N_LAYERS`-layer file in tmp, bf16, slab lanes: the server's default mode, 4
    lanes each) behind the router: (a) the serving mix through the router,
    every answer equal to the serving round's solo replay (`SERVE_TRUTH`:
    text, finish, token count) and each non-stream ``usage.prompt_tokens``
    to the router's own count, the fleet's lane tok/s (lane tokens over the
    union of both replicas' decode-block seconds) against the serving
    round's single replica; each replica's device ms a decode block with its
    sibling idle and busy (`InferenceEngine.device_step_seconds`); (b) the
    three shared-prefix requests one after another: one plan target, the
    second and third served there with a reused prefix, the affinity-hit
    counter +3 (spills by reason printed); (c) a stream whose serving
    replica dies at its 3rd flush (`FLEET_FAULT`): the client's stream ends
    with one finish reason, one failover and one ``died`` counted (whether
    its bytes equal the fault-free stream's printed, not gated: the sibling
    re-makes the emitted rows through the prefill kernels); (f) the
    router's /metrics re-exports both replicas' families, /v1/fleet lists
    both, and the failed-over request's /v1/fleet/timeline stitches both
    replicas' fragments; (e) then ``POST /v1/drain?replica=r1`` through the
    router with r1's streams held in flight (its next decode block waits
    for the drain): they finish, r1 reports draining, then drained with
    nothing in flight, and later requests land on r0. (d) An f32 fleet of
    `FLEET_F32_REPLICAS` replicas over llama-8b's widths at
    `ACCEPT_LAYERS` layers (serving_draft's (b) file), pool-native lanes:
    the failed-over stream byte-identical to the fault-free one, and under
    `FLEET_CHAOS` (a flush killed on each of the two replicas the mix
    lands on) every stream of the mix with its fault-free bytes. (g) ``python -m dllama_tpu_torch.fleet.launch``
    with two replica processes on a `FLEET_SUB_LAYERS`-layer file: both
    answer /v1/health, a stream through the router completes, SIGTERM ends
    every process (each replica's drain); its replicas' start seconds
    printed. Returns the launch counts of the bf16 rounds and of the f32
    rounds. On one card the replicas' engines share the default stream:
    their steps serialize."""
    import signal
    import threading
    import urllib.request

    import torch

    from dllama_tpu_torch.fleet.launch import launch_inprocess_fleet
    from dllama_tpu_torch.models.synthetic import write_synth_model
    from dllama_tpu_torch.ops import launch_counts, reset_launch_counts
    from dllama_tpu_torch.runtime.faults import set_fault_plane
    from dllama_tpu_torch.tokenizer import ChatTemplateType, Tokenizer

    mp, tp = os.path.join(tmp, "model.m"), os.path.join(tmp, "tok.t")
    tok = Tokenizer(tp)
    payloads = serving_payloads(tok)
    truth = SERVE_TRUTH
    cuda = device == "cuda"

    def mem_gb():
        return torch.cuda.memory_allocated() / 1e9 if cuda else 0.0

    def launch(path, dtype, native, n_replicas):
        t0 = time.perf_counter()
        fl = launch_inprocess_fleet(
            path, tp, n_replicas=n_replicas, batch_size=SERVE_LANES,
            chat_template_type=ChatTemplateType.LLAMA3, device=device,
            engine_kwargs=dict(dtype=dtype, weight_format="q40", seed=SEED),
            serve_kwargs=dict(model_name="llama-8b", kv_page_size=PAGE, kv_native=native))
        return fl, time.perf_counter() - t0

    def close(fl):
        fl.close()
        for _, srv in fl.replicas:
            release_engine(srv.state.engine)

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mem0 = mem_gb()
    reset_launch_counts()
    fleet, launch_s = launch(mp, torch.bfloat16, False, FLEET_REPLICAS)
    st = fleet.router_state
    url = fleet.router_url
    reps = dict(fleet.replicas)
    engines = {name: srv.state.engine for name, srv in fleet.replicas}
    gens = {name: _track_generated(srv.state.scheduler) for name, srv in fleet.replicas}

    def tokens_of(rid):
        return next((g[rid] for g in gens.values() if rid in g), [])

    h = engines["r0"].header
    print(f"== llama-8b q40 serving fleet: {FLEET_REPLICAS} replicas x {SERVE_LANES} slab lanes, "
          f"{h.n_layers} layers, bf16, behind the router (affinity k {st.affinity_k}); launched "
          f"in {launch_s:.1f} s; torch.cuda.memory_allocated {mem0:.3f} GB before, "
          f"{mem_gb():.3f} GB with both replicas; {smi}")
    try:
        # (a) the mix through the router
        log, restore = _block_log(engines)
        try:
            results, wall = _fleet_mix(url, payloads)
        finally:
            restore()
        tokens = sum(n for *_, n in log)
        union = _union_s([(a, b) for _, a, b, _ in log])
        for i, r in enumerate(results):
            r["tokens"] = tokens_of(r["meta"]["request_id"])
            want = truth["solo"][i] if truth else None
            same = want is not None and (r["content"], r["finish"], len(r["tokens"])) == (
                want["content"], want["finish"], len(want["tokens"]))
            served = st.ledger.get(r["meta"]["request_id"])
            n_prompt = len(st.prompt_tokens(payloads[i]["messages"]))
            usage = r.get("usage")
            print(f"fleet r{i}: replica {served['replicas'] if served else None} finish "
                  f"{r['finish']} tokens {len(r['tokens'])} reused "
                  f"{r['meta']['reused_prefix_tokens']} ttft_ms {r['meta']['ttft_ms']}; router "
                  f"prompt tokens {n_prompt}, usage {usage}; equals the serving round's solo "
                  f"replay {same}")
            require(r["finish"] in ("stop", "length"), f"fleet r{i}: finish {r['finish']}")
            require(same, f"fleet r{i}: the answer differs from the serving round's solo replay")
            require(usage is None or usage["prompt_tokens"] == n_prompt,
                    f"fleet r{i}: usage {usage} against the router's {n_prompt} prompt tokens")
        per = {name: sum(n for rn, *_, n in log if rn == name) for name in engines}
        fleet_tok_s = tokens / union if union else 0.0
        single = truth.get("lane_tok_s")
        print(f"fleet lane tok/s: {tokens} lane tokens ({json.dumps(per)}) in {union:.3f} s of "
              f"decode blocks (the union over both replicas; {wall:.2f} s wall with prefill): "
              f"{fleet_tok_s:.2f} tok/s"
              + (f", {fleet_tok_s / single:.3f}x the serving round's single replica "
                 f"{single:.2f}" if single else "") + f"; {smi}")

        # each replica's device ms a decode block, sibling idle and busy
        solo_req = dict(payloads[1], stream=False)
        snap = {}

        def settle():
            if cuda:
                torch.cuda.synchronize()
            return {name: _device_block(e) for name, e in engines.items()}

        def delta(a, b, name):
            n, s_ = b[name][0] - a[name][0], b[name][1] - a[name][1]
            return (s_ / n * 1e3 if n else None), n

        def host_ms(log, name):
            xs = [b - a for rn, a, b, _ in log if rn == name]
            return statistics.median(xs) * 1e3 if xs else float("nan")

        snap["0"] = settle()
        idle_host = {}
        for name in engines:
            log, restore = _block_log(engines)
            try:
                _request(fleet.replica_urls[name], solo_req)
            finally:
                restore()
            idle_host[name] = host_ms(log, name)
            snap[name] = settle()
        log, restore = _block_log(engines)
        both = [threading.Thread(target=_request, args=(fleet.replica_urls[n], solo_req),
                                 daemon=True, name=f"dllama-smoke-{n}")
                for n in engines]
        try:
            for th in both:
                th.start()
            for th in both:
                th.join(timeout=600)
        finally:
            restore()
        snap["busy"] = settle()
        prev = "0"
        for name in engines:
            idle, n_idle = delta(snap[prev], snap[name], name)
            prev = name
            busy, n_busy = delta(snap[list(engines)[-1]], snap["busy"], name)
            print(f"fleet device {name}: decode_lanes block (of {BLOCK} steps, one lane) "
                  + ("device ms not measured (no card)" if idle is None or busy is None else
                     f"device ms {idle:.3f} with the sibling idle ({n_idle} blocks), {busy:.3f} "
                     f"with the sibling busy ({n_busy} blocks): busy/idle {busy / idle:.2f}; "
                     f"a lane step {idle / BLOCK:.3f} / {busy / BLOCK:.3f} ms")
                  + f"; host ms a block (median) {idle_host[name]:.3f} idle, "
                  f"{host_ms(log, name):.3f} busy; health "
                  f"{reps[name].state.health_snapshot()['status']}; {smi}")

        # (b) affinity: the three shared-prefix requests, one after another
        shared = [payloads[i] for i in (0, 4, 5)]
        st.registry.poll_once()
        plans = [st.route(st.prompt_tokens(p["messages"])) for p in shared]
        targets = {p.target for p in plans}
        hits0 = st.m_affinity_hits.value
        aff = [_request(url, p) for p in shared]
        served = [st.ledger.get(r["meta"]["request_id"])["replicas"] for r in aff]
        hits = st.m_affinity_hits.value - hits0
        spills = {k[0]: v for k, v in st.m_spills.child_values().items()}
        print(f"fleet affinity: plan targets {sorted(targets)}, candidates "
              f"{[p.candidates for p in plans]}, served by {served}, reused "
              f"{[r['meta']['reused_prefix_tokens'] for r in aff]}; affinity hits +{hits:.0f}; "
              f"spills by reason over the rounds so far {json.dumps(spills)}")
        require(len(targets) == 1, f"fleet affinity: plan targets {targets}")
        target = targets.pop()
        require(all(s_ == [target] for s_ in served), f"fleet affinity: served by {served}")
        require(all(r["meta"]["reused_prefix_tokens"] > 0 for r in aff[1:]),
                "fleet affinity: the second and third request reused no prefix")
        require(hits == 3, f"fleet affinity: {hits} affinity hits, wanted 3")

        # (c) failover in bf16
        fo = dict(payloads[2], stream=True)
        st.registry.poll_once()
        victim = st.route(st.prompt_tokens(fo["messages"])).candidates[0]
        clean = _request(url, fo)
        clean["tokens"] = tokens_of(clean["meta"]["request_id"])
        died = st.m_requests.labels(replica=victim, outcome="died")
        f0, d0 = st.m_failovers.value, died.value
        set_fault_plane(FLEET_FAULT.format(victim))
        try:
            failed = _request(url, fo)
        finally:
            set_fault_plane("")
        fo_rid = failed["meta"]["request_id"]
        n_fo, n_died = st.m_failovers.value - f0, died.value - d0
        same = failed["content"] == clean["content"]
        print(f"fleet failover bf16: {FLEET_FAULT.format(victim)}; the stream finished "
              f"{failed['finish']} with no error frame; failovers +{n_fo:.0f}, died +{n_died:.0f}; "
              f"bytes equal the fault-free stream's {same}"
              + ("" if same else f" (they part at {_parts_at(tok, clean['tokens'], clean['content'], failed['content'])})")
              + f"; ledger {json.dumps(st.ledger.get(fo_rid))}")
        require(failed["finish"] in ("stop", "length"), f"fleet failover: finish {failed['finish']}")
        require(n_fo == 1 and n_died == 1,
                f"fleet failover: failovers +{n_fo}, died +{n_died}, wanted 1 and 1")

        # (f) observability
        ok = st.fleet.scrape_once()
        with urllib.request.urlopen(url + "/metrics", timeout=120) as r:
            text = r.read().decode()
        fams = {name: sorted({ln.split("{")[0] for ln in text.splitlines()
                              if f'{{replica="{name}"' in ln and not ln.startswith("#")})
                for name in engines}
        fl = _get_json(url + "/v1/fleet")
        tl = _get_json(f"{url}/v1/fleet/timeline?request_id={fo_rid}")
        # one process, two engines: each replica's /v1/debug/memory holds the
        # process's bytes in use against its own engine's analytic figure
        mem = _get_json(fleet.replica_urls["r0"] + "/v1/debug/memory")["comparison"]
        print(f"fleet obs: r0's /v1/debug/memory divergence from its own engine's analytic "
              f"figure {mem.get('max_divergence_fraction')} (the process holds both engines)")
        d = tl["dllama"]
        print(f"fleet obs: scrape {ok}; /metrics re-exports {json.dumps({k: len(v) for k, v in fams.items()})} "
              f"families by replica; /v1/fleet replicas {sorted(fl['replicas'])} aggregate "
              f"{json.dumps(fl['aggregate'])}; timeline of {fo_rid}: replicas {d['replicas']}, "
              f"spans by source {json.dumps(d['sources'])}, failovers {json.dumps(d['failovers'])}")
        require(ok == dict.fromkeys(engines, True), f"fleet obs: scrape {ok}")
        for name in engines:
            require("dllama_http_requests_total" in fams[name] and len(fams[name]) > 10,
                    f"fleet obs: /metrics re-exports {fams[name]} for {name}")
        require(set(fl["replicas"]) == set(engines), f"fleet obs: /v1/fleet {fl['replicas']}")
        require(len(d["replicas"]) == 2 and all(d["sources"].get(n, 0) > 0 for n in d["replicas"])
                and "fetch_errors" not in d,
                f"fleet obs: the timeline {json.dumps(d)} does not stitch both replicas")
        # (e) drain r1 with its streams held in flight
        streams = [dict(p, stream=True) for p in payloads]
        sched = reps["r1"].state.scheduler
        entered, release, restore = _gate_step(sched)
        holder: dict = {}

        def mix():
            holder["res"] = _fleet_mix(url, streams)[0]

        th = threading.Thread(target=mix, daemon=True, name="dllama-smoke-mix")
        th.start()
        try:
            require(entered.wait(600), "fleet drain: r1 took no stream")
            status, first = _post_json(f"{url}/v1/drain?replica=r1", {})
        finally:
            release.set()
            restore()
        th.join(timeout=600)
        require(reps["r1"].state.drained.wait(120), "fleet drain: r1 never drained")
        status2, poll = _post_json(fleet.replica_urls["r1"] + "/v1/drain", {})
        health = _get_json(fleet.replica_urls["r1"] + "/v1/health")
        later = [_request(url, p) for p in payloads[:3]]
        landed = [st.ledger.get(r["meta"]["request_id"])["replicas"] for r in later]
        held_ok = [r["finish"] for r in holder.get("res", [])]
        print(f"fleet drain r1: {status} {json.dumps(first)}; the held streams finished "
              f"{held_ok}; then {json.dumps({k: poll[k] for k in ('status', 'in_flight', 'drained')})}, "
              f"health {health['status']}; later requests served by {landed}")
        require(status == 200 and first["status"] == "draining" and first["in_flight"] >= 1,
                f"fleet drain: {status} {first}")
        require(len(held_ok) == len(streams) and all(f in ("stop", "length") for f in held_ok),
                f"fleet drain: the in-flight streams ended {held_ok}")
        require(poll["drained"] and poll["in_flight"] == 0 and health["status"] == "draining",
                f"fleet drain: {poll}, health {health['status']}")
        require(all(x == ["r0"] for x in landed), f"fleet drain: later requests on {landed}")
        counts = launch_counts()
        print(f"fleet launches (bf16 rounds) {json.dumps(counts)}")
        for name in ("q40_matmul", "flash_attention_stats", "flash_decode"):
            require(counts[name] > 0, f"fleet: {name} was not launched in the bf16 rounds")
        anomalies = {n: reps[n].state.anomaly.status().get("active") for n in engines}
        print(f"fleet health after the bf16 rounds: "
              f"{json.dumps({n: reps[n].state.health_snapshot().get('degraded_reasons', []) for n in engines})}; "
              f"anomaly {json.dumps(anomalies)}")
    finally:
        close(fleet)
    del fleet, st, reps, engines, gens

    # (d) failover and chaos in f32, pool-native lanes
    ap = os.path.join(tmp, "accept", "model.m")
    if not os.path.exists(ap):
        os.makedirs(os.path.dirname(ap), exist_ok=True)
        write_synth_model(ap, "llama-8b", seed=SEED, max_seq_len=4096, n_layers=ACCEPT_LAYERS)
    reset_launch_counts()
    fleet, launch_s = launch(ap, torch.float32, True, FLEET_F32_REPLICAS)
    st, url, reps = fleet.router_state, fleet.router_url, dict(fleet.replicas)
    try:
        fo = dict(payloads[2], stream=True)
        st.registry.poll_once()
        victim = st.route(st.prompt_tokens(fo["messages"])).candidates[0]
        clean = _request(url, fo)
        set_fault_plane(FLEET_FAULT.format(victim))
        try:
            failed = _request(url, fo)
        finally:
            set_fault_plane("")
        streams = [dict(p, stream=True) for p in payloads]
        base, _ = _fleet_mix(url, streams)
        f0 = st.m_failovers.value
        st.registry.poll_once()  # the base mix's in-flight counts gone: no replica saturated
        serving = sorted({st.route(st.prompt_tokens(p["messages"])).candidates[0]
                          for p in streams})
        require(len(serving) == 2, f"fleet f32: the mix lands on {serving}, wanted two replicas")
        chaos_spec = FLEET_CHAOS.format(*serving[:2])
        set_fault_plane(chaos_spec)
        try:
            chaos, _ = _fleet_mix(url, streams)
        finally:
            set_fault_plane("")
        n_chaos = st.m_failovers.value - f0
        bad = [i for i, (a, b) in enumerate(zip(base, chaos))
               if a is None or b is None or (a["content"], a["finish"]) != (b["content"],
                                                                           b["finish"])]
        print(f"== llama-8b q40 f32 serving fleet: {ACCEPT_LAYERS} of 32 layers, f32, "
              f"{FLEET_F32_REPLICAS} replicas x {SERVE_LANES} pool-native lanes, launched in "
              f"{launch_s:.1f} s; failover at {victim}'s 3rd flush: bytes equal the fault-free "
              f"stream's {failed['content'] == clean['content']}; chaos {chaos_spec}: "
              f"{n_chaos:.0f} failovers, streams with fault-free bytes "
              f"{len(streams) - len(bad)} of {len(streams)}")
        require(failed["content"] == clean["content"] and failed["finish"] == clean["finish"],
                "fleet f32: the failed-over stream's bytes differ from the fault-free stream's")
        require(n_chaos >= 2 and not bad,
                f"fleet f32 chaos: {n_chaos} failovers, streams {bad} differ")

        f32_counts = launch_counts()
        print(f"fleet launches (f32 rounds) {json.dumps(f32_counts)}")
        for name in ("q40_matmul", "flash_attention_stats", "paged_flash_decode"):
            require(f32_counts[name] > 0, f"fleet f32: {name} was not launched")
    finally:
        close(fleet)
    del fleet, st, reps

    # (g) the subprocess topology
    sub = os.path.join(tmp, "fleet_sub")
    os.makedirs(sub, exist_ok=True)
    sp = os.path.join(sub, "model.m")
    if not os.path.exists(sp):  # written ahead (`start_prewrite`)
        write_synth_model(sp, "llama-8b", seed=SEED, max_seq_len=4096, n_layers=FLEET_SUB_LAYERS)
    base = _free_port_base(3)
    rport = base + 2
    log_path = os.path.join(sub, "launch.log")
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "dllama_tpu_torch.fleet.launch", "--model", sp, "--tokenizer", tp,
           "--n-replicas", "2", "--base-port", str(base), "--port", str(rport), "--batch-size",
           str(SERVE_LANES), "--chat-template", "llama3", "--device", device]
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        # its own session: every process of the fleet shares its group id
        proc = subprocess.Popen(cmd, cwd=root, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        rurl = f"http://127.0.0.1:{rport}"
        health = None
        while time.perf_counter() - t0 < 300 and proc.poll() is None:
            try:
                health = _get_json(rurl + "/v1/health")
                break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        require(health is not None, f"fleet subprocess: the router never answered "
                f"(exit {proc.poll()}): {open(log_path).read()[-2000:]}")
        names = [_get_json(f"http://127.0.0.1:{base + i}/v1/health").get("replica")
                 for i in range(2)]
        r = _request(rurl, dict(payloads[3], stream=True, temperature=0))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
        down_s = time.perf_counter() - t0 - up_s
    finally:
        try:  # whatever of the fleet is left, after a failure
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    out = open(log_path).read()
    ready = re.findall(r"Replica (r\d) healthy after ([0-9.]+) s", out)
    import socket

    def closed(port):
        with socket.socket() as sk:
            return sk.connect_ex(("127.0.0.1", port)) != 0

    gone = all(closed(p) for p in (base, base + 1, rport))
    print(f"fleet subprocess: {FLEET_SUB_LAYERS} of 32 layers, two replica processes, each its "
          f"own CUDA context; replicas healthy after {ready} s (the router up after "
          f"{up_s:.1f} s); /v1/health replica names {names}; a stream through the router "
          f"finished {r['finish']} ({len(r['content'])} chars); SIGTERM: exit {rc} after "
          f"{down_s:.1f} s, every port closed {gone}; {smi}")
    require(names == ["r0", "r1"] and health["replicas"] == {"r0": "healthy", "r1": "healthy"},
            f"fleet subprocess: health {health}, names {names}")
    require(r["finish"] in ("stop", "length"), f"fleet subprocess: finish {r['finish']}")
    require(rc == 0 and gone and len(ready) == 2, f"fleet subprocess: exit {rc}, ports closed "
            f"{gone}, ready {ready}: {out[-2000:]}")
    return {"llama-8b q40 serving fleet": counts, "llama-8b q40 f32 serving fleet": f32_counts}


def run_path(model: str, preset: str, n_layers: int, weight_format: str, tmp: str,
             kv_dtype: str | None = None):
    """Phases 3 and 4 for one model and weight format (and KV dtype, None
    for the engine's): the CLI run (graphed),
    its launch counts against the shapes', graphs against the eager path
    (`graphs_vs_eager`), on llama-8b q40 the sampled streams, on the q40
    runs of both presets the engine's perplexity, and the parity gates.
    The model file lives in tmp (written by the first run on it). Returns
    the run's label, launch counts, greedy tokens and graphed decode tok/s
    (the median of the timed runs)."""
    import torch

    res = end_to_end(
        "cuda", preset, n_layers, PROMPT_TOKENS, DECODE_TOKENS, 4096, SEED, tmp, weight_format,
        kv_dtype,
    )
    h, eng = res["header"], res["engine"]
    kv8 = eng.kv_dtype == torch.int8
    label = f"{model} {eng.weight_format}" + (" kv-int8" if kv8 else "")
    n_dec = res["pred"].n_tokens
    require(n_dec == DECODE_TOKENS, f"{label}: decoded {n_dec} tokens, wanted {DECODE_TOKENS}")
    counts = res["counts"]
    require(eng.prefill_buckets == CLI_BUCKETS,
            f"{label}: the CLI's buckets {eng.prefill_buckets}, wanted {CLI_BUCKETS}")
    want = expected_launches(h, len(res["prompt_tokens"]), n_dec, eng.weight_format, kv8)
    wb = weight_bytes(eng.params, h)
    written = "" if res["write_s"] is None else f"; written in {res['write_s']:.1f} s"
    group = f", int8 group {eng.i8_group}" if eng.i8_group else ""
    print(f"== {label}: {h.n_layers} layers, seq_len {h.seq_len}, weights {eng.weight_format}"
          f"{group}{written}")
    print(f"cli {label}: prefill buckets {eng.prefill_buckets} (--nbatches 32, the default)")
    print(f"e2e {label} load_s {res['load_s']:.2f} prefill_ms {res['eval'].time_ms:.1f} "
          f"({res['eval'].n_tokens} tokens) decode_ms_per_token "
          f"{res['pred'].time_ms / n_dec:.3f} tok_s {n_dec * 1000 / res['pred'].time_ms:.2f} "
          "(graphed; first uses and captures included)")
    print(f"weight bytes per token {wb} -> bound {wb / HBM_BYTES_PER_S * 1e3:.3f} ms/token")
    eng.settle_costs()
    roof = eng.cost_report()["kinds"].get("decode_block") or {}
    frac = roof.get("roofline_fraction")
    print(f"roofline {label} decode_block (the CLI run's registry): key {roof.get('key')}, "
          f"{roof.get('bytes_accessed', 0) / 1e9:.4f} GB a dispatch over "
          f"{(roof.get('mean_step_s') or 0) * 1e3:.3f} device ms (mean of "
          f"{roof.get('dispatches')}), dllama_step_roofline_fraction{{kind=\"decode_block\"}} "
          f"{frac}")
    require(frac is not None and 0 < frac <= OBS_ROOF_MAX,
            f"{label}: decode_block roofline fraction {frac}")
    print(f"on the card after the run: weights {nbytes(eng.params) / 1e9:.3f} GB, "
          f"torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    bf16_kv = 2 * h.n_layers * h.n_kv_heads * h.seq_len * h.head_dim * 2
    print(f"kv cache {label}: {nbytes(eng.cache)} B on the card ({eng.kv_dtype}), a bf16 cache "
          f"of the same rows {bf16_kv} B: {nbytes(eng.cache) / bf16_kv:.4f}x")
    print(f"launches {json.dumps(counts)} expected {json.dumps(want)}")
    for name, c in counts.items():
        require(c == want[name], f"{label} {name}: {c} launches, the shapes imply {want[name]}")
        if want[name]:
            require(c > 0, f"{label}: {name} was never launched on the main path")
    decode_ms = graphs_vs_eager(eng, res, want, label)
    if label == "llama-8b q40":
        sampled_streams(eng, res["prompt_tokens"])
    if eng.weight_format == "q40":
        perplexity_check(eng, res["prompt_tokens"], label)
    if label == "llama-8b q40":
        # the single step's graph ("step", greedy) too, for the lint's census
        eng.reset()
        eng.decode_step(res["prompt_tokens"][0], 0)
        eng.reset()
    graph_lint(eng, label)
    par = parity(eng, res["prompt_tokens"])
    for (name, tag), p in par.items():
        if name == "routing":
            print(f"parity routing, {tag}: {p['differ']} of {p['of']} (layer, token) top-k "
                  "expert sets differ")
        elif name == "graphs":
            print(f"parity {tag} f32 kernel graphed vs eager: bits equal {p['equal']}, logits "
                  f"err {p['err']:.3e}")
        elif name == "nll":
            print(f"parity nll f32 kernel vs plain: {p['kernel']!r} vs {p['plain']!r}, diff "
                  f"{p['diff']:.3e}, limit {p['tol']:.3e} (2 x TOL_E2E x max|plain logits|); "
                  f"largest logit error {p['logit_err']:.3e} (2x it: {2 * p['logit_err']:.3e})")
        elif tag == "int8 inputs":
            print(f"parity {name} f32 {SHARED}: the inputs of {p['calls']} int8 matmuls err "
                  f"{p['err']:.3e} against the kernel path's; the plain path's own quantization "
                  f"would round {p['flips']} of {p['values']} int8 values otherwise")
        else:
            print(f"parity {name} {tag}: logits err {p['err']:.3e} top1 {p['top1']} "
                  f"top5_overlap {p['top5_overlap']}/5")
    # with int8 weights the gate shares the kernel path's int8 activations
    # with the plain path (see parity)
    int8 = ("prefill", "int8 inputs") in par
    gates = [f"f32 kernel vs {SHARED}", "int8 inputs"] if int8 else ["f32 kernel vs plain"]
    for name in ("prefill", "decode"):
        for gate in gates:
            err = par[name, gate]["err"]
            require(err <= TOL_E2E, f"{label} {name}: {gate} err {err:.3e} > {TOL_E2E}")
        # a replay launches the eager run's kernels on the same inputs; the
        # dense run's cuBLAS products picked the same algorithms under
        # capture too (PERF.md §6)
        g = par["graphs", name]
        require(g["equal"], f"{label} {name}: f32 kernel logits graphed vs eager err "
                f"{g['err']:.3e}, not the same bits")
    nll = par["nll", "f32 kernel vs plain"]
    if not int8:
        require(nll["diff"] <= nll["tol"],
                f"{label}: f32 NLL kernel vs plain differ by {nll['diff']:.3e} > {nll['tol']:.3e}")
    return label, counts, res["tokens"], 1e3 / decode_ms


if __name__ == "__main__":
    sys.exit(main())
