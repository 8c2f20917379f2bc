#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and ``nvcc``; without a card, or outside a checkout, it exits non-zero
and prints no result. Phases, in order (any failure exits non-zero):

  1. probe  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build  — compiles the kernels from ``src/repro_torch/csrc`` with
     nvcc for sm_90a, one nvcc per source in parallel; prints the build
     time and ptxas' register and spill lines of every kernel (K9's four
     instantiations among them), then one line per head_dim 256 kernel:
     its registers, spill stores and loads, and whether ptxas serialised
     its wgmma (C7512);
  3. kernels — each kernel against its plain PyTorch version on the card,
     at llama3-8b widths in bf16 (Hq 32, Hkv 8, D 128, page size 16):
     max error at a stated tolerance, CUDA-event median times of kernel and
     plain version, and the bound (bytes over 3.35 TB/s vs operations over
     989 TFLOP/s, the H100 SXM data-sheet peaks). K1 in bf16 is the
     tensor-core kernel: every launch order (head-first and block-first
     bitwise equal), window + softcap, hymba-1.5b's widths (timed with SDPA
     beside it); K1 in float32 (the CUDA-core kernel) held at 2e-5 and
     timed at the same B 2, S 2048; K1 with per-row query offsets and
     kv_len (three rows at 0, 700 and 1536 over 2048 keys, causal and
     window 300) in bf16 and float32 against the plain version, offset 0
     as arrays bit for bit the null pointers', 100 reruns bitwise equal,
     and K1 at the gather route's shape (8 rows, queries 1024 .. 1279)
     timed beside its bound and SDPA under an explicit mask; then K2
     (paged prefix prefill; bf16 on the tensor cores) at B 2, prefix 1000,
     tail 256 and at the paged serve run's extend shape, every launch on the tensor cores, rows past
     tail_len exactly zero, ten reruns bitwise equal, timed with the launch
     queue primed and without, gather + SDPA beside it as a two-call
     yardstick; K2 in float32 (the CUDA-core kernel) held at 2e-5 and timed;
     then K3 / K4 (paged decode, one
     pass and split-K; bf16 on the tensor cores) at B 8 with lengths up to
     4096 and at the paged serve run's decode shape, every launch on the
     tensor cores, ten reruns bitwise equal, timed with the launch queue
     primed and without, gather + SDPA beside them as a two-call
     yardstick; K3 / K4 in float32 (the CUDA-core kernels) at B 8, lengths
     up to 4096, 1 and 4 splits, held at 2e-5 and timed. Then K3q / K4q and
     K2q, the same kernels over int8 and fp8 pools (codes and per-page
     scales; bf16 q on the tensor cores: K3q / K4q with the codes widened
     to bf16 and the scales folded into S and P, K2q with each code times
     its page's scale rounded to bf16 into K2's stages, bit for bit K2 over
     the dequantized values; float32 q on the CUDA cores), at those shapes,
     the serve run (a)'s decode and extend shapes with rows frozen on a
     null page of NaN scales and run (b)'s at 1, 2, 4 and 8 splits: bf16 q
     against the plain version per row, float32 q at 2e-5, against the
     unquantized bf16 kernel within the JAX suite's budget (int8 0.03, fp8
     0.12), ten reruns bitwise equal, each timed beside the CUDA-core walk
     it replaced. Then K5
     (dQ) and K6 (dK/dV) in bf16, on the tensor cores, under both launch
     orders (bitwise equal), with window + softcap, and at S 1000 padded to
     1024 (kv_len masking), SDPA's backward as the library yardstick; K5 /
     K6 in float32 (the CUDA-core kernels) held per slice at 1e-5 and timed
     at the same B 2, S 2048; then K7 / K8 (dense decode, one pass and
     split-K; bf16 on the tensor cores) at llama3-8b and hymba-1.5b widths
     (window 1024 and global) and at hymba's serve batch, one pass against
     4 splits, SDPA on the expanded, masked stripes as the library
     yardstick, both timed with the launch queue primed; K7 / K8 in float32
     (the CUDA-core kernel) held at 2e-5 and timed; then K9
     (SSD intra-chunk, on the tensor cores in 3xTF32) at hymba-1.5b's and
     mamba2-1.3b's prefill shapes, in the layout ``ssd_chunked_cuda`` gives
     it (B and C per group, G 1), held per slice at 1e-5, ten reruns
     bitwise equal, its bound at the TF32 peak beside the float32 one, and
     the whole SSD scan timed part by part; then K1, K2, K3, K4, K7 and K8
     at head_dim 256 (``check_gemma_kernels``), at gemma2-2b's widths (Hq
     8, Hkv 4, softcap 50, window 4096) and gemma3-1b's (Hq 4, Hkv 1,
     window 512), each against its plain version per row, 100 reruns
     bitwise equal, CUDA-event times, the bound and SDPA where one call
     computes the same function, and K1 (global and window 4096) and K7 /
     K8 at gemma2-2b's widths once more without the softcap, beside SDPA,
     which has none (the like-for-like library row), and K3q / K4q and K2q
     at head_dim 256 over int8 and fp8 pools with a NaN null page
     (``check_gemma_quantized``: B 8 global and windowed, the serve runs'
     decode shapes with rows frozen on the null page, run (b)'s one row of
     4200 at 1, 2, 4 and 8 splits beside the split estimator's pick, K2q at
     prefix 1000 / tail 256 and the serve extend shape; per row against the
     plain version, against the unquantized kernel within QTOL, ten reruns
     bitwise equal, K2q bit for bit K2 over the dequantized pools, each
     timed beside the bf16 kernel on bf16 pools); then K5 / K6 at
     head_dim 256 (``check_gemma_backward``) at each model's train shape
     (gemma2-2b B 1, S 8192; gemma3-1b B 2, S 4096), global and the local
     window, with the softcap: per (b, head) slice within 2^-6 of the plain
     backward, 100 reruns and the block-first order bitwise equal, every
     launch on the tensor cores, times (queue primed and without: the
     wrappers' host time shows in the second), bounds and SDPA's
     backward like for like (no softcap, the window as a mask; its refusal
     printed if it refuses), K6's part count and its longest block's walk
     against the mean;
  3b. plan — the plan's models against the card: (a) bf16 K3 / K4 at
     llama3-8b widths, every row full, B 1, 2, 4, 8 over tables of 128 and
     256 pages (and the serve runs' 8 x 36 and 1 x 260) at 1, 2, 3, 4, 6,
     8, 12 and 16 splits and the plan's pick, CUDA events with the queue
     primed and one replay of a one-launch CUDA graph; per shape the
     committed split model's time per split count, the measured times and
     the plan's pick (it fails where the graph time at the pick exceeds
     1.15x the fastest); a fit of the model's terms to the shapes not held
     out, with its error per split at every shape, held-out ones included,
     beside the committed model's and the model's before the fit; (b) bf16
     K1 under the plan's three candidate launches (head-first linear,
     head-first sawtooth, block-first) at llama3-8b's B 2, S 2048 and B 1,
     S 8192 and hymba-1.5b's windowed B 1, S 4096, beside the mapping
     model's times under three readings of an H100 domain (SM, L2 half,
     whole L2) and the scorer's pick (it fails where K1 at the pick exceeds
     1.10x the fastest launch), then K1 + K5 + K6 at the train shape under
     both orders; (c) round trips of 1, 2, 4 and 8 llama3-8b page payloads
     to pinned host and back, and the host-link fit; (d) the paged extend's
     two routes, K2 against the gather route (``tools/prefill_ab.extend_ab``:
     K2, the whole route, its copies and K1 alone) at 11 llama3-8b (rows,
     prefix, tail) shapes, a fit of the H100's extend terms to 8 of them,
     the committed model's and the fit's times at all 11, and the plan's
     route (it fails where the route takes more than 1.10x the faster).
     ``python3 chip_smoke.py --phase plan`` runs the probe, the build and
     this phase alone and prints no result line; ``--phase extend`` runs
     K1's offset checks and part (d) alone;
  4. serve  — ``LLMEngine(kv_layout="paged")`` on full-width llama3-8b with
     random bf16 weights: (a) 8 greedy requests of 512 tokens sharing a
     256-token system prefix, (b) one 4096-token request, 32 new tokens
     each, each run on an engine sized for it (a decode sync runs every row
     over the whole page table as one CUDA graph replay, so the rows and the
     table's width set the decode plan: one pass over (a)'s 8 rows of 36
     pages, split-K over (b)'s one row of 260); every kernel's launch count
     over that run must be
     above 0, and every K1, K2 and K3 / K4 launch on the tensor cores. Then
     each run once more for one sync at ``steps_per_sync=1`` through
     ``engine.step()``, at its own engine sizes, kernel path against the
     plain path (whose tick is a captured graph too): every request's
     prefill logits and its decode tick's logits from the graph, and the
     greedy ids (``compare_sync``). Then (a) and (b) again over int8 and
     over fp8 pools (K2q on (a)'s extend wave, K3q and K4q in the decode
     graphs, every launch counted, every K2q / K3q / K4q launch on the
     tensor cores, none on an unquantized paged kernel),
     each held to the plain path on the same format by ``compare_sync``, its
     logits against the bf16 pool's printed, and the pool's bytes; then
     run (a) with the paged extend's gather route pinned
     (``attn_impl="gather"``) over a bf16 and an int8 pool: K1 launched (on
     the tensor cores) and K2 / K2q not, and one sync held to the K2
     route's by ``compare_sync``; then the host tier: a 48-page pool with
     1 GiB of host memory behind it, a prompt served, pushed host-side by
     three others and served again, its
     ids equal to an untiered engine's, pages demoted and promoted, and one
     page's payload timed both ways over the host link. Then the fused decode on (a)'s
     engine: ``steps_per_sync`` 1, 8 and "auto" on the same weights must
     give identical ids, each run's decode tok/s, graphs captured and launch
     counts printed; the eager tick (the one-tick graph's tick function run
     without the graph) against one
     replay of the one-tick graph, both with CUDA events; the host clock of
     one steps_per_sync=1 sync minus that graph's device time (which sets
     ``perf_model.HOST_SYNC_OVERHEAD_S``); and a torch.profiler summary of
     an eager tick and of an 8-tick replay (device-busy share, top device
     ops). Then the same weights served from dense stripes
     (``kv_layout="dense"``), then hymba-1.5b at full width and 16 of its
     32 layers (two periods of one global and seven window-1024 layers) through
     ``LLMEngine(cfg, params)`` (``kv_layout`` resolves to dense): 8 greedy
     requests off the prompt buckets, several past the 1024 window, on
     2048-token stripes (one pass, K7), then one of 4000 tokens alone on
     4096-token stripes, whose decode the plan splits (K8); then
     mamba2-1.3b at full width and 24 of its 48 layers (both cuts keep the
     whole smoke near half its time limit). Each dense run must launch its kernels (every
     K7 / K8 launch of the llama and hymba runs on the tensor cores; one K9
     launch, on the tensor cores, per SSM layer per prefill) and
     hold one sync of each run to the plain path's (every kernel off:
     ``attn_impl`` and ``ssm.impl`` "plain"; ``compare_sync`` as above);
     each dense path then runs the fused
     decode at ``steps_per_sync`` 1 and 8 (identical ids) and times its
     eager and one-tick graph ticks. Then, before the llama weights leave
     the card, the load phase: ``repro_torch.launch.loadgen.run_one`` with
     telemetry on, full-width llama3-8b paged (8 rows, a 1024-page pool of
     2 GiB, prompt buckets 256 / 512 / 1024), 32 requests of a Poisson trace
     at 4 requests/s (prompt tails 128 / 384 / 768, a 256-token prefix on
     half, 32 / 64 / 128 new tokens, greedy, seed 0), at ``steps_per_sync``
     1 and 8, artifacts in a temporary directory: each run passes the
     harness's smoke check, its streamed tokens equal those its requests
     hold, every lifecycle runs arrival ... finish, the open-loop drive
     launches K1, K2 and K3 (or K4, if the plan splits) on the tensor cores,
     and N 1 captures no graph after warm-up; it prints TTFT (to the first
     streamed token, and to the first sampled one), ITL and queue
     p50/p90/p99, measured and modelled tok/s, host overhead per token, the
     scheduler's occupancy cap (an integer in 1..8), the drift table, each
     beside the card's name and power limit; then one sync
     of that engine against the plain path (``compare_sync``), and 8
     closed-loop requests with the same greedy ids with telemetry on and
     off, their decode tok/s side by side. Then the gemma family at full
     width, head_dim 256 (``serve_gemma``): gemma2-2b and gemma3-1b paged
     ((a) 8 requests sharing a 256-token prefix on an engine of 16 or 64
     rows, so the plan decodes in one pass: K1, K2, K3; (b) one row of
     4200 tokens, past gemma2's window of 4096: K4), dense (32 rows of 2048
     or 128 of 1024: K1, K7; one row of 4400 alone: K8), every run held to
     the plain path by ``compare_sync``, paged (a) and (b) again over int8
     and over fp8 pools (``serve_quantized``: K2q, K3q and K4q at head_dim
     256, every launch on the tensor cores, none on an unquantized kernel,
     one sync of each run held to the plain path on the same format), and
     the fused decode on (a)'s engine at ``steps_per_sync`` 1 and 8.
     ``python3 chip_smoke.py --phase
     gemma`` runs the head_dim 256 kernels, these runs and the gemma train
     phases alone, with no result line;
  5. train  — ``Trainer`` + ``make_train_step`` on llama3-8b at full width
     cut to 4 layers (float32 masters and AdamW moments of all 32 layers
     need ~128 GB), sequence 4096, global batch 4 in 2 microbatches, bf16
     compute, remat, 3 steps; K1, K5 and K6 must each launch as often as the
     layer count predicts (every path's K1 launches, and every K5 / K6
     launch, on the tensor cores); then the step's attention kernels held
     against their plain versions at its shapes (B 2, S 4096) and, with its
     float32 LM head, timed alone there (K1 with SDPA beside it, K5 + K6
     with SDPA's backward), beside the step time; then one step's
     gradients at 2 layers, sequence 1024, kernel path against the plain
     path. Then the same for gemma2-2b (4 layers: 2 local with window 4096,
     2 global; sequence 8192, batch 2 in 2 microbatches) and gemma3-1b (6
     layers: 5 local with window 512, 1 global; sequence 4096, batch 4 in 2
     microbatches) at full width, head_dim 256: K5 and K6 on the tensor
     cores at D 256, the float32 LM head over 256000 / 262144 words, the
     breakdown per distinct window of the layers.

It ends with one JSON line of per-kernel numbers and, last, the line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 off the tensor cores, data sheet
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 on the tensor cores, data sheet
PEAK_HBM_BW = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
# bf16 outputs against their plain versions, per row: max |o - ref| over
# max |ref| of that row (a row of ref that is all zero must be exactly zero).
# Two outputs that round differently to bf16 differ by one ulp, at most
# 2^-7 of the row's max; a dropped page or a mis-masked tile of a 4096-key
# row moves o by ~2^-4 of its row max.
ROW_TOL = 2.0**-6
LSE_TOL = 1e-5             # float32 logsumexp, |lse| ~ 8: about 10 ulp
# K1 in float32 (CUDA cores) against its plain version: both sum float32
# products, in another order (the card tests' bar).
F32_TOL = 2e-5
# K5 / K6 in float32 (CUDA cores) against the plain backward, per (b, head)
# slice of each gradient: float32 sums in another order differ by ~1e-6 of a
# slice's max (the card tests' bar).
GRAD_F32_TOL = 1e-5
# K9 (float32 in and out; its products in 3xTF32 on the tensor cores, about
# 22 bits each) against its plain version, per (b, chunk, head) slice: max
# |y - ref| over max |ref|. Both sum over at most q + N terms in another
# order (about 1e-6 relative); a dropped or mis-masked key tile moves y by
# a large fraction of its max, a single TF32 pass by ~5e-4.
SSD_TOL = 1e-5
# Logits of the kernel path against the plain path, relative to max |logit|:
# bf16 attention outputs round differently in the two paths (~2^-8
# relative) and the difference compounds over 32 layers.
LOGIT_TOL = 5e-2
# Train phase: the kernel path's step-1 loss and gradients against the
# plain path's (same weights and batch, bf16 compute). The loss agrees as
# the logits do; each gradient leaf is held by its relative norm.
TRAIN_LOSS_TOL = 1e-2
# Read 5.4e-3 at most (median 2.2e-3) at 2 layers, seq 1024 on an NVIDIA
# H100 80GB HBM3 at 700 W: bf16 attention outputs that round differently in
# the two paths, and the tensor-core backward's P and dS rounded to bf16
# before their products, carried through the backward pass (3.3e-3 at most
# with the float32 CUDA-core backward). 1e-2 keeps ~2x headroom; each
# kernel is also held per slice in phase 3.
TRAIN_GRAD_TOL = 1e-2
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 4, 2, 3
HYMBA_LAYERS, MAMBA_LAYERS = 16, 24   # the serve phase's depth cuts (``main``)
REPS = 20                  # timed runs per case; the median is reported
PRIME_CYCLES = 2_000_000   # ~1 ms of the card's clock: longer than any wrapper's host time
HQ, HKV, D, PS = 32, 8, 128, 16

KERNELS = {
    "K1": dict(name="K1 flash_attention_fwd (bf16, tensor cores)",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:361",
               counter="flash_attention_fwd_tc"),
    "K2": dict(name="K2 paged_flash_prefill (bf16, tensor cores)",
               source="src/repro_torch/csrc/paged_prefill.cu",
               replaces="src/repro/kernels/paged_prefill_attention.py:277",
               counter="paged_flash_prefill_tc"),
    "K3": dict(name="K3 paged_flash_decode (bf16, tensor cores)",
               source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/paged_decode_attention.py:262",
               counter="paged_flash_decode_tc"),
    "K4": dict(name="K4 paged_flash_decode_split+combine (bf16, tensor cores)",
               source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/paged_decode_attention.py:323",
               counter="paged_flash_decode_split_tc"),
    "K5": dict(name="K5 flash_attention_bwd_dq (bf16, tensor cores)",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention_bwd.py:228",
               counter="flash_attention_bwd_dq_tc"),
    "K6": dict(name="K6 flash_attention_bwd_dkv (bf16, tensor cores)",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention_bwd.py:279",
               counter="flash_attention_bwd_dkv_tc"),
    "K7": dict(name="K7 flash_decode (bf16, tensor cores)",
               source="src/repro_torch/csrc/dense_decode.cu",
               replaces="src/repro/kernels/decode_attention.py:175",
               counter="flash_decode_tc"),
    "K8": dict(name="K8 flash_decode_split+combine (bf16, tensor cores)",
               source="src/repro_torch/csrc/dense_decode.cu",
               replaces="src/repro/kernels/decode_attention.py:227",
               counter="flash_decode_split_tc"),
    "K9": dict(name="K9 ssd_intra_chunk (float32, tensor cores in 3xTF32)",
               source="src/repro_torch/csrc/ssd.cu",
               replaces="src/repro/kernels/ssd.py:83", counter="ssd_intra_chunk_tc"),
    "K2q": dict(name="K2q paged_flash_prefill, quantized pool (int8 codes, bf16 q, tensor "
                     "cores)",
                source="src/repro_torch/csrc/paged_prefill.cu",
                replaces="src/repro/kernels/paged_prefill_attention.py:277",
                counter="paged_flash_prefill_q_tc"),
    "K3q": dict(name="K3q paged_flash_decode, quantized pool (int8 codes, bf16 q, tensor cores)",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_decode_attention.py:262",
                counter="paged_flash_decode_q_tc"),
    "K4q": dict(name="K4q paged_flash_decode_split+combine, quantized pool (int8 codes, bf16 q, "
                     "tensor cores)",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_decode_attention.py:323",
                counter="paged_flash_decode_split_q_tc"),
}
#: Quantized pools against the unquantized kernel, max |o_q - o|: the JAX
#: suite's budget per format (tests/test_tiering.py QTOL), which averages
#: the codes' error over the keys of a row. An fp8 row of fewer keys than a
#: page averages over too few (a 1-key row outputs its one V row), so such
#: a row is held within QTOL plus the largest rounding error its own V codes
#: were measured to carry against the bf16 values.
QTOL = {"int8": 0.03, "fp8": 0.12}


#: The phase under way (the last "== " line logged) and when it began.
_phase = {"name": None, "t": 0.0}


def log(msg=""):
    """Print ``msg``; a line that opens a phase ("== ...") first prints how
    long the last phase took (host clock), for the time budget."""
    if msg.startswith("== "):
        now = time.perf_counter()
        if _phase["name"]:
            print(f"(phase {_phase['name']!r}: {now - _phase['t']:.1f} s)", flush=True)
        _phase.update(name=msg[3:].split("\n")[0][:60], t=now)
    print(msg, flush=True)


def ptxas_d256(log_text: str) -> list:
    """(kernel, registers, spill stores, spill loads, wgmma serialised) of
    each head_dim 256 tensor-core kernel in one library's ptxas log."""
    rows, cur, serialised = [], None, set()
    for line in log_text.splitlines():
        if "C7512" in line:
            serialised.add(line.rsplit("'", 2)[-2] if "'" in line else "")
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            rows.append([cur, None, None, None])
        elif cur and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            rows[-1][2:4] = nums[1:3]
        elif cur and "Used" in line and "registers" in line:
            rows[-1][1] = int(line.split("Used")[1].split()[0])
    out = []
    for name, regs, st, ld in rows:
        # A kernel templated on head_dim 256, or one written for it alone
        # (K5 / K6's ``*_tc256_kernel``).
        m = re.search(r"(\w+_tc(?:256)?_kernel)I((?:L[ib]\d+E)+)", name)
        if m is None or ("Li256E" not in m.group(2) and "tc256_kernel" not in m.group(1)):
            continue
        ident = m.group(1)   # ...<length><kernel name>, the Itanium mangling
        kernel = next((ident[n.end():] for n in re.finditer(r"\d+", ident)
                       if len(ident) - n.end() == int(n.group())), ident)
        args = ", ".join(re.findall(r"L[ib](\d+)E", m.group(2)))
        out.append((f"{kernel}<{args}>", regs, st, ld, name in serialised))
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing and bounds -------------------------------------------------------

class Timer:
    """CUDA-event medians of REPS runs; a 64 MB write before each run
    leaves the 50 MB L2 cold, as the serving path finds it. ``primed``
    puts a ~1 ms spin on the card before the start event, so the host has
    enqueued every launch of ``fn`` before the card reaches them: the
    reading is then the card's time alone, also where the wrapper takes
    longer on the host than its kernel on the card."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, primed=False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            self.flush.zero_()
            if primed:
                torch.cuda._sleep(PRIME_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_mem, t_ops = nbytes / PEAK_HBM_BW, flops / peak_flops
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bound_of(q, k, v, o, lse, *, causal, window=None, peak=PEAK_BF16_FLOPS):
    """K1's bound: q, k, v read and o, lse written once, against the two
    products' operations over the (row, key) pairs the masks leave live
    (causal: row r sees min(r + 1, window) keys)."""
    b, hq, s, d = q.shape
    seen = [min(r + 1, window or s) if causal else s for r in range(s)]
    return bound(nbytes(q, k, v, o, lse), 4.0 * d * b * hq * sum(seen), peak)


def rel_err(a, ref, dims: int) -> float:
    """max |a - ref| / max |ref| over the last ``dims`` axes (a row, or a
    (b, head) slice of a gradient), the worst over the rest; where ref is
    all zero, a must be exactly zero."""
    import torch

    diff = (a.float() - ref.float()).abs().flatten(-dims).amax(-1)
    den = ref.float().abs().flatten(-dims).amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


def row_err(a, ref) -> float:
    return rel_err(a, ref, 1)


def slice_err(g, ref) -> float:
    return rel_err(g, ref, 2)


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_k1_route(label, counts):
    """Every K1 launch of a bf16 main path went to the tensor-core kernel."""
    total, tc = counts["flash_attention_fwd"], counts["flash_attention_fwd_tc"]
    log(f"{label}: K1 launches {total}, on the tensor cores {tc}")
    if tc != total:
        raise AssertionError(f"{label}: {total - tc} K1 launches missed the tensor-core kernel")


def bwd_launches(before, after):
    """K5 and K6 launches between two reads of the counters: (all, on the
    tensor cores) for each."""
    return {key: (after[f"flash_attention_bwd_{key}"] - before[f"flash_attention_bwd_{key}"],
                  after[f"flash_attention_bwd_{key}_tc"] - before[f"flash_attention_bwd_{key}_tc"])
            for key in ("dq", "dkv")}


def check_bwd_route(label, launched, tensor_cores=True):
    """K5 and K6 launched, each on the tensor cores (bf16) or each on the
    CUDA cores (float32)."""
    log(f"{label}: K5 / K6 launches (all, on the tensor cores) {launched}")
    for key, (total, tc) in launched.items():
        if total <= 0 or tc != (total if tensor_cores else 0):
            raise AssertionError(f"{label}: {key} launches {total}, {tc} on the tensor cores")


# -- phase 3: kernels against their plain versions ---------------------------

def check_kernels(torch, timer, results):
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_prefill_attention as pp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # K1 (bf16, the tensor-core kernel): B 2, S 2048, causal, every mapping;
    # head-first and block-first must give the same bits.
    b, s = 2, 2048
    q, k, v = randn(b, HQ, s, D), randn(b, HKV, s, D), randn(b, HKV, s, D)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    k1_bound = k1_bound_of(q, k, v, o_ref, lse_ref, causal=True)
    # The three distinct launches: the paper's naive_/swizzled_ names are
    # aliases of the two orders (kernels/flash_attention.py).
    mappings = [("head_first", fa.MappingConfig(order=fa.HEAD_FIRST)),
                ("block_first", fa.MappingConfig(order=fa.BLOCK_FIRST)),
                ("head_first+sawtooth", fa.MappingConfig(order=fa.HEAD_FIRST,
                                                         traversal="sawtooth"))]
    k1_main, outs = None, {}
    for name, mapping in mappings:
        o, lse = outs[name] = fa.flash_attention_fwd(q, k, v, mapping=mapping, causal=True)
        torch.cuda.synchronize()
        e_o, e_r, e_l = err(o, o_ref), row_err(o, o_ref), err(lse, lse_ref)
        ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, mapping=mapping, causal=True))
        log(f"K1 {name}: max_err o {e_o:.3e} (row-relative {e_r:.3e}, tol {ROW_TOL:.3e}) "
            f"lse {e_l:.3e} (tol {LSE_TOL}) {ms:.4f} ms, bound {k1_bound[0]:.4f} ms "
            f"({k1_bound[1]})")
        if e_r > ROW_TOL or e_l > LSE_TOL:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        if k1_main is None:
            k1_main = (max(e_o, e_l), ms)
    same = all(torch.equal(a, b_) for a, b_ in zip(outs["head_first"], outs["block_first"]))
    log(f"K1 head-first and block-first bitwise equal: {same}")
    if not same:
        raise AssertionError("K1's launch order changed its output")
    del outs
    plain_ms = timer.ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True))
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True))
    log(f"K1 plain {plain_ms:.3f} ms, library sdpa {lib_ms:.4f} ms")
    results["K1"] = dict(max_abs_err=k1_main[0], ms=k1_main[1], plain_ms=plain_ms,
                         bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=lib_ms)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=512, softcap=50.0)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=512,
                                                  softcap=50.0)
    e_o, e_r, e_l = err(o, o_ref), row_err(o, o_ref), err(lse, lse_ref)
    log(f"K1 window 512 + softcap 50: max_err o {e_o:.3e} (row-relative {e_r:.3e}) "
        f"lse {e_l:.3e}")
    if e_r > ROW_TOL or e_l > LSE_TOL:
        raise AssertionError("K1 window+softcap disagrees with its plain version")
    del q, k, v, o, lse, o_ref, lse_ref

    # K1 at hymba-1.5b's prefill widths: Hq 25, Hkv 5 (a GQA group of 5),
    # D 64, S 4096, global and window 1024 (tile skips at D 64); timed, with
    # SDPA beside it (the window as an explicit mask).
    s = 4096
    q, k, v = randn(1, 25, s, 64), randn(1, 5, s, 64), randn(1, 5, s, 64)
    for window in (None, 1024):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        e_r, e_l = row_err(o, o_ref), err(lse, lse_ref)
        hb = k1_bound_of(q, k, v, o, lse, causal=True, window=window)
        ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True, window=window))
        if window is None:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)
        else:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                          enable_gqa=True)
        lib = timer.ms(sdpa)
        log(f"K1 hymba-1.5b widths (Hq 25, Hkv 5, D 64, S {s}, window {window}): o "
            f"row-relative {e_r:.3e} (tol {ROW_TOL:.3e}) lse {e_l:.3e} (tol {LSE_TOL}); "
            f"{ms:.4f} ms, library sdpa {lib:.4f} ms, bound {hb[0]:.4f} ms ({hb[1]})")
        if e_r > ROW_TOL or e_l > LSE_TOL:
            raise AssertionError("K1 at hymba widths disagrees with its plain version")
        del o, lse, o_ref, lse_ref
    del q, k, v

    # K1 in float32 stays on the CUDA cores: held at 2e-5 (both sum float32),
    # then timed at the bf16 case's shape against the float32 peak.
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((1, HQ, 300, D), (1, HKV, 300, D), (1, HKV, 300, D)))
    counts0 = kernels.launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    counts1 = kernels.launch_counts()
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    e_o, e_l = err(o, o_ref), err(lse, lse_ref)
    on_cuda_cores = (counts1["flash_attention_fwd"] - counts0["flash_attention_fwd"] == 1
                     and counts1["flash_attention_fwd_tc"] == counts0["flash_attention_fwd_tc"])
    log(f"K1 float32 (CUDA cores, Hq 32, Hkv 8, S 300, causal): max_err o {e_o:.3e} lse "
        f"{e_l:.3e} (tol {F32_TOL}); CUDA-core entry: {on_cuda_cores}")
    if e_o > F32_TOL or e_l > F32_TOL or not on_cuda_cores:
        raise AssertionError("K1 float32 disagrees with its plain version")
    b, s = 2, 2048
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, HQ, s, D), (b, HKV, s, D), (b, HKV, s, D)))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fb = k1_bound_of(q, k, v, o, lse, causal=True, peak=PEAK_F32_FLOPS)
    ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = timer.ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True))
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True))
    log(f"K1 float32 (CUDA cores) B {b} S {s} causal: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library sdpa {lib_ms:.3f} ms, bound {fb[0]:.4f} ms ({fb[1]}, float32 peak)")
    del q, k, v, o, lse, o_ref, lse_ref

    check_k1_offsets(torch, timer, gen)
    check_paged_prefill(torch, timer, results, gen)
    check_paged_decode(torch, timer, results, gen)
    check_quantized(torch, timer, results, gen)


def check_k1_offsets(torch, timer, gen):
    """K1 with per-row query offsets against its plain version: three rows of
    512 queries at offsets 0, 700 and 1536 over 2048 keys, each its own
    kv_len (the second 12 keys short of its last query), causal and with
    window 300, bf16 on the tensor cores per row within ROW_TOL and lse
    within LSE_TOL, float32 on the CUDA cores within F32_TOL; an explicit
    offset of 0 (the kernel's arrays, not its null pointers) bit for bit
    the null pointers' output; 100 reruns bitwise equal. Then K1 at the
    gather route's shape (8 rows, a 1024-token prefix, a 256-token tail)
    timed beside its bound and SDPA under the same mask as an explicit
    one. Every launch counts under K1."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa

    def inputs(dtype, b, sq, skv):
        randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return randn(b, HQ, sq, D), randn(b, HKV, skv, D), randn(b, HKV, skv, D)

    off = torch.tensor([0, 700, 1536], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([512, 1200, 2048], dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(dtype, 3, 512, 2048)
        for window in (None, 300):
            kw = dict(causal=True, window=window, q_offset=off, kv_len=kv_len)
            kernels.reset_launch_counts()
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            counts = kernels.launch_counts()
            o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            tc = counts["flash_attention_fwd_tc"] == (dtype == torch.bfloat16)
            if dtype == torch.bfloat16:
                e_o, e_l = row_err(o, o_ref), err(lse, lse_ref)
                ok = e_o <= ROW_TOL and e_l <= LSE_TOL
                bars = (f"o row-relative {e_o:.3e} (tol {ROW_TOL:.3e}) lse {e_l:.3e} "
                        f"(tol {LSE_TOL})")
            else:
                e_o, e_l = err(o, o_ref), err(lse, lse_ref)
                ok = e_o <= F32_TOL and e_l <= F32_TOL
                bars = f"o {e_o:.3e} lse {e_l:.3e} (tol {F32_TOL})"
            log(f"K1 offsets {dtype}, rows at 0 / 700 / 1536, kv_len 512 / 1200 / 2048, "
                f"window {window}: {bars}; launches {counts['flash_attention_fwd']}, on the "
                f"tensor cores {counts['flash_attention_fwd_tc']}")
            if not ok or counts["flash_attention_fwd"] != 1 or not tc:
                raise AssertionError(f"K1 offsets {dtype} window {window} disagree with the "
                                     "plain version")
        del q, k, v, o, lse, o_ref, lse_ref

    # Offset 0 through the kernel's arrays against its null pointers, and
    # 100 reruns of the ragged case, bit for bit.
    q, k, v = inputs(torch.bfloat16, 2, 2048, 2048)
    zero = torch.zeros((2,), dtype=torch.int32, device="cuda")
    full = torch.full((2,), 2048, dtype=torch.int32, device="cuda")
    for window in (None, 300):
        null = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
        arrays = fa.flash_attention_fwd(q, k, v, causal=True, window=window, q_offset=zero,
                                        kv_len=full)
        same = all(torch.equal(a, b_) for a, b_ in zip(null, arrays))
        log(f"K1 offset 0 as (B,) arrays, B 2, S 2048, window {window}: o and lse bitwise "
            f"equal to the null pointers' {same}")
        if not same:
            raise AssertionError("K1 with offset 0 as arrays changed its output")
    q, k, v = inputs(torch.bfloat16, 3, 512, 2048)
    run = lambda: fa.flash_attention_fwd(q, k, v, causal=True, q_offset=off, kv_len=kv_len)
    first = run()
    differ = sum(not all(torch.equal(a, b_) for a, b_ in zip(run(), first)) for _ in range(100))
    log(f"K1 offsets, 100 reruns: {differ} differ bitwise")
    if differ:
        raise AssertionError("K1 with offsets is not deterministic")

    # The gather route's shape: 8 rows, queries 1024 .. 1279 over 1280 keys.
    b, plen, st = 8, 1024, 256
    q, k, v = inputs(torch.bfloat16, b, st, plen + st)
    offs = torch.full((b,), plen, dtype=torch.int32, device="cuda")
    lens = offs + st
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, q_offset=offs, kv_len=lens)
    o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True, q_offset=offs, kv_len=lens)
    e_r = row_err(o, o_ref)
    pairs = b * HQ * sum(plen + i + 1 for i in range(st))
    kb = bound(nbytes(q, k, v, o, lse, offs, lens), 4.0 * D * pairs)
    pos = torch.arange(plen + st, device="cuda")
    mask = pos[None, :] <= plen + torch.arange(st, device="cuda")[:, None]
    ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True, q_offset=offs,
                                                 kv_len=lens), primed=True)
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                          enable_gqa=True), primed=True)
    log(f"K1 at the gather route's shape (B {b}, queries {plen} .. {plen + st - 1} over "
        f"{plen + st} keys): row-relative {e_r:.3e} (tol {ROW_TOL:.3e}); {ms:.4f} ms (queue "
        f"primed), library sdpa (explicit mask) {lib:.4f} ms, bound {kb[0]:.5f} ms ({kb[1]}); "
        f"card: {smi_line()}")
    if e_r > ROW_TOL:
        raise AssertionError("K1 at the gather route's shape disagrees with its plain version")
    del q, k, v, o, lse, o_ref, mask


def check_k2_route(label, counts, tensor_cores=True):
    """Every K2 launch went to the tensor-core kernel (bf16), or none did
    (float32)."""
    total, tc = counts["paged_flash_prefill"], counts["paged_flash_prefill_tc"]
    log(f"{label}: K2 launches {total}, on the tensor cores {tc}")
    if total <= 0 or tc != (total if tensor_cores else 0):
        raise AssertionError(f"{label}: K2 launches {total}, {tc} on the tensor cores")


def check_paged_prefill(torch, timer, results, gen):
    """K2, bf16 on the tensor cores, against its plain version over
    scattered page tables, per row within ROW_TOL, rows at or past tail_len
    exactly zero, ten reruns bitwise equal, every launch on the tensor-core
    kernel: B 2 with a prefix of 1000 positions (not a page multiple) and a
    tail of 256, the second row's live to 219 (the JSON line takes this),
    then the paged serve run's extend shape, the 7 requests that hit the
    256-token system prefix, each a full tail of 256 over a 16-page table.
    No one PyTorch call computes K2 (library_ms stays None); the yardstick
    beside it is two calls, gather + SDPA: ``index_select`` of the table's
    pages into dense stripes joined to the tail, then
    ``scaled_dot_product_attention`` with ``enable_gqa=True`` and the
    prefix / causal / tail_len mask as an explicit one. The bound counts
    the live prefix K/V read once, q, the tail K/V and the lengths read and
    o written once, against 4 D operations per live (row, key) pair. Then
    the first case in float32 (the CUDA-core kernel), held at F32_TOL and
    timed against the float32 peak."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import paged_prefill_attention as pp

    def inputs(b, plen, st, tlens, dtype=torch.bfloat16):
        mp = -(-plen // PS)
        num_pages = 1 + b * mp
        randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
        kp, vp = randn(HKV, num_pages, PS, D), randn(HKV, num_pages, PS, D)
        perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
        table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
        q, kt, vt = randn(b, HQ, st, D), randn(b, HKV, st, D), randn(b, HKV, st, D)
        plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
        return (q, kp, vp, table, kt, vt, plens,
                torch.tensor(tlens, dtype=torch.int32, device="cuda"))

    def k2_bound(args, o, peak=PEAK_BF16_FLOPS):
        q, kp, _, table, kt, vt, plens, tlens = args
        plen = plens.tolist()
        pairs = HQ * sum(t * p + t * (t + 1) // 2 for t, p in zip(tlens.tolist(), plen))
        live_kv = 2 * HKV * sum(plen) * D * kp.element_size()
        return bound(live_kv + nbytes(q, kt, vt, o, table, plens, tlens), 4.0 * D * pairs,
                     peak)

    def gather_sdpa(args, mask):
        q, kp, vp, table, kt, vt, plens, tlens = args
        b, mp = table.shape
        k, v = (torch.cat([p.index_select(1, table.flatten()).view(HKV, b, mp * PS, D)
                           .transpose(0, 1), t], dim=2) for p, t in ((kp, kt), (vp, vt)))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    def sdpa_mask(args):
        q, _, _, table, _, _, plens, tlens = args
        rows = torch.arange(q.shape[2], device="cuda")[None, :, None]
        cp = torch.arange(table.shape[1] * PS, device="cuda")[None, None, :]
        ct = torch.arange(q.shape[2], device="cuda")[None, None, :]
        ok = rows < tlens[:, None, None]
        return torch.cat([(cp < plens[:, None, None]) & ok, (ct <= rows) & ok], dim=-1)[:, None]

    for label, b, plen, st, tlens in (
            ("prefix 1000 tail 256", 2, 1000, 256, [256, 219]),
            ("serve extend shape, B 7 x prefix 256 tail 256", 7, 256, 256, [256] * 7)):
        args = inputs(b, plen, st, tlens)
        run = lambda: pp.paged_flash_prefill(*args)
        kernels.reset_launch_counts()
        o = run()
        check_k2_route(f"K2 {label}", kernels.launch_counts())
        o_ref = pp.paged_flash_prefill_plain(*args)
        torch.cuda.synchronize()
        e, e_r = err(o, o_ref), row_err(o, o_ref)
        past = sum(float(o[i, :, t:].float().abs().sum()) for i, t in enumerate(tlens))
        same = all(torch.equal(run(), o) for _ in range(10))
        kb = k2_bound(args, o)
        mask = sdpa_mask(args)
        ms = timer.ms(run, primed=True)
        event_ms = timer.ms(run)
        plain_ms = timer.ms(lambda: pp.paged_flash_prefill_plain(*args))
        yard_ms = timer.ms(lambda: gather_sdpa(args, mask), primed=True)
        log(f"K2 {label}: max_err {e:.3e} (row-relative {e_r:.3e}, tol {ROW_TOL:.3e}), rows "
            f"past tail_len sum |o| {past}, 10 reruns bitwise equal {same}, {ms:.4f} ms (queue "
            f"primed; {event_ms:.4f} ms with the wrapper's host time), plain {plain_ms:.3f} ms, "
            f"gather + sdpa {yard_ms:.4f} ms (two calls, primed), bound {kb[0]:.5f} ms "
            f"({kb[1]})")
        if e_r > ROW_TOL or past != 0.0 or not same:
            raise AssertionError(f"K2 {label} disagrees with its plain version")
        if "K2" not in results:
            results["K2"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=kb[0],
                                 bound_by=kb[1], library_ms=None)
        del args, o, o_ref, mask

    # float32 stays on the CUDA cores: the first case again in float32.
    args = inputs(2, 1000, 256, [256, 219], dtype=torch.float32)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args)
    check_k2_route("K2 float32", kernels.launch_counts(), tensor_cores=False)
    o_ref = pp.paged_flash_prefill_plain(*args)
    torch.cuda.synchronize()
    e = err(o, o_ref)
    fb = k2_bound(args, o, PEAK_F32_FLOPS)
    ms = timer.ms(lambda: pp.paged_flash_prefill(*args), primed=True)
    plain_ms = timer.ms(lambda: pp.paged_flash_prefill_plain(*args))
    log(f"K2 float32 (CUDA cores) prefix 1000 tail 256: max_err {e:.3e} (tol {F32_TOL}), "
        f"{ms:.4f} ms (queue primed), plain {plain_ms:.3f} ms, bound {fb[0]:.5f} ms ({fb[1]}, "
        f"float32 peak)")
    if e > F32_TOL:
        raise AssertionError("K2 float32 disagrees with its plain version")
    del args, o, o_ref


def check_paged_route(label, counts):
    """Every K3/K4 launch of a bf16 path went to the tensor-core kernel."""
    total = counts["paged_flash_decode"] + counts["paged_flash_decode_split"]
    tc = counts["paged_flash_decode_tc"] + counts["paged_flash_decode_split_tc"]
    log(f"{label}: K3/K4 launches {total}, on the tensor cores {tc}")
    if total <= 0 or tc != total:
        raise AssertionError(f"{label}: {total - tc} K3/K4 launches missed the tensor-core "
                             "kernel")


def check_paged_decode(torch, timer, results, gen):
    """K3 (one pass) and K4 (split-K + combine), bf16 on the tensor cores,
    against their plain version over scattered page tables, per row within
    ROW_TOL, length-0 rows exactly zero, ten reruns bitwise equal, every
    launch on the tensor-core kernel: B 8 with ragged lengths up to 4096 and
    a length-0 row (one pass, 4 and 7 splits; the JSON line takes these),
    then the paged serve run's decode shape, 8 rows of 560 tokens on a
    36-page table (one pass and 2 splits). Each is timed with the launch
    queue primed and without (the wrapper's host time shows in the second).
    No one PyTorch call computes a paged decode (library_ms stays None);
    the yardstick beside it is two calls, gather + SDPA: ``index_select``
    of the table's pages into dense stripes, then
    ``scaled_dot_product_attention`` with ``enable_gqa=True`` and the
    length mask. The bound counts each live key and value read once, q
    read and o written once, the table and lengths. Then the first case in
    float32 (the CUDA-core kernels), one pass and 4 splits, held at F32_TOL
    and timed against the float32 peak. The split model against these
    kernels is the plan phase's (a)."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import paged_decode_attention as pd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def gather_sdpa(q, kp, vp, table, lengths):
        b, mp = table.shape
        hkv, _, ps, d = kp.shape
        k, v = (p.index_select(1, table.flatten()).view(hkv, b, mp * ps, d).transpose(0, 1)
                for p in (kp, vp))
        mask = torch.arange(mp * ps, device="cuda")[None, :] < lengths[:, None]
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask[:, None, None, :],
                                              enable_gqa=True)

    b = 8
    for label, mp, lens, splits in (
            ("B 8, table 4096", 4096 // PS, [4096, 0, 3001, 17, 2048, 4000, 1, 1500],
             (1, 4, 7)),
            ("serve decode shape, B 8 x 560, table 36 pages", 36, [560] * b, (1, 2))):
        num_pages = 1 + b * mp
        kp, vp = randn(HKV, num_pages, PS, D), randn(HKV, num_pages, PS, D)
        perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
        table = perm.reshape(b, mp).to(torch.int32).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(b, HQ, D)
        live = int(lengths.sum())
        dec_bound = bound(2 * HKV * live * D * 2 + nbytes(q, q, table, lengths),
                          4.0 * HQ * D * live)
        yard_ms = timer.ms(lambda: gather_sdpa(q, kp, vp, table, lengths), primed=True)
        for ns in splits:
            key = "K3" if ns == 1 else "K4"
            run = lambda: pd.paged_flash_decode(q, kp, vp, table, lengths, num_splits=ns)
            kernels.reset_launch_counts()
            o = run()
            check_paged_route(f"{key} {label} num_splits {ns}", kernels.launch_counts())
            o_ref = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, num_splits=ns)
            torch.cuda.synchronize()
            e, e_r = err(o, o_ref), row_err(o, o_ref)
            zero_row = float(o[lengths == 0].float().abs().sum())
            same = all(torch.equal(run(), o) for _ in range(10))
            ms = timer.ms(run, primed=True)
            event_ms = timer.ms(run)
            plain_ms = timer.ms(lambda: pd.paged_flash_decode_plain(
                q, kp, vp, table, lengths, num_splits=ns))
            log(f"{key} {label} num_splits {ns}: max_err {e:.3e} (row-relative {e_r:.3e}, tol "
                f"{ROW_TOL:.3e}), length-0 rows sum |o| {zero_row}, 10 reruns bitwise equal "
                f"{same}, {ms:.4f} ms (queue primed; {event_ms:.4f} ms with the wrapper's host "
                f"time), plain {plain_ms:.3f} ms, gather + sdpa {yard_ms:.4f} ms (two calls, "
                f"primed), bound {dec_bound[0]:.5f} ms ({dec_bound[1]})")
            if e_r > ROW_TOL or zero_row != 0.0 or not same:
                raise AssertionError(f"{key} {label} num_splits {ns} disagrees with its plain "
                                     "version")
            if mp == 4096 // PS and key not in results:
                results[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                    bound_ms=dec_bound[0], bound_by=dec_bound[1],
                                    library_ms=None)
        del kp, vp, q, o, o_ref

    # float32 stays on the CUDA cores: the first case again in float32, one
    # pass and 4 splits, against the float32 peak.
    mp = 4096 // PS
    num_pages = 1 + b * mp
    kp, vp = (torch.randn((HKV, num_pages, PS, D), generator=gen, device="cuda")
              for _ in range(2))
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    lengths = torch.tensor([4096, 0, 3001, 17, 2048, 4000, 1, 1500], dtype=torch.int32,
                           device="cuda")
    q = torch.randn((b, HQ, D), generator=gen, device="cuda")
    live = int(lengths.sum())
    f32_bound = bound(2 * HKV * live * D * 4 + nbytes(q, q, table, lengths),
                      4.0 * HQ * D * live, PEAK_F32_FLOPS)
    for ns in (1, 4):
        key = "K3" if ns == 1 else "K4"
        kernels.reset_launch_counts()
        o = pd.paged_flash_decode(q, kp, vp, table, lengths, num_splits=ns)
        counts = kernels.launch_counts()
        o_ref = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, num_splits=ns)
        torch.cuda.synchronize()
        e = err(o, o_ref)
        on_cuda_cores = (counts["paged_flash_decode"] + counts["paged_flash_decode_split"] == 1
                         and counts["paged_flash_decode_tc"]
                         + counts["paged_flash_decode_split_tc"] == 0)
        ms = timer.ms(lambda: pd.paged_flash_decode(q, kp, vp, table, lengths, num_splits=ns),
                      primed=True)
        plain_ms = timer.ms(lambda: pd.paged_flash_decode_plain(q, kp, vp, table, lengths,
                                                                num_splits=ns))
        log(f"{key} float32 (CUDA cores) B 8, table 4096 num_splits {ns}: max_err {e:.3e} "
            f"(tol {F32_TOL}), CUDA-core entry: {on_cuda_cores}, {ms:.4f} ms (queue primed), "
            f"plain {plain_ms:.3f} ms, bound {f32_bound[0]:.5f} ms ({f32_bound[1]}, float32 "
            f"peak)")
        if e > F32_TOL or not on_cuda_cores:
            raise AssertionError(f"{key} float32 num_splits {ns} disagrees with its plain "
                                 "version")
    del kp, vp, q, o, o_ref


def quant_pools(torch, gen, hkv, num_pages, d, kv_dtype):
    """(float32 values, codes, scales) for K and for V: pools of pages of
    PS rows made from normal values, whose null page (0) is then
    overwritten as rows frozen on it leave it: NaN scales, and codes that
    are NaN bits in e4m3 (0x7F)."""
    from repro_torch.cache import quant

    out = []
    for _ in range(2):
        x = torch.randn((hkv, num_pages, PS, d), generator=gen, device="cuda")
        codes, scales = quant.quantize_pages(x, kv_dtype)
        codes.view(torch.uint8)[:, 0] = 0x7F
        scales[:, 0] = float("nan")
        out.append((x, codes, scales))
    return out


def quant_table(torch, gen, lengths, mp, frozen=()):
    """Scattered live pages per row, the null page past them; frozen rows'
    tables are all null."""
    perm = (torch.randperm(len(lengths) * mp, generator=gen, device="cuda") + 1).tolist()
    table = torch.zeros((len(lengths), mp), dtype=torch.int32)
    for i, n in enumerate(lengths):
        if i not in frozen:
            live = -(-n // PS)
            table[i, :live] = torch.tensor(perm[i * mp: i * mp + live])
    return table.cuda()


def only_launched(counts, *keys) -> bool:
    """One launch of each of ``keys`` and of nothing else."""
    return {k: n for k, n in counts.items() if n} == {k: 1 for k in keys}


def check_quant_rows(label, ok_rows, e_r, e32, o, o_bf, bars):
    """A quantized case's bars: ``ok_rows`` (routing, reruns, finite and
    zero rows), the row-relative error ``e_r`` against the plain version,
    float32 q's error ``e32`` (None where float32 q is not run: head_dim
    256 refuses it), and ``o`` against the unquantized kernel's ``o_bf``
    within ``bars`` (rows,), each row's own."""
    e_bf = (o.float() - o_bf.float()).abs().flatten(1).amax(1)
    worst = int((e_bf / bars).argmax())
    f32 = "not run" if e32 is None else f"max_err {e32:.3e} (tol {F32_TOL})"
    log(f"{label}: row-relative {e_r:.3e} (tol {ROW_TOL:.3e}); float32 q {f32}; "
        f"against the unquantized bf16 kernel max {float(e_bf.max()):.3e}, "
        f"nearest its bar at row {worst}: {float(e_bf[worst]):.3e} (tol "
        f"{float(bars[worst]):.3e})")
    for r in (bars > bars.min()).nonzero().flatten().tolist():
        log(f"  row {r}, fewer keys than a page: {float(e_bf[r]):.3e} against its bar "
            f"{float(bars[r]):.3e} (QTOL plus its own V codes' measured error)")
    if not ok_rows or e_r > ROW_TOL or (e32 or 0.0) > F32_TOL or bool((e_bf > bars).any()):
        raise AssertionError(f"{label} disagrees")


def quant_decode_bars(lens, rows, table, vc, vs, vb, kv_dtype):
    """Each row's bar against the unquantized kernel: QTOL, and for an fp8
    row of fewer keys than a page QTOL plus its own V codes' largest error
    against the bf16 values."""
    import torch

    from repro_torch.cache import quant

    bars = []
    for i in rows:
        bar = QTOL[kv_dtype]
        if kv_dtype == "fp8" and 0 < lens[i] < PS:
            pages = table[i, : -(-lens[i] // PS)].long()
            deq = quant.dequantize_pages(vc[:, pages], vs[:, pages])
            own = (deq - vb[:, pages].float()).flatten(1, 2)[:, : lens[i]]
            bar += float(own.abs().max())
        bars.append(bar)
    return torch.tensor(bars, device="cuda")


def check_quantized(torch, timer, results, gen):
    """K3q / K4q (paged decode of bf16 q over int8 and fp8 pools, one pass
    and split-K, on the tensor cores: the codes widened to bf16 in shared
    memory, the page scales folded into S's and P's columns) and K2q (paged
    prefill of bf16 q over a quantized prefix, on the tensor cores: each
    code times its page's scale rounded once to bf16 into K2's stages).
    Each pool is made
    from float32 normal values; its null page (0) is then overwritten as
    rows frozen on it leave it: NaN scales, and codes that are NaN bits in
    e4m3 (0x7F). Tables pad with the null page past each row's live pages.
    Decode: B 8 with lengths up to 4096 and a length-0 row (one pass and 4
    splits; the JSON line takes int8 here), then the serve run (a)'s decode
    shape, 8 rows of 560 tokens on 36-page tables, 2 of them frozen on the
    null page (one pass and 2 splits), then run (b)'s, one row of 4096
    tokens on a 260-page table at 1, 2, 4 and 8 splits beside the split
    estimator's choice for the format. Prefill: B 2, prefix 1000 (a
    64-page table, the last null), tail 256, the second row live to 219,
    then the serve run (a)'s extend shape, 7 rows of prefix 256 on 16 pages
    and tail 256; K2q's output must be bit for bit K2's over bf16 pools of
    the dequantized values.
    Bars: bf16 q against the plain version per live row within ROW_TOL,
    float32 q (the CUDA-core kernels) within F32_TOL, each against the
    unquantized bf16 kernel on the same values within QTOL (an fp8 row of
    fewer keys than a page within QTOL plus the largest error of its own
    dequantized V codes against the bf16 values); live rows finite,
    length-0 rows and rows past tail_len exactly zero; every launch on its
    entry (bf16 q on the tensor cores); ten reruns of each case bitwise
    equal, the frozen rows' NaNs too. Times: CUDA-event medians, primed, L2
    flushed; each case's tensor-core kernel and the CUDA-core walk it
    replaced (``paged_flash_decode_q_cuda_cores``,
    ``paged_flash_prefill_q_cuda_cores``) in turns, new, old, old, new,
    K2q beside K2 on bf16 pools. Bound: codes at 1 B for each live position,
    the scales of the live pages, q, the tail, out and the table over 3.35
    TB/s, against the operations over the peak of q's type: int8 and e4m3
    codes are exact in bf16 and the scale factors out of each product, so
    the same work runs at the bf16 peak."""
    from repro_torch import kernels
    from repro_torch.cache import quant
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import paged_prefill_attention as pp
    from repro_torch.kernels import plan

    pools = lambda num_pages, kv_dtype: quant_pools(torch, gen, HKV, num_pages, D, kv_dtype)
    table_of = lambda lengths, mp, frozen=(): quant_table(torch, gen, lengths, mp, frozen)
    only, check, decode_bars = only_launched, check_quant_rows, quant_decode_bars

    for kv_dtype in ("int8", "fp8"):
        for label, mp, lens, frozen, splits, timed in (
                ("B 8, table 4096", 4096 // PS, [4096, 0, 3001, 17, 2048, 4000, 1, 1500], (),
                 (1, 4), True),
                ("serve decode shape (a), B 8 x 560, table 36, rows 6-7 frozen on the null "
                 "page", 36, [560] * 8, (6, 7), (1, 2), False),
                ("serve decode shape (b), B 1 x 4096, table 260", 260, [4096], (),
                 (1, 2, 4, 8), False)):
            b = len(lens)
            (xk, kc, ks), (xv, vc, vs) = pools(1 + b * mp, kv_dtype)
            table = table_of(lens, mp, frozen)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
            kb, vb = xk.to(torch.bfloat16), xv.to(torch.bfloat16)
            live = [i for i in range(b) if i not in frozen]
            zero = [i for i in live if lens[i] == 0]
            pages = sum(-(-lens[i] // PS) for i in live)
            qb = bound(2 * HKV * D * sum(lens[i] for i in live) + 2 * HKV * pages * 4
                       + nbytes(q, q, table, lengths), 4.0 * HQ * D * sum(lens),
                       PEAK_BF16_FLOPS)
            if b == 1:
                chosen = plan.plan_attention((b, HQ, HKV, 1, mp * PS, D), phase=plan.DECODE,
                                             kv_layout=plan.PAGED, page_size=PS,
                                             kv_dtype=kv_dtype).num_splits
                log(f"K4q {kv_dtype} {label}: the split estimator picks {chosen} splits "
                    "(codes priced at 1 B)")
            for ns in splits:
                key = "K3q" if ns == 1 else "K4q"
                kw = dict(num_splits=ns, k_scales=ks, v_scales=vs)
                run = lambda: pd.paged_flash_decode(q, kc, vc, table, lengths, **kw)
                old = lambda: pd.paged_flash_decode_q_cuda_cores(q, kc, vc, table, lengths,
                                                                 **kw)
                kernels.reset_launch_counts()
                o = run()
                counter = KERNELS[key]["counter"]
                routed = only(kernels.launch_counts(), counter, counter[:-len("_tc")])
                o_ref = pd.paged_flash_decode_plain(q, kc, vc, table, lengths, **kw)
                o_old = old()
                o32 = pd.paged_flash_decode(q.float(), kc, vc, table, lengths, **kw)
                o32_ref = pd.paged_flash_decode_plain(q.float(), kc, vc, table, lengths, **kw)
                o_bf = pd.paged_flash_decode(q, kb, vb, table, lengths, num_splits=ns)
                bits = o.view(torch.int16)
                same = all(torch.equal(run().view(torch.int16), bits) for _ in range(10))
                torch.cuda.synchronize()
                ok = (routed and same and bool(torch.isfinite(o[live].float()).all())
                      and all(float(o[i].float().abs().max()) == 0.0 for i in zero))
                e_r, e = row_err(o[live], o_ref[live]), err(o[live], o_ref[live])
                e32 = err(o32[live], o32_ref[live])
                name = f"{key} {kv_dtype} {label} num_splits {ns}"
                e_old = row_err(o_old[live], o_ref[live])
                log(f"{name}: routed to {counter} {routed}, 10 reruns bitwise equal {same}, "
                    f"the CUDA-core walk's row-relative error {e_old:.3e}")
                check(name, ok, e_r, e32, o[live], o_bf[live],
                      decode_bars(lens, live, table, vc, vs, vb, kv_dtype))
                turns = [timer.ms(fn, primed=True) for fn in (run, old, old, run)]
                ms, old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                plain_ms = (timer.ms(lambda: pd.paged_flash_decode_plain(
                    q, kc, vc, table, lengths, **kw)) if timed else float("nan"))
                bf_ms = timer.ms(lambda: pd.paged_flash_decode(q, kb, vb, table, lengths,
                                                               num_splits=ns), primed=True)
                log(f"{name}: {ms:.4f} ms (queue primed; turns {turns[0]:.4f}, {turns[3]:.4f}), "
                    f"the CUDA-core walk it replaced {old_ms:.4f} ms (turns {turns[1]:.4f}, "
                    f"{turns[2]:.4f}), plain {plain_ms:.3f} ms, the bf16 tensor-core kernel on "
                    f"bf16 pools {bf_ms:.4f} ms, bound {qb[0]:.5f} ms ({qb[1]})")
                if timed and kv_dtype == "int8":
                    results[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                        bound_ms=qb[0], bound_by=qb[1], library_ms=None)
            del xk, xv, kc, vc, ks, vs, kb, vb, q, o, o_ref, o_old, o32, o32_ref, o_bf

        # K2q, bf16 q on the tensor cores: B 2, prefix 1000 on a 64-page
        # table (the last entry null), tail 256 (the JSON line takes int8
        # here); then the serve extend shape, 7 rows of prefix 256 on 16
        # pages and tail 256.
        for label, b, plen, mp, tlens, timed in (
                ("prefix 1000 (64-page table) tail 256", 2, 1000, 64, [256, 219], True),
                ("serve extend shape, B 7 x prefix 256 (16 pages) tail 256", 7, 256, 16,
                 [256] * 7, False)):
            st = max(tlens)
            (xk, kc, ks), (xv, vc, vs) = pools(1 + b * mp, kv_dtype)
            table = table_of([plen] * b, mp)
            randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            q, kt, vt = randn(b, HQ, st, D), randn(b, HKV, st, D), randn(b, HKV, st, D)
            plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
            tl = torch.tensor(tlens, dtype=torch.int32, device="cuda")
            kw = dict(k_scales=ks, v_scales=vs)
            run = lambda: pp.paged_flash_prefill(q, kc, vc, table, kt, vt, plens, tl, **kw)
            old = lambda: pp.paged_flash_prefill_q_cuda_cores(q, kc, vc, table, kt, vt, plens,
                                                              tl, **kw)
            kernels.reset_launch_counts()
            o = run()
            counter = KERNELS["K2q"]["counter"]
            routed = only(kernels.launch_counts(), counter, counter[:-len("_tc")])
            o_ref = pp.paged_flash_prefill_plain(q, kc, vc, table, kt, vt, plens, tl, **kw)
            o_old = old()
            f32 = [t.float() for t in (q, kt, vt)]
            o32 = pp.paged_flash_prefill(f32[0], kc, vc, table, f32[1], f32[2], plens, tl, **kw)
            o32_ref = pp.paged_flash_prefill_plain(f32[0], kc, vc, table, f32[1], f32[2], plens,
                                                   tl, **kw)
            kb, vb = xk.to(torch.bfloat16), xv.to(torch.bfloat16)
            o_bf = pp.paged_flash_prefill(q, kb, vb, table, kt, vt, plens, tl)
            # K2 over bf16 pools of the dequantized values: K2q's bits.
            kd, vd = (quant.dequantize_pages(c, sc).to(torch.bfloat16) for c, sc in
                      ((kc, ks), (vc, vs)))
            o_deq = pp.paged_flash_prefill(q, kd, vd, table, kt, vt, plens, tl)
            same = all(torch.equal(run(), o) for _ in range(10))
            torch.cuda.synchronize()
            bitwise = torch.equal(o, o_deq)
            past = sum(float(o[i, :, t:].float().abs().sum()) for i, t in enumerate(tlens))
            ok = (routed and past == 0.0 and bitwise and same
                  and bool(torch.isfinite(o.float()).all()))
            name = f"K2q {kv_dtype} {label}"
            log(f"{name}: routed to {counter} {routed}, bitwise equal to K2 on bf16 pools of "
                f"the dequantized values {bitwise}, rows past tail_len sum |o| {past}, 10 "
                f"reruns bitwise equal {same}, the CUDA-core walk's row-relative error "
                f"{row_err(o_old, o_ref):.3e}")
            check(name, ok, row_err(o, o_ref), err(o32, o32_ref), o, o_bf,
                  torch.full((b,), QTOL[kv_dtype], device="cuda"))
            pairs = HQ * sum(t * plen + t * (t + 1) // 2 for t in tlens)
            pages = b * -(-plen // PS)
            kq = bound(2 * HKV * D * plen * b + 2 * HKV * pages * 4
                       + nbytes(q, kt, vt, o, table, plens, tl), 4.0 * D * pairs,
                       PEAK_BF16_FLOPS)
            turns = [timer.ms(fn, primed=True) for fn in (run, old, old, run)]
            ms, old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            plain_ms = (timer.ms(lambda: pp.paged_flash_prefill_plain(
                q, kc, vc, table, kt, vt, plens, tl, **kw)) if timed else float("nan"))
            bf_ms = timer.ms(lambda: pp.paged_flash_prefill(q, kb, vb, table, kt, vt, plens,
                                                            tl), primed=True)
            log(f"{name}: {ms:.4f} ms (queue primed; turns {turns[0]:.4f}, {turns[3]:.4f}), "
                f"the CUDA-core walk it replaced {old_ms:.4f} ms (turns {turns[1]:.4f}, "
                f"{turns[2]:.4f}), plain {plain_ms:.3f} ms, the bf16 tensor-core kernel on "
                f"bf16 pools {bf_ms:.4f} ms ({ms / bf_ms:.3f}x), bound {kq[0]:.5f} ms "
                f"({kq[1]})")
            if timed and kv_dtype == "int8":
                results["K2q"] = dict(max_abs_err=err(o, o_ref), ms=ms, plain_ms=plain_ms,
                                      bound_ms=kq[0], bound_by=kq[1], library_ms=None)
            del xk, xv, kc, vc, ks, vs, kb, vb, kd, vd, q, kt, vt, o, o_ref, o_old, o32
            del o32_ref, o_bf, o_deq, f32


def check_backward(torch, timer, results):
    """K5 and K6 (bf16, the tensor-core kernels) against the plain backward,
    per (b, head) slice of each gradient: max |g - ref| / max |ref| within
    ROW_TOL (both round float32 sums to bf16 once; the kernels also round P
    and dS to bf16 before their products, and sum in another order). Then
    the float32 CUDA-core kernels, per slice within GRAD_F32_TOL."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def inputs(b, s, pad_to=None, **kw):
        q, k, v = randn(b, HQ, s, D), randn(b, HKV, s, D), randn(b, HKV, s, D)
        do = randn(b, HQ, s, D)
        if pad_to is not None:   # as ops.flash_attention pads: zero rows, kv_len = s
            q, k, v, do = (F.pad(t, (0, 0, 0, pad_to - s)) for t in (q, k, v, do))
            kw = dict(kw, kv_len=s)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        return (q, k, v, o, lse, do), kw

    def run(args, kw, mapping):
        q, k, v, o, lse, do = args
        delta = (do.float() * o.float()).sum(-1)
        dq = fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, mapping=mapping, **kw)
        dk, dv = fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, mapping=mapping, **kw)
        return (dq, dk, dv), delta

    def check(label, args, kw, mapping, tol=ROW_TOL):
        before = kernels.launch_counts()
        got, delta = run(args, kw, mapping)
        check_bwd_route(f"K5/K6 {label}", bwd_launches(before, kernels.launch_counts()),
                        tensor_cores=args[0].dtype == torch.bfloat16)
        ref = fb.flash_attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        rel = [slice_err(g, r) for g, r in zip(got, ref)]
        ab = [err(g, r) for g, r in zip(got, ref)]
        log(f"K5/K6 {label}: per-slice relative dq {rel[0]:.3e} dk {rel[1]:.3e} "
            f"dv {rel[2]:.3e} (tol {tol:.3e}); max abs {ab[0]:.3e} {ab[1]:.3e} "
            f"{ab[2]:.3e}")
        if max(rel) > tol:
            raise AssertionError(f"K5/K6 {label} disagree with the plain backward")
        return ab, delta, got

    # B 2, S 2048, causal: the K1 case, under both orders.
    b, s = 2, 2048
    args, kw = inputs(b, s, causal=True)
    q, k, v, o, lse, do = args
    rows = torch.arange(s)
    pairs = b * HQ * int((rows + 1).sum())
    main, grads = {}, {}
    for name, order in (("head_first", fa.HEAD_FIRST), ("block_first", fa.BLOCK_FIRST)):
        mapping = fa.MappingConfig(order=order)
        ab, delta, grads[name] = check(f"B {b} S {s} causal {name}", args, kw, mapping)
        ms_dq = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                           mapping=mapping, **kw))
        ms_dkv = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                             mapping=mapping, **kw))
        log(f"K5 {name} {ms_dq:.4f} ms, K6 {name} {ms_dkv:.4f} ms, pair "
            f"{ms_dq + ms_dkv:.4f} ms")
        if not main:
            main = dict(ab=ab, dq=ms_dq, dkv=ms_dkv, delta=delta)
    same = all(torch.equal(x, y) for x, y in zip(grads["head_first"], grads["block_first"]))
    log(f"K5/K6 head-first and block-first bitwise equal: {same}")
    if not same:
        raise AssertionError("K5/K6's launch order changed their gradients")
    del grads
    delta = main["delta"]
    plain_ms = timer.ms(lambda: fb.flash_attention_bwd_plain(*args, **kw))
    # SDPA's backward on the same shapes: one number beside K5 + K6, with
    # K/V expanded to Hq so the flash backend takes them.
    group = HQ // HKV
    leaves = [t.detach().requires_grad_(True)
              for t in (q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    del leaves, out
    dq_bytes = nbytes(q, k, v, do, lse, delta, q)
    dkv_bytes = nbytes(q, k, v, do, lse, delta, k, v)
    k5_bound = bound(dq_bytes, 6.0 * D * pairs)       # S, dP, dQ: 3 products
    k6_bound = bound(dkv_bytes, 8.0 * D * pairs)      # S, dP, dV, dK: 4 products
    pair_bound = bound(dq_bytes + nbytes(k, v), 10.0 * D * pairs)  # 5 distinct products
    log(f"K5 {main['dq']:.4f} ms bound {k5_bound[0]:.4f} ({k5_bound[1]}); K6 "
        f"{main['dkv']:.4f} ms bound {k6_bound[0]:.4f} ({k6_bound[1]}); pair "
        f"{main['dq'] + main['dkv']:.4f} ms, least work {pair_bound[0]:.4f} ms; plain "
        f"{plain_ms:.3f} ms; library sdpa backward {lib_ms:.4f} ms")
    results["K5"] = dict(max_abs_err=main["ab"][0], ms=main["dq"], plain_ms=plain_ms,
                         bound_ms=k5_bound[0], bound_by=k5_bound[1], library_ms=lib_ms)
    results["K6"] = dict(max_abs_err=max(main["ab"][1:]), ms=main["dkv"], plain_ms=plain_ms,
                         bound_ms=k6_bound[0], bound_by=k6_bound[1], library_ms=lib_ms)
    del args, q, k, v, o, lse, do
    args, kw = inputs(b, s, causal=True, window=512, softcap=50.0)
    check("window 512 + softcap 50", args, kw, fa.MappingConfig())
    del args
    args, kw = inputs(b, 1000, pad_to=1024, causal=True)
    check("S 1000 padded to 1024 (kv_len 1000)", args, kw, fa.MappingConfig())
    del args

    # float32 stays on the CUDA cores: held per slice at GRAD_F32_TOL (both
    # sum float32), then timed at the bf16 case's shape against the float32
    # peak, with the plain version and SDPA's float32 backward beside it.
    def randn32(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v, do = randn32(1, HQ, 300, D), randn32(1, HKV, 300, D), randn32(1, HKV, 300, D), \
        randn32(1, HQ, 300, D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    check("float32 (CUDA cores) Hq 32, Hkv 8, S 300 causal", (q, k, v, o, lse, do),
          dict(causal=True), fa.MappingConfig(), tol=GRAD_F32_TOL)
    q, k, v, do = randn32(b, HQ, s, D), randn32(b, HKV, s, D), randn32(b, HKV, s, D), \
        randn32(b, HQ, s, D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = (do * o).sum(-1)
    ms_dq = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True))
    ms_dkv = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True))
    plain_ms = timer.ms(lambda: fb.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True))
    leaves = [t.detach().requires_grad_(True)
              for t in (q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    del leaves, out
    f5 = bound(nbytes(q, k, v, do, lse, delta, q), 6.0 * D * pairs, PEAK_F32_FLOPS)
    f6 = bound(nbytes(q, k, v, do, lse, delta, k, v), 8.0 * D * pairs, PEAK_F32_FLOPS)
    log(f"K5/K6 float32 (CUDA cores) B {b} S {s} causal: K5 {ms_dq:.3f} ms bound "
        f"{f5[0]:.4f} ({f5[1]}, float32 peak), K6 {ms_dkv:.3f} ms bound {f6[0]:.4f} "
        f"({f6[1]}, float32 peak); plain {plain_ms:.3f} ms; library sdpa backward "
        f"(float32) {lib_ms:.3f} ms")


def check_dense_route(label, counts):
    """Every K7/K8 launch of a bf16 path went to the tensor-core kernel."""
    total = counts["flash_decode"] + counts["flash_decode_split"]
    tc = counts["flash_decode_tc"] + counts["flash_decode_split_tc"]
    log(f"{label}: K7/K8 launches {total}, on the tensor cores {tc}")
    if tc != total:
        raise AssertionError(f"{label}: {total - tc} K7/K8 launches missed the tensor-core "
                             "kernel")


def check_dense_decode(torch, timer, results):
    """K7 (one pass) and K8 (split-K + combine) against their plain version
    on dense stripes, B 8, per row within ROW_TOL, every bf16 launch on the
    tensor-core kernel: capacity 4096 with ragged lengths and a length-0
    row at llama3-8b widths (one pass, 4 and 7 splits), then at hymba-1.5b
    widths (Hq 25, Hkv 5, D 64) global and with window 1024 (one pass and 4
    splits); then hymba's serve batch at the end of its decode (8 rows of
    100-1500 + 32 tokens over the whole 2048-row stripes, as the fused
    decode's graph passes them), global and window 1024, one pass against 4
    splits. The bound counts what these lengths need: each live key and
    value read once (``min(length, window)`` per row), q read and o written
    once; the JSON line takes hymba's global case. SDPA (q as (B, Hq, 1, D)
    against K/V expanded to Hq and masked by length) is the library
    yardstick. Kernel and SDPA are timed with the launch queue primed (the
    wrapper's host time exceeds the kernel's), and the kernel also without.
    Then float32 K7/K8 (the CUDA-core kernel) at hymba's global case, held
    at F32_TOL and timed against the float32 peak."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import plan as plan_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, smax = 8, 4096
    lengths = torch.tensor([4096, 0, 3001, 17, 2048, 4000, 1, 1500], dtype=torch.int32,
                           device="cuda")
    serve_lens = torch.tensor([100, 300, 600, 900, 1100, 1300, 1450, 1500], dtype=torch.int32,
                              device="cuda") + 32

    def case(q, kc, vc, lens, window):
        """SDPA on the same inputs (the library yardstick) and the bound."""
        width, hq, d = kc.shape[2], q.shape[1], q.shape[2]
        live = int(torch.clamp(lens, max=window or width).sum())
        peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
        dec_bound = bound(2 * kc.shape[1] * live * d * kc.element_size() + 2 * nbytes(q)
                          + nbytes(lens), 4.0 * hq * d * live, peak)
        pos = torch.arange(width, device="cuda")[None, :]
        mask = pos < lens[:, None].long()
        if window:
            mask = mask & (pos > lens[:, None].long() - 1 - window)
        group = hq // kc.shape[1]
        kx, vx = kc.repeat_interleave(group, 1), vc.repeat_interleave(group, 1)
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kx, vx, attn_mask=mask[:, None, None, :]), primed=True)
        return dec_bound, lib_ms

    for label, hq, hkv, d, window, splits, width, lens in (
            ("llama3-8b", HQ, HKV, D, None, (1, 4, 7), smax, lengths),
            ("hymba-1.5b global", 25, 5, 64, None, (1, 4), smax, lengths),
            ("hymba-1.5b window 1024", 25, 5, 64, 1024, (1, 4), smax, lengths),
            ("hymba-1.5b serve batch global", 25, 5, 64, None, (1, 4), 2048, serve_lens),
            ("hymba-1.5b serve batch window 1024", 25, 5, 64, 1024, (1, 4), 2048,
             serve_lens)):
        q, kc, vc = randn(b, hq, d), randn(b, hkv, smax, d), randn(b, hkv, smax, d)
        kc, vc = kc[:, :, :width], vc[:, :, :width]
        chunk = plan_lib.decode_chunk(width)
        dec_bound, lib_ms = case(q, kc, vc, lens, window)
        for ns in splits:
            kw = dict(window=window, chunk=chunk, num_splits=ns)
            key = "K7" if ns == 1 else "K8"
            kernels.reset_launch_counts()
            o = dd.flash_decode(q, kc, vc, lens, **kw)
            check_dense_route(f"{key} {label} num_splits {ns}", kernels.launch_counts())
            o_ref = dd.flash_decode_plain(q, kc, vc, lens, **kw)
            torch.cuda.synchronize()
            e, e_r = err(o, o_ref), row_err(o, o_ref)
            zero_row = float(o[(lens == 0).nonzero()[:1, 0]].float().abs().sum())
            same = all(torch.equal(dd.flash_decode(q, kc, vc, lens, **kw), o)
                       for _ in range(10))
            ms = timer.ms(lambda: dd.flash_decode(q, kc, vc, lens, **kw), primed=True)
            event_ms = timer.ms(lambda: dd.flash_decode(q, kc, vc, lens, **kw))
            plain_ms = timer.ms(lambda: dd.flash_decode_plain(q, kc, vc, lens, **kw))
            log(f"{key} {label} chunk {chunk} num_splits {ns}: max_err {e:.3e} (row-relative "
                f"{e_r:.3e}, tol {ROW_TOL:.3e}), length-0 row sum |o| {zero_row}, 10 reruns "
                f"bitwise equal {same}, {ms:.4f} ms (queue primed; {event_ms:.4f} ms with the "
                f"wrapper's host time), plain {plain_ms:.3f} ms, library sdpa {lib_ms:.4f} ms, "
                f"bound {dec_bound[0]:.5f} ms ({dec_bound[1]})")
            if e_r > ROW_TOL or zero_row != 0.0 or not same:
                raise AssertionError(f"{key} {label} num_splits {ns} disagrees with its "
                                     "plain version")
            if label == "hymba-1.5b global" and key not in results:
                results[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                    bound_ms=dec_bound[0], bound_by=dec_bound[1],
                                    library_ms=lib_ms)
        del q, kc, vc

    # float32 stays on the CUDA cores: hymba's global case in float32.
    q, kc, vc = (randn(*shape, dtype=torch.float32)
                 for shape in ((b, 25, 64), (b, 5, smax, 64), (b, 5, smax, 64)))
    dec_bound, lib_ms = case(q, kc, vc, lengths, None)
    for ns in (1, 4):
        kw = dict(chunk=plan_lib.decode_chunk(smax), num_splits=ns)
        kernels.reset_launch_counts()
        o = dd.flash_decode(q, kc, vc, lengths, **kw)
        counts = kernels.launch_counts()
        o_ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
        torch.cuda.synchronize()
        e = err(o, o_ref)
        on_cuda_cores = (counts["flash_decode"] + counts["flash_decode_split"] == 1
                         and counts["flash_decode_tc"] + counts["flash_decode_split_tc"] == 0)
        ms = timer.ms(lambda: dd.flash_decode(q, kc, vc, lengths, **kw), primed=True)
        plain_ms = timer.ms(lambda: dd.flash_decode_plain(q, kc, vc, lengths, **kw))
        log(f"K7/K8 float32 (CUDA cores) hymba-1.5b global num_splits {ns}: max_err {e:.3e} "
            f"(tol {F32_TOL}), CUDA-core entry: {on_cuda_cores}, {ms:.4f} ms (queue primed), "
            f"plain {plain_ms:.3f} ms, library sdpa (float32) {lib_ms:.4f} ms, bound "
            f"{dec_bound[0]:.5f} ms ({dec_bound[1]}, float32 peak)")
        if e > F32_TOL or not on_cuda_cores:
            raise AssertionError(f"K7/K8 float32 num_splits {ns} disagrees with its plain "
                                 "version")
    del q, kc, vc


# -- phase 3 (head_dim 256): the gemma family's widths -------------------------

#: The head_dim 256 kernel phase's widths: (model, Hq, Hkv, its local window,
#: its attention softcap). gemma2-2b's group of 2 (softcap 50, window 4096),
#: gemma3-1b's group of 4 over one kv head (no softcap, window 512).
GEMMA_WIDTHS = (("gemma2-2b", 8, 4, 4096, 50.0), ("gemma3-1b", 4, 1, 512, None))
#: The gemma train phases (``train``): layers kept, sequence, global batch
#: and microbatches. gemma2-2b: 2 local layers (window 4096) and 2 global,
#: sequence 8192 so that the window bites; gemma3-1b: 5 local (window 512)
#: and 1 global.
GEMMA_TRAIN = {"gemma2-2b": dict(layers=4, seq=8192, batch=2, micro=2),
               "gemma3-1b": dict(layers=6, seq=4096, batch=4, micro=2)}
D256 = 256
#: Reruns of each head_dim 256 case that must give the same bits.
RERUNS = 100


def check_gemma_kernels(torch, timer):
    """K1, K2, K3, K4, K7 and K8 at head_dim 256, in bf16 on the tensor
    cores, at gemma2-2b's and gemma3-1b's widths, each with its model's
    softcap and local window: against the plain version per row within
    ROW_TOL, 100 reruns bitwise equal, every launch on the tensor-core
    kernel, CUDA-event medians (decode kernels and K2 with the queue
    primed), the bound (bytes over 3.35 TB/s against operations over 989
    TFLOP/s), and SDPA where one call computes the same function: K1 and
    K7/K8 without a softcap (gemma3-1b; at gemma2-2b's widths SDPA, which
    has no softcap, is timed on the same shapes without it and said so).
    K1: B 1, S 8192, global and the local window; K2: B 2, prefix 1000,
    tail 256 (the second row's live to 219), pages of 16; K3 / K4 (4
    splits): B 8, lengths up to 4096 and a length-0 row, pages of 16, with
    the plan's split model beside them; K7 / K8 (4 splits) the same rows on
    4096-row stripes; at gemma2-2b's widths K1 and K7 / K8 again without
    the softcap. Returns one row per (kernel, width) for the summary line."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.core import numa, perf_model
    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import paged_prefill_attention as pp
    from repro_torch.kernels import plan as plan_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    d = D256

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = []

    def report(key, label, run, plain, o, o_ref, kb, lib_ms, counter, primed, extra=""):
        torch.cuda.synchronize()
        e_r = row_err(o, o_ref)
        same = sum(not torch.equal(run(), o) for _ in range(RERUNS))
        kernels.reset_launch_counts()
        run()
        launched = kernels.launch_counts()
        ms = timer.ms(run, primed=primed)
        plain_ms = timer.ms(plain)
        log(f"{key} D 256 {label}: row-relative {e_r:.3e} (tol {ROW_TOL:.3e}), {same} of "
            f"{RERUNS} reruns differ, {ms:.4f} ms{' (queue primed)' if primed else ''}, plain "
            f"{plain_ms:.3f} ms, library sdpa "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}{extra}, bound {kb[0]:.5f} ms "
            f"({kb[1]})")
        if e_r > ROW_TOL or same or launched[counter] != 1:
            raise AssertionError(f"{key} D 256 {label}: disagrees with its plain version, "
                                 "changes between reruns or missed the tensor-core kernel")
        rows.append(dict(kernel=key, widths=label, ms=ms, plain_ms=plain_ms, bound_ms=kb[0],
                         bound_by=kb[1], library_ms=lib_ms, row_err=e_r))

    lens8 = [4096, 0, 3001, 17, 2048, 4000, 1, 1500]
    no_cap_ms = {}   # (kernel, window) -> ms at gemma2-2b's widths without the softcap
    for model, hq, hkv, local, cap in GEMMA_WIDTHS:
        no_cap = "" if cap is None else " (sdpa without the softcap: it has none)"
        # K1: B 1, S 8192, global and the local window.
        s = 8192
        q, k, v = randn(1, hq, s, d), randn(1, hkv, s, d), randn(1, hkv, s, d)
        pos = torch.arange(s, device="cuda")
        for window in (None, local):
            kw = dict(causal=True, window=window, softcap=cap)
            run = lambda: fa.flash_attention_fwd(q, k, v, **kw)[0]
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, **kw)
            kb = k1_bound_of(q, k, v, o, lse, causal=True, window=window)
            if window is None:
                sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True)
            else:
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              enable_gqa=True)
            report("K1", f"{model} (Hq {hq}, Hkv {hkv}) B 1 S {s} window {window}", run,
                   lambda: fa.flash_attention_fwd_plain(q, k, v, **kw), o, o_ref, kb,
                   timer.ms(sdpa), "flash_attention_fwd_tc", False, no_cap)
            del o, lse, o_ref
        if cap is not None:
            # Like for like with SDPA, which has no softcap: both cases again
            # without it.
            for window in (None, local):
                ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                                             window=window))
                log(f"K1 D 256 {model} (Hq {hq}, Hkv {hkv}) B 1 S {s} window {window} without "
                    f"the softcap: {ms:.4f} ms")
                no_cap_ms[("K1", window)] = ms
        del q, k, v
        rows.extend(check_gemma_backward(torch, timer, gen, model, hq, hkv, local, cap))

        # K2: B 2, prefix 1000, tail 256, pages of 16, the local window.
        b, plen, st, tlens = 2, 1000, 256, [256, 219]
        mp = -(-plen // PS)
        num_pages = 1 + b * mp
        kp, vp = randn(hkv, num_pages, PS, d), randn(hkv, num_pages, PS, d)
        perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
        table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
        q, kt, vt = randn(b, hq, st, d), randn(b, hkv, st, d), randn(b, hkv, st, d)
        plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
        tl = torch.tensor(tlens, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, table, kt, vt, plens, tl)
        kw = dict(window=local, softcap=cap)
        run = lambda: pp.paged_flash_prefill(*args, **kw)
        o = run()
        o_ref = pp.paged_flash_prefill_plain(*args, **kw)
        # Tail row i sits at plen + i and sees min(plen + i + 1, local) keys;
        # the prefix keys any row needs are its last local - 1.
        seen = sum(min(plen + i + 1, local) for t in tlens for i in range(t))
        kb = bound(2 * hkv * b * min(plen, local - 1) * d * 2
                   + nbytes(q, kt, vt, o, table, plens, tl), 4.0 * d * hq * seen)
        report("K2", f"{model} (Hq {hq}, Hkv {hkv}) prefix {plen} tail {st} window {local}",
               run, lambda: pp.paged_flash_prefill_plain(*args, **kw), o, o_ref, kb, None,
               "paged_flash_prefill_tc", True)
        del kp, vp, q, kt, vt, o, o_ref, args

        # K3 / K4: B 8, lengths up to 4096 over 256-page tables, pages of 16.
        b, mp = 8, 4096 // PS
        num_pages = 1 + b * mp
        kp, vp = randn(hkv, num_pages, PS, d), randn(hkv, num_pages, PS, d)
        perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
        table = perm.reshape(b, mp).to(torch.int32).contiguous()
        lengths = torch.tensor(lens8, dtype=torch.int32, device="cuda")
        q = randn(b, hq, d)
        live = sum(min(n, local) for n in lens8)
        kb = bound(2 * hkv * live * d * 2 + nbytes(q, q, table, lengths), 4.0 * hq * d * live)
        # The plan's split model at these widths, every row at the table's
        # 4096 positions (its reading of a tick), beside the times.
        est = dict(perf_model.estimate_decode_splits(
            batch=b, num_q_heads=hq, num_kv_heads=hkv, seq_kv=4096, granule=PS, head_dim=d,
            dtype_bytes=2, topo=numa.H100, window=local).times)
        for ns, key, counter in ((1, "K3", "paged_flash_decode_tc"),
                                 (4, "K4", "paged_flash_decode_split_tc")):
            kw = dict(window=local, softcap=cap, num_splits=ns)
            run = lambda: pd.paged_flash_decode(q, kp, vp, table, lengths, **kw)
            o = run()
            o_ref = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, **kw)
            report(key, f"{model} (Hq {hq}, Hkv {hkv}) B 8 table 4096 window {local} "
                        f"num_splits {ns}", run,
                   lambda: pd.paged_flash_decode_plain(q, kp, vp, table, lengths, **kw), o,
                   o_ref, kb, None, counter, True,
                   f", split model {est[ns] * 1e3:.4f} ms")
            rows[-1]["split_model_ms"] = est[ns] * 1e3
        del kp, vp, q, o, o_ref
        t = time.perf_counter()
        rows.extend(check_gemma_quantized(torch, timer, gen, model, hq, hkv, local, cap))
        log(f"K2q, K3q / K4q at D 256, {model}: {time.perf_counter() - t:.1f} s")

        # K7 / K8: the same rows on 4096-row stripes; SDPA on the stripes
        # expanded to Hq under the length and window mask.
        smax = 4096
        q, kc, vc = randn(b, hq, d), randn(b, hkv, smax, d), randn(b, hkv, smax, d)
        p = torch.arange(smax, device="cuda")[None, :]
        mask = (p < lengths[:, None].long()) & (p > lengths[:, None].long() - 1 - local)
        kx, vx = kc.repeat_interleave(hq // hkv, 1), vc.repeat_interleave(hq // hkv, 1)
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kx, vx, attn_mask=mask[:, None, None, :]), primed=True)
        kb = bound(2 * hkv * live * d * 2 + 2 * nbytes(q) + nbytes(lengths),
                   4.0 * hq * d * live)
        for ns, key, counter in ((1, "K7", "flash_decode_tc"),
                                 (4, "K8", "flash_decode_split_tc")):
            kw = dict(window=local, softcap=cap, chunk=plan_lib.decode_chunk(smax),
                      num_splits=ns)
            run = lambda: dd.flash_decode(q, kc, vc, lengths, **kw)
            o = run()
            o_ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
            report(key, f"{model} (Hq {hq}, Hkv {hkv}) B 8 stripes 4096 window {local} "
                        f"num_splits {ns}", run,
                   lambda: dd.flash_decode_plain(q, kc, vc, lengths, **kw), o, o_ref, kb,
                   lib_ms, counter, True, no_cap)
            if cap is not None:
                kw.pop("softcap")
                ms = timer.ms(lambda: dd.flash_decode(q, kc, vc, lengths, **kw), primed=True)
                log(f"{key} D 256 {model} (Hq {hq}, Hkv {hkv}) B 8 stripes 4096 window "
                    f"{local} num_splits {ns} without the softcap: {ms:.4f} ms (queue primed; "
                    f"sdpa {lib_ms:.4f} ms)")
                no_cap_ms[(key, local)] = ms
        del q, kc, vc, kx, vx, o, o_ref
    for row in rows:
        window = int(row["widths"].split("window ")[1].split()[0].replace("None", "-1"))
        ms = no_cap_ms.get((row["kernel"], None if window < 0 else window))
        if ms is not None and row["widths"].startswith("gemma2-2b"):
            row["ms_without_softcap"] = ms
    return rows


def check_gemma_quantized(torch, timer, gen, model, hq, hkv, local, cap):
    """K3q / K4q and K2q at head_dim 256 (bf16 q over int8 and fp8 pools,
    on the tensor cores) at ``model``'s widths, with its softcap, over
    pools whose null page holds NaN scales and e4m3 NaN codes (``quant_pools``,
    pages of PS). Decode: B 8 with lengths up to 4096 and a length-0 row,
    global and the local window, at 1 and 4 splits; the serve run (a)'s
    decode shape, 8 rows of 560 tokens on 36-page tables, 2 of them frozen
    on the null page, at 1 and 2 splits; run (b)'s, one row of 4200 tokens
    on a 268-page table, at 1, 2, 4 and 8 splits beside the split
    estimator's pick for the format (both with the local window). Prefill:
    B 2, prefix 1000 on a 63-page table, tail 256, the second row live to
    219, global and the local window; the serve run (a)'s extend shape, 7
    rows of prefix 256 on 16 pages and tail 256. Bars as ``check_quantized``:
    each live row within ROW_TOL of the plain version, within QTOL of the
    unquantized bf16 kernel on the same values (``quant_decode_bars``),
    finite; length-0 rows and rows past tail_len exactly zero; every launch
    on the tensor-core entry; ten reruns bitwise equal, the frozen rows'
    NaNs too; K2q bit for bit K2 over bf16 pools of the dequantized values.
    Times: CUDA-event medians, primed, L2 flushed, beside the bf16 kernel on
    bf16 pools (K3 / K4 / K2 at D 256) in the same call; the plain version
    timed for the B 8 case (int8, the local window) and the B 2 ones. Bound:
    codes at 1 B a live position,
    the live pages' scales, q, the tail, out and the table over 3.35 TB/s
    against the operations at the bf16 peak. Returns one row per case."""
    from repro_torch import kernels
    from repro_torch.cache import quant
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import paged_prefill_attention as pp
    from repro_torch.kernels import plan

    d, rows = D256, []
    widths = f"{model} (Hq {hq}, Hkv {hkv})"
    for kv_dtype in ("int8", "fp8"):
        for label, mp, lens, frozen, windows, splits, timed in (
                ("B 8 table 4096", 4096 // PS, [4096, 0, 3001, 17, 2048, 4000, 1, 1500], (),
                 (None, local), (1, 4), True),
                ("serve decode shape (a) B 8 x 560 table 36 rows 6-7 frozen", 36, [560] * 8,
                 (6, 7), (local,), (1, 2), False),
                (f"serve decode shape (b) B 1 x {GEMMA_B_LEN} table 268", 268, [GEMMA_B_LEN],
                 (), (local,), (1, 2, 4, 8), False)):
            b = len(lens)
            (xk, kc, ks), (xv, vc, vs) = quant_pools(torch, gen, hkv, 1 + b * mp, d, kv_dtype)
            table = quant_table(torch, gen, lens, mp, frozen)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = torch.randn((b, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
            kb, vb = xk.to(torch.bfloat16), xv.to(torch.bfloat16)
            live = [i for i in range(b) if i not in frozen]
            zero = [i for i in live if lens[i] == 0]
            for window in windows:
                seen = [min(lens[i], window or lens[i]) for i in live]
                pages = sum(-(-lens[i] // PS) - (lens[i] - n) // PS for i, n in zip(live, seen))
                qb = bound(2 * hkv * d * sum(seen) + 2 * hkv * pages * 4
                           + nbytes(q, q, table, lengths), 4.0 * hq * d * sum(seen))
                if b == 1:
                    chosen = plan.plan_attention((b, hq, hkv, 1, mp * PS, d), phase=plan.DECODE,
                                                 kv_layout=plan.PAGED, page_size=PS,
                                                 window=window, kv_dtype=kv_dtype).num_splits
                    log(f"K4q D 256 {widths} {kv_dtype} {label}: the split estimator picks "
                        f"{chosen} splits")
                for ns in splits:
                    key = "K3q" if ns == 1 else "K4q"
                    kw = dict(num_splits=ns, window=window, softcap=cap)
                    run = lambda: pd.paged_flash_decode(q, kc, vc, table, lengths, k_scales=ks,
                                                        v_scales=vs, **kw)
                    kernels.reset_launch_counts()
                    o = run()
                    counter = KERNELS[key]["counter"]
                    routed = only_launched(kernels.launch_counts(), counter,
                                           counter[:-len("_tc")])
                    o_ref = pd.paged_flash_decode_plain(q, kc, vc, table, lengths, k_scales=ks,
                                                        v_scales=vs, **kw)
                    o_bf = pd.paged_flash_decode(q, kb, vb, table, lengths, **kw)
                    bits = o.view(torch.int16)
                    same = all(torch.equal(run().view(torch.int16), bits) for _ in range(10))
                    torch.cuda.synchronize()
                    ok = (routed and same and bool(torch.isfinite(o[live].float()).all())
                          and all(float(o[i].float().abs().max()) == 0.0 for i in zero))
                    e_r = row_err(o[live], o_ref[live])
                    name = (f"{key} D 256 {widths} {kv_dtype} {label} window {window} "
                            f"num_splits {ns}")
                    log(f"{name}: routed to {counter} {routed}, 10 reruns bitwise equal {same}")
                    check_quant_rows(name, ok, e_r, None, o[live], o_bf[live],
                                     quant_decode_bars(lens, live, table, vc, vs, vb, kv_dtype))
                    ms = timer.ms(run, primed=True)
                    bf_ms = timer.ms(lambda: pd.paged_flash_decode(q, kb, vb, table, lengths,
                                                                   **kw), primed=True)
                    # The plain walk takes ~0.2 s a call here: timed once a
                    # model and split kind (int8, the local window).
                    plain_ms = (timer.ms(lambda: pd.paged_flash_decode_plain(
                        q, kc, vc, table, lengths, k_scales=ks, v_scales=vs, **kw))
                        if timed and kv_dtype == "int8" and window == local else float("nan"))
                    log(f"{name}: {ms:.4f} ms (queue primed), the bf16 tensor-core kernel on "
                        f"bf16 pools {bf_ms:.4f} ms ({ms / bf_ms:.3f}x), plain {plain_ms:.3f} ms, "
                        f"bound {qb[0]:.5f} ms ({qb[1]})")
                    rows.append(dict(kernel=key, widths=f"{widths} {kv_dtype} {label} window "
                                     f"{window} num_splits {ns}", ms=ms, bf16_ms=bf_ms,
                                     plain_ms=plain_ms, bound_ms=qb[0], bound_by=qb[1],
                                     library_ms=None, row_err=e_r))
            del xk, xv, kc, vc, ks, vs, kb, vb, q, o, o_ref, o_bf

        for label, b, plen, mp, tlens, windows, timed in (
                ("prefix 1000 (63-page table) tail 256", 2, 1000, 63, [256, 219],
                 (None, local), True),
                ("serve extend shape B 7 x prefix 256 (16 pages) tail 256", 7, 256, 16,
                 [256] * 7, (local,), False)):
            st = max(tlens)
            (xk, kc, ks), (xv, vc, vs) = quant_pools(torch, gen, hkv, 1 + b * mp, d, kv_dtype)
            table = quant_table(torch, gen, [plen] * b, mp)
            randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            q, kt, vt = randn(b, hq, st, d), randn(b, hkv, st, d), randn(b, hkv, st, d)
            plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
            tl = torch.tensor(tlens, dtype=torch.int32, device="cuda")
            kb, vb = xk.to(torch.bfloat16), xv.to(torch.bfloat16)
            kd, vd = (quant.dequantize_pages(c, sc).to(torch.bfloat16) for c, sc in
                      ((kc, ks), (vc, vs)))
            for window in windows:
                kw = dict(window=window, softcap=cap)
                run = lambda: pp.paged_flash_prefill(q, kc, vc, table, kt, vt, plens, tl,
                                                     k_scales=ks, v_scales=vs, **kw)
                kernels.reset_launch_counts()
                o = run()
                counter = KERNELS["K2q"]["counter"]
                routed = only_launched(kernels.launch_counts(), counter, counter[:-len("_tc")])
                o_ref = pp.paged_flash_prefill_plain(q, kc, vc, table, kt, vt, plens, tl,
                                                     k_scales=ks, v_scales=vs, **kw)
                o_bf = pp.paged_flash_prefill(q, kb, vb, table, kt, vt, plens, tl, **kw)
                o_deq = pp.paged_flash_prefill(q, kd, vd, table, kt, vt, plens, tl, **kw)
                same = all(torch.equal(run(), o) for _ in range(10))
                torch.cuda.synchronize()
                bitwise = torch.equal(o, o_deq)
                past = sum(float(o[i, :, t:].float().abs().sum()) for i, t in enumerate(tlens))
                ok = (routed and past == 0.0 and bitwise and same
                      and bool(torch.isfinite(o.float()).all()))
                name = f"K2q D 256 {widths} {kv_dtype} {label} window {window}"
                e_r = row_err(o, o_ref)
                log(f"{name}: routed to {counter} {routed}, bitwise equal to K2 on bf16 pools of "
                    f"the dequantized values {bitwise}, rows past tail_len sum |o| {past}, 10 "
                    f"reruns bitwise equal {same}")
                check_quant_rows(name, ok, e_r, None, o, o_bf,
                                 torch.full((b,), QTOL[kv_dtype], device="cuda"))
                # Tail row i sits at plen + i and sees min(plen + i + 1, window)
                # keys; the prefix positions any row needs are its last window - 1.
                pairs = hq * sum(min(plen + i + 1, window or plen + i + 1)
                                 for t in tlens for i in range(t))
                pref = min(plen, window - 1) if window else plen
                kq = bound(2 * hkv * d * pref * b + 2 * hkv * b * -(-pref // PS) * 4
                           + nbytes(q, kt, vt, o, table, plens, tl), 4.0 * d * pairs)
                ms = timer.ms(run, primed=True)
                bf_ms = timer.ms(lambda: pp.paged_flash_prefill(q, kb, vb, table, kt, vt, plens,
                                                                tl, **kw), primed=True)
                plain_ms = (timer.ms(lambda: pp.paged_flash_prefill_plain(
                    q, kc, vc, table, kt, vt, plens, tl, k_scales=ks, v_scales=vs, **kw))
                    if timed else float("nan"))
                log(f"{name}: {ms:.4f} ms (queue primed), the bf16 tensor-core kernel on bf16 "
                    f"pools {bf_ms:.4f} ms ({ms / bf_ms:.3f}x), plain {plain_ms:.3f} ms, bound "
                    f"{kq[0]:.5f} ms ({kq[1]})")
                rows.append(dict(kernel="K2q", widths=f"{widths} {kv_dtype} {label} window "
                                 f"{window}", ms=ms, bf16_ms=bf_ms, plain_ms=plain_ms,
                                 bound_ms=kq[0], bound_by=kq[1], library_ms=None, row_err=e_r))
            del xk, xv, kc, vc, ks, vs, kb, vb, kd, vd, q, kt, vt, o, o_ref, o_bf, o_deq
    return rows


def check_gemma_backward(torch, timer, gen, model, hq, hkv, local, cap):
    """K5 and K6 at head_dim 256 (bf16, tensor cores) at ``model``'s train
    shape (``GEMMA_TRAIN``: one microbatch), causal, global and its local
    window, with its softcap: each gradient per (b, head) slice within
    ROW_TOL of the plain backward, 100 reruns of each kernel and the
    block-first order bitwise equal to the first run, one launch each on the
    tensor cores, CUDA-event medians with the queue primed (the card's time)
    and without (the wrappers' host time included), the bound (bytes over
    3.35 TB/s
    against K5's three and K6's four products over the live (row, key)
    pairs at 989 TFLOP/s) and SDPA's backward like for like: no softcap
    (K5 / K6 timed again without it), the window as an explicit mask, K / V
    expanded to Hq; also K6's part count (``dkv_parts``, the wrapper's pick)
    and its longest block's walk against the mean. Returns one row per
    (kernel, window)."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    d = D256
    run_cfg = GEMMA_TRAIN[model]
    b, s = run_cfg["batch"] // run_cfg["micro"], run_cfg["seq"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d), randn(b, hq, s, d)
    pos = torch.arange(s, device="cuda")
    group = hq // hkv
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for window in (None, local):
        label = f"{model} (Hq {hq}, Hkv {hkv}) B {b} S {s} window {window}"
        kw = dict(causal=True, window=window, softcap=cap)
        # K6's part count (the wrapper's own pick) and its blocks' walks.
        parts = fb.dkv_parts(b, hq, hkv, s, s, causal=True, window=window, sms=sms)
        walks = fb.dkv_part_walks(fb.dkv_walks(s, s, group, causal=True, window=window), parts)
        longest, mean_walk = max(walks), sum(walks) / len(walks)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)

        def run(order=fa.HEAD_FIRST, kw=kw):
            mapping = fa.MappingConfig(order=order)
            dq = fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, mapping=mapping, **kw)
            return (dq, *fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, mapping=mapping,
                                                    **kw))

        kernels.reset_launch_counts()
        got = run()
        launched = bwd_launches({key: 0 for key in kernels.launch_counts()},
                                kernels.launch_counts())
        ref = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        rel = [slice_err(g, r) for g, r in zip(got, ref)]
        ab = [err(g, r) for g, r in zip(got, ref)]
        del ref
        differ = sum(not all(torch.equal(x, y) for x, y in zip(run(), got))
                     for _ in range(RERUNS))
        orders = all(torch.equal(x, y) for x, y in zip(run(fa.BLOCK_FIRST), got))
        del got

        def both(fn):   # (queue primed, with the host time)
            return timer.ms(fn, primed=True), timer.ms(fn)

        (ms5, host5), (ms6, host6) = (
            both(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)),
            both(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)))
        plain_ms = timer.ms(lambda: fb.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw))
        no_cap = ""
        if cap is not None:
            nc = dict(kw, softcap=None)
            (nc5, nch5), (nc6, nch6) = (
                both(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **nc)),
                both(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **nc)))
            no_cap = (f"; without the softcap K5 {nc5:.4f} ms ({nch5:.4f}), K6 {nc6:.4f} ms "
                      f"({nch6:.4f})")
        # SDPA's backward on the same shapes (no softcap; the window as a mask).
        leaves = [t.detach().requires_grad_(True) for t in
                  (q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))]
        try:
            if window is None:
                out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            else:
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lib_ms, lib_host = both(lambda: torch.autograd.grad(out, leaves, do,
                                                                retain_graph=True))
            lib = f"{lib_ms:.4f} ms ({lib_host:.4f})"
            del out
        except RuntimeError as e:   # no SDPA backend takes these shapes
            lib_ms, lib = None, f"refused ({str(e).splitlines()[0][:160]})"
        del leaves
        torch.cuda.empty_cache()
        pairs = b * hq * sum(min(r + 1, window or s) for r in range(s))
        b5 = bound(nbytes(q, k, v, do, lse, delta, q), 6.0 * d * pairs)
        b6 = bound(nbytes(q, k, v, do, lse, delta, k, v), 8.0 * d * pairs)
        log(f"K5/K6 D 256 {label} softcap {cap}: per-slice relative dq {rel[0]:.3e} dk "
            f"{rel[1]:.3e} dv {rel[2]:.3e} (tol {ROW_TOL:.3e}), max abs {ab[0]:.3e} "
            f"{ab[1]:.3e} {ab[2]:.3e}; {differ} of {RERUNS} reruns differ, block-first "
            f"bitwise equal {orders}; launches (all, on the tensor cores) {launched}; times "
            f"with the queue primed (in parentheses with the wrappers' host time): K5 "
            f"{ms5:.4f} ms ({host5:.4f}) bound {b5[0]:.4f} ({b5[1]}), K6 {ms6:.4f} ms "
            f"({host6:.4f}) bound {b6[0]:.4f} ({b6[1]}), pair {ms5 + ms6:.4f} ms "
            f"({host5 + host6:.4f}); plain (pair) {plain_ms:.3f} ms; library sdpa backward "
            f"{lib}{no_cap}; K6 in {parts} part(s) of {b * hkv * len(walks)} blocks on {sms} "
            f"SMs, longest block {longest} tiles against a mean of {mean_walk:.2f} "
            f"({longest / mean_walk:.3f}x)")
        if max(rel) > ROW_TOL or differ or not orders or launched != {"dq": (1, 1),
                                                                         "dkv": (1, 1)}:
            raise AssertionError(f"K5/K6 D 256 {label}: disagree with the plain backward, "
                                 "change between reruns or orders, or missed the tensor cores")
        for key, ms, host, kb, e in (("K5", ms5, host5, b5, ab[0]),
                                     ("K6", ms6, host6, b6, max(ab[1:]))):
            rows.append(dict(kernel=key, widths=label, ms=ms, host_ms=host, plain_ms=plain_ms,
                             bound_ms=kb[0], bound_by=kb[1], library_ms=lib_ms,
                             slice_err=max(rel), max_abs_err=e))
            if cap is not None:
                rows[-1]["ms_without_softcap"] = nc5 if key == "K5" else nc6
            if key == "K6":
                rows[-1].update(parts=parts, longest_walk=longest, mean_walk=mean_walk)
        del o, lse, delta
    return rows


def check_ssd(torch, timer, results):
    """K9 against its plain version at the prefill shapes of the serve path
    (B 1, L 4096, chunk 256): hymba-1.5b (H 50, P 64, N 16) and mamba2-1.3b
    (H 64, P 64, N 128), one group of B and C (G 1), in the layout
    ``ssd_chunked_cuda`` gives the kernel: ``ssd.chunk_inputs`` of x, B, C
    in bf16 as the SSM block passes them, dt = softplus(normal) and A = -1
    .. -16 over the heads. Per (b, chunk, head) slice within SSD_TOL, both
    routes' error against float64 printed, ten reruns bitwise equal. Timed
    with the launch queue primed (the card's time; the JSON line takes
    hymba's case) and without. The bound counts the causal half of the two
    (q x q) products and the state product, three TF32 products each (the
    3xTF32 split) at the dense TF32 peak, against each input read once (B
    and C once per group) and y and the state written once; the bound at
    the float32 peak (one float32 product each) is printed beside it. Then
    the whole ``ssd_chunked_cuda`` call and its parts: the preparation
    (padding, cumsum, dt x, float32 copies), K9, and the recurrence with
    the cross-chunk term. No one PyTorch call computes this block: no
    library time."""
    from repro_torch.kernels import ssd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bsz, length, chunk = 1, 4096, 256
    perm = (0, 1, 3, 2, 4)
    for label, h, p, n in (("hymba-1.5b", 50, 64, 16), ("mamba2-1.3b", 64, 64, 128)):
        x = randn(bsz, length, h, p, dtype=torch.bfloat16)
        dt = torch.nn.functional.softplus(randn(bsz, length, h))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        bm, cm = (randn(bsz, length, 1, n, dtype=torch.bfloat16) for _ in range(2))
        xdt, bq, cq, acum = ssd.chunk_inputs(x, dt, a, bm, cm, chunk)
        nc, q = xdt.shape[1], xdt.shape[2]
        jax_layout = (xdt.permute(perm), bq.permute(perm), cq.permute(perm),
                      acum.permute(0, 1, 3, 2))

        def run():
            return ssd.ssd_intra_chunk_seq(xdt, bq, cq, acum)

        y, s = run()
        y_ref, s_ref = ssd.ssd_intra_chunk_plain(*jax_layout)
        # The same function in float64: how far each float32 route is from it.
        y64, s64 = (t.float() for t in ssd.ssd_intra_chunk_plain(
            *(t.double() for t in jax_layout)))
        torch.cuda.synchronize()
        yk, sk = y.permute(perm), s.transpose(-1, -2)          # the JAX layout, as views
        e_y, e_s = slice_err(yk, y_ref), slice_err(sk, s_ref)
        e = max(err(yk, y_ref), err(sk, s_ref))
        log(f"K9 {label} against float64: kernel y {slice_err(yk, y64):.3e} s "
            f"{slice_err(sk, s64):.3e}, plain y {slice_err(y_ref, y64):.3e} s "
            f"{slice_err(s_ref, s64):.3e} (per-slice relative)")
        del y64, s64, y_ref, s_ref
        same = all(all(torch.equal(u, v) for u, v in zip(run(), (y, s))) for _ in range(10))
        ms = timer.ms(run, primed=True)
        event_ms = timer.ms(run)
        plain_ms = timer.ms(lambda: ssd.ssd_intra_chunk_plain(*jax_layout))
        ops = 2.0 * bsz * nc * h * (q * (q + 1) // 2 * (n + p) + q * n * p)
        moved = nbytes(xdt, bq, cq, acum, y, s)
        k9_bound = bound(moved, 3 * ops, PEAK_TF32_FLOPS)
        f32_bound = bound(moved, ops, PEAK_F32_FLOPS)
        log(f"K9 {label} (B {bsz}, L {length}, H {h}, P {p}, N {n}, G 1, q {q}): per-slice "
            f"relative y {e_y:.3e} s {e_s:.3e} (tol {SSD_TOL:.0e}), max abs {e:.3e}, 10 reruns "
            f"bitwise equal {same}; {ms:.4f} ms (queue primed; {event_ms:.4f} ms with the "
            f"wrapper's host time), plain {plain_ms:.3f} ms; bound {k9_bound[0]:.4f} ms "
            f"({k9_bound[1]}: {moved / 1e6:.1f} MB, 3 x {ops / 1e9:.2f} GFLOP at the TF32 "
            f"peak), {f32_bound[0]:.4f} ms at the float32 peak ({f32_bound[1]})")
        if max(e_y, e_s) > SSD_TOL or not same:
            raise AssertionError(f"K9 {label} disagrees with its plain version")
        if "K9" not in results:
            results["K9"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                 bound_ms=k9_bound[0], bound_by=k9_bound[1], library_ms=None)
        whole = timer.ms(lambda: ssd.ssd_chunked_cuda(x, dt, a, bm, cm, chunk), primed=True)
        prep = timer.ms(lambda: ssd.chunk_inputs(x, dt, a, bm, cm, chunk), primed=True)
        rest = timer.ms(lambda: ssd.inter_chunk(y, s, cq, acum, length), primed=True)
        log(f"ssd_chunked_cuda {label} (bf16 x, B, C): {whole:.4f} ms (queue primed); parts "
            f"alone: preparation {prep:.4f} ms, K9 {ms:.4f} ms, recurrence + y_inter "
            f"{rest:.4f} ms")
        del x, dt, bm, cm, xdt, bq, cq, acum, y, s, yk, sk


# -- phase 3b: the plan's models against the card -----------------------------

#: Split-K calibration grid (plan phase (a)): rows x table pages at page 16,
#: and the split counts timed at each. The serve runs' tables (36 pages at 8
#: rows, 260 at 1) are timed beside them. The fit uses every shape not held
#: out; the held-out ones check it, the loadgen engine's (8 rows, 128 pages)
#: among them.
SPLIT_ROWS = (1, 2, 4, 8)
SPLIT_TABLES = (128, 256)
SPLIT_COUNTS = (1, 2, 3, 4, 6, 8, 12, 16)
SPLIT_EXTRA = ((8, 36), (1, 260))
SPLIT_HELD_OUT = ((8, 128), (2, 256), (1, 260))
#: The plan's pick may take at most this much more than the fastest split
#: count measured at its shape (plan phase (a)), and K1 under the scorer's
#: launch at most this much more than the fastest of the three (b).
SPLIT_PICK_TOL = 1.15
MAPPING_PICK_TOL = 1.10
#: Plan part (d): the route the plan picks for a paged extend may take at
#: most this much more than the faster of K2 and the gather route.
EXTEND_PICK_TOL = 1.10


def graph_ms(torch, timer, fn):
    """CUDA-event median of one replay of ``fn`` captured as a CUDA graph,
    the queue primed (as the engines' decode runs: one graph replay per
    sync); the graph and its memory are freed after."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    ms = timer.ms(g.replay, primed=True)
    del g
    return ms


def split_model_times(points, stream_bw, hbm_bw, wave_s):
    """The split model's terms at each measured ``(rows, pages, splits)``
    point, vectorised over candidate (stream_bw, hbm_bw, wave_s) rows: the
    core time ``max(waves * (wave_s + bytes / s / stream_bw), cells * bytes
    / hbm_bw)``; the state round trip; the 0/1 of a split; the split count.
    The formula of ``perf_model.estimate_decode_splits``, whose flops term
    (under 3% of the bytes term at these shapes) is left out; the launch,
    combine and per-split costs add linearly."""
    import numpy as np

    from repro_torch.core import numa

    topo = numa.H100
    cells = np.array([b * HKV for b, _, _ in points], float)
    s = np.array([ns for _, _, ns in points], float)
    kv = np.array([2.0 * pages * PS * D * 2 for _, pages, _ in points])
    waves = np.ceil(cells * s / topo.num_domains)
    rows, group = topo.state_rows, HQ // HKV
    gp = max(rows, -(-group // rows) * rows)
    state = np.where(s > 1, cells * s * 2 * 4.0 * gp * (D + 2) / topo.hbm_bw, 0.0)
    core = np.maximum(waves * (np.asarray(wave_s, float)[:, None] + kv / s
                               / np.asarray(stream_bw, float)[:, None]),
                      cells * kv / np.asarray(hbm_bw, float)[:, None])
    return core, state, (s > 1).astype(float), s


def fit_split_model(points, measured):
    """Least squares in relative error over the fit points: a grid over the
    per-cell stream rate, the aggregate rate and the wave cost; for each, the
    launch cost, the combine's fixed cost and its cost per split solved in
    closed form (the model is linear in them), clamped at 0. Returns
    (stream_bw, hbm_bw, wave_s, launch_s, combine_s, split_s, rms relative
    error)."""
    import itertools

    import numpy as np

    t = np.array(measured)
    grid = np.array(list(itertools.product(
        np.geomspace(10e9, 200e9, 60), np.geomspace(1.5e12, 3.35e12, 40),
        np.linspace(0.0, 12e-6, 49))))
    core, state, split, s = split_model_times(points, grid[:, 0], grid[:, 1], grid[:, 2])
    y = (t - core - state) / t                      # one row per candidate
    a = np.stack([1.0 / t, split / t, split * s / t], 1)
    sol = np.maximum(y @ np.linalg.pinv(a).T, 0.0)
    rms = np.sqrt(np.mean((y - sol @ a.T) ** 2, axis=1))
    i = int(np.argmin(rms))
    return (*grid[i], *sol[i], float(rms[i]))


def split_calibration(torch, timer, gen):
    """Plan phase (a): bf16 K3 (one split) and K4 (split-K + combine) on
    llama3-8b widths, every row full (the table's width, as the plan prices
    it), at each shape of the grid and each split count of SPLIT_COUNTS
    (and the plan's pick, if another): CUDA events with the queue primed,
    and one replay of a one-launch CUDA graph, the L2 flushed before each.
    Prints per shape the committed model's time at each split count, the
    measured times and the plan's pick; fits the model's terms to the graph
    replays of the shapes not held out and prints the fit, its error at
    every shape and its own picks. Returns the failures: a shape where the
    graph time at the plan's pick exceeds SPLIT_PICK_TOL times the
    fastest."""
    import numpy as np

    from repro_torch.core import numa, perf_model
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import plan

    card = smi_line()
    shapes = [(b, t) for t in SPLIT_TABLES for b in SPLIT_ROWS] + list(SPLIT_EXTRA)
    table_rows, failures = [], []
    for b, pages in shapes:
        num_pages = 1 + b * pages
        kp = torch.randn((HKV, num_pages, PS, D), generator=gen, device="cuda").to(torch.bfloat16)
        vp = torch.randn((HKV, num_pages, PS, D), generator=gen, device="cuda").to(torch.bfloat16)
        perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
        table = perm.reshape(b, pages).to(torch.int32).contiguous()
        lengths = torch.full((b,), pages * PS, dtype=torch.int32, device="cuda")
        q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
        pick = plan.plan_attention((b, HQ, HKV, 1, pages * PS, D), phase=plan.DECODE,
                                   kv_layout=plan.PAGED, page_size=PS,
                                   device_type="cuda").num_splits
        est = perf_model.estimate_decode_splits(
            batch=b, num_q_heads=HQ, num_kv_heads=HKV, seq_kv=pages * PS, granule=PS,
            head_dim=D, dtype_bytes=2, topo=numa.H100)
        model = dict(est.times)
        graph, primed = {}, {}
        for ns in sorted(set(SPLIT_COUNTS) | {pick}):
            run = lambda: pd.paged_flash_decode(q, kp, vp, table, lengths, num_splits=ns)
            primed[ns] = timer.ms(run, primed=True)
            graph[ns] = graph_ms(torch, timer, run)
        best = min(graph, key=graph.get)
        ratio = graph[pick] / graph[best]
        held = (b, pages) in SPLIT_HELD_OUT
        log(f"split-K B {b}, table {pages} pages ({'held out' if held else 'fit'}): "
            + ", ".join(f"{ns}: model {model[ns] * 1e3:.4f} graph {graph[ns]:.4f} primed "
                        f"{primed[ns]:.4f}" for ns in sorted(graph))
            + f" ms; plan picks {pick} ({graph[pick]:.4f} ms), fastest {best} "
            f"({graph[best]:.4f} ms), ratio {ratio:.3f} (tol {SPLIT_PICK_TOL}); card: {card}")
        if ratio > SPLIT_PICK_TOL:
            failures.append(f"split-K B {b}, table {pages}: the plan's pick {pick} takes "
                            f"{ratio:.3f}x the fastest ({best})")
        table_rows.append(dict(b=b, pages=pages, held_out=held, pick=pick, fastest=best,
                               model_ms={ns: model[ns] * 1e3 for ns in graph},
                               graph_ms=graph, primed_ms=primed))
        del kp, vp, q, table, lengths

    points = [(r["b"], r["pages"], ns) for r in table_rows if not r["held_out"]
              for ns in sorted(r["graph_ms"])]
    measured = [r["graph_ms"][ns] * 1e-3 for r in table_rows if not r["held_out"]
                for ns in sorted(r["graph_ms"])]
    stream_bw, hbm_bw, wave_s, launch_s, combine_s, split_s, rms = fit_split_model(
        points, measured)
    h = numa.H100
    log(f"split-K fit over {len(points)} graph replays ({card}): decode_stream_bw "
        f"{stream_bw:.4g} B/s, decode_hbm_bw {hbm_bw:.4g} B/s, decode_wave_s {wave_s:.4g} s, "
        f"decode_launch_s {launch_s:.4g} s, COMBINE_LAUNCH_OVERHEAD_S {combine_s:.4g} s, "
        f"decode_split_s {split_s:.4g} s; rms relative error {rms:.4f}; committed "
        f"{h.decode_stream_bw:.4g}, {h.decode_hbm_bw:.4g}, {h.decode_wave_s:.4g}, "
        f"{h.decode_launch_s:.4g}, {perf_model.COMBINE_LAUNCH_OVERHEAD_S:.4g}, "
        f"{h.decode_split_s:.4g}")

    def rel(model_ms, r, splits):
        return ", ".join(f"{ns}: {m / r['graph_ms'][ns] - 1:+.3f}"
                         for ns, m in zip(splits, model_ms))

    for r in table_rows:
        splits = sorted(r["graph_ms"])
        pts = [(r["b"], r["pages"], ns) for ns in splits]
        core, state, split, s = split_model_times(pts, [stream_bw], [hbm_bw], [wave_s])
        fit = (core[0] + state + launch_s + split * (combine_s + s * split_s)) * 1e3
        # Before this PR: the data-sheet terms, no wave or launch cost, and
        # the 17 us eager combine.
        core, state, split, _ = split_model_times(pts, [h.hbm_bw / h.num_domains], [h.hbm_bw],
                                                  [0.0])
        old = (core[0] + state + split * 17e-6) * 1e3
        fit_pick = splits[int(np.argmin(fit))]
        log(f"  B {r['b']}, table {r['pages']} ({'held out' if r['held_out'] else 'fit'}), "
            f"model error per split: this call's fit {rel(fit, r, splits)}; committed "
            f"{rel([r['model_ms'][ns] for ns in splits], r, splits)}; before this PR "
            f"(data sheet, 17 us combine) {rel(old, r, splits)}; this call's fit picks "
            f"{fit_pick} ({r['graph_ms'][fit_pick] / r['graph_ms'][r['fastest']]:.3f}x the "
            f"fastest)")
    return failures


#: Plan phase (b): K1 shapes (label, B, Hq, Hkv, S, D, window): llama3-8b's
#: two prefill shapes and hymba-1.5b's windowed one.
MAPPING_SHAPES = (("llama3-8b B 2, S 2048", 2, 32, 8, 2048, 128, None),
                  ("llama3-8b B 1, S 8192", 1, 32, 8, 8192, 128, None),
                  ("hymba-1.5b B 1, S 4096, window 1024", 1, 25, 5, 4096, 64, 1024))


def mapping_views():
    """The three readings of an H100 domain the mapping model could take:
    an SM with its 256 KiB, an L2 half (25 MiB, 66 SMs), the whole L2."""
    import dataclasses as dc

    from repro_torch.core import numa

    base = numa.H100_L2
    return {"SM": dc.replace(base, name="sm", num_domains=132, slots_per_domain=1,
                             cache_bytes=256 * 1024),
            "L2 half": dc.replace(base, name="l2_half", num_domains=2, slots_per_domain=66,
                                  cache_bytes=25 * 1024 * 1024),
            "whole L2": base}


def mapping_check(torch, timer, gen):
    """Plan phase (b): bf16 K1 under each of the plan's three candidate
    launches at MAPPING_SHAPES, CUDA events with the queue primed, beside
    ``perf_model.estimate`` of each under the three cache views, and the
    scorer's pick (``plan.plan_attention``, mapping "auto"); then K1 + K5 +
    K6 at the train shape (B 2, S 4096) under both orders. Returns the
    failures: a shape where K1 at the pick takes more than MAPPING_PICK_TOL
    times the fastest candidate."""
    from repro_torch.core import perf_model, swizzle
    from repro_torch.core.cache_sim import AttentionWorkload
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import plan

    card = smi_line()
    views = mapping_views()
    failures = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def name(m):
        return m.order + ("+sawtooth" if m.traversal == swizzle.SAWTOOTH else "")

    for label, b, hq, hkv, s, d, window in MAPPING_SHAPES:
        q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
        pick = plan.plan_attention((b, hq, hkv, s, s, d), device_type="cuda",
                                   window=window).mapping
        times = {}
        for m in plan.CANDIDATES:
            times[name(m)] = timer.ms(lambda: fa.flash_attention_fwd(
                q, k, v, mapping=m, causal=True, window=window), primed=True)
        wl = AttentionWorkload(
            grid=swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=-(-s // 128),
                                       group_size=hq // hkv),
            seq_len=s, head_dim=d, block_m=128, block_n=128, causal=True, dtype_bytes=2)
        model = {view: {o: perf_model.estimate(plan.PAPER_NAME[o], wl, topo)
                        for o in (fa.HEAD_FIRST, fa.BLOCK_FIRST)}
                 for view, topo in views.items()}
        best = min(times, key=times.get)
        ratio = times[name(pick)] / times[best]
        log(f"mapping {label}: K1 " + ", ".join(f"{n} {t:.4f}" for n, t in times.items())
            + f" ms (primed); scorer picks {name(pick)}, fastest {best}, ratio {ratio:.3f} "
            f"(tol {MAPPING_PICK_TOL}); model ms (hit rate) head-first / block-first: "
            + "; ".join(f"{view} " + " / ".join(
                f"{e.time * 1e3:.4f} ({e.hit_rate:.2f})" for e in ests.values())
                for view, ests in model.items())
            + f"; card: {card}")
        if ratio > MAPPING_PICK_TOL:
            failures.append(f"mapping {label}: K1 at the pick {name(pick)} takes {ratio:.3f}x "
                            f"the fastest ({best})")
        del q, k, v

    # The train shape: the plan takes one order for the forward and the
    # backward (the JAX package has no separate backward mapping).
    b, s = 2, 4096
    q, k, v, do = randn(b, HQ, s, D), randn(b, HKV, s, D), randn(b, HKV, s, D), randn(b, HQ, s, D)
    sums = {}
    for order in (fa.HEAD_FIRST, fa.BLOCK_FIRST):
        m = fa.MappingConfig(order=order)
        o, lse = fa.flash_attention_fwd(q, k, v, mapping=m, causal=True)
        delta = (do.float() * o.float()).sum(-1)
        fwd = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, mapping=m, causal=True),
                       primed=True)
        dq = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, mapping=m),
                      primed=True)
        dkv = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, mapping=m),
                       primed=True)
        sums[order] = fwd + dq + dkv
        log(f"mapping train shape (B 2, S 4096) {order}: K1 {fwd:.4f} + K5 {dq:.4f} + K6 "
            f"{dkv:.4f} = {sums[order]:.4f} ms (primed); card: {card}")
    pick = plan.plan_attention((b, HQ, HKV, s, s, D), device_type="cuda").mapping
    log(f"mapping train shape: scorer picks {name(pick)} for the forward and the backward; "
        f"block-first takes {sums[fa.BLOCK_FIRST] / sums[fa.HEAD_FIRST]:.3f}x head-first's "
        f"K1 + K5 + K6 (not a check: the plan has one mapping for both passes)")
    return failures


def host_link_fit(torch):
    """Plan phase (c): round trips of llama3-8b page payloads (every
    layer's K and V, 2 MiB) through a weightless paged backend's own tier
    path: ``_page_payload`` (packed on the card, copied to pinned host) then
    ``_restore_page`` back, for 1, 2, 4 and 8 pages, host clock around a
    synchronize, median of 10 each way. Half a round trip is one transfer;
    a least-squares line through the four sizes fits
    ``perf_model.HOST_LINK_BW`` and ``TIER_TRANSFER_FIXED_S`` (through the
    origin where the free line's intercept falls below 0)."""
    import numpy as np

    from repro_torch.configs import llama3_8b
    from repro_torch.core import perf_model
    from repro_torch.serving.backends import PagedBackend

    sizes = (1, 2, 4, 8)
    backend = PagedBackend(llama3_8b.CONFIG, None, device=torch.device("cuda"),
                           num_pages=1 + 2 * max(sizes), page_size=PS, rows=1,
                           max_pages_per_seq=2 * max(sizes), prompt_buckets=(PS,))
    page = backend.page_nbytes()
    backend._restore_page(backend._page_payload(1), 9)      # pinned buffers, kernels warm
    down, up = {}, {}
    for n in sizes:
        d_s, u_s = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            payloads = [backend._page_payload(1 + i) for i in range(n)]
            d_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            for i, p in enumerate(payloads):
                backend._restore_page(p, 1 + max(sizes) + i)
            torch.cuda.synchronize()
            u_s.append(time.perf_counter() - t)
        down[n], up[n] = statistics.median(d_s), statistics.median(u_s)
    x = np.array([n * page for n in sizes], float)
    y = np.array([(down[n] + up[n]) / 2 for n in sizes])
    slope, fixed = np.polyfit(x, y, 1)
    if fixed < 0:
        slope, fixed = float(x @ y / (x @ x)), 0.0
    bw = 1.0 / slope
    log(f"host link, llama3-8b page payloads of {page / 2**20:.2f} MiB (host clock, median of "
        f"10), {' / '.join(map(str, sizes))} pages: device -> pinned host "
        + " / ".join(f"{down[n] * 1e3:.4f}" for n in sizes) + " ms, back "
        + " / ".join(f"{up[n] * 1e3:.4f}" for n in sizes) + " ms; fit HOST_LINK_BW "
        f"{bw:.4g} B/s, TIER_TRANSFER_FIXED_S {fixed:.4g} s; committed "
        f"{perf_model.HOST_LINK_BW:.4g} B/s, {perf_model.TIER_TRANSFER_FIXED_S:.4g} s, which "
        f"price one transfer of " + " / ".join(
            f"{perf_model.estimate_tier_transfer(n * page) * 1e3:.4f}" for n in sizes)
        + f" ms against half a round trip's " + " / ".join(f"{v * 1e3:.4f}" for v in y)
        + f" ms; card: {smi_line()}")
    backend.shutdown()
    del backend


def _fit_line(x, t):
    """(intercept, slope) of ``t = a + c x`` by least squares in relative
    error, the intercept clamped at 0 (then through the origin)."""
    import numpy as np

    x, t = np.asarray(x, float), np.asarray(t, float)
    a, c = np.linalg.lstsq(np.stack([1.0 / t, x / t], 1), np.ones_like(t), rcond=None)[0]
    if a < 0:
        a, c = 0.0, float((x / t).sum() / (x * x / t / t).sum())
    return float(a), float(c)


def extend_fit(torch, timer, gen):
    """Plan part (d): the paged extend's two routes against the plan's
    route model. ``tools/prefill_ab.extend_ab`` times K2, the gather route,
    its copies and K1 over the stripes at ``EXTEND_SHAPES`` (llama3-8b
    widths, bf16, pages of 16, L2 flushed, queue primed). Fits the H100's
    extend terms (``core.numa.ExtendTerms``) to the shapes not held out: K2
    and K1 each a launch cost plus their operations over a block's rate
    times the blocks in flight, the copies a fixed cost plus twice the
    prefix pages' bytes over a rate. Prints per shape the measured times,
    the committed model's, this call's fit's, and the plan's pick. Returns
    the failures: a shape where the plan's route takes more than
    EXTEND_PICK_TOL times the faster one, or the routes' outputs differ
    beyond ROW_TOL."""
    import dataclasses as dc

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import prefill_ab
    from repro_torch.core import numa, perf_model
    from repro_torch.kernels import plan

    card = smi_line()
    rows = prefill_ab.extend_ab(torch, timer, gen, log=log)
    h = numa.H100
    terms = h.extend

    def per_block(r):
        blocks, flops = perf_model.extend_blocks(
            batch=r["rows"], num_q_heads=HQ, prefix_len=r["prefix"], tail_len=r["tail"],
            head_dim=D, tile_rows=terms.tile_rows)
        return flops / min(blocks, h.num_domains)

    def prefix_bytes(r):
        return r["rows"] * HKV * -(-r["prefix"] // PS) * 2.0 * PS * D * 2

    fit_rows = [r for r in rows if (r["rows"], r["prefix"], r["tail"])
                not in prefill_ab.EXTEND_HELD_OUT]
    x = [per_block(r) for r in fit_rows]
    a_k2, c_k2 = _fit_line(x, [r["k2_ms"] * 1e-3 for r in fit_rows])
    a_k1, c_k1 = _fit_line(x, [r["k1_ms"] * 1e-3 for r in fit_rows])
    a_cp, c_cp = _fit_line([2 * prefix_bytes(r) for r in fit_rows],
                           [r["copy_ms"] * 1e-3 for r in fit_rows])
    fit = numa.ExtendTerms(tile_rows=terms.tile_rows, paged_cell_flops=1.0 / c_k2,
                           paged_launch_s=a_k2, gather_cell_flops=1.0 / c_k1,
                           gather_bw=1.0 / c_cp, gather_s=a_k1 + a_cp)
    log(f"extend fit over {len(fit_rows)} shapes ({card}): {fit}; committed {terms}")
    failures, errs = [], {"committed": [], "fit": []}
    for r in rows:
        b, plen, st = r["rows"], r["prefix"], r["tail"]
        mp = -(-plen // PS)
        kw = dict(batch=b, num_q_heads=HQ, num_kv_heads=HKV, prefix_len=mp * PS, tail_len=st,
                  page_size=PS, head_dim=D, dtype_bytes=2)
        model = {}
        for name, topo in (("committed", h), ("fit", dc.replace(h, extend=fit))):
            model[name] = [perf_model.estimate_extend_prefill(topo=topo, gather=g, **kw).time
                           * 1e3 for g in (False, True)]
            errs[name] += [m / t - 1 for m, t in zip(model[name], (r["k2_ms"], r["gather_ms"]))]
        pick = plan.plan_attention((b, HQ, HKV, st, mp * PS + st, D), phase=plan.EXTEND,
                                   kv_layout=plan.PAGED, page_size=PS, prefix_pages=mp,
                                   device_type="cuda").impl
        measured = {"cuda": r["k2_ms"], plan.GATHER: r["gather_ms"]}
        ratio = measured[pick] / min(measured.values())
        held = (b, plen, st) in prefill_ab.EXTEND_HELD_OUT
        log(f"extend B {b}, prefix {plen}, tail {st} ({'held out' if held else 'fit'}): K2 "
            f"{r['k2_ms']:.4f} / gather {r['gather_ms']:.4f} ms measured; committed model "
            f"{model['committed'][0]:.4f} / {model['committed'][1]:.4f}, this call's fit "
            f"{model['fit'][0]:.4f} / {model['fit'][1]:.4f}; the plan picks "
            f"{'K2' if pick == 'cuda' else 'gather'}, {ratio:.3f}x the faster route (tol "
            f"{EXTEND_PICK_TOL}); card: {card}")
        if ratio > EXTEND_PICK_TOL:
            failures.append(f"extend B {b}, prefix {plen}, tail {st}: the plan's route takes "
                            f"{ratio:.3f}x the faster")
        if r["row_err"] > ROW_TOL:
            failures.append(f"extend B {b}, prefix {plen}, tail {st}: the gather route's "
                            f"output differs from K2's by {r['row_err']:.3e}")
    log("extend model rms relative error over both routes: " + ", ".join(
        f"{name} {float(np.sqrt(np.mean(np.square(e)))):.4f} (max "
        f"{float(np.max(np.abs(e))):.4f})" for name, e in errs.items()))
    return failures


def plan_phase(torch, timer):
    """Plan phase: (a) the split-K model against K3 / K4, (b) the mapping
    scorer against K1, (c) the host link, (d) the paged extend's route
    model against K2 and the gather route. Every table is printed before
    any failure is raised."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    t = time.perf_counter()
    failures = split_calibration(torch, timer, gen)
    failures += mapping_check(torch, timer, gen)
    host_link_fit(torch)
    failures += extend_fit(torch, timer, gen)
    log(f"plan phase {time.perf_counter() - t:.1f} s")
    if failures:
        raise AssertionError("plan phase: " + "; ".join(failures))


# -- phase 4: serve llama3-8b ------------------------------------------------

def init_params(torch, cfg, seed=0, device="cuda"):
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    params = transformer.init_model(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    log(f"init_model {cfg.name}: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params


#: The paged serve engine of run (a) and of the fused decode phase: 8 rows,
#: tables of 36 pages (576 tokens: a 512-token prompt and 32 new tokens).
SERVE_PAGED_KW = dict(kv_layout="paged", max_batch=8, num_pages=1024, page_size=PS,
                      max_pages_per_seq=36, prompt_buckets=(256, 512))
#: Run (b)'s engine on top of it: one row (one request) over 260-page
#: tables, which the plan splits (K4).
SERVE_B_KW = dict(max_batch=1, max_pages_per_seq=260, prompt_buckets=(256, 512, 4096))


def serve_prompts(cfg, seed=0):
    """Run (a)'s prompts, 8 of 512 tokens sharing a 256-token prefix, and
    the generator that drew them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab, size=(256,))
    return [np.concatenate([system, rng.integers(1, cfg.vocab, size=(256,))])
            for _ in range(8)], rng


def serve(torch, cfg, params, seed=0, device="cuda", rows=8, b_len=4096, b_kw=SERVE_B_KW):
    """Runs (a) and (b) on ``cfg``: (a)'s 8 requests on an engine of ``rows``
    rows, (b)'s one request of ``b_len`` tokens on ``b_kw``'s engine."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    engine_kw = dict(SERVE_PAGED_KW, max_batch=rows, device=device)
    prompts_a, rng = serve_prompts(cfg, seed)
    prompt_b = rng.integers(1, cfg.vocab, size=(b_len,))
    greedy = SamplingParams(max_tokens=32)

    # Each run on an engine sized for it: a sync decodes every row over the
    # whole page table (one CUDA graph per (steps, stop width)), so the
    # table width sets the decode plan: one pass (K3) over (a)'s 8 rows of
    # 36 pages, split-K (K4) over (b)'s one row of 260.
    kernels.reset_launch_counts()
    runs, stats = {}, {}
    for label, prompts, uid0, kw in (("a", prompts_a, 0, engine_kw),
                                     ("b", [prompt_b], 100, dict(engine_kw, **b_kw))):
        engine = LLMEngine(cfg, params, **kw)
        t = time.perf_counter()
        out = engine.generate([Request(uid=uid0 + i, prompt=p, sampling=greedy)
                               for i, p in enumerate(prompts)])
        sync()
        runs[label] = (out, time.perf_counter() - t, dict(engine.ttft))
        stats[label] = (engine.stats(), engine.backend.decode_tick_s)
        engine.close()
        del engine
    counts = kernels.launch_counts()
    for label, (out, secs, ttfts) in runs.items():
        uids = sorted(o.uid for o in out)
        ttft = [ttfts[u] * 1e3 for u in uids]
        st, tick = stats[label]
        log(f"serve ({label}): {len(out)} requests, {sum(len(o.tokens) for o in out)} tokens "
            f"in {secs:.2f} s; TTFT ms min {min(ttft):.1f} max {max(ttft):.1f}; decode "
            f"{st.decode_tok_s:.1f} tok/s over {st.decode_elapsed_s:.2f} s (host clock, "
            f"{st.steps_per_sync} step per sync, CUDA graphs); the last sync's graph replay "
            f"{tick * 1e3:.3f} ms a tick (CUDA events); prefix hit rate "
            f"{st.prefix_hit_rate:.3f}")
    for o in sorted(runs["a"][0], key=lambda o: o.uid)[:1] + runs["b"][0][:1]:
        log(f"  uid={o.uid} tokens={[int(t) for t in o.tokens]}")
    log(f"launch counts over the serve run: {json.dumps(counts)}")
    check_k1_route(f"serve {cfg.name} paged", counts)
    check_k2_route(f"serve {cfg.name} paged", counts)
    check_paged_route(f"serve {cfg.name} paged", counts)
    for key in ("K1", "K2", "K3", "K4"):
        if counts[KERNELS[key]["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on the main path")
    for label, (out, _, _) in runs.items():
        if any(len(o.tokens) != 32 for o in out):
            raise AssertionError(f"serve ({label}) did not generate 32 tokens per request")

    # Kernel path against the plain path, same weights, on the card: one
    # sync of each run at its own engine sizes.
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    logits = {"a": compare_sync(torch, cfg, plain_cfg, params, label=f"{cfg.name} paged (a)",
                                engine_kw=engine_kw, prompts=prompts_a),
              "b": compare_sync(torch, cfg, plain_cfg, params, label=f"{cfg.name} paged (b)",
                                engine_kw=dict(engine_kw, **b_kw), prompts=[prompt_b])}
    return counts, logits


def serve_quantized(torch, cfg, params, bf16_logits, seed=0, device="cuda", rows=8,
                    b_len=4096, b_kw=SERVE_B_KW):
    """Run (a)'s and run (b)'s workloads (``serve``'s, with its ``rows``,
    ``b_len`` and ``b_kw``) on ``cfg`` paged with the pool stored as int8
    and then as fp8 codes: (a) runs K1, then K2q on its extend wave, then
    K3q in the decode graph; (b) K1 and K4q (the plan's split count over
    one row of 260 pages at llama3-8b, 268 at gemma's 4200 tokens). The
    launch counts are set to 0 just before each format's
    two runs and read just after: K2q, K3q and K4q must each have launched,
    every one of their launches on a tensor-core kernel, and no decode or
    extend launch may have gone to an unquantized kernel. Each run's TTFT
    (host clock) is printed, informative only.
    Then one sync of each run, kernel path against the plain path on the
    same format (``compare_sync``, LOGIT_TOL), and, informative only, each
    run's logits against the bf16 pool's (``bf16_logits``, from ``serve``):
    random weights through 32 layers may flip near-ties. Prints the pool's
    bytes, scales included, against the bf16 pool's. Returns the summed
    launch counts of the serve runs."""
    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    engine_kw = dict(SERVE_PAGED_KW, max_batch=rows, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    prompts_a, rng = serve_prompts(cfg, seed)
    prompt_b = rng.integers(1, cfg.vocab, size=(b_len,))
    kw_b = dict(engine_kw, **b_kw)
    greedy = SamplingParams(max_tokens=32)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    total = {}
    for kv_dtype in ("int8", "fp8"):
        kernels.reset_launch_counts()
        for label, prompts, uid0, kw in (("a", prompts_a, 0, engine_kw),
                                         ("b", [prompt_b], 100, kw_b)):
            engine = LLMEngine(cfg, params, kv_dtype=kv_dtype, **kw)
            t = time.perf_counter()
            out = engine.generate([Request(uid=uid0 + i, prompt=p, sampling=greedy)
                                   for i, p in enumerate(prompts)])
            sync()
            secs = time.perf_counter() - t
            st, b = engine.stats(), engine.backend
            bf16_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * PS * cfg.head_dim * 2
                          * b.pool.num_pages)
            ttft = sorted(engine.ttft[o.uid] * 1e3 for o in out)
            log(f"serve {cfg.name} {kv_dtype} ({label}): {len(out)} requests, "
                f"{sum(len(o.tokens) for o in out)} tokens in {secs:.2f} s; TTFT ms min "
                f"{ttft[0]:.1f} median {statistics.median(ttft):.1f} max {ttft[-1]:.1f}; decode "
                f"{st.decode_tok_s:.1f} tok/s (host clock, CUDA graphs); the last sync's graph "
                f"replay {b.decode_tick_s * 1e3:.3f} ms a tick (CUDA events); prefix hit rate "
                f"{st.prefix_hit_rate:.3f}; pool {b.kv_pool_bytes() / 2**20:.1f} MiB with its "
                f"scales against {bf16_bytes / 2**20:.1f} MiB in bf16 "
                f"({b.kv_pool_bytes() / bf16_bytes:.4f}x)")
            if any(len(o.tokens) != 32 for o in out):
                raise AssertionError(f"serve {kv_dtype} ({label}): not 32 tokens each")
            engine.close()
            del engine, b
        counts = kernels.launch_counts()
        log(f"launch counts over the {kv_dtype} serve runs: "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        for key in ("K2q", "K3q", "K4q"):
            if counts[KERNELS[key]["counter"]] <= 0:
                raise AssertionError(f"{key} was not launched on the {kv_dtype} serve path")
        prefill_q = counts["paged_flash_prefill_q"]
        prefill_q_tc = counts["paged_flash_prefill_q_tc"]
        log(f"{kv_dtype} serve: K2q launches {prefill_q}, on the tensor cores {prefill_q_tc}")
        if prefill_q_tc != prefill_q:
            raise AssertionError(f"{kv_dtype} serve: {prefill_q - prefill_q_tc} K2q launches "
                                 "missed the tensor-core kernel")
        decode_q = counts["paged_flash_decode_q"] + counts["paged_flash_decode_split_q"]
        decode_q_tc = counts["paged_flash_decode_q_tc"] + counts["paged_flash_decode_split_q_tc"]
        log(f"{kv_dtype} serve: K3q / K4q launches {decode_q}, on the tensor cores {decode_q_tc}")
        if decode_q_tc != decode_q:
            raise AssertionError(f"{kv_dtype} serve: {decode_q - decode_q_tc} K3q / K4q launches "
                                 "missed the tensor-core kernel")
        unquantized = sum(counts[c] for c in ("paged_flash_prefill", "paged_flash_decode",
                                              "paged_flash_decode_split"))
        if unquantized:
            raise AssertionError(f"{kv_dtype} serve: {unquantized} paged launches went to an "
                                 "unquantized kernel")
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        for label, kw, prompts in (("a", engine_kw, prompts_a), ("b", kw_b, [prompt_b])):
            got = compare_sync(torch, cfg, plain_cfg, params,
                               label=f"{cfg.name} paged {kv_dtype} ({label})",
                               engine_kw=dict(kw, kv_dtype=kv_dtype), prompts=prompts)
            dist = {stage: max(float((got[stage][u] - ref).abs().max() / ref.abs().max())
                               for u, ref in bf16_logits[label][stage].items())
                    for stage in ("first", "last")}
            log(f"  {kv_dtype} ({label}) against the bf16 pool, informative: prefill logits "
                f"max |{kv_dtype} - bf16| / max |bf16| = {dist['first']:.3e}, decode tick "
                f"{dist['last']:.3e}")
    return total


def serve_gather(torch, cfg, params, seed=0, device="cuda"):
    """Run (a) with the paged extend's gather route pinned
    (``attn_impl="gather"``: the prefix gathered into dense stripes, then K1
    with per-row query offsets), over a bf16 and an int8 pool. Each format's
    launch counts are set to 0 just before its run and read just after: K1
    must have launched, every launch on the tensor cores, and K2 / K2q not
    at all. Then one sync (``compare_sync``) of the gather route against
    run (a)'s K2 route on the same format: prefill and decode logits within
    LOGIT_TOL, greedy ids equal but for near-ties; the whole run's ids
    against a K2 engine's, informative. Returns the summed launch counts."""
    from repro_torch import kernels
    from repro_torch.kernels import plan
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    engine_kw = dict(SERVE_PAGED_KW, device=device)
    prompts, _ = serve_prompts(cfg, seed)
    gather_cfg = dataclasses.replace(cfg, attn_impl=plan.GATHER)
    greedy = SamplingParams(max_tokens=32)
    total = {}
    for kv_dtype in ("fp32", "int8"):
        ids = {}
        for name, c in (("K2", cfg), ("gather", gather_cfg)):
            kernels.reset_launch_counts()
            engine = LLMEngine(c, params, kv_dtype=kv_dtype, **engine_kw)
            out = engine.generate([Request(uid=i, prompt=p, sampling=greedy)
                                   for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            ids[name] = {o.uid: [int(t) for t in o.tokens] for o in out}
            extends = engine.backend.stats["extend_prefills"]
            engine.close()
            del engine
            counts = kernels.launch_counts()
        k2 = sum(counts[c] for c in ("paged_flash_prefill", "paged_flash_prefill_q"))
        label = f"serve (a) {'bf16' if kv_dtype == 'fp32' else kv_dtype}, gather route pinned"
        log(f"{label}: {extends} extend prefills; K1 launches {counts['flash_attention_fwd']}, "
            f"on the tensor cores {counts['flash_attention_fwd_tc']}; K2 / K2q launches {k2}; "
            f"greedy ids equal to the K2 route's on "
            f"{sum(ids['gather'][u] == t for u, t in ids['K2'].items())}/{len(prompts)} "
            "requests (informative)")
        check_k1_route(label, counts)
        if counts["flash_attention_fwd"] <= 0 or k2 or extends <= 0:
            raise AssertionError(f"{label}: the extends did not run the gather route")
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        compare_sync(torch, gather_cfg, cfg, params,
                     label=f"llama3-8b paged {kv_dtype}, gather route against K2 (a)",
                     engine_kw=dict(engine_kw, kv_dtype=kv_dtype), prompts=prompts)
    return total


def serve_tiered(torch, cfg, params, seed=0, device="cuda"):
    """The host tier on llama3-8b paged (bf16 pool): a 48-page pool, too
    small for the workload, with 1 GiB of host memory behind it. A
    512-token prompt P, then three other 512-token prompts one after another
    (each needs 34 of the 47 usable pages: P's cached pages demote), then P
    again (its 31 reusable pages promote back). P's greedy ids, both times,
    must equal those of an untiered 1024-page engine that serves P twice
    (the second time off its cached pages, as the tiered engine's second P
    extends off the promoted ones), with demoted and promoted pages counted.
    Then one page's payload (every layer's K and V, packed into one byte
    buffer) timed device -> pinned host and back, host clock around a
    synchronize, median of 10."""
    import numpy as np

    from repro_torch.serving import LLMEngine, Request, SamplingParams

    rng = np.random.default_rng(seed + 3)
    p_main = rng.integers(1, cfg.vocab, size=(512,))
    fillers = [rng.integers(1, cfg.vocab, size=(512,)) for _ in range(3)]
    kw = dict(kv_layout="paged", max_batch=8, page_size=PS, max_pages_per_seq=36,
              prompt_buckets=(256, 512), device=device)
    greedy = SamplingParams(max_tokens=32)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def ids(engine, prompts, uid0):
        out = engine.generate([Request(uid=uid0 + i, prompt=p, sampling=greedy)
                               for i, p in enumerate(prompts)])
        return [[int(t) for t in o.tokens] for o in sorted(out, key=lambda o: o.uid)]

    ref = LLMEngine(cfg, params, num_pages=1024, **kw)
    want = ids(ref, [p_main], 0) + ids(ref, [p_main], 1)
    ref.close()
    del ref
    engine = LLMEngine(cfg, params, num_pages=48, host_pool_bytes=1 << 30, **kw)
    t = time.perf_counter()
    got = ids(engine, [p_main], 0)
    ids(engine, fillers, 10)
    got += ids(engine, [p_main], 1)
    sync()
    secs = time.perf_counter() - t
    b = engine.backend
    st = b.prefix_stats()
    log(f"serve tiered: 5 requests in {secs:.2f} s; {engine.stats().summary()}")
    log(f"  demoted {st['demoted_pages']:.0f} pages, promoted {st['promoted_pages']:.0f}, "
        f"{st['host_entries']:.0f} held ({st['host_bytes_resident'] / 2**20:.1f} MiB host); "
        f"P's ids equal the untiered engine's: first {got[0] == want[0]}, again "
        f"{got[1] == want[1]}")
    if got != want or st["demoted_pages"] <= 0 or st["promoted_pages"] <= 0:
        raise AssertionError("serve tiered: ids differ from the untiered engine, or nothing "
                             "was demoted and promoted")
    nbytes_page = b.page_nbytes()
    down, up = [], []
    for _ in range(10):
        sync()
        t = time.perf_counter()
        payload = b._page_payload(1)
        down.append(time.perf_counter() - t)
        t = time.perf_counter()
        b._restore_page(payload, 2)
        sync()
        up.append(time.perf_counter() - t)
    d_s, u_s = statistics.median(down), statistics.median(up)
    log(f"host link, one page payload ({nbytes_page / 2**20:.2f} MiB: {cfg.n_layers} layers x "
        f"K and V, packed on the device into one copy): device -> pinned host "
        f"{d_s * 1e3:.3f} ms ({nbytes_page / d_s / 1e9:.2f} GB/s), host -> device "
        f"{u_s * 1e3:.3f} ms ({nbytes_page / u_s / 1e9:.2f} GB/s) (host clock, synced, "
        f"median of 10; card: {smi_line()})")
    engine.close()
    del engine, b, payload


def serve_dense(torch, cfg, params, *, prompt_lens, lone_len=None, lone_cache_len=None,
                lone_rows=None, want, kv_layout=None, rows=8, cache_len=4096,
                buckets=(512, 1024, 2048, 4096), seed=0, device="cuda"):
    """Dense serving through ``LLMEngine``: greedy requests of
    ``prompt_lens`` tokens (none a bucket size, so each prefill is
    right-padded), then one of ``lone_len`` alone on an engine of
    ``lone_cache_len`` stripes and ``lone_rows`` rows (default ``rows``; a
    sync decodes every row over the whole stripe, so the rows and the
    stripe set the decode plan), 32 new tokens each, with
    the launch counts set to 0 just before and read just after; every
    kernel of ``want`` must have launched. ``kv_layout=None`` takes the
    engine's default ("auto"), which must resolve to dense. Then each run
    once more, one sync of it, kernel path against the plain path
    (attention and SSM impl "plain"): ``compare_sync``."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    kw = dict(max_batch=rows, cache_len=cache_len, prompt_buckets=buckets, device=device)
    if kv_layout is not None:
        kw["kv_layout"] = kv_layout
    lens = list(prompt_lens) + ([lone_len] if lone_len else [])
    if any(n in buckets for n in lens):
        raise AssertionError("serve_dense prompts must not be bucket sizes")
    rng = np.random.default_rng(seed + 7)
    prompts = {n: rng.integers(1, cfg.vocab, size=(n,)) for n in set(lens)}
    greedy = SamplingParams(max_tokens=32)
    # Each group its own uids, as serve() does: the lone request's TTFT is
    # then its own, not the batch's uid 0.
    batches = [("batch", list(prompt_lens), 0, kw)] + (
        [("alone", [lone_len], 100, dict(kw, cache_len=lone_cache_len or cache_len,
                                         max_batch=lone_rows or rows))]
        if lone_len else [])
    kernels.reset_launch_counts()
    runs, prefills = {}, 0
    for label, group, uid0, ekw in batches:
        engine = LLMEngine(cfg, params, **ekw)
        if engine.kv_layout != "dense":
            raise AssertionError(f"{cfg.name}: kv_layout resolved to {engine.kv_layout}, "
                                 "not dense")
        t = time.perf_counter()
        out = engine.generate([Request(uid=uid0 + i, prompt=prompts[n], sampling=greedy)
                               for i, n in enumerate(group)])
        torch.cuda.synchronize()
        runs[label] = (out, time.perf_counter() - t, group, dict(engine.ttft), engine.stats())
        prefills += engine.stats().prefill_launches
        engine.close()
        del engine
    counts = kernels.launch_counts()
    for label, (out, secs, group, ttfts, stats) in runs.items():
        ttft = sorted(ttfts[o.uid] * 1e3 for o in out)
        log(f"serve {cfg.name} ({label}, prompts {[len(prompts[n]) for n in group]}): "
            f"{len(out)} requests, {sum(len(o.tokens) for o in out)} tokens in {secs:.2f} s; "
            f"TTFT ms min {ttft[0]:.1f} max {ttft[-1]:.1f}; decode {stats.decode_tok_s:.1f} "
            f"tok/s over {stats.decode_elapsed_s:.2f} s (host clock, {stats.steps_per_sync} "
            f"step per sync, CUDA graphs)")
        if any(len(o.tokens) != 32 for o in out):
            raise AssertionError(f"serve {cfg.name} ({label}) did not generate 32 tokens each")
    log(f"serve {cfg.name} kv_layout=dense: prefill launches {prefills}; launch counts "
        f"{json.dumps(counts)}")
    for key in want:
        if counts[KERNELS[key]["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on the {cfg.name} dense path")
    if "K1" in want:
        check_k1_route(f"serve {cfg.name} dense", counts)
    if "K7" in want or "K8" in want:
        check_dense_route(f"serve {cfg.name} dense", counts)
    if "K9" in want:
        # K9 has one kernel, on the tensor cores: one launch per SSM layer
        # per prefill forward.
        n_ssm = sum(spec.kind in ("mamba", "hybrid") for spec in cfg.layer_specs())
        k9, want_k9 = counts["ssd_intra_chunk_tc"], n_ssm * prefills
        log(f"serve {cfg.name} dense: K9 launches {k9} on the tensor cores "
            f"(ssd_intra_chunk_tc), {n_ssm} SSM layers x {prefills} prefills = {want_k9}")
        if k9 != want_k9:
            raise AssertionError(f"serve {cfg.name}: {k9} K9 launches, expected {want_k9}")
    plain_cfg = dataclasses.replace(
        cfg, attn_impl="plain",
        ssm=dataclasses.replace(cfg.ssm, impl="plain") if cfg.ssm else None)
    for label, group, _, ekw in batches:
        compare_sync(torch, cfg, plain_cfg, params, label=f"{cfg.name} dense ({label})",
                     engine_kw=ekw, prompts=[prompts[n] for n in group])
    return counts


def compare_sync(torch, cfg, plain_cfg, params, *, label, engine_kw, prompts):
    """The kernel path against the plain path on the main path's own
    decode: one ``steps_per_sync=1`` sync through ``engine.step()``
    (admission, the prefills, the first-token sample, one replay of the
    one-tick graph over every row at the full table or stripe) on an engine
    of ``engine_kw`` serving ``prompts`` (greedy), once with ``plain_cfg``
    (whose tick is a captured graph too) and once with ``cfg``, on the same
    weights. The plain path runs first, and the kernel engine's first-token
    sample is handed the plain path's first tokens, so both decode ticks
    take the same inputs. Each request's prefill logits and its decode
    tick's logits (``backend.last_logits``) must lie within LOGIT_TOL of the
    plain path's max |logit|, and their greedy ids must agree, except where
    the plain logits' margin between the two ids is within twice the row's
    largest error (a near-tie that an error within tolerance can flip)."""
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    greedy = SamplingParams(max_tokens=32)
    runs, force = {}, None
    for name, c in (("plain", plain_cfg), ("cuda", cfg)):
        engine = LLMEngine(c, params, steps_per_sync=1, **engine_kw)
        b = engine.backend
        first = {}

        def recording(records, b=b, flush=b.flush, first=first, force=force):
            got = flush(records)
            for row, x in got.items():
                uid = b.row_req(row).uid
                first[uid] = x.float().clone()
                if force is not None:
                    pick = torch.zeros_like(x)
                    pick[force[uid]] = 1.0
                    got[row] = pick
            return got

        b.flush = recording
        for i, p in enumerate(prompts):
            engine.add_request(Request(uid=i, prompt=p, sampling=greedy))
        engine.step()
        torch.cuda.synchronize()
        rows = {b.row_req(r).uid: r for r in range(b.rows) if b.active[r]}
        if sorted(rows) != list(range(len(prompts))) or b.stats["decode_traces"] != 1:
            raise AssertionError(f"compare {label}: the first sync did not decode every "
                                 "request in one graph")
        runs[name] = dict(first=first, fed={u: int(b.out[r][0]) for u, r in rows.items()},
                          last={u: b.last_logits[r].float().clone() for u, r in rows.items()})
        if force is None:
            force = runs[name]["fed"]
        engine.close()
        del engine, b
    if runs["cuda"]["fed"] != force:
        raise AssertionError(f"compare {label}: the kernel engine did not decode the plain "
                             "path's first tokens")
    worst, same, flips = {}, {}, 0
    for stage in ("first", "last"):
        worst[stage], same[stage] = 0.0, 0
        for uid, ref in runs["plain"][stage].items():
            got = runs["cuda"][stage][uid]
            if not torch.isfinite(got).all():
                raise AssertionError(f"compare {label}: non-finite {stage} logits, uid {uid}")
            diff = float((got - ref).abs().max())
            worst[stage] = max(worst[stage], diff / float(ref.abs().max()))
            i, j = int(ref.argmax()), int(got.argmax())
            if i == j:
                same[stage] += 1
            elif float(ref[i] - ref[j]) <= 2 * diff:
                flips += 1
            else:
                raise AssertionError(f"compare {label} uid {uid}: {stage} argmax {j} against "
                                     f"the plain path's {i}, outside the error's reach")
    n = len(prompts)
    log(f"compare {label}, one sync at steps_per_sync=1 ({n} requests, engine "
        f"{json.dumps({k: v for k, v in engine_kw.items() if k != 'device'})}): prefill "
        f"logits max |cuda - plain| / max |plain| = {worst['first']:.3e}, decode tick "
        f"(graph) logits {worst['last']:.3e} (tol {LOGIT_TOL}); greedy ids equal "
        f"{same['first']}/{n} prefill, {same['last']}/{n} decode ({flips} near-ties within "
        "twice the error)")
    if max(worst.values()) > LOGIT_TOL:
        raise AssertionError(f"compare {label}: kernel path disagrees with the plain path")
    return runs["cuda"]


# -- phase 4 (fused decode): CUDA graphs of the decode tick ---------------------

def graph_runs(torch, cfg, params, *, label, engine_kw, prompts, steps):
    """The same greedy requests (32 new tokens each) on a fresh engine at
    each ``steps_per_sync`` of ``steps``. Each engine first serves requests
    of the same lengths drawn anew, which captures its graphs; then, the
    launch counts set to 0 just before and read just after, ``prompts``:
    that run must capture no graph, its decode must launch its kernels, all
    on the tensor cores, and its ids must be identical across ``steps``.
    Returns each measured run's host-clock decode tok/s (capture excluded)
    and the seconds of the warm-up run's decode (captures included)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    greedy = SamplingParams(max_tokens=32)
    rng = np.random.default_rng(99)
    warm = [rng.integers(1, cfg.vocab, size=(len(p),)) for p in prompts]
    ids, rates, first = {}, {}, {}
    for n in steps:
        engine = LLMEngine(cfg, params, steps_per_sync=n, **engine_kw)
        engine.generate([Request(uid=1000 + i, prompt=p, sampling=greedy)
                         for i, p in enumerate(warm)])
        torch.cuda.synchronize()
        st0, graphs = engine.stats(), engine.backend.stats["decode_traces"]
        kernels.reset_launch_counts()
        out = engine.generate([Request(uid=i, prompt=p, sampling=greedy)
                               for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        st = engine.stats()
        ids[n] = {o.uid: [int(t) for t in o.tokens] for o in out}
        secs = st.decode_elapsed_s - st0.decode_elapsed_s
        rates[n] = sum(len(t) for t in ids[n].values()) / secs
        first[n] = st0.decode_elapsed_s
        paged = engine.kv_layout == "paged"
        log(f"fused {label} steps_per_sync={n!r}: decode {rates[n]:.1f} tok/s over {secs:.3f} "
            f"s (host clock; N {st.steps_per_sync} at the last sync; the warm-up run's "
            f"decode, which captured {graphs} CUDA graphs, took {st0.decode_elapsed_s:.3f} "
            f"s); launch counts {json.dumps({k: v for k, v in counts.items() if v})}")
        if engine.backend.stats["decode_traces"] != graphs:
            raise AssertionError(f"fused {label} steps_per_sync={n!r}: a graph was captured "
                                 "after warm-up")
        if any(spec.kind != "mamba" for spec in cfg.layer_specs()):
            (check_paged_route if paged else check_dense_route)(
                f"fused {label} steps_per_sync={n!r}", counts)
            decode = (counts["paged_flash_decode"] + counts["paged_flash_decode_split"]
                      if paged else counts["flash_decode"] + counts["flash_decode_split"])
            if decode <= 0:
                raise AssertionError(f"fused {label}: no decode kernel launched in graphs")
        if any(len(t) != 32 for t in ids[n].values()):
            raise AssertionError(f"fused {label} steps_per_sync={n!r}: not 32 tokens each")
        engine.close()
        del engine
    for n in steps[1:]:
        if ids[n] != ids[steps[0]]:
            raise AssertionError(f"fused {label}: steps_per_sync={n!r} ids differ from "
                                 f"steps_per_sync={steps[0]!r}")
    log(f"fused {label}: ids identical across steps_per_sync {list(steps)}")
    return rates, first


def profile_summary(torch, fn, label):
    """One ``fn`` under torch.profiler: the device's busy time (its kernels'
    time, summed) over the host clock of the profiled call, and the top
    device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    kernels_ = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels_) / 1e3
    log(f"profile {label}: {wall_ms:.3f} ms host clock (profiler on), device busy "
        f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}%, {sum(e.count for e in kernels_)} "
        "kernels; top device ops:")
    if busy_ms <= 0:
        log("  (the trace holds no device time)")
    for e in sorted(kernels_, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<5d} {e.key[:100]}")
    return busy_ms, wall_ms


def tick_times(torch, timer, cfg, params, *, label, engine_kw, prompts, host_sync=False,
               profile=False):
    """On one engine at steps_per_sync=1 with ``prompts`` decoding: the
    eager tick (the one-tick graph's tick function run without the graph,
    CUDA events around each call, the host's launches included) against
    one replay of the one-tick graph (CUDA events with the queue primed:
    the card's time alone). ``host_sync``: also the host clock of a
    steady-state sync, minus the one-tick graph's device time, which sets
    ``perf_model.HOST_SYNC_OVERHEAD_S``. ``profile``: a torch.profiler
    summary of an eager tick and of an 8-tick replay. Both re-run the last
    sync's inputs and rewrite the same cache entries."""
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    greedy = SamplingParams(max_tokens=32)
    engine = LLMEngine(cfg, params, steps_per_sync=1, **engine_kw)
    b = engine.backend
    for i, p in enumerate(prompts):
        engine.add_request(Request(uid=i, prompt=p, sampling=greedy))
    engine.step()
    engine.step()
    host = []
    for _ in range(10):
        t = time.perf_counter()
        engine.step()
        host.append((time.perf_counter() - t) * 1e3)
    program = b._programs[(1, 0)]
    graph_ms = timer.ms(program.graph.replay, primed=True)
    rows = [r for r in range(b.rows) if b.active[r]]
    eager = program.run
    eager_ms = timer.ms(eager)
    out = {"rows": len(rows), "eager_ms": eager_ms, "graph_ms": graph_ms}
    log(f"tick {label}, {len(rows)} rows: eager tick {eager_ms:.3f} ms (CUDA events, "
        f"host launches included; {1e3 * len(rows) / eager_ms:.1f} tok/s), one-tick graph "
        f"replay {graph_ms:.3f} ms (queue primed; {1e3 * len(rows) / graph_ms:.1f} tok/s): "
        f"{eager_ms / graph_ms:.1f}x")
    if host_sync:
        host_ms = statistics.median(host)
        out["host_sync_ms"] = host_ms - graph_ms
        log(f"host sync {label}: one steps_per_sync=1 sync {host_ms:.3f} ms (host clock, "
            f"median of {len(host)}; min {min(host):.3f}) - one-tick graph {graph_ms:.3f} ms "
            f"= {host_ms - graph_ms:.3f} ms (HOST_SYNC_OVERHEAD_S)")
    if profile:
        out["eager_profile"] = profile_summary(torch, eager, f"{label} eager tick")
    engine.close()
    del engine
    if profile:
        out["graph8_ms"], out["graph8_profile"] = graph8(torch, timer, cfg, params, label=label,
                                                         engine_kw=engine_kw, prompts=prompts)
    return out


def graph8(torch, timer, cfg, params, *, label, engine_kw, prompts):
    """One replay of the 8-tick decode graph of an engine at steps_per_sync=8
    serving ``prompts`` (CUDA events, the queue primed), and a
    torch.profiler summary of it: (ms, summary)."""
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    engine = LLMEngine(cfg, params, steps_per_sync=8, **engine_kw)
    for i, p in enumerate(prompts):
        engine.add_request(Request(uid=i, prompt=p, sampling=SamplingParams(max_tokens=32)))
    engine.step()
    replay = engine.backend._programs[(8, 0)].graph.replay
    ms8 = timer.ms(replay, primed=True)
    log(f"tick {label}: 8-tick graph replay {ms8:.3f} ms (queue primed), {ms8 / 8:.3f} ms a "
        "tick")
    summary = profile_summary(torch, replay, f"{label} 8-tick graph replay")
    engine.close()
    del engine
    return ms8, summary


def fused_phase(torch, timer, cfg, params, *, label, engine_kw, prompts, steps=(1, 8),
                **kw):
    rates, _ = graph_runs(torch, cfg, params, label=label, engine_kw=engine_kw,
                          prompts=prompts, steps=steps)
    ticks = tick_times(torch, timer, cfg, params, label=label, engine_kw=engine_kw,
                       prompts=prompts, **kw)
    log(f"decode {label}: graphs {', '.join(f'N={n!r} {r:.1f}' for n, r in rates.items())} "
        f"tok/s (host clock); eager tick {1e3 * ticks['rows'] / ticks['eager_ms']:.1f} "
        f"tok/s (CUDA events); card: {smi_line()}")
    return rates, ticks


# -- phase 4 (load): open-loop Poisson traffic with telemetry on ---------------

#: The loadgen phase's engine: 8 rows, tables of up to 128 pages, a 1024-page
#: pool (1024 x 16 x 32 layers x 8 x 128 x 2 x 2 B = 2 GiB).
LOADGEN_KW = dict(kv_layout="paged", max_batch=8, page_size=PS, num_pages=1024,
                  cache_len=2048, prompt_buckets=(256, 512, 1024))
#: The trace: 32 requests at 4 requests/s; prompt tails 128 / 384 / 768, a
#: 256-token shared prefix on half of them (prefix hits: K2); 32 / 64 / 128
#: new tokens; greedy, seed 0.
LOADGEN_TRACE = dict(requests=32, rate=4.0, shared_prefix=256, shared_fraction=0.5,
                     prompt_mix=((128, 0.5), (384, 0.3), (768, 0.2)),
                     output_mix=((32, 0.6), (64, 0.3), (128, 0.1)))


def loadgen_phase(torch, cfg, params):
    """``repro_torch.launch.loadgen.run_one`` on full-width llama3-8b paged
    with telemetry on, at ``steps_per_sync`` 1 and 8 (an engine each), its
    artifacts in a temporary directory. Each run must pass the harness's
    ``_smoke_check``; ``serving_tokens_total`` must equal the tokens the
    finished requests hold (the trace's ``finish`` events); every measured
    uid's lifecycle must run arrival ... finish; the open-loop drive (counts
    set to 0 at its start, read after it) must launch K1, K2 and the decode
    kernel the engine's plan fixed (K3, or K4 if it splits), all on the
    tensor cores; and N 1 must capture no graph after warm-up. One sync of
    that engine is held against the plain path (``compare_sync``) on the
    trace's first 8 prompts, and 8 closed-loop requests must give the same
    greedy ids with telemetry on and off. Returns the drive's launch counts,
    summed over both runs."""
    import argparse
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch import loadgen
    from repro_torch.obs import Telemetry
    from repro_torch.obs.drift import DriftReport
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    trace = dict(LOADGEN_TRACE)
    mixes = {k: trace.pop(k) for k in ("prompt_mix", "output_mix")}
    drive = loadgen.drive
    drive_counts = {}

    def counted_drive(*a, **kw):
        kernels.reset_launch_counts()
        try:
            return drive(*a, **kw)
        finally:
            torch.cuda.synchronize()
            drive_counts.update(kernels.launch_counts())

    total, payloads = {}, {}
    loadgen.drive = counted_drive
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            for n in (1, 8):
                args = argparse.Namespace(
                    arch="llama3-8b", smoke=False, max_batch=LOADGEN_KW["max_batch"],
                    cache_len=LOADGEN_KW["cache_len"], num_pages=LOADGEN_KW["num_pages"],
                    page_size=PS, temperature=0.0, seed=0, out_dir=out_dir, device="cuda",
                    steps_per_sync=n, **trace)
                drive_counts.clear()
                p = loadgen.run_one(args, "paged", cfg=cfg, params=params,
                                    prompt_buckets=LOADGEN_KW["prompt_buckets"], **mixes)
                sys.stdout.flush()
                loadgen._smoke_check(p)
                counts = dict(drive_counts)
                label = f"loadgen llama3-8b paged N={n}"
                check_k1_route(label, counts)
                check_k2_route(label, counts)
                check_paged_route(label, counts)
                k3, k4 = (counts[KERNELS[k]["counter"]] for k in ("K3", "K4"))
                log(f"{label}: decode kernel {'K3 (one pass)' if k4 == 0 else 'K4 (split)'}: "
                    f"K3 {k3} launches, K4 {k4}")
                for key in ("K1", "K2"):
                    if counts[KERNELS[key]["counter"]] <= 0:
                        raise AssertionError(f"{label}: {key} was not launched under load")
                if k3 + k4 <= 0:
                    raise AssertionError(f"{label}: no decode kernel launched under load")
                with open(p["_artifacts"]["json"]) as f:
                    env = json.load(f)
                with open(p["_artifacts"]["trace"]) as f:
                    events = json.load(f)["traceEvents"]
                life = {}
                for e in events:
                    if e.get("cat") == "lifecycle" and e["tid"] - 1 < loadgen.PILOT_UID:
                        life.setdefault(e["tid"] - 1, []).append(e)
                held = sum(ev[-1]["args"]["tokens"] for ev in life.values()
                           if ev[-1]["name"] == "finish")
                streamed = env["metrics"]["serving_tokens_total"]["value"]
                if sorted(life) != list(range(args.requests)) or any(
                        ev[0]["name"] != "arrival" or ev[-1]["name"] != "finish"
                        for ev in life.values()):
                    raise AssertionError(f"{label}: a measured lifecycle is not arrival ... "
                                         "finish")
                if streamed != held or held != p["tokens_generated"]:
                    raise AssertionError(f"{label}: serving_tokens_total {streamed}, the "
                                         f"finished requests hold {held}, the engine counted "
                                         f"{p['tokens_generated']}")
                if n == 1 and p["decode_retraces_after_warmup"] != 0:
                    raise AssertionError(f"{label}: {p['decode_retraces_after_warmup']} graphs "
                                         "captured after warm-up")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
                payloads[n] = p
    finally:
        loadgen.drive = drive

    card = smi_line()

    def ms(d):
        return " / ".join(f"{d[f'p{q}'] * 1e3:.2f}" for q in (50, 90, 99))

    for n, p in payloads.items():
        log(f"loadgen N={n}: {p['finished']}/{p['requests']} requests at {p['rate_req_s']}/s in "
            f"{p['wall_s']:.2f} s, {p['tokens_generated']} tokens; p50/p90/p99 ms: TTFT "
            f"{ms(p['ttft_s'])} (arrival to first streamed token), TTFT to first sampled "
            f"token {ms(p['ttft_sampled_s'])}, ITL {ms(p['itl_s'])}, queue {ms(p['queue_s'])}; "
            f"card: {card}")
        log(f"loadgen N={n}: measured {p['measured_tok_s']:.1f} tok/s over "
            f"{p['decode_elapsed_s']:.3f} s of decode (host clock), modeled "
            f"{p['modeled_tok_s']:.0f} tok/s (attention kernel only); host overhead "
            f"{p['host_overhead_per_token_s'] * 1e6:.1f} us/token (modeled "
            f"{p['modeled_host_overhead_s'] * 1e6:.1f}); graphs captured after warm-up "
            f"{p['decode_retraces_after_warmup']}; prefix hit rate "
            f"{p['prefix']['prefix_hit_rate']:.3f}, preemptions {p['preemptions']}, "
            f"occupancy cap {p['occupancy_cap']}; card: {card}")
        cap = p["occupancy_cap"]
        if not isinstance(cap, int) or not 1 <= cap <= LOADGEN_KW["max_batch"]:
            raise AssertionError(f"loadgen N={n}: occupancy_cap {cap!r} is not an integer "
                                 f"in 1..{LOADGEN_KW['max_batch']}")
        log(f"loadgen N={n} drift (worst ratio {p['drift_worst_ratio']}; card: {card}):")
        log("  " + DriftReport(rows=p["drift"]["rows"]).render().replace("\n", "\n  "))
    log(f"loadgen host overhead per token: N=1 "
        f"{payloads[1]['host_overhead_per_token_s'] * 1e6:.1f} us, N=8 "
        f"{payloads[8]['host_overhead_per_token_s'] * 1e6:.1f} us; card: {card}")
    log("loadgen summary: " + json.dumps({
        f"n{n}": {k: p[k] for k in ("ttft_s", "ttft_sampled_s", "itl_s", "queue_s",
                                    "measured_tok_s", "modeled_tok_s",
                                    "host_overhead_per_token_s",
                                    "decode_retraces_after_warmup", "drift_worst_ratio",
                                    "occupancy_cap")}
        for n, p in payloads.items()}))

    # The loadgen engine against the plain path: one sync on the trace's
    # first 8 prompts (prefix hits among them), at the engine's own sizes.
    workload = loadgen.build_workload(
        cfg, np.random.default_rng(0), trace["requests"], rate=trace["rate"],
        shared_prefix_len=trace["shared_prefix"], shared_fraction=trace["shared_fraction"],
        **mixes)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    compare_sync(torch, cfg, plain_cfg, params, label="llama3-8b paged (loadgen engine)",
                 engine_kw=dict(LOADGEN_KW, device="cuda"),
                 prompts=[r.prompt for _, r in workload[:8]])

    # Telemetry changes no output: the same 8 closed-loop requests on an
    # engine with telemetry off and on, each warmed up first.
    prompts, _ = serve_prompts(cfg)
    rng = np.random.default_rng(98)
    warm = [rng.integers(1, cfg.vocab, size=(len(p),)) for p in prompts]
    greedy = SamplingParams(max_tokens=32)
    ids, rates = {}, {}
    for name, tel in (("off", None), ("on", Telemetry.create())):
        engine = LLMEngine(cfg, params, steps_per_sync=1, telemetry=tel,
                           **dict(SERVE_PAGED_KW, device="cuda"))
        engine.generate([Request(uid=1000 + i, prompt=p, sampling=greedy)
                         for i, p in enumerate(warm)])
        torch.cuda.synchronize()
        engine.reset_metrics()
        out = engine.generate([Request(uid=i, prompt=p, sampling=greedy)
                               for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        ids[name] = {o.uid: [int(t) for t in o.tokens] for o in out}
        rates[name] = engine.stats().decode_tok_s
        engine.close()
        del engine
    if ids["on"] != ids["off"]:
        raise AssertionError("telemetry changed the greedy ids of the closed-loop requests")
    log(f"closed loop, 8 requests of 512 tokens, 32 new each, N 1: greedy ids identical with "
        f"telemetry on and off; decode {rates['on']:.1f} tok/s on against {rates['off']:.1f} "
        f"off (host clock, same call); card: {card}")
    return total


def dense_prompts(cfg, lens, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    return [rng.integers(1, cfg.vocab, size=(n,)) for n in lens]


# -- phase 4 (gemma): head_dim 256 on the serve paths --------------------------

#: The gemma serve runs, per model. The plan sets one pass or split-K from
#: the engine's rows and its table or stripe width (a sync decodes every row
#: at the full width), and at head_dim 256 it splits more than at 128: an
#: engine of 16 rows (gemma2-2b's 4 kv heads) or 64 (gemma3-1b's one) over
#: (a)'s 36-page tables decodes in one pass (K3), the free rows frozen on
#: the null page; one row of 4200 tokens (past gemma2-2b's window of 4096)
#: over 268 pages splits (K4). Dense: 32 rows of 2048-token stripes
#: (gemma2-2b) or 128 of 1024 (gemma3-1b) in one pass (K7), one row of
#: 4400 tokens alone on a one-row engine of 4608 splits (K8).
GEMMA_SERVE = {
    "gemma2-2b": dict(paged_rows=16, dense_rows=32, dense_cache=2048,
                      dense_lens=(300, 900, 1500, 1900)),
    "gemma3-1b": dict(paged_rows=64, dense_rows=128, dense_cache=1024,
                      dense_lens=(300, 600, 900, 950)),
}
GEMMA_B_LEN = 4200
GEMMA_B_KW = dict(max_batch=1, max_pages_per_seq=268, prompt_buckets=(256, 512, 4224))


def serve_gemma(torch, timer, cfg, params):
    """Full-width ``cfg`` (gemma2-2b or gemma3-1b, head_dim 256) on random
    seeded bf16 weights: paged runs (a) and (b) (``serve``: K1, K2 on (a)'s
    extend wave, K3, then K4 over (b)'s one long row, each run's launch
    counts set to 0 just before and read just after, and one sync of each
    held to the plain path by ``compare_sync``), the same runs over int8
    and fp8 pools (``serve_quantized``: K2q, K3q, K4q, every launch on the
    tensor cores and none on an unquantized kernel, one sync of each held
    to the plain path on the same format), then dense
    (``serve_dense``: K1, K7 over the batch, K8 over the lone row, each held
    to the plain path), then the fused decode on (a)'s engine at
    ``steps_per_sync`` 1 and 8 (identical ids, eager and graph tick times,
    a profiler summary of an eager tick and of an 8-tick replay).
    Returns the launch counts of the paged and dense runs together and the
    fused decode's (rates, ticks)."""
    run = GEMMA_SERVE[cfg.name]
    counts, bf16_logits = serve(torch, cfg, params, rows=run["paged_rows"], b_len=GEMMA_B_LEN,
                                b_kw=GEMMA_B_KW)
    log(f"== serve {cfg.name} paged over quantized pools (int8, fp8)")
    t = time.perf_counter()
    quantized = serve_quantized(torch, cfg, params, bf16_logits, rows=run["paged_rows"],
                                b_len=GEMMA_B_LEN, b_kw=GEMMA_B_KW)
    for key in ("K2q", "K3q", "K4q"):
        counts[KERNELS[key]["counter"]] += quantized[KERNELS[key]["counter"]]
    log(f"serve {cfg.name} over quantized pools: {time.perf_counter() - t:.1f} s")
    dense = serve_dense(torch, cfg, params, kv_layout="dense", rows=run["dense_rows"],
                        cache_len=run["dense_cache"], prompt_lens=run["dense_lens"],
                        buckets=(512, 1024, 2048, 4608), lone_len=4400,
                        lone_cache_len=4608, lone_rows=1, want=("K1", "K7", "K8"))
    for key, n in dense.items():
        counts[key] += n
    prompts, _ = serve_prompts(cfg)
    engine_kw = dict(SERVE_PAGED_KW, max_batch=run["paged_rows"], device="cuda")
    fused = fused_phase(torch, timer, cfg, params, label=f"{cfg.name} paged",
                        engine_kw=engine_kw, prompts=prompts, profile=True)
    # The same 8-tick graph over an int8 pool: K3q in place of K3, and the
    # codes' writes (quant.append_rows) in every layer's tick.
    ms8, _ = graph8(torch, timer, cfg, params, label=f"{cfg.name} paged int8",
                    engine_kw=dict(engine_kw, kv_dtype="int8"), prompts=prompts)
    log(f"decode tick {cfg.name} paged, {len(prompts)} rows of an engine of "
        f"{run['paged_rows']}: 8-tick graph replay over an int8 pool {ms8 / 8:.3f} ms a tick "
        f"against bf16's {fused[1]['graph8_ms'] / 8:.3f} ({ms8 / fused[1]['graph8_ms']:.3f}x); "
        f"card: {smi_line()}")
    return counts, fused


# -- phase 5: train at full width ----------------------------------------------

def train(torch, cfg_full, seed=0, *, layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
          micro=TRAIN_MICRO):
    """``Trainer`` + ``make_train_step`` on ``cfg_full`` cut to ``layers``
    layers, ``TRAIN_STEPS`` steps of ``batch`` rows of ``seq`` tokens in
    ``micro`` microbatches: each step's loss, grad norm, time and launches
    (K1 twice per layer per microbatch, K5 and K6 once, all on the tensor
    cores), the peak memory; then ``train_breakdown``; then one step's
    gradients at 2 layers, sequence 1024, kernel path against plain path.
    Returns the launch counts of the train run."""
    from repro_torch import kernels
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import train_step as ts
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(cfg_full, n_layers=layers)
    tcfg = ts.TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=1,
                                                total_steps=TRAIN_STEPS),
                          microbatches=micro)
    gc.collect()                 # the serve phase's engines sit in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ts.init_train_state(seed, cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_lib.leaves(state["params"]))
    state_gib = torch.cuda.memory_allocated() / 2**30
    log(f"init_train_state {cfg.name} x {layers} layers: {n_params / 1e9:.3f} B "
        f"float32 parameters, {state_gib:.2f} GiB with AdamW state, "
        f"{time.perf_counter() - t0:.1f} s")
    pipe = make_pipeline(DataConfig(seq_len=seq, global_batch=batch, seed=seed,
                                    vocab=cfg.vocab))
    step_fn = ts.make_train_step(cfg, tcfg)
    per_step = []

    def counted(state, batch):
        out = step_fn(state, batch)
        per_step.append(kernels.launch_counts())
        return out

    trainer = Trainer(counted, state, pipe,
                      TrainerConfig(total_steps=TRAIN_STEPS, log_every=1),
                      put_batch=lambda b: ts.to_device(b, "cuda"))
    kernels.reset_launch_counts()
    trainer.run()
    counts = kernels.launch_counts()
    tokens = seq * batch
    prev = {key: 0 for key in counts}
    for rec, cum in zip(trainer.history, per_step):
        step_counts = {KERNELS[k]["counter"]: cum[KERNELS[k]["counter"]]
                       - prev[KERNELS[k]["counter"]] for k in ("K1", "K5", "K6")}
        prev = cum
        log(f"train step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.4f} step {rec['step_time_s']:.3f} s, "
            f"{tokens / rec['step_time_s']:.0f} tok/s (host clock, synced); launches "
            f"{json.dumps(step_counts)}")
        want = {KERNELS["K1"]["counter"]: 2 * layers * micro,
                KERNELS["K5"]["counter"]: layers * micro,
                KERNELS["K6"]["counter"]: layers * micro}
        if step_counts != want:
            raise AssertionError(f"train launches {step_counts}, expected {want} "
                                 "(remat: K1 twice per layer per microbatch)")
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"train step {rec['step']}: non-finite loss or grad norm")
    log(f"train {cfg.name} peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(max_memory_allocated; parameters, gradients and AdamW state {state_gib:.2f} + "
        f"{n_params * 4 / 2**30:.2f} GiB; float32 logits of one microbatch "
        f"{batch // micro * seq * cfg.vocab * 4 / 2**30:.2f} GiB); retries {trainer.retries}; "
        f"launch counts over the train run: {json.dumps(counts)}")
    if trainer.retries or trainer.step != TRAIN_STEPS:
        raise AssertionError(f"trainer made {trainer.retries} retries")
    check_k1_route(f"train {cfg.name}", counts)
    check_bwd_route(f"train {cfg.name}", bwd_launches({key: 0 for key in counts}, counts))
    step_s = trainer.history[-1]["step_time_s"]
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    train_breakdown(torch, cfg, step_s, batch // micro, seq, micro)

    # Kernel path against plain path: one step's gradients, same weights
    # and batch, 2 layers at full width, sequence 1024, batch 1.
    cfg2 = dataclasses.replace(cfg_full, n_layers=2)
    params = transformer.init_model(cfg2, seed=seed + 1, device="cuda",
                                    param_dtype=torch.float32)
    batch = ts.to_device(make_pipeline(DataConfig(seq_len=1024, global_batch=1, seed=seed + 1,
                                                  vocab=cfg2.vocab)).batch_at(0), "cuda")
    grads, losses = {}, {}
    for name, c in (("cuda", cfg2), ("plain", dataclasses.replace(cfg2, attn_impl="plain"))):
        g, loss, _ = ts._accumulate_grads(params, c, batch, ts.TrainConfig())
        torch.cuda.synchronize()
        grads[name], losses[name] = g, float(loss)
    rel_loss = abs(losses["cuda"] - losses["plain"]) / abs(losses["plain"])
    rels = {tree_lib.key_of(path): float((a - b).float().norm() / b.float().norm())
            for (path, a), b in zip(tree_lib.leaves_with_paths(grads["cuda"]),
                                    tree_lib.leaves(grads["plain"]))}
    worst = max(rels, key=rels.get)
    log(f"train {cfg.name} step-1 kernel path vs plain path: loss {losses['cuda']:.6f} vs "
        f"{losses['plain']:.6f} (relative {rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
        f"||g_cuda - g_plain|| / ||g_plain|| max {rels[worst]:.3e} at {worst} (tol "
        f"{TRAIN_GRAD_TOL}), median {statistics.median(rels.values()):.3e}")
    if rel_loss > TRAIN_LOSS_TOL or rels[worst] > TRAIN_GRAD_TOL or not math.isfinite(
            losses["cuda"]):
        raise AssertionError("train: kernel path disagrees with the plain path")
    return counts


def train_breakdown(torch, cfg, step_s, b, s, micro):
    """K1, K5 and K6 at the train step's shapes (``b`` rows of ``s`` tokens
    per microbatch, causal) and with the plan its attention layers build,
    once per distinct window of ``cfg``'s layers, with its softcap: each held
    against its plain version on the same inputs (K1 per row, K5 / K6 per
    (b, head) slice, ROW_TOL); then each timed alone (CUDA-event medians, L2
    flushed) beside the float32 LM head, times its count per step, against
    the measured step time: a breakdown by parts, not a profile. SDPA's
    forward and backward are timed beside K1 and K5 + K6 where no softcap
    or window keeps it from computing the same function. These launches
    come after the train run's counts were read."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import plan as plan_lib

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    windows = [spec.window for spec in cfg.layer_specs()]
    cap = cfg.attn_softcap
    q, k, v, do = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d), randn(b, hq, s, d)
    attn = k1_ms = 0.0
    torch.cuda.reset_peak_memory_stats()     # the train run's peak was read already
    log(f"train {cfg.name} parts: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        "before the plain versions")
    for window in sorted(set(windows), key=lambda w: -1 if w is None else w):
        n = windows.count(window)
        plan = plan_lib.plan_for_config(cfg, (b, hq, hkv, s, s, d), device_type="cuda",
                                        dtype_bytes=2, phase=plan_lib.PREFILL, window=window)
        kw = dict(mapping=plan.mapping, causal=True, window=window, softcap=cap)
        plain_kw = dict(causal=True, window=window, softcap=cap)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **plain_kw)
        e_o, e_l = row_err(o, o_ref), err(lse, lse_ref)
        del o_ref, lse_ref
        ref = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, **plain_kw)
        rel = [slice_err(g, r) for g, r in zip((dq, dk, dv), ref)]
        del ref, dq, dk, dv
        label = f"B {b} S {s} causal window {window} softcap {cap} ({n} of {len(windows)} layers)"
        log(f"train {cfg.name} shape {label}, {plan.mapping}: K1 o row-relative {e_o:.3e} lse "
            f"{e_l:.3e}; K5/K6 per-slice relative dq {rel[0]:.3e} dk {rel[1]:.3e} dv "
            f"{rel[2]:.3e} (tol {ROW_TOL:.3e}, lse {LSE_TOL}); peak of the check "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if e_o > ROW_TOL or e_l > LSE_TOL or max(rel) > ROW_TOL:
            raise AssertionError("K1/K5/K6 at the train shape disagree with their plain "
                                 "versions")
        t_k1 = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        k1_bound = k1_bound_of(q, k, v, o, lse, causal=True, window=window)
        t_k5 = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
        t_k6 = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
        lib = ""
        if cap is None and window is None:
            t_sdpa = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            group = hq // hkv
            leaves = [t.detach().requires_grad_(True)
                      for t in (q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))]
            out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True)
            t_sdpa_bwd = timer.ms(lambda: torch.autograd.grad(out, leaves, do,
                                                              retain_graph=True))
            del leaves, out
            lib = f"; library sdpa {t_sdpa:.4f} ms, sdpa backward {t_sdpa_bwd:.4f} ms"
        log(f"train {cfg.name} parts at {label} per microbatch: K1 {t_k1:.4f} ms (bound "
            f"{k1_bound[0]:.4f} ms ({k1_bound[1]})), K5 {t_k5:.4f} ms, K6 {t_k6:.4f} ms (pair "
            f"{t_k5 + t_k6:.4f} ms){lib}")
        attn += micro * n * (2 * t_k1 + t_k5 + t_k6)
        k1_ms += micro * n * 2 * t_k1
        del o, lse, delta
    del q, k, v, do
    x = randn(b * s, cfg.d_model, dtype=torch.float32)
    head = randn(cfg.d_model, cfg.vocab, dtype=torch.float32)
    g = randn(b * s, cfg.vocab, dtype=torch.float32)
    # The head's forward product and the two of its backward, float32.
    t_head = timer.ms(lambda: (x @ head, g @ head.T, x.T @ g))
    del x, head, g, timer
    head_ms = micro * t_head
    log(f"train {cfg.name} step parts: float32 LM head (3 products) {t_head:.3f} ms a "
        f"microbatch; per step: attention kernels {attn:.1f} ms "
        f"({attn / (step_s * 1e3):.1%} of the {step_s * 1e3:.1f} ms step; K1 x 2 "
        f"{k1_ms:.1f} ms, {k1_ms / (step_s * 1e3):.1%}), LM head {head_ms:.1f} ms "
        f"({head_ms / (step_s * 1e3):.1%})")


def train_gemma(torch, cfg):
    """The train phase on full-width ``cfg`` (gemma2-2b or gemma3-1b) at
    ``GEMMA_TRAIN``'s depth, sequence and batch: K5 / K6 at head_dim 256."""
    run = GEMMA_TRAIN[cfg.name]
    log(f"== train {cfg.name} ({run['layers']} layers, seq {run['seq']}, batch "
        f"{run['batch']} in {run['micro']} microbatches, head_dim 256, bf16 compute, random "
        "weights)")
    gc.collect()
    torch.cuda.empty_cache()
    return train(torch, cfg, **run)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=("all", "plan", "extend", "gemma"), default="all",
                        help="'plan' runs the plan phase alone, 'extend' K1's offset checks "
                             "and plan part (d) alone, 'gemma' the head_dim 256 kernels and "
                             "the gemma serve runs alone; none prints a result line")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import gemma2_2b, gemma3_1b, hymba_1_5b, llama3_8b, mamba2_1_3b
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = smi_line()
    log(f"== probe\nnvidia-smi: {card}\ndevice: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}\ntorch {torch.__version__} cuda {torch.version.cuda}")
    log(subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                       text=True).stdout.strip().splitlines()[-1])

    log("== build")
    t = time.perf_counter()
    info = build.build_all()
    log(f"built {len(build.SOURCES)} libraries in {time.perf_counter() - t:.1f} s")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "wgmma" in line:   # ptxas' serialisation warnings (C7510 .. C7515)
                log(f"  {name}: {line.strip()}")
    for name, rec in info.items():
        for kernel, regs, st, ld, ser in ptxas_d256(rec["log"]):
            log(f"head_dim 256 ptxas {name} {kernel}: {regs} registers, spill stores {st} B, "
                f"loads {ld} B, wgmma serialised {ser}")

    timer = Timer(torch)
    if args.phase == "plan":
        log("== plan: split-K, mapping, host-link and extend-route models against the card")
        plan_phase(torch, timer)
        log(f"total {time.perf_counter() - t_start:.1f} s (plan phase only: no result line)")
        return 0
    if args.phase == "extend":
        log("== K1 with per-row query offsets; plan part (d): the extend routes")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        check_k1_offsets(torch, timer, gen)
        failures = extend_fit(torch, timer, gen)
        log(f"total {time.perf_counter() - t_start:.1f} s (extend checks only: no result line)")
        if failures:
            raise AssertionError("plan part (d): " + "; ".join(failures))
        return 0
    gemma = (gemma2_2b.CONFIG, gemma3_1b.CONFIG)
    if args.phase == "gemma":
        log("== kernels at head_dim 256 (gemma2-2b and gemma3-1b widths, bf16)")
        log("head_dim 256 kernels: " + json.dumps(check_gemma_kernels(torch, timer)))
        for cfg in gemma:
            log(f"== serve {cfg.name} (head_dim 256: paged, dense, fused decode; bf16, "
                "random weights)")
            params = init_params(torch, cfg)
            counts, _ = serve_gemma(torch, timer, cfg, params)
            log(f"serve {cfg.name}: launch counts {json.dumps(counts)}")
            del params
            gc.collect()
            torch.cuda.empty_cache()
        for cfg in gemma:
            train_gemma(torch, cfg)
        log(f"total {time.perf_counter() - t_start:.1f} s (gemma phase only: no result line)")
        return 0
    log("== kernels (bf16, Hq 32, Hkv 8, D 128, page 16)")
    results = {}
    check_kernels(torch, timer, results)
    check_backward(torch, timer, results)
    log("== kernels K7 / K8 (dense decode, bf16) and K9 (SSD intra-chunk, float32 in 3xTF32)")
    check_dense_decode(torch, timer, results)
    check_ssd(torch, timer, results)
    log("== kernels at head_dim 256 (gemma2-2b and gemma3-1b widths, bf16)")
    d256 = check_gemma_kernels(torch, timer)
    log("== plan: split-K, mapping, host-link and extend-route models against the card")
    plan_phase(torch, timer)
    del timer
    log("== serve llama3-8b (paged, bf16, random weights)")
    params = init_params(torch, llama3_8b.CONFIG)
    counts, bf16_logits = serve(torch, llama3_8b.CONFIG, params)
    log("== serve llama3-8b paged over quantized pools (int8, fp8) and with a host tier")
    quantized = serve_quantized(torch, llama3_8b.CONFIG, params, bf16_logits)
    for key in ("K2q", "K3q", "K4q"):
        counts[KERNELS[key]["counter"]] += quantized[KERNELS[key]["counter"]]
    log("== serve llama3-8b paged (a) with the gather route pinned (bf16 and int8 pools)")
    counts[KERNELS["K1"]["counter"]] += serve_gather(
        torch, llama3_8b.CONFIG, params)[KERNELS["K1"]["counter"]]
    serve_tiered(torch, llama3_8b.CONFIG, params)
    timer = Timer(torch)
    fused = {}
    log("== fused decode llama3-8b paged: steps_per_sync 1, 8 and auto, CUDA graphs")
    prompts, _ = serve_prompts(llama3_8b.CONFIG)
    fused["llama3-8b paged"] = fused_phase(
        torch, timer, llama3_8b.CONFIG, params, label="llama3-8b paged",
        engine_kw=dict(SERVE_PAGED_KW, device="cuda"), prompts=prompts,
        steps=(1, 8, "auto"), host_sync=True, profile=True)
    # The graphs run the whole table: the same 8 rows over (b)'s 260-page
    # table cost this much more a tick than over 36 pages.
    tick_times(torch, timer, llama3_8b.CONFIG, params, label="llama3-8b paged, 260-page table",
               engine_kw=dict(SERVE_PAGED_KW, max_pages_per_seq=260,
                              prompt_buckets=(256, 512, 4096), device="cuda"),
               prompts=prompts)
    log("== serve llama3-8b (dense, the same weights)")
    dense_lens = (300, 900, 1500, 2500)
    paths = [serve_dense(torch, llama3_8b.CONFIG, params, kv_layout="dense", rows=4,
                         prompt_lens=dense_lens, want=("K1", "K8"))]
    fused["llama3-8b dense"] = fused_phase(
        torch, timer, llama3_8b.CONFIG, params, label="llama3-8b dense",
        engine_kw=dict(kv_layout="dense", max_batch=4, cache_len=4096,
                       prompt_buckets=(512, 1024, 2048, 4096), device="cuda"),
        prompts=dense_prompts(llama3_8b.CONFIG, dense_lens))
    log("== loadgen llama3-8b paged (telemetry on)")
    t = time.perf_counter()
    for key, n in loadgen_phase(torch, llama3_8b.CONFIG, params).items():
        counts[key] = counts.get(key, 0) + n
    log(f"loadgen phase {time.perf_counter() - t:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # hymba-1.5b and mamba2-1.3b at full width and half their depth (16 of
    # 32 layers: two periods of one global and seven window-1024 layers; 24
    # of 48 SSM layers), so that the whole run stays near half its time limit.
    hymba = dataclasses.replace(hymba_1_5b.CONFIG, n_layers=HYMBA_LAYERS)
    log(f"== serve hymba-1.5b ({hymba.n_layers} of {hymba_1_5b.CONFIG.n_layers} layers; "
        "kv_layout auto -> dense, bf16, random weights)")
    params = init_params(torch, hymba)
    hymba_lens = (100, 300, 600, 900, 1100, 1300, 1450, 1500)
    paths.append(serve_dense(torch, hymba, params, prompt_lens=hymba_lens,
                             cache_len=2048, lone_len=4000, lone_cache_len=4096,
                             want=("K1", "K7", "K8", "K9")))
    fused["hymba-1.5b dense"] = fused_phase(
        torch, timer, hymba, params, label="hymba-1.5b dense",
        engine_kw=dict(max_batch=8, cache_len=2048, prompt_buckets=(512, 1024, 2048),
                       device="cuda"),
        prompts=dense_prompts(hymba, hymba_lens))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mamba = dataclasses.replace(mamba2_1_3b.CONFIG, n_layers=MAMBA_LAYERS)
    log(f"== serve mamba2-1.3b ({mamba.n_layers} of {mamba2_1_3b.CONFIG.n_layers} layers; "
        "kv_layout auto -> dense, bf16, random weights)")
    params = init_params(torch, mamba)
    mamba_lens = (200, 700, 1300, 2000)
    paths.append(serve_dense(torch, mamba, params, rows=4,
                             prompt_lens=mamba_lens, want=("K9",)))
    fused["mamba2-1.3b dense"] = fused_phase(
        torch, timer, mamba, params, label="mamba2-1.3b dense",
        engine_kw=dict(max_batch=4, cache_len=4096, prompt_buckets=(512, 1024, 2048, 4096),
                       device="cuda"),
        prompts=dense_prompts(mamba, mamba_lens))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for cfg in gemma:
        log(f"== serve {cfg.name} (head_dim 256: paged, dense, fused decode; bf16, random "
            "weights)")
        params = init_params(torch, cfg)
        gemma_counts, fused[f"{cfg.name} paged"] = serve_gemma(torch, timer, cfg, params)
        paths.append(gemma_counts)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    del timer
    log("fused decode summary (decode tok/s; host clock for the engine runs, CUDA events "
        f"for the ticks; card: {smi_line()}): " + json.dumps({
            path: {"graphs_tok_s": {str(n): round(r, 1) for n, r in rates.items()},
                   "eager_tick_ms": round(t["eager_ms"], 4),
                   "graph_tick_ms": round(t["graph_ms"], 4), "rows": t["rows"]}
            for path, (rates, t) in fused.items()}))
    for path in paths:
        for key, n in path.items():
            counts[key] += n
    log(f"== train llama3-8b widths ({TRAIN_LAYERS} layers, seq {TRAIN_SEQ}, batch "
        f"{TRAIN_BATCH} in {TRAIN_MICRO} microbatches, bf16 compute, random weights)")
    train_counts = train(torch, llama3_8b.CONFIG)
    for key, n in train_counts.items():
        counts[key] += n
    for cfg in gemma:
        for key, n in train_gemma(torch, cfg).items():
            counts[key] += n
    for key, spec in KERNELS.items():
        if counts[spec["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on a main path")

    # launches: each kernel's count over the serve and train runs together.
    line = {"kernels": [
        dict(name=spec["name"], route="cuda", source=spec["source"],
             replaces=spec["replaces"], launches=counts[spec["counter"]], **results[key])
        for key, spec in KERNELS.items()
    ]}
    log(f"head_dim 256 kernels (card: {smi_line()}): {json.dumps(d256)}")
    log("== summary")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi_line()}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
