#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and ``nvcc``; without a card, or outside a checkout, it exits non-zero
and prints no result. Phases, in order (any failure exits non-zero):

  1. probe  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build  — compiles the kernels from ``src/repro_torch/csrc`` with
     nvcc for sm_90a, one nvcc per source in parallel; prints the build
     time and ptxas' register and spill lines of every kernel (K9's four
     instantiations among them);
  3. kernels — each kernel against its plain PyTorch version on the card,
     at llama3-8b widths in bf16 (Hq 32, Hkv 8, D 128, page size 16):
     max error at a stated tolerance, CUDA-event median times of kernel and
     plain version, and the bound (bytes over 3.35 TB/s vs operations over
     989 TFLOP/s, the H100 SXM data-sheet peaks). K1 in bf16 is the
     tensor-core kernel: every launch order (head-first and block-first
     bitwise equal), window + softcap, hymba-1.5b's widths (timed with SDPA
     beside it); K1 in float32 (the CUDA-core kernel) held at 2e-5 and
     timed at the same B 2, S 2048; then K2 (paged prefix prefill; bf16 on
     the tensor cores) at B 2, prefix 1000, tail 256 and at the paged serve
     run's extend shape, every launch on the tensor cores, rows past
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
     it replaced. Then the split-K
     estimator's modelled
     decode times beside the measured ones, and the fixed cost per call of
     the split path over the one-pass path; then K5
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
     the whole SSD scan timed part by part;
  4. serve  — ``LLMEngine(kv_layout="paged")`` on full-width llama3-8b with
     random bf16 weights: (a) 8 greedy requests of 512 tokens sharing a
     256-token system prefix, (b) one 4096-token request, 32 new tokens
     each, each run on an engine sized for it (a decode sync runs every row
     over the whole page table as one CUDA graph replay, so the table's
     width sets the decode plan: one pass over (a)'s 36 pages, two splits
     over (b)'s 260); every kernel's launch count over that run must be
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
     logits against the bf16 pool's printed, and the pool's bytes; then the
     host tier: a 48-page pool with 1 GiB of host memory behind it, a
     prompt served, pushed host-side by three others and served again, its
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
     (``kv_layout="dense"``), then full-width hymba-1.5b through
     ``LLMEngine(cfg, params)`` (``kv_layout`` resolves to dense): 8 greedy
     requests off the prompt buckets, several past the 1024 window, on
     2048-token stripes (one pass, K7), then one of 4000 tokens alone on
     4096-token stripes, whose decode the plan splits (K8); then
     full-width mamba2-1.3b. Each dense run must launch its kernels (every
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
     drift table, each beside the card's name and power limit; then one sync
     of that engine against the plain path (``compare_sync``), and 8
     closed-loop requests with the same greedy ids with telemetry on and
     off, their decode tok/s side by side;
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
     path.

It ends with one JSON line of per-kernel numbers and, last, the line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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


def log(msg=""):
    print(msg, flush=True)


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

    check_paged_prefill(torch, timer, results, gen)
    check_paged_decode(torch, timer, results, gen)
    check_quantized(torch, timer, results, gen)


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
    read and o written once, the table and lengths. Then the split-K
    estimator's modelled times beside the measured ones, and the split
    path's fixed cost per call. Between them, the first case in float32 (the
    CUDA-core kernels), one pass and 4 splits, held at F32_TOL and timed
    against the float32 peak."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.core import numa, perf_model
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

    measured = {}
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
            if mp == 4096 // PS:
                measured[ns] = ms
                if key not in results:
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

    # The split-K estimator's modelled times for the first case, beside the
    # measured ones: the model is calibrated only where the two agree.
    est = perf_model.estimate_decode_splits(
        batch=b, num_q_heads=HQ, num_kv_heads=HKV, seq_kv=4096, granule=PS, head_dim=D,
        dtype_bytes=2, topo=numa.H100)
    model = dict(est.times)
    log("split-K model vs measured (B 8, table 4096, queue primed): " + ", ".join(
        f"num_splits {ns}: model {model[ns] * 1e3:.4f} ms, measured {measured[ns]:.4f} ms"
        for ns in sorted(measured)) + f"; model picks {est.num_splits}")
    split_path_cost(torch, pd, randn)


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

    def pools(num_pages, kv_dtype):
        """(float32 values, codes, scales) for K and for V."""
        out = []
        for _ in range(2):
            x = torch.randn((HKV, num_pages, PS, D), generator=gen, device="cuda")
            codes, scales = quant.quantize_pages(x, kv_dtype)
            codes.view(torch.uint8)[:, 0] = 0x7F
            scales[:, 0] = float("nan")
            out.append((x, codes, scales))
        return out

    def table_of(lengths, mp, frozen=()):
        """Scattered live pages per row, the null page past them; frozen
        rows' tables are all null."""
        perm = (torch.randperm(len(lengths) * mp, generator=gen, device="cuda") + 1).tolist()
        table = torch.zeros((len(lengths), mp), dtype=torch.int32)
        for i, n in enumerate(lengths):
            if i not in frozen:
                live = -(-n // PS)
                table[i, :live] = torch.tensor(perm[i * mp: i * mp + live])
        return table.cuda()

    def only(counts, *keys):
        return {k: n for k, n in counts.items() if n} == {k: 1 for k in keys}

    def check(label, ok_rows, e_r, e32, o, o_bf, bars):
        """``bars`` (rows,): each row's bar against the unquantized kernel."""
        e_bf = (o.float() - o_bf.float()).abs().flatten(1).amax(1)
        worst = int((e_bf / bars).argmax())
        log(f"{label}: row-relative {e_r:.3e} (tol {ROW_TOL:.3e}); float32 q max_err {e32:.3e} "
            f"(tol {F32_TOL}); against the unquantized bf16 kernel max {float(e_bf.max()):.3e}, "
            f"nearest its bar at row {worst}: {float(e_bf[worst]):.3e} (tol "
            f"{float(bars[worst]):.3e})")
        for r in (bars > bars.min()).nonzero().flatten().tolist():
            log(f"  row {r}, fewer keys than a page: {float(e_bf[r]):.3e} against its bar "
                f"{float(bars[r]):.3e} (QTOL plus its own V codes' measured error)")
        if not ok_rows or e_r > ROW_TOL or e32 > F32_TOL or bool((e_bf > bars).any()):
            raise AssertionError(f"{label} disagrees")

    def decode_bars(lens, rows, table, vc, vs, vb, kv_dtype):
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


def split_path_cost(torch, pd, randn, calls=200, rounds=5):
    """Time per call of the decode wrapper, host clock over ``calls``
    back-to-back calls ended by one sync (so whichever of host or card is
    slower sets it), one-pass against two splits. At one row of two pages
    the split saves nothing, so the difference is the split path's fixed
    cost per call: what ``COMBINE_LAUNCH_OVERHEAD_S`` models. At the serve
    run's decode shape (8 rows of ~560 tokens) it shows which choice wins."""
    from repro_torch.core import numa, perf_model

    def per_call(args, ns):
        for _ in range(10):
            pd.paged_flash_decode(*args, num_splits=ns)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            pd.paged_flash_decode(*args, num_splits=ns)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    for b, width, length in ((1, 2, 32), (8, 36, 560)):
        num_pages = 1 + b * width
        kp, vp = randn(HKV, num_pages, PS, D), randn(HKV, num_pages, PS, D)
        table = (torch.arange(b * width, device="cuda", dtype=torch.int32) + 1).reshape(b, width)
        lengths = torch.full((b,), length, dtype=torch.int32, device="cuda")
        args = (randn(b, HQ, D), kp, vp, table, lengths)
        us = {1: [], 2: []}
        for _ in range(rounds):
            for ns in (1, 2, 2, 1):
                us[ns].append(per_call(args, ns))
        one, two = statistics.median(us[1]), statistics.median(us[2])
        est = perf_model.estimate_decode_splits(
            batch=b, num_q_heads=HQ, num_kv_heads=HKV, seq_kv=width * PS, granule=PS,
            head_dim=D, dtype_bytes=2, topo=numa.H100)
        log(f"decode per call, B {b} x {length} tokens (table {width} pages), host clock over "
            f"{calls} calls: num_splits 1 {one:.2f} us, 2 {two:.2f} us, split path costs "
            f"{two - one:+.2f} us; model picks {est.num_splits} (combine overhead "
            f"{perf_model.COMBINE_LAUNCH_OVERHEAD_S * 1e6:.1f} us)")


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


def serve_prompts(cfg, seed=0):
    """Run (a)'s prompts, 8 of 512 tokens sharing a 256-token prefix, and
    the generator that drew them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab, size=(256,))
    return [np.concatenate([system, rng.integers(1, cfg.vocab, size=(256,))])
            for _ in range(8)], rng


def serve(torch, cfg, params, seed=0, device="cuda"):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    engine_kw = dict(SERVE_PAGED_KW, device=device)
    prompts_a, rng = serve_prompts(cfg, seed)
    prompt_b = rng.integers(1, cfg.vocab, size=(4096,))
    greedy = SamplingParams(max_tokens=32)

    # Each run on an engine sized for it: a sync decodes every row over the
    # whole page table (one CUDA graph per (steps, stop width)), so the
    # table width sets the decode plan: one pass (K3) over (a)'s 36 pages,
    # two splits (K4) over (b)'s 260.
    kernels.reset_launch_counts()
    runs, stats = {}, {}
    for label, prompts, uid0, kw in (("a", prompts_a, 0, engine_kw),
                                     ("b", [prompt_b], 100,
                                      dict(engine_kw, max_pages_per_seq=260,
                                           prompt_buckets=(256, 512, 4096)))):
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
    check_k1_route("serve llama3-8b paged", counts)
    check_k2_route("serve llama3-8b paged", counts)
    check_paged_route("serve llama3-8b paged", counts)
    for key in ("K1", "K2", "K3", "K4"):
        if counts[KERNELS[key]["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on the main path")
    for label, (out, _, _) in runs.items():
        if any(len(o.tokens) != 32 for o in out):
            raise AssertionError(f"serve ({label}) did not generate 32 tokens per request")

    # Kernel path against the plain path, same weights, on the card: one
    # sync of each run at its own engine sizes.
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    logits = {"a": compare_sync(torch, cfg, plain_cfg, params, label="llama3-8b paged (a)",
                                engine_kw=engine_kw, prompts=prompts_a),
              "b": compare_sync(torch, cfg, plain_cfg, params, label="llama3-8b paged (b)",
                                engine_kw=dict(engine_kw, max_pages_per_seq=260,
                                               prompt_buckets=(256, 512, 4096)),
                                prompts=[prompt_b])}
    return counts, logits


def serve_quantized(torch, cfg, params, bf16_logits, seed=0, device="cuda"):
    """Run (a)'s and run (b)'s workloads on llama3-8b paged with the pool
    stored as int8 and then as fp8 codes: (a) runs K1, then K2q on its
    extend wave, then K3q in the decode graph; (b) K1 and K4q (2 splits over
    260 pages). The launch counts are set to 0 just before each format's
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

    engine_kw = dict(SERVE_PAGED_KW, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    prompts_a, rng = serve_prompts(cfg, seed)
    prompt_b = rng.integers(1, cfg.vocab, size=(4096,))
    kw_b = dict(engine_kw, max_pages_per_seq=260, prompt_buckets=(256, 512, 4096))
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
            bf16_bytes = 2 * cfg.n_layers * HKV * PS * D * 2 * b.pool.num_pages
            ttft = sorted(engine.ttft[o.uid] * 1e3 for o in out)
            log(f"serve {kv_dtype} ({label}): {len(out)} requests, "
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
                               label=f"llama3-8b paged {kv_dtype} ({label})",
                               engine_kw=dict(kw, kv_dtype=kv_dtype), prompts=prompts)
            dist = {stage: max(float((got[stage][u] - ref).abs().max() / ref.abs().max())
                               for u, ref in bf16_logits[label][stage].items())
                    for stage in ("first", "last")}
            log(f"  {kv_dtype} ({label}) against the bf16 pool, informative: prefill logits "
                f"max |{kv_dtype} - bf16| / max |bf16| = {dist['first']:.3e}, decode tick "
                f"{dist['last']:.3e}")
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
                want, kv_layout=None, rows=8, cache_len=4096,
                buckets=(512, 1024, 2048, 4096), seed=0, device="cuda"):
    """Dense serving through ``LLMEngine``: greedy requests of
    ``prompt_lens`` tokens (none a bucket size, so each prefill is
    right-padded), then one of ``lone_len`` alone on an engine of
    ``lone_cache_len`` stripes (a sync decodes every row over the whole
    stripe, so the stripe sets the decode plan), 32 new tokens each, with
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
        [("alone", [lone_len], 100, dict(kw, cache_len=lone_cache_len or cache_len))]
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
        engine = LLMEngine(cfg, params, steps_per_sync=8, **engine_kw)
        for i, p in enumerate(prompts):
            engine.add_request(Request(uid=i, prompt=p, sampling=greedy))
        engine.step()
        replay = engine.backend._programs[(8, 0)].graph.replay
        ms8 = timer.ms(replay, primed=True)
        log(f"tick {label}: 8-tick graph replay {ms8:.3f} ms (queue primed), "
            f"{ms8 / 8:.3f} ms a tick")
        out["graph8_ms"] = ms8
        out["graph8_profile"] = profile_summary(torch, replay, f"{label} 8-tick graph replay")
        engine.close()
        del engine
    return out


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
            f"{p['prefix']['prefix_hit_rate']:.3f}, preemptions {p['preemptions']}; "
            f"card: {card}")
        log(f"loadgen N={n} drift (worst ratio {p['drift_worst_ratio']}; card: {card}):")
        log("  " + DriftReport(rows=p["drift"]["rows"]).render().replace("\n", "\n  "))
    log(f"loadgen host overhead per token: N=1 "
        f"{payloads[1]['host_overhead_per_token_s'] * 1e6:.1f} us, N=8 "
        f"{payloads[8]['host_overhead_per_token_s'] * 1e6:.1f} us; card: {card}")
    log("loadgen summary: " + json.dumps({
        f"n{n}": {k: p[k] for k in ("ttft_s", "ttft_sampled_s", "itl_s", "queue_s",
                                    "measured_tok_s", "modeled_tok_s",
                                    "host_overhead_per_token_s",
                                    "decode_retraces_after_warmup", "drift_worst_ratio")}
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


# -- phase 5: train llama3-8b widths ------------------------------------------

def train(torch, cfg_full, seed=0):
    from repro_torch import kernels
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import train_step as ts
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(cfg_full, n_layers=TRAIN_LAYERS)
    tcfg = ts.TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=1,
                                                total_steps=TRAIN_STEPS),
                          microbatches=TRAIN_MICRO)
    gc.collect()                 # the serve phase's engines sit in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ts.init_train_state(seed, cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_lib.leaves(state["params"]))
    log(f"init_train_state {cfg.name} x {TRAIN_LAYERS} layers: {n_params / 1e9:.3f} B "
        f"float32 parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB with AdamW "
        f"state, {time.perf_counter() - t0:.1f} s")
    pipe = make_pipeline(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed,
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
    tokens = TRAIN_SEQ * TRAIN_BATCH
    prev = {key: 0 for key in counts}
    for rec, cum in zip(trainer.history, per_step):
        step_counts = {KERNELS[k]["counter"]: cum[KERNELS[k]["counter"]]
                       - prev[KERNELS[k]["counter"]] for k in ("K1", "K5", "K6")}
        prev = cum
        log(f"train step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.4f} step {rec['step_time_s']:.3f} s, "
            f"{tokens / rec['step_time_s']:.0f} tok/s (host clock, synced); launches "
            f"{json.dumps(step_counts)}")
        want = {KERNELS["K1"]["counter"]: 2 * TRAIN_LAYERS * TRAIN_MICRO,
                KERNELS["K5"]["counter"]: TRAIN_LAYERS * TRAIN_MICRO,
                KERNELS["K6"]["counter"]: TRAIN_LAYERS * TRAIN_MICRO}
        if step_counts != want:
            raise AssertionError(f"train launches {step_counts}, expected {want} "
                                 "(remat: K1 twice per layer per microbatch)")
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"train step {rec['step']}: non-finite loss or grad norm")
    log(f"train peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(max_memory_allocated); retries {trainer.retries}; launch counts over the "
        f"train run: {json.dumps(counts)}")
    if trainer.retries or trainer.step != TRAIN_STEPS:
        raise AssertionError(f"trainer made {trainer.retries} retries")
    check_k1_route("train", counts)
    check_bwd_route("train", bwd_launches({key: 0 for key in counts}, counts))
    step_s = trainer.history[-1]["step_time_s"]
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    train_breakdown(torch, cfg, step_s)

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
    log(f"train step-1 kernel path vs plain path: loss {losses['cuda']:.6f} vs "
        f"{losses['plain']:.6f} (relative {rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
        f"||g_cuda - g_plain|| / ||g_plain|| max {rels[worst]:.3e} at {worst} (tol "
        f"{TRAIN_GRAD_TOL}), median {statistics.median(rels.values()):.3e}")
    if rel_loss > TRAIN_LOSS_TOL or rels[worst] > TRAIN_GRAD_TOL or not math.isfinite(
            losses["cuda"]):
        raise AssertionError("train: kernel path disagrees with the plain path")
    return counts


def train_breakdown(torch, cfg, step_s):
    """K1, K5 and K6 at the train step's shapes and with the plan its
    attention layers build (B 2 per microbatch, S 4096, causal), each held
    against its plain version on the same inputs (K1 per row, K5 / K6 per
    (b, head) slice, ROW_TOL); then each timed alone (CUDA-event medians, L2
    flushed) beside the float32 LM head, times its count per step, against
    the measured step time: a breakdown by parts, not a profile. SDPA's
    forward and backward are timed beside K1 and K5 + K6. These
    launches come after the train run's counts were read."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import plan as plan_lib

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, s = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ
    plan = plan_lib.plan_for_config(cfg, (b, HQ, HKV, s, s, D), device_type="cuda",
                                    dtype_bytes=2, phase=plan_lib.PREFILL)
    kw = dict(mapping=plan.mapping, causal=True)
    q, k, v, do = randn(b, HQ, s, D), randn(b, HKV, s, D), randn(b, HKV, s, D), randn(b, HQ, s, D)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # the train run's peak was read already
    log(f"train parts: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before "
        "the plain versions")
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    e_o, e_l = row_err(o, o_ref), err(lse, lse_ref)
    del o_ref, lse_ref
    ref = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    rel = [slice_err(g, r) for g, r in zip((dq, dk, dv), ref)]
    del ref, dq, dk, dv
    log(f"train shape B {b} S {s} causal, {plan.mapping}: K1 o row-relative {e_o:.3e} "
        f"lse {e_l:.3e}; K5/K6 per-slice relative dq {rel[0]:.3e} dk {rel[1]:.3e} dv "
        f"{rel[2]:.3e} (tol {ROW_TOL:.3e}, lse {LSE_TOL}); peak of the check "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if e_o > ROW_TOL or e_l > LSE_TOL or max(rel) > ROW_TOL:
        raise AssertionError("K1/K5/K6 at the train shape disagree with their plain versions")
    t_k1 = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
    t_sdpa = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    k1_bound = k1_bound_of(q, k, v, o, lse, causal=True)
    t_k5 = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
    t_k6 = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    group = HQ // HKV
    leaves = [t.detach().requires_grad_(True)
              for t in (q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True)
    t_sdpa_bwd = timer.ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    del leaves, out, q, k, v, do, o, lse, delta
    x = randn(b * s, cfg.d_model, dtype=torch.float32)
    head = randn(cfg.d_model, cfg.vocab, dtype=torch.float32)
    g = randn(b * s, cfg.vocab, dtype=torch.float32)
    # The head's forward product and the two of its backward, float32.
    t_head = timer.ms(lambda: (x @ head, g @ head.T, x.T @ g))
    del x, head, g, timer
    attn = TRAIN_MICRO * TRAIN_LAYERS * (2 * t_k1 + t_k5 + t_k6)
    head_ms = TRAIN_MICRO * t_head
    k1_ms = TRAIN_MICRO * TRAIN_LAYERS * 2 * t_k1
    log(f"train step parts at B {b} S {s} per microbatch: K1 {t_k1:.4f} ms (library sdpa "
        f"{t_sdpa:.4f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]})), K5 {t_k5:.4f} ms, K6 "
        f"{t_k6:.4f} ms (pair {t_k5 + t_k6:.4f} ms, library sdpa backward {t_sdpa_bwd:.4f} "
        f"ms), float32 LM head (3 products) {t_head:.3f} ms; per step: attention "
        f"kernels {attn:.1f} ms ({attn / (step_s * 1e3):.1%} of the {step_s * 1e3:.1f} ms "
        f"step; K1 x 2 {k1_ms:.1f} ms, {k1_ms / (step_s * 1e3):.1%}), LM head "
        f"{head_ms:.1f} ms ({head_ms / (step_s * 1e3):.1%})")


def main() -> int:
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
    from repro_torch.configs import hymba_1_5b, llama3_8b, mamba2_1_3b
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

    log("== kernels (bf16, Hq 32, Hkv 8, D 128, page 16)")
    results = {}
    timer = Timer(torch)
    check_kernels(torch, timer, results)
    check_backward(torch, timer, results)
    log("== kernels K7 / K8 (dense decode, bf16) and K9 (SSD intra-chunk, float32 in 3xTF32)")
    check_dense_decode(torch, timer, results)
    check_ssd(torch, timer, results)
    del timer
    log("== serve llama3-8b (paged, bf16, random weights)")
    params = init_params(torch, llama3_8b.CONFIG)
    counts, bf16_logits = serve(torch, llama3_8b.CONFIG, params)
    log("== serve llama3-8b paged over quantized pools (int8, fp8) and with a host tier")
    quantized = serve_quantized(torch, llama3_8b.CONFIG, params, bf16_logits)
    for key in ("K2q", "K3q", "K4q"):
        counts[KERNELS[key]["counter"]] += quantized[KERNELS[key]["counter"]]
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
    log("== serve hymba-1.5b (kv_layout auto -> dense, bf16, random weights)")
    params = init_params(torch, hymba_1_5b.CONFIG)
    hymba_lens = (100, 300, 600, 900, 1100, 1300, 1450, 1500)
    paths.append(serve_dense(torch, hymba_1_5b.CONFIG, params, prompt_lens=hymba_lens,
                             cache_len=2048, lone_len=4000, lone_cache_len=4096,
                             want=("K1", "K7", "K8", "K9")))
    fused["hymba-1.5b dense"] = fused_phase(
        torch, timer, hymba_1_5b.CONFIG, params, label="hymba-1.5b dense",
        engine_kw=dict(max_batch=8, cache_len=2048, prompt_buckets=(512, 1024, 2048),
                       device="cuda"),
        prompts=dense_prompts(hymba_1_5b.CONFIG, hymba_lens))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("== serve mamba2-1.3b (kv_layout auto -> dense, bf16, random weights)")
    params = init_params(torch, mamba2_1_3b.CONFIG)
    mamba_lens = (200, 700, 1300, 2000)
    paths.append(serve_dense(torch, mamba2_1_3b.CONFIG, params, rows=4,
                             prompt_lens=mamba_lens, want=("K9",)))
    fused["mamba2-1.3b dense"] = fused_phase(
        torch, timer, mamba2_1_3b.CONFIG, params, label="mamba2-1.3b dense",
        engine_kw=dict(max_batch=4, cache_len=4096, prompt_buckets=(512, 1024, 2048, 4096),
                       device="cuda"),
        prompts=dense_prompts(mamba2_1_3b.CONFIG, mamba_lens))
    del params, timer
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
    for key, spec in KERNELS.items():
        if counts[spec["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on a main path")

    # launches: each kernel's count over the serve and train runs together.
    line = {"kernels": [
        dict(name=spec["name"], route="cuda", source=spec["source"],
             replaces=spec["replaces"], launches=counts[spec["counter"]], **results[key])
        for key, spec in KERNELS.items()
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi_line()}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
