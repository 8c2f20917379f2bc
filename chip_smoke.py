#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and ``nvcc``; without a card, or outside a checkout, it exits non-zero
and prints no result. Phases, in order (any failure exits non-zero):

  1. probe  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build  — compiles the nine kernels from ``src/repro_torch/csrc`` with
     nvcc for sm_90a, one nvcc per source in parallel; prints the build
     time and ptxas' register / shared-memory lines;
  3. kernels — each kernel against its plain PyTorch version on the card,
     at llama3-8b widths in bf16 (Hq 32, Hkv 8, D 128, page size 16):
     max error at a stated tolerance, CUDA-event median times of kernel and
     plain version, and the bound (bytes over 3.35 TB/s vs operations over
     989 TFLOP/s, the H100 SXM data-sheet peaks). K1 in bf16 is the
     tensor-core kernel: every launch order (head-first and block-first
     bitwise equal), window + softcap, hymba-1.5b's widths (timed with SDPA
     beside it); K1 in float32 (the CUDA-core kernel) held at 2e-5 and
     timed at the same B 2, S 2048. Then the split-K estimator's modelled
     decode times beside the measured ones, and the fixed cost per call of
     the split path over the one-pass path; then K5
     (dQ) and K6 (dK/dV) in bf16, on the tensor cores, under both launch
     orders (bitwise equal), with window + softcap, and at S 1000 padded to
     1024 (kv_len masking), SDPA's backward as the library yardstick; K5 /
     K6 in float32 (the CUDA-core kernels) held per slice at 1e-5 and timed
     at the same B 2, S 2048; then K7 / K8 (dense decode, one pass and
     split-K) at llama3-8b and hymba-1.5b widths (window 1024 and global),
     SDPA on the expanded, masked stripes as the library yardstick; then K9
     (SSD intra-chunk) at hymba-1.5b's and mamba2-1.3b's prefill shapes;
  4. serve  — ``LLMEngine(kv_layout="paged")`` on full-width llama3-8b with
     random bf16 weights: (a) 8 greedy requests of 512 tokens sharing a
     256-token system prefix, (b) one 4096-token request, 32 new tokens
     each; every kernel's launch count over that run must be above 0. Then
     one request's prefill and first-decode logits, kernel path against the
     plain path on the card; then the same weights served from dense
     stripes (``kv_layout="dense"``); then full-width hymba-1.5b through
     ``LLMEngine(cfg, params)`` (``kv_layout`` resolves to dense): 8 greedy
     requests off the prompt buckets, several past the 1024 window, then one
     of 4000 tokens alone, whose decode the plan splits (K8); then
     full-width mamba2-1.3b. Each dense run must launch its kernels and
     hold its first-token and next-token logits to the plain path's (every
     kernel off: ``attn_impl`` and ``ssm.impl`` "plain");
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
# K9 (float32 in and out) against its plain version, per (b, chunk, head)
# slice: max |y - ref| over max |ref|. Both sum float32 FMAs over at most
# q + N terms in another order (about 1e-6 relative); a dropped or
# mis-masked key tile moves y by a large fraction of its max.
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
HQ, HKV, D, PS = 32, 8, 128, 16

KERNELS = {
    "K1": dict(name="K1 flash_attention_fwd (bf16, tensor cores)",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:361",
               counter="flash_attention_fwd_tc"),
    "K2": dict(name="K2 paged_flash_prefill", source="src/repro_torch/csrc/paged_prefill.cu",
               replaces="src/repro/kernels/paged_prefill_attention.py:277",
               counter="paged_flash_prefill"),
    "K3": dict(name="K3 paged_flash_decode", source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/paged_decode_attention.py:262",
               counter="paged_flash_decode"),
    "K4": dict(name="K4 paged_flash_decode_split+combine",
               source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/paged_decode_attention.py:323",
               counter="paged_flash_decode_split"),
    "K5": dict(name="K5 flash_attention_bwd_dq (bf16, tensor cores)",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention_bwd.py:228",
               counter="flash_attention_bwd_dq_tc"),
    "K6": dict(name="K6 flash_attention_bwd_dkv (bf16, tensor cores)",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention_bwd.py:279",
               counter="flash_attention_bwd_dkv_tc"),
    "K7": dict(name="K7 flash_decode", source="src/repro_torch/csrc/dense_decode.cu",
               replaces="src/repro/kernels/decode_attention.py:175", counter="flash_decode"),
    "K8": dict(name="K8 flash_decode_split+combine",
               source="src/repro_torch/csrc/dense_decode.cu",
               replaces="src/repro/kernels/decode_attention.py:227",
               counter="flash_decode_split"),
    "K9": dict(name="K9 ssd_intra_chunk", source="src/repro_torch/csrc/ssd.cu",
               replaces="src/repro/kernels/ssd.py:83", counter="ssd_intra_chunk"),
}


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
    leaves the 50 MB L2 cold, as the serving path finds it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            self.flush.zero_()
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
    from repro_torch.core import numa, perf_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pd
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

    # K2: prefix 1000 tokens (not a page multiple), tail 256, B 2.
    b, plen, st = 2, 1000, 256
    mp = -(-plen // PS)
    num_pages = 1 + b * mp
    kp, vp = randn(HKV, num_pages, PS, D), randn(HKV, num_pages, PS, D)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
    q, kt, vt = randn(b, HQ, st, D), randn(b, HKV, st, D), randn(b, HKV, st, D)
    plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
    tlens = torch.tensor([st, st - 37], dtype=torch.int32, device="cuda")
    args = (q, kp, vp, table, kt, vt, plens, tlens)
    o = pp.paged_flash_prefill(*args)
    o_ref = pp.paged_flash_prefill_plain(*args)
    torch.cuda.synchronize()
    e, e_r = err(o, o_ref), row_err(o, o_ref)
    ms = timer.ms(lambda: pp.paged_flash_prefill(*args))
    plain_ms = timer.ms(lambda: pp.paged_flash_prefill_plain(*args))
    live_rows = int(tlens.sum())
    pairs = HQ * (live_rows * plen + sum(t * (t + 1) // 2 for t in tlens.tolist()))
    kv_read = 2 * b * HKV * plen * D * 2
    k2_bound = bound(kv_read + nbytes(q, kt, vt, o, table, plens, tlens), 4.0 * D * pairs)
    log(f"K2 prefix {plen} tail {st}: max_err {e:.3e} (row-relative {e_r:.3e}, tol "
        f"{ROW_TOL:.3e}) {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {k2_bound[0]:.3f} ms "
        f"({k2_bound[1]})")
    if e_r > ROW_TOL:
        raise AssertionError("K2 disagrees with its plain version")
    results["K2"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=k2_bound[0],
                         bound_by=k2_bound[1], library_ms=None)
    del kp, vp, q, kt, vt, o, o_ref

    # K3 / K4: B 8, ragged lengths up to 4096 with one length-0 row.
    b, smax = 8, 4096
    mp = smax // PS
    num_pages = 1 + b * mp
    kp, vp = randn(HKV, num_pages, PS, D), randn(HKV, num_pages, PS, D)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, mp).to(torch.int32).contiguous()
    lengths = torch.tensor([4096, 0, 3001, 17, 2048, 4000, 1, 1500], dtype=torch.int32,
                           device="cuda")
    measured = {}
    q = randn(b, HQ, D)
    live = int(lengths.sum())
    dec_bound = bound(2 * HKV * live * D * 2 + nbytes(q, q, table, lengths),
                      4.0 * HQ * D * live)
    for key, splits in (("K3", (1,)), ("K4", (4, 7))):
        for ns in splits:
            o = pd.paged_flash_decode(q, kp, vp, table, lengths, num_splits=ns)
            o_ref = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, num_splits=ns)
            torch.cuda.synchronize()
            e, e_r = err(o, o_ref), row_err(o, o_ref)
            zero_row = float(o[1].float().abs().max())
            ms = timer.ms(lambda: pd.paged_flash_decode(q, kp, vp, table, lengths,
                                                        num_splits=ns))
            plain_ms = timer.ms(lambda: pd.paged_flash_decode_plain(
                q, kp, vp, table, lengths, num_splits=ns))
            log(f"{key} num_splits {ns}: max_err {e:.3e} (row-relative {e_r:.3e}, tol "
                f"{ROW_TOL:.3e}), length-0 row max {zero_row}, {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {dec_bound[0]:.4f} ms ({dec_bound[1]})")
            if e_r > ROW_TOL or zero_row != 0.0:
                raise AssertionError(f"{key} num_splits {ns} disagrees with its plain version")
            measured[ns] = ms
            if key not in results:
                results[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                    bound_ms=dec_bound[0], bound_by=dec_bound[1],
                                    library_ms=None)

    # The split-K estimator's modelled times for this case, beside the
    # measured ones: the model is calibrated only where the two agree.
    est = perf_model.estimate_decode_splits(
        batch=b, num_q_heads=HQ, num_kv_heads=HKV, seq_kv=smax, granule=PS, head_dim=D,
        dtype_bytes=2, topo=numa.H100)
    model = dict(est.times)
    log("split-K model vs measured (B 8, table 4096): " + ", ".join(
        f"num_splits {ns}: model {model[ns] * 1e3:.4f} ms, measured {measured[ns]:.4f} ms"
        for ns in sorted(measured)) + f"; model picks {est.num_splits}")
    split_path_cost(torch, pd, randn)


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


def check_dense_decode(torch, timer, results):
    """K7 (one pass) and K8 (split-K + combine) against their plain version
    on dense stripes, B 8, capacity 4096, ragged lengths with a length-0
    row, per row within ROW_TOL: at llama3-8b widths (one pass, 4 and 7
    splits), then at hymba-1.5b widths (Hq 25, Hkv 5, D 64) global and with
    window 1024 (one pass and 4 splits). The bound counts what these
    lengths need: each live key and value read once (``min(length,
    window)`` per row), q read and o written once; the JSON line takes
    hymba's global case, the serve path's. SDPA (q as (B, Hq, 1, D) against
    K/V expanded to Hq and masked by length) is the library yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import plan as plan_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    b, smax = 8, 4096
    lengths = torch.tensor([4096, 0, 3001, 17, 2048, 4000, 1, 1500], dtype=torch.int32,
                           device="cuda")
    chunk = plan_lib.decode_chunk(smax)
    for label, hq, hkv, d, window, splits in (
            ("llama3-8b", HQ, HKV, D, None, (1, 4, 7)),
            ("hymba-1.5b global", 25, 5, 64, None, (1, 4)),
            ("hymba-1.5b window 1024", 25, 5, 64, 1024, (1, 4))):
        q, kc, vc = randn(b, hq, d), randn(b, hkv, smax, d), randn(b, hkv, smax, d)
        live = int(torch.clamp(lengths, max=window or smax).sum())
        dec_bound = bound(2 * hkv * live * d * 2 + 2 * nbytes(q) + nbytes(lengths),
                          4.0 * hq * d * live)
        group = hq // hkv
        pos = torch.arange(smax, device="cuda")[None, :]
        mask = pos < lengths[:, None].long()
        if window:
            mask = mask & (pos > lengths[:, None].long() - 1 - window)
        kx, vx = kc.repeat_interleave(group, 1), vc.repeat_interleave(group, 1)
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kx, vx, attn_mask=mask[:, None, None, :]))
        del kx, vx
        for ns in splits:
            kw = dict(window=window, chunk=chunk, num_splits=ns)
            o = dd.flash_decode(q, kc, vc, lengths, **kw)
            o_ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
            torch.cuda.synchronize()
            e, e_r = err(o, o_ref), row_err(o, o_ref)
            zero_row = float(o[1].float().abs().max())
            ms = timer.ms(lambda: dd.flash_decode(q, kc, vc, lengths, **kw))
            plain_ms = timer.ms(lambda: dd.flash_decode_plain(q, kc, vc, lengths, **kw))
            key = "K7" if ns == 1 else "K8"
            log(f"{key} {label} chunk {chunk} num_splits {ns}: max_err {e:.3e} (row-relative "
                f"{e_r:.3e}, tol {ROW_TOL:.3e}), length-0 row max {zero_row}, {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, library sdpa {lib_ms:.4f} ms, bound "
                f"{dec_bound[0]:.4f} ms ({dec_bound[1]})")
            if e_r > ROW_TOL or zero_row != 0.0:
                raise AssertionError(f"{key} {label} num_splits {ns} disagrees with its "
                                     "plain version")
            if label == "hymba-1.5b global" and key not in results:
                results[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                    bound_ms=dec_bound[0], bound_by=dec_bound[1],
                                    library_ms=lib_ms)
        del q, kc, vc


def check_ssd(torch, timer, results):
    """K9 against its plain version at the prefill shapes of the serve path
    (B 1, L 4096, chunk 256): hymba-1.5b (H 50, P 64, N 16) and mamba2-1.3b
    (H 64, P 64, N 128), per (b, chunk, head) slice within SSD_TOL. Inputs
    as ``ssd_chunked_cuda`` makes them: dt = softplus(normal), A = -exp of
    the JAX package's initial log-decay range, acum the in-chunk cumsum.
    The bound counts the causal half of the two (q x q) products and the
    state product at the float32 peak, and each input read and output
    written once; the JSON line takes hymba's case. No one PyTorch call
    computes this block: no library time."""
    from repro_torch.kernels import ssd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    bsz, length, q = 1, 4096, 256
    nc = length // q
    for label, h, p, n in (("hymba-1.5b", 50, 64, 16), ("mamba2-1.3b", 64, 64, 128)):
        dt = torch.nn.functional.softplus(randn(bsz, nc, h, q))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        acum = torch.cumsum(dt * a[None, None, :, None], dim=-1).contiguous()
        xdt = (randn(bsz, nc, h, q, p) * dt[..., None]).contiguous()
        bh, ch = randn(bsz, nc, h, q, n), randn(bsz, nc, h, q, n)
        y, s = ssd.ssd_intra_chunk(xdt, bh, ch, acum)
        y_ref, s_ref = ssd.ssd_intra_chunk_plain(xdt, bh, ch, acum)
        # The same function in float64: how far each float32 route is from it.
        y64, s64 = (t.float() for t in ssd.ssd_intra_chunk_plain(
            *(t.double() for t in (xdt, bh, ch, acum))))
        torch.cuda.synchronize()
        e_y, e_s = slice_err(y, y_ref), slice_err(s, s_ref)
        e = max(err(y, y_ref), err(s, s_ref))
        log(f"K9 {label} against float64: kernel y {slice_err(y, y64):.3e} s "
            f"{slice_err(s, s64):.3e}, plain y {slice_err(y_ref, y64):.3e} s "
            f"{slice_err(s_ref, s64):.3e} (per-slice relative)")
        del y64, s64
        ms = timer.ms(lambda: ssd.ssd_intra_chunk(xdt, bh, ch, acum))
        plain_ms = timer.ms(lambda: ssd.ssd_intra_chunk_plain(xdt, bh, ch, acum))
        cells = bsz * nc * h
        ops = 2.0 * cells * (q * (q + 1) // 2 * (n + p) + q * n * p)
        k9_bound = bound(nbytes(xdt, bh, ch, acum, y, s), ops, PEAK_F32_FLOPS)
        log(f"K9 {label} (B {bsz}, L {length}, H {h}, P {p}, N {n}, q {q}): per-slice "
            f"relative y {e_y:.3e} s {e_s:.3e} (tol {SSD_TOL:.0e}), max abs {e:.3e}, "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {k9_bound[0]:.4f} ms "
            f"({k9_bound[1]}, float32 peak)")
        if max(e_y, e_s) > SSD_TOL:
            raise AssertionError(f"K9 {label} disagrees with its plain version")
        if "K9" not in results:
            results["K9"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                 bound_ms=k9_bound[0], bound_by=k9_bound[1], library_ms=None)
        del xdt, bh, ch, acum, y, s, y_ref, s_ref


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


def serve(torch, cfg, params, seed=0, device="cuda"):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    engine_kw = dict(kv_layout="paged", max_batch=8, num_pages=1024, page_size=PS,
                     max_pages_per_seq=260, prompt_buckets=(256, 512, 4096), device=device)
    engine = LLMEngine(cfg, params, **engine_kw)
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab, size=(256,))
    prompts_a = [np.concatenate([system, rng.integers(1, cfg.vocab, size=(256,))])
                 for _ in range(8)]
    prompt_b = rng.integers(1, cfg.vocab, size=(4096,))
    greedy = SamplingParams(max_tokens=32)

    kernels.reset_launch_counts()
    runs = {}
    for label, prompts, uid0 in (("a", prompts_a, 0), ("b", [prompt_b], 100)):
        t = time.perf_counter()
        out = engine.generate([Request(uid=uid0 + i, prompt=p, sampling=greedy)
                               for i, p in enumerate(prompts)])
        sync()
        runs[label] = (out, time.perf_counter() - t)
    counts = kernels.launch_counts()
    stats = engine.stats()
    for label, (out, secs) in runs.items():
        uids = sorted(o.uid for o in out)
        ttft = [engine.ttft[u] * 1e3 for u in uids]
        log(f"serve ({label}): {len(out)} requests, {sum(len(o.tokens) for o in out)} tokens "
            f"in {secs:.2f} s; TTFT ms min {min(ttft):.1f} max {max(ttft):.1f}")
    for o in sorted(runs["a"][0], key=lambda o: o.uid)[:1] + runs["b"][0][:1]:
        log(f"  uid={o.uid} tokens={[int(t) for t in o.tokens]}")
    log(f"serve decode {stats.decode_tok_s:.1f} tok/s over {stats.decode_elapsed_s:.2f} s "
        f"(host clock); prefix hit rate {stats.prefix_hit_rate:.3f}")
    log(f"launch counts over the serve run: {json.dumps(counts)}")
    check_k1_route("serve llama3-8b paged", counts)
    for key in ("K1", "K2", "K3", "K4"):
        if counts[KERNELS[key]["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on the main path")
    for label, (out, _) in runs.items():
        if any(len(o.tokens) != 32 for o in out):
            raise AssertionError(f"serve ({label}) did not generate 32 tokens per request")
    engine.close()
    del engine

    # Kernel path against the plain path, same weights, on the card.
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    small = dict(engine_kw, max_batch=1, num_pages=80, max_pages_per_seq=40,
                 prompt_buckets=(256, 512))
    outs = {}
    for name, c in (("cuda", cfg), ("plain", plain_cfg)):
        eng = LLMEngine(c, params, **small)
        logits = []
        for uid, prompt in ((0, prompts_a[0]), (1, prompts_a[1])):
            rec = eng.backend.try_admit(Request(uid=uid, prompt=prompt, sampling=greedy))
            first = eng.backend.flush([rec])[rec["row"]]
            tok = int(first.argmax())
            eng.backend.reserve_rows()
            nxt = eng.backend.decode([rec["row"]], [tok])[0]
            logits += [first.float(), nxt.float()]
            eng.backend.release(rec["row"])
        outs[name] = logits
        eng.close()
    labels = ("prefill K1", "decode after K1", "prefill K2 (prefix hit)", "decode after K2")
    for label, a, b in zip(labels, outs["cuda"], outs["plain"]):
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"logits {label}: max |cuda - plain| / max |plain| = {rel:.3e}, argmax "
            f"{int(a.argmax())} vs {int(b.argmax())}")
        if not torch.isfinite(a).all() or rel > LOGIT_TOL:
            raise AssertionError(f"logits {label}: kernel path disagrees with the plain path")
    return counts


def serve_dense(torch, cfg, params, *, prompt_lens, lone_len=None, compare_lens,
                want, kv_layout=None, rows=8, cache_len=4096,
                buckets=(512, 1024, 2048, 4096), seed=0, device="cuda"):
    """Dense serving through ``LLMEngine``: greedy requests of
    ``prompt_lens`` tokens (none a bucket size, so each prefill is
    right-padded), then one of ``lone_len`` alone, 32 new tokens each, with
    the launch counts set to 0 just before and read just after; every
    kernel of ``want`` must have launched. ``kv_layout=None`` takes the
    engine's default ("auto"), which must resolve to dense. Then the
    first-token and next-token logits of ``compare_lens`` prompts, kernel
    path against the plain path (attention and SSM impl "plain"), each
    prompt alone, within LOGIT_TOL of the plain path's max |logit|."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    kw = dict(max_batch=rows, cache_len=cache_len, prompt_buckets=buckets, device=device)
    if kv_layout is not None:
        kw["kv_layout"] = kv_layout
    engine = LLMEngine(cfg, params, **kw)
    if engine.kv_layout != "dense":
        raise AssertionError(f"{cfg.name}: kv_layout resolved to {engine.kv_layout}, not dense")
    lens = list(prompt_lens) + ([lone_len] if lone_len else [])
    if any(n in buckets for n in lens):
        raise AssertionError("serve_dense prompts must not be bucket sizes")
    rng = np.random.default_rng(seed + 7)
    prompts = {n: rng.integers(1, cfg.vocab, size=(n,)) for n in set(lens) | set(compare_lens)}
    greedy = SamplingParams(max_tokens=32)
    batches = [("batch", list(prompt_lens))] + ([("alone", [lone_len])] if lone_len else [])
    kernels.reset_launch_counts()
    runs = {}
    for label, group in batches:
        t = time.perf_counter()
        out = engine.generate([Request(uid=i, prompt=prompts[n], sampling=greedy)
                               for i, n in enumerate(group)])
        torch.cuda.synchronize()
        runs[label] = (out, time.perf_counter() - t)
    counts = kernels.launch_counts()
    stats = engine.stats()
    for label, (out, secs) in runs.items():
        ttft = sorted(engine.ttft[o.uid] * 1e3 for o in out)
        log(f"serve {cfg.name} ({label}, prompts {[len(prompts[n]) for n in dict(batches)[label]]}): "
            f"{len(out)} requests, {sum(len(o.tokens) for o in out)} tokens in {secs:.2f} s; "
            f"TTFT ms min {ttft[0]:.1f} max {ttft[-1]:.1f}")
        if any(len(o.tokens) != 32 for o in out):
            raise AssertionError(f"serve {cfg.name} ({label}) did not generate 32 tokens each")
    log(f"serve {cfg.name} kv_layout={engine.kv_layout}: decode {stats.decode_tok_s:.1f} "
        f"tok/s over {stats.decode_elapsed_s:.2f} s (host clock); prefill launches "
        f"{stats.prefill_launches}; launch counts {json.dumps(counts)}")
    for key in want:
        if counts[KERNELS[key]["counter"]] <= 0:
            raise AssertionError(f"{key} was not launched on the {cfg.name} dense path")
    if "K1" in want:
        check_k1_route(f"serve {cfg.name} dense", counts)
    engine.close()
    del engine

    plain_cfg = dataclasses.replace(
        cfg, attn_impl="plain",
        ssm=dataclasses.replace(cfg.ssm, impl="plain") if cfg.ssm else None)
    outs = {}
    for name, c in (("cuda", cfg), ("plain", plain_cfg)):
        eng = LLMEngine(c, params, **dict(kw, max_batch=1))
        logits = []
        for n in compare_lens:
            rec = eng.backend.try_admit(Request(uid=n, prompt=prompts[n], sampling=greedy))
            first = eng.backend.flush([rec])[rec["row"]]
            nxt = eng.backend.decode([rec["row"]], [int(first.argmax())])[0]
            logits += [(f"prefill {n}", first.float()), (f"decode after {n}", nxt.float())]
            eng.backend.release(rec["row"])
        outs[name] = logits
        eng.close()
    for (label, a), (_, b) in zip(outs["cuda"], outs["plain"]):
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"logits {cfg.name} {label}: max |cuda - plain| / max |plain| = {rel:.3e} (tol "
            f"{LOGIT_TOL}), argmax {int(a.argmax())} vs {int(b.argmax())}")
        if not torch.isfinite(a).all() or rel > LOGIT_TOL:
            raise AssertionError(f"logits {cfg.name} {label}: kernel path disagrees with "
                                 "the plain path")
    return counts


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
    log("== kernels K7 / K8 (dense decode, bf16) and K9 (SSD intra-chunk, float32)")
    check_dense_decode(torch, timer, results)
    check_ssd(torch, timer, results)
    del timer
    log("== serve llama3-8b (paged, bf16, random weights)")
    params = init_params(torch, llama3_8b.CONFIG)
    counts = serve(torch, llama3_8b.CONFIG, params)
    log("== serve llama3-8b (dense, the same weights)")
    paths = [serve_dense(torch, llama3_8b.CONFIG, params, kv_layout="dense", rows=4,
                         prompt_lens=(300, 900, 1500, 2500), compare_lens=(900,),
                         want=("K1",))]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("== serve hymba-1.5b (kv_layout auto -> dense, bf16, random weights)")
    params = init_params(torch, hymba_1_5b.CONFIG)
    paths.append(serve_dense(torch, hymba_1_5b.CONFIG, params,
                             prompt_lens=(100, 300, 600, 900, 1100, 1300, 1450, 1500),
                             lone_len=4000, compare_lens=(1500, 4000),
                             want=("K1", "K7", "K8", "K9")))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("== serve mamba2-1.3b (kv_layout auto -> dense, bf16, random weights)")
    params = init_params(torch, mamba2_1_3b.CONFIG)
    paths.append(serve_dense(torch, mamba2_1_3b.CONFIG, params, rows=4,
                             prompt_lens=(200, 700, 1300, 2000), compare_lens=(700, 2000),
                             want=("K9",)))
    del params
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
