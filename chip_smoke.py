#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and ``nvcc``; without a card, or outside a checkout, it exits non-zero
and prints no result. Phases, in order (any failure exits non-zero):

  1. probe  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build  — compiles the six attention kernels from ``src/repro_torch/
     csrc`` with nvcc for sm_90a, one nvcc per source in parallel; prints
     the build time and ptxas' register / shared-memory lines;
  3. kernels — each kernel against its plain PyTorch version on the card,
     at llama3-8b widths in bf16 (Hq 32, Hkv 8, D 128, page size 16):
     max error at a stated tolerance, CUDA-event median times of kernel and
     plain version, and the bound (bytes over 3.35 TB/s vs operations over
     989 TFLOP/s, the H100 SXM data-sheet peaks); then the split-K
     estimator's modelled decode times beside the measured ones, and the
     fixed cost per call of the split path over the one-pass path; then K5
     (dQ) and K6 (dK/dV) under both launch orders, with window + softcap,
     and at S 1000 padded to 1024 (kv_len masking), and SDPA's backward as
     the library yardstick;
  4. serve  — ``LLMEngine(kv_layout="paged")`` on full-width llama3-8b with
     random bf16 weights: (a) 8 greedy requests of 512 tokens sharing a
     256-token system prefix, (b) one 4096-token request, 32 new tokens
     each; every kernel's launch count over that run must be above 0. Then
     one request's prefill and first-decode logits, kernel path against the
     plain path on the card;
  5. train  — ``Trainer`` + ``make_train_step`` on llama3-8b at full width
     cut to 4 layers (float32 masters and AdamW moments of all 32 layers
     need ~128 GB), sequence 4096, global batch 4 in 2 microbatches, bf16
     compute, remat, 3 steps; K1, K5 and K6 must each launch as often as the
     layer count predicts; then the step's attention kernels held against
     their plain versions at its shapes (B 2, S 4096) and, with its float32
     LM head, timed alone there, beside the step time; then one step's
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
PEAK_HBM_BW = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
# bf16 outputs against their plain versions, per row: max |o - ref| over
# max |ref| of that row (a row of ref that is all zero must be exactly zero).
# Two outputs that round differently to bf16 differ by one ulp, at most
# 2^-7 of the row's max; a dropped page or a mis-masked tile of a 4096-key
# row moves o by ~2^-4 of its row max.
ROW_TOL = 2.0**-6
LSE_TOL = 1e-5             # float32 logsumexp, |lse| ~ 8: about 10 ulp
# Logits of the kernel path against the plain path, relative to max |logit|:
# bf16 attention outputs round differently in the two paths (~2^-8
# relative) and the difference compounds over 32 layers.
LOGIT_TOL = 5e-2
# Train phase: the kernel path's step-1 loss and gradients against the
# plain path's (same weights and batch, bf16 compute). The loss agrees as
# the logits do; each gradient leaf is held by its relative norm.
TRAIN_LOSS_TOL = 1e-2
# Read 3.3e-3 at most (median 1.7e-3) at 2 layers, seq 1024 on an NVIDIA
# H100 80GB HBM3 at 700 W: bf16 attention outputs that round differently in
# the two paths, carried through the backward pass. 1e-2 keeps 3x headroom;
# each kernel is also held per slice in phase 3.
TRAIN_GRAD_TOL = 1e-2
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 4, 2, 3
REPS = 20                  # timed runs per case; the median is reported
HQ, HKV, D, PS = 32, 8, 128, 16

KERNELS = {
    "K1": dict(name="K1 flash_attention_fwd", source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:361", counter="flash_attention_fwd"),
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
    "K5": dict(name="K5 flash_attention_bwd_dq", source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention_bwd.py:228",
               counter="flash_attention_bwd_dq"),
    "K6": dict(name="K6 flash_attention_bwd_dkv",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention_bwd.py:279",
               counter="flash_attention_bwd_dkv"),
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


def bound(nbytes: float, flops: float):
    t_mem, t_ops = nbytes / PEAK_HBM_BW, flops / PEAK_BF16_FLOPS
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


# -- phase 3: kernels against their plain versions ---------------------------

def check_kernels(torch, timer, results):
    import torch.nn.functional as F
    from repro_torch.core import numa, perf_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import paged_prefill_attention as pp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # K1: B 2, S 2048, causal, every mapping; then window + softcap.
    b, s = 2, 2048
    q, k, v = randn(b, HQ, s, D), randn(b, HKV, s, D), randn(b, HKV, s, D)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    rows = torch.arange(s)
    pairs = b * HQ * int((rows + 1).sum())
    k1_bytes = nbytes(q, k, v, o_ref, lse_ref)
    k1_bound = bound(k1_bytes, 4.0 * D * pairs)
    # The three distinct launches: the paper's naive_/swizzled_ names are
    # aliases of the two orders (kernels/flash_attention.py).
    mappings = [("head_first", fa.MappingConfig(order=fa.HEAD_FIRST)),
                ("block_first", fa.MappingConfig(order=fa.BLOCK_FIRST)),
                ("head_first+sawtooth", fa.MappingConfig(order=fa.HEAD_FIRST,
                                                         traversal="sawtooth"))]
    k1_main = None
    for name, mapping in mappings:
        o, lse = fa.flash_attention_fwd(q, k, v, mapping=mapping, causal=True)
        torch.cuda.synchronize()
        e_o, e_r, e_l = err(o, o_ref), row_err(o, o_ref), err(lse, lse_ref)
        ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, mapping=mapping, causal=True))
        log(f"K1 {name}: max_err o {e_o:.3e} (row-relative {e_r:.3e}, tol {ROW_TOL:.3e}) "
            f"lse {e_l:.3e} (tol {LSE_TOL}) {ms:.3f} ms, bound {k1_bound[0]:.3f} ms "
            f"({k1_bound[1]})")
        if e_r > ROW_TOL or e_l > LSE_TOL:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        if k1_main is None:
            k1_main = (max(e_o, e_l), ms)
    plain_ms = timer.ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True))
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True))
    log(f"K1 plain {plain_ms:.3f} ms, library sdpa {lib_ms:.3f} ms")
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
    """K5 and K6 against the plain backward, per (b, head) slice of each
    gradient: max |g - ref| / max |ref| within ROW_TOL (both round float32
    sums to bf16 once; only the order of the sums differs)."""
    import torch.nn.functional as F
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

    def check(label, args, kw, mapping):
        got, delta = run(args, kw, mapping)
        ref = fb.flash_attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        rel = [slice_err(g, r) for g, r in zip(got, ref)]
        ab = [err(g, r) for g, r in zip(got, ref)]
        log(f"K5/K6 {label}: per-slice relative dq {rel[0]:.3e} dk {rel[1]:.3e} "
            f"dv {rel[2]:.3e} (tol {ROW_TOL:.3e}); max abs {ab[0]:.3e} {ab[1]:.3e} "
            f"{ab[2]:.3e}")
        if max(rel) > ROW_TOL:
            raise AssertionError(f"K5/K6 {label} disagree with the plain backward")
        return ab, delta

    # B 2, S 2048, causal: the K1 case, under both orders.
    b, s = 2, 2048
    args, kw = inputs(b, s, causal=True)
    q, k, v, o, lse, do = args
    rows = torch.arange(s)
    pairs = b * HQ * int((rows + 1).sum())
    main = {}
    for name, order in (("head_first", fa.HEAD_FIRST), ("block_first", fa.BLOCK_FIRST)):
        mapping = fa.MappingConfig(order=order)
        ab, delta = check(f"B {b} S {s} causal {name}", args, kw, mapping)
        ms_dq = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                           mapping=mapping, **kw))
        ms_dkv = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                             mapping=mapping, **kw))
        log(f"K5 {name} {ms_dq:.3f} ms, K6 {name} {ms_dkv:.3f} ms")
        if not main:
            main = dict(ab=ab, dq=ms_dq, dkv=ms_dkv, delta=delta)
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
    log(f"K5 {main['dq']:.3f} ms bound {k5_bound[0]:.4f} ({k5_bound[1]}); K6 "
        f"{main['dkv']:.3f} ms bound {k6_bound[0]:.4f} ({k6_bound[1]}); pair "
        f"{main['dq'] + main['dkv']:.3f} ms, least work {pair_bound[0]:.4f} ms; plain "
        f"{plain_ms:.3f} ms; library sdpa backward {lib_ms:.3f} ms")
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

def serve(torch, cfg, seed=0, device="cuda"):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import transformer
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    t0 = time.perf_counter()
    params = transformer.init_model(cfg, seed=seed, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    log(f"init_model {cfg.name}: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
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
        want = {"flash_attention_fwd": 2 * TRAIN_LAYERS * TRAIN_MICRO,
                "flash_attention_bwd_dq": TRAIN_LAYERS * TRAIN_MICRO,
                "flash_attention_bwd_dkv": TRAIN_LAYERS * TRAIN_MICRO}
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
    the measured step time: a breakdown by parts, not a profile. These
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
    t_k5 = timer.ms(lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
    t_k6 = timer.ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    del q, k, v, do, o, lse, delta
    x = randn(b * s, cfg.d_model, dtype=torch.float32)
    head = randn(cfg.d_model, cfg.vocab, dtype=torch.float32)
    g = randn(b * s, cfg.vocab, dtype=torch.float32)
    # The head's forward product and the two of its backward, float32.
    t_head = timer.ms(lambda: (x @ head, g @ head.T, x.T @ g))
    del x, head, g, timer
    attn = TRAIN_MICRO * TRAIN_LAYERS * (2 * t_k1 + t_k5 + t_k6)
    head_ms = TRAIN_MICRO * t_head
    log(f"train step parts at B {b} S {s} per microbatch: K1 {t_k1:.3f} ms, K5 {t_k5:.3f} "
        f"ms, K6 {t_k6:.3f} ms, float32 LM head (3 products) {t_head:.3f} ms; per step: "
        f"attention kernels {attn:.1f} ms ({attn / (step_s * 1e3):.1%} of the "
        f"{step_s * 1e3:.1f} ms step), LM head {head_ms:.1f} ms "
        f"({head_ms / (step_s * 1e3):.1%})")


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
    from repro_torch.configs import llama3_8b
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
    del timer
    log("== serve llama3-8b (paged, bf16, random weights)")
    counts = serve(torch, llama3_8b.CONFIG)
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
