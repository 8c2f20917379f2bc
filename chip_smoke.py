#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and ``nvcc``; without a card, or outside a checkout, it exits non-zero
and prints no result. Phases, in order (any failure exits non-zero):

  1. probe  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build  — compiles the four attention kernels from ``src/repro_torch/
     csrc`` with nvcc for sm_90a, one nvcc per source in parallel; prints
     the build time and ptxas' register / shared-memory lines;
  3. kernels — each kernel against its plain PyTorch version on the card,
     at llama3-8b widths in bf16 (Hq 32, Hkv 8, D 128, page size 16):
     max error at a stated tolerance, CUDA-event median times of kernel and
     plain version, and the bound (bytes over 3.35 TB/s vs operations over
     989 TFLOP/s, the H100 SXM data-sheet peaks); then the split-K
     estimator's modelled decode times beside the measured ones, and the
     fixed cost per call of the split path over the one-pass path;
  4. serve  — ``LLMEngine(kv_layout="paged")`` on full-width llama3-8b with
     random bf16 weights: (a) 8 greedy requests of 512 tokens sharing a
     256-token system prefix, (b) one 4096-token request, 32 new tokens
     each; every kernel's launch count over that run must be above 0. Then
     one request's prefill and first-decode logits, kernel path against the
     plain path on the card.

It ends with one JSON line of per-kernel numbers and, last, the line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
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

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def row_err(a, ref):
        diff = (a.float() - ref.float()).abs().amax(-1)
        den = ref.float().abs().amax(-1)
        zero_ok = torch.where(diff > 0, float("inf"), 0.0)
        return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())

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
    for key, spec in KERNELS.items():
        if counts[spec["counter"]] <= 0:
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
    check_kernels(torch, Timer(torch), results)
    log("== serve llama3-8b (paged, bf16, random weights)")
    counts = serve(torch, llama3_8b.CONFIG)

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
