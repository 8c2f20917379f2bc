#!/usr/bin/env python3
"""The bf16-q prefill kernels of two checkouts side by side on one card: K2
(the paged prefix-extension prefill), K2q (the same over int8 and fp8
prefix codes) and K1 (the FA2 forward).

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/prefill_ab.py [--serve] [--d256] [OTHER_ROOT ...]

Each root (this checkout, and every OTHER_ROOT, for example the parent
commit unpacked with ``git archive``) runs in a process of its own, twice,
in the order others, this, this, others reversed, so that drift of the
card over the call falls on all alike. Each run builds that root's
``paged_prefill`` and ``flash_attention`` libraries and, timed by this
checkout's ``chip_smoke.Timer``, runs at llama3-8b widths (Hq 32, Hkv 8,
D 128, bf16, pages of 16 on a scattered table):

* K2 at ``chip_smoke.py``'s kernel-phase shape: B 2, a prefix of 1000
  positions (not a page multiple), a tail of 256, the second row's tail
  live to 219;
* K2 at the paged serve run's extend shape: the 7 requests that hit the
  256-token system prefix, each a full tail of 256 over a 16-page table;
* K2q at both shapes, the same values quantized to int8 and to fp8 by the
  root's ``cache.quant`` (what ``paged_flash_prefill`` launches for bf16 q
  over codes in that root), and, in a root that has it, the CUDA-core walk
  (``paged_flash_prefill_q_cuda_cores``) beside it and K2q's output
  checked bit for bit against K2's over bf16 pools of the dequantized
  values;
* K1 at B 2, S 2048, causal, head-first, and at hymba-1.5b's prefill
  widths (B 1, Hq 25, Hkv 5, D 64, S 4096), global and window 1024, as
  ``chip_smoke.py`` times it; in a root whose K1 takes per-row query
  offsets, each case again with an explicit offset of 0 (the kernel's
  offset array, not its null pointer), its o and lse checked bit for bit
  against the first root's;
* head_dim 256 at the shapes of ``chip_smoke.py``'s ``check_gemma_kernels``
  (``GEMMA_K1`` and ``GEMMA_K2``): K1 at B 1, S 8192, causal, global and
  the model's window, and K2 at B 2, a prefix of 1000, a tail of 256 (the
  second row's live to 219), pages of 16, with the model's window, at
  gemma2-2b's widths (Hq 8, Hkv 4, softcap 50; K1 also without it) and
  gemma3-1b's (Hq 4, Hkv 1, no softcap), K1's o and lse and K2's o
  compared bit for bit with the first root's;
* K2q at head_dim 256 (``GEMMA_K2Q``): both models, over int8 and fp8
  codes of the same values, global and the model's window at that kernel
  shape, and the model's window at the gemma serve run's extend shape (7
  rows, prefix 256, tail 256); each output compared bit for bit with the
  first root's and with K2 over bf16 pools of the dequantized values, K2
  there timed beside it, and as a yardstick (not the port's route) the two
  calls ``quant.dequantize_pages`` of the prefix pages then bf16 K2;
* in a root that has the paged extend's gather route, the extend A/B
  (:func:`extend_ab`, which ``chip_smoke.py``'s plan part (d) runs too):
  K2 against the gather route (the prefix gathered and packed into dense
  stripes, then K1 with per-row offsets), and the route's two parts alone,
  at ``EXTEND_SHAPES``.

``--d256`` runs the head_dim 256 cases and the first K1 case (D 128)
alone. With ``--serve`` each run then serves ``chip_smoke.py``'s run (a) on
full-width llama3-8b (random weights) over an int8 and then an fp8 pool,
twice each on a fresh engine, and prints the TTFT of its 8 requests (host
clock, informative only: it spreads by more than the kernels' difference)
and the K2q launches, all of them and those on the tensor cores.

Per case it reports the CUDA-event median of ``chip_smoke.Timer`` with the
launch queue primed (the card's time alone), the sum of the device times of
the case's kernel from ``torch.profiler``, the row-relative error against
the root's plain version, and how many of 100 reruns (the L2 flushed before
every third) differ bitwise from the first run. K1's o and lse and K2's o
are also compared bit for bit, case by case, with those of the first root
run (saved under ``build/prefill_ab/``). The last line of each run is one
JSON object of the times.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

HQ, HKV, D, PS = 32, 8, 128, 16
RERUNS = 100
#: K1's cases: label, B, Hq, Hkv, D, S, window (all causal, head-first).
K1_CASES = (("K1 (B 2, S 2048, causal, head-first)", 2, HQ, HKV, D, 2048, None),
            ("K1 hymba-1.5b widths (S 4096, global)", 1, 25, 5, 64, 4096, None),
            ("K1 hymba-1.5b widths (S 4096, window 1024)", 1, 25, 5, 64, 4096, 1024))
#: The extend A/B's llama3-8b shapes (rows, prefix, tail): one request and
#: eight, prefixes of 256 to 4096 positions, tails of 16 to 512. The plan's
#: fit reads the first eight and holds the last three out.
EXTEND_SHAPES = ((1, 256, 16), (1, 1024, 256), (1, 4096, 64), (1, 2048, 512),
                 (8, 256, 256), (8, 1024, 16), (8, 2048, 128), (8, 4096, 512),
                 (8, 1024, 256), (1, 512, 128), (4, 4096, 256))
EXTEND_HELD_OUT = EXTEND_SHAPES[8:]
#: head_dim 256 (chip_smoke.py's check_gemma_kernels): K1's cases (label,
#: Hq, Hkv, window, softcap) at B 1, S 8192, causal; K2's (label, Hq, Hkv,
#: window, softcap) at B 2, prefix 1000, tail 256.
GEMMA_K1 = (("K1 D 256 gemma2-2b (S 8192, global, softcap 50)", 8, 4, None, 50.0),
            ("K1 D 256 gemma2-2b (S 8192, window 4096, softcap 50)", 8, 4, 4096, 50.0),
            ("K1 D 256 gemma2-2b widths (S 8192, global, no softcap)", 8, 4, None, None),
            ("K1 D 256 gemma3-1b (S 8192, global)", 4, 1, None, None),
            ("K1 D 256 gemma3-1b (S 8192, window 512)", 4, 1, 512, None))
GEMMA_K2 = (("K2 D 256 gemma2-2b (prefix 1000, tail 256, window 4096, softcap 50)", 8, 4,
             4096, 50.0),
            ("K2 D 256 gemma3-1b (prefix 1000, tail 256, window 512)", 4, 1, 512, None))
#: K2q at head_dim 256: label, Hq, Hkv, window, softcap, B, prefix, tail
#: lengths; each over int8 and fp8 codes.
GEMMA_K2Q = tuple(
    case for model, hq, hkv, local, cap in (("gemma2-2b", 8, 4, 4096, 50.0),
                                            ("gemma3-1b", 4, 1, 512, None))
    for case in (
        (f"K2q D 256 {model} (prefix 1000, tail 256, global)", hq, hkv, None, cap, 2, 1000,
         [256, 219]),
        (f"K2q D 256 {model} (prefix 1000, tail 256, window {local})", hq, hkv, local, cap, 2,
         1000, [256, 219]),
        (f"K2q D 256 {model} serve extend (B 7, prefix 256, tail 256, window {local})", hq, hkv,
         local, cap, 7, 256, [256] * 7)))
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVED = os.path.join(HERE, "build", "prefill_ab")


def k2_inputs(torch, gen, b, plen, st, tlens, hq=HQ, hkv=HKV, d=D):
    """bf16 q, pools, a scattered table (page 0 the null page), tail K/V and
    the lengths of one K2 case."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    mp = -(-plen // PS)
    num_pages = 1 + b * mp
    kp, vp = randn(hkv, num_pages, PS, d), randn(hkv, num_pages, PS, d)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
    q, kt, vt = randn(b, hq, st, d), randn(b, hkv, st, d), randn(b, hkv, st, d)
    plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
    tl = torch.tensor(tlens, dtype=torch.int32, device="cuda")
    return (q, kp, vp, table, kt, vt, plens, tl)


def extend_ab(torch, timer, gen, shapes=EXTEND_SHAPES, log=print) -> list:
    """K2 against the gather route at llama3-8b widths (bf16, pages of 16 on
    a scattered table, every tail full): per ``(rows, prefix, tail)`` the
    CUDA-event medians of ``timer`` with the queue primed of K2
    (``paged_flash_prefill``), the whole gather route
    (``paged_prefill_gather``), its copies alone (``gather_stripes``) and K1
    alone over the packed stripes; the gather route's output against K2's
    (row-relative). Returns one dict a shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_prefill_attention as pp

    rows = []
    for b, plen, st in shapes:
        args = k2_inputs(torch, gen, b, plen, st, [st] * b)
        q, kp, vp, table, kt, vt, plens, tl = args
        o_k2 = pp.paged_flash_prefill(*args)
        o_g = pp.paged_prefill_gather(*args)
        k, v = pp.gather_stripes(kp, vp, table, kt, vt, plens)
        kv_len = plens + tl
        torch.cuda.synchronize()
        row = dict(rows=b, prefix=plen, tail=st, row_err=float(_row_err(o_g, o_k2)),
                   k2_ms=timer.ms(lambda: pp.paged_flash_prefill(*args), primed=True),
                   gather_ms=timer.ms(lambda: pp.paged_prefill_gather(*args), primed=True),
                   copy_ms=timer.ms(lambda: pp.gather_stripes(kp, vp, table, kt, vt, plens),
                                    primed=True),
                   k1_ms=timer.ms(lambda: fa.flash_attention_fwd(
                       q, k, v, causal=True, q_offset=plens, kv_len=kv_len), primed=True))
        log(f"extend B {b}, prefix {plen}, tail {st}: K2 {row['k2_ms']:.4f} ms, gather route "
            f"{row['gather_ms']:.4f} ms (copies {row['copy_ms']:.4f} + K1 {row['k1_ms']:.4f}), "
            f"gather against K2 row-relative {row['row_err']:.3e}")
        rows.append(row)
        del args, q, kp, vp, table, kt, vt, plens, tl, o_k2, o_g, k, v
    return rows


def _row_err(a, ref) -> float:
    import torch

    diff = (a.float() - ref.float()).abs().amax(-1)
    den = ref.float().abs().amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


def serve_ttft(torch, cs, tag) -> dict:
    """TTFT of run (a) over int8 and fp8 pools, two fresh engines each."""
    from repro_torch import kernels
    from repro_torch.configs import llama3_8b
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    cfg = llama3_8b.CONFIG
    params = cs.init_params(torch, cfg)
    prompts, _ = cs.serve_prompts(cfg)
    ttfts = {}
    for kv_dtype in ("int8", "fp8"):
        for rep in range(2):
            kernels.reset_launch_counts()
            engine = LLMEngine(cfg, params, kv_dtype=kv_dtype,
                               **dict(cs.SERVE_PAGED_KW, device="cuda"))
            out = engine.generate([Request(uid=i, prompt=p, sampling=SamplingParams(max_tokens=32))
                                   for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            ms = sorted(engine.ttft[o.uid] * 1e3 for o in out)
            counts = kernels.launch_counts()
            engine.close()
            ttfts[f"{kv_dtype} {rep}"] = ms
            print(f"[{tag}] serve (a) {kv_dtype}, engine {rep}: TTFT ms "
                  f"{', '.join(f'{t:.1f}' for t in ms)}; K2q launches "
                  f"{counts['paged_flash_prefill_q']}, on the tensor cores "
                  f"{counts.get('paged_flash_prefill_q_tc', 0)}", flush=True)
    del params
    return ttfts


def run_one(root: str, tag: str, first: bool, serve: bool, d256: bool = False) -> None:
    # The port from `root`; the timer and the bars from this checkout's
    # chip_smoke.py, so both roots are measured alike.
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.cache import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_prefill_attention as pp

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["paged_prefill", "flash_attention"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    timer = cs.Timer(torch)

    def device_ms(fn, name) -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(cs.REPS):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "device_time_total", 0) or 0 for ev in prof.key_averages()
                   if name in ev.key) / cs.REPS / 1e3

    def reruns_differ(fn, out) -> int:
        differ = 0
        for i in range(RERUNS):
            if i % 3 == 0:
                timer.flush.zero_()
            differ += not all(torch.equal(u, v) for u, v in zip(fn(), out))
        return differ

    times = {}

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def report(label, fn, ref, name, note=""):
        out = as_tuple(fn())
        e = cs.row_err(out[0], ref)
        ms = timer.ms(fn, primed=True)
        dev = device_ms(fn, name)
        differ = reruns_differ(lambda: as_tuple(fn()), out)
        times[label] = dict(ms=ms, device_ms=dev, row_err=e, reruns_differ=differ)
        print(f"[{tag}] {label}: {ms:.4f} ms (queue primed), device {dev:.4f} ms, row-relative "
              f"error {e:.3e} (tol {cs.ROW_TOL:.3e}), {differ} of {RERUNS} reruns differ{note}",
              flush=True)
        return out

    os.makedirs(SAVED, exist_ok=True)

    def same_as_first_root(key, outs, save=True) -> bool:
        """Whether ``outs`` equal, bit for bit, what the first root run
        saved under ``key`` (which the first run saves, unless ``save`` is
        False)."""
        path = os.path.join(SAVED, f"{key}.pt")
        outs = [t.cpu() for t in outs]
        if first and save:
            torch.save(outs, path)
        return all(torch.equal(u, v) for u, v in zip(outs, torch.load(path)))

    for i, (label, b, plen, st, tlens) in enumerate(() if d256 else (
            ("smoke shape (B 2, prefix 1000, tail 256)", 2, 1000, 256, [256, 219]),
            ("serve extend shape (B 7, prefix 256, tail 256)", 7, 256, 256, [256] * 7))):
        args = k2_inputs(torch, gen, b, plen, st, tlens)
        ref = pp.paged_flash_prefill_plain(*args)
        fn = lambda: pp.paged_flash_prefill(*args)
        same = same_as_first_root(f"k2_{i}", [fn()])
        report(f"K2 {label}", fn, ref, "paged_prefill",
               note=f"; o bitwise equal to the first root's: {same}")
        times[f"K2 {label}"]["bitwise_equal_first_root"] = same
        q, kp, vp, table, kt, vt, plens, tl = args
        for kv_dtype in ("int8", "fp8"):
            (kc, ks), (vc, vs) = (quant.quantize_pages(p.float(), kv_dtype) for p in (kp, vp))
            kw = dict(k_scales=ks, v_scales=vs)
            qargs = (q, kc, vc, table, kt, vt, plens, tl)
            ref = pp.paged_flash_prefill_plain(*qargs, **kw)
            fn = lambda: pp.paged_flash_prefill(*qargs, **kw)
            note = ""
            if hasattr(pp, "paged_flash_prefill_q_cuda_cores"):
                kd, vd = (quant.dequantize_pages(c, sc).to(torch.bfloat16)
                          for c, sc in ((kc, ks), (vc, vs)))
                deq = torch.equal(fn(), pp.paged_flash_prefill(q, kd, vd, table, kt, vt, plens,
                                                               tl))
                note = f"; bitwise equal to K2 over the dequantized values in bf16: {deq}"
                report(f"K2q {kv_dtype} {label}, CUDA-core walk",
                       lambda: pp.paged_flash_prefill_q_cuda_cores(*qargs, **kw), ref,
                       "paged_prefill")
                del kd, vd
            report(f"K2q {kv_dtype} {label}", fn, ref, "paged_prefill", note=note)
            del kc, vc, ks, vs, qargs, ref
        del args, q, kp, vp, table, kt, vt, plens, tl

    offsets = "q_offset" in inspect.signature(fa.flash_attention_fwd).parameters
    for i, (label, b, hq, hkv, d, s, window) in enumerate(K1_CASES[:1] if d256 else K1_CASES):
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=window)
        fn = lambda: fa.flash_attention_fwd(q, k, v, causal=True, window=window)
        o, lse = fn()
        torch.cuda.synchronize()
        same = same_as_first_root(f"k1_{i}", [o, lse])
        report(label, fn, o_ref, "fa2_fwd",
               note=f"; o and lse bitwise equal to the first root's: {same}")
        times[label]["bitwise_equal_first_root"] = same
        if offsets:
            zero = torch.zeros((b,), dtype=torch.int32, device="cuda")
            fn0 = lambda: fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                                 q_offset=zero)
            same0 = same_as_first_root(f"k1_{i}", list(fn0()), save=False)
            report(f"{label}, offset 0 as an array", fn0, o_ref, "fa2_fwd",
                   note=f"; o and lse bitwise equal to the first root's: {same0}")
            times[f"{label}, offset 0 as an array"]["bitwise_equal_first_root"] = same0
        del q, k, v, o, lse, o_ref
    for i, (label, hq, hkv, window, cap) in enumerate(GEMMA_K1):
        q = torch.randn((1, hq, 8192, 256), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((1, hkv, 8192, 256), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=True, window=window, softcap=cap)
        o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, **kw)
        fn = lambda: fa.flash_attention_fwd(q, k, v, **kw)
        o, lse = fn()
        torch.cuda.synchronize()
        same = same_as_first_root(f"k1_d256_{i}", [o, lse])
        report(label, fn, o_ref, "fa2_fwd",
               note=f"; o and lse bitwise equal to the first root's: {same}")
        times[label]["bitwise_equal_first_root"] = same
        del q, k, v, o, lse, o_ref
    for i, (label, hq, hkv, window, cap) in enumerate(GEMMA_K2):
        args = k2_inputs(torch, gen, 2, 1000, 256, [256, 219], hq=hq, hkv=hkv, d=256)
        kw = dict(window=window, softcap=cap)
        ref = pp.paged_flash_prefill_plain(*args, **kw)
        fn = lambda: pp.paged_flash_prefill(*args, **kw)
        same = same_as_first_root(f"k2_d256_{i}", [fn()])
        report(label, fn, ref, "paged_prefill",
               note=f"; o bitwise equal to the first root's: {same}")
        times[label]["bitwise_equal_first_root"] = same
        del args, ref
    for i, (label, hq, hkv, window, cap, b, plen, tlens) in enumerate(GEMMA_K2Q):
        q, kp, vp, table, kt, vt, plens, tl = k2_inputs(torch, gen, b, plen, max(tlens), tlens,
                                                        hq=hq, hkv=hkv, d=256)
        kw = dict(window=window, softcap=cap)
        for kv_dtype in ("int8", "fp8"):
            (kc, ks), (vc, vs) = (quant.quantize_pages(x.float(), kv_dtype) for x in (kp, vp))
            qargs = (q, kc, vc, table, kt, vt, plens, tl)
            ref = pp.paged_flash_prefill_plain(*qargs, **kw, k_scales=ks, v_scales=vs)
            fn = lambda: pp.paged_flash_prefill(*qargs, **kw, k_scales=ks, v_scales=vs)
            kd, vd = (quant.dequantize_pages(c, sc).to(torch.bfloat16)
                      for c, sc in ((kc, ks), (vc, vs)))
            k2 = lambda: pp.paged_flash_prefill(q, kd, vd, table, kt, vt, plens, tl, **kw)
            deq = torch.equal(fn(), k2())
            same = same_as_first_root(f"k2q_d256_{i}_{kv_dtype}", [fn()])
            name = f"{label} {kv_dtype}"
            report(name, fn, ref, "paged_prefill",
                   note=f"; bitwise equal to K2 over the dequantized values in bf16: {deq}, "
                        f"to the first root's: {same}")

            def two_calls():   # the yardstick: widen the whole prefix, then bf16 K2
                kd2, vd2 = (quant.dequantize_pages(c, sc).to(torch.bfloat16)
                            for c, sc in ((kc, ks), (vc, vs)))
                return pp.paged_flash_prefill(q, kd2, vd2, table, kt, vt, plens, tl, **kw)

            times[name].update(bitwise_equal_k2_dequantized=deq, bitwise_equal_first_root=same,
                               k2_ms=timer.ms(k2, primed=True),
                               dequantize_then_k2_ms=timer.ms(two_calls, primed=True))
            print(f"[{tag}] {name}: bf16 K2 on the dequantized pools "
                  f"{times[name]['k2_ms']:.4f} ms, dequantize_pages then K2 "
                  f"{times[name]['dequantize_then_k2_ms']:.4f} ms (queue primed)", flush=True)
            del kc, vc, ks, vs, kd, vd, qargs, ref
        del q, kp, vp, table, kt, vt, plens, tl
    if hasattr(pp, "paged_prefill_gather") and not d256:
        times["extend A/B"] = extend_ab(torch, timer, gen,
                                        log=lambda m: print(f"[{tag}] {m}", flush=True))
    line = {"root": root, "tag": tag, "card": cs.smi_line(), "times": times}
    if serve:
        line["serve_ttft_ms"] = serve_ttft(torch, cs, tag)
    print(json.dumps(line), flush=True)


def main() -> int:
    if len(sys.argv) == 7 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3], sys.argv[4] == "first", sys.argv[5] == "serve",
                sys.argv[6] == "d256")
        return 0
    args = sys.argv[1:]
    serve = "--serve" in args
    d256 = "--d256" in args
    others = [(os.path.abspath(p), os.path.basename(os.path.abspath(p)))
              for p in args if p not in ("--serve", "--d256")]
    order = others + [(HERE, "this")] * (2 if others else 1) + others[::-1]
    rc = 0
    for i, (root, tag) in enumerate(order):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, tag,
                              "first" if i == 0 else "later", "serve" if serve else "-",
                              "d256" if d256 else "-"], cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
