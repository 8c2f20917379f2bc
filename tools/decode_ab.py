#!/usr/bin/env python3
"""The decode kernels of two checkouts side by side on one card: K7/K8
(dense flash-decode), K3/K4 (paged flash-decode) and K3q/K4q (paged
flash-decode of bf16 q over int8 and fp8 pools).

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/decode_ab.py [--d256] [OTHER_ROOT ...]

Each root (this checkout, and every OTHER_ROOT, for example the parent
commit unpacked with ``git archive``) runs in a process of its own, twice,
in the order others, this, this, others reversed, so that drift of the
card over the call falls on all alike. Each run builds that root's
``dense_decode`` and ``paged_decode`` libraries and, timed by this
checkout's ``chip_smoke.Timer``, runs:

* K7/K8 at the shapes of ``chip_smoke.py``'s dense-decode phase (B 8,
  capacity 4096, ragged lengths; hymba-1.5b global and window 1024,
  llama3-8b widths; hymba's serve batch cut to its 1536-row live width;
  one group of 32);
* K3/K4 at the shapes of its paged-decode phase (llama3-8b widths, pages of
  16 on a scattered table: B 8 with ragged lengths up to 4096 at 1, 4 and 7
  splits; the paged serve run's decode shape, 8 rows of 560 tokens on a
  36-page table, at 1 and 2 splits), and the first of them again in pages
  of 64;
* K3q/K4q over int8 and over fp8 pools (``cache.quant`` codes of normal
  values and their per-page scales) at the paged serve run (a)'s decode
  shape, 8 rows of 560 tokens on a 36-page table at 1 and 2 splits, and at
  run (b)'s, one row of 4096 tokens on a 260-page table at 1, 2, 4 and 8
  splits: whatever ``paged_flash_decode`` runs in that checkout for bf16 q
  over a quantized pool;
* head_dim 256 at the shapes of ``chip_smoke.py``'s ``check_gemma_kernels``
  (``GEMMA_CASES``): K3/K4 (pages of 16) and K7/K8 (4096-row stripes) at
  gemma2-2b's widths (Hq 8, Hkv 4, window 4096, softcap 50) and again
  without the softcap, and at gemma3-1b's (Hq 4, Hkv 1, window 512), B 8
  with ragged lengths up to 4096 and a length-0 row, at 1 and 4 splits;
  K3q/K4q over int8 and over fp8 pools at gemma2-2b's and gemma3-1b's
  widths (each with its local window and softcap), B 8 as above at 1 and 4
  splits, the gemma serve run (a)'s decode shape, 8 rows of 560 tokens on a
  36-page table, at 1 and 2 splits, and run (b)'s, one row of 4200 tokens
  on a 268-page table, at 1, 2, 4 and 8 splits.

``--d256`` runs the head_dim 256 cases alone. ``--variants [NAME ...]``
runs no other root: it builds this checkout's ``paged_decode.cu``
with each source substitution of ``VARIANTS`` (other ring depths of K3q /
K4q at head_dim 256, and diagnostics) and times K3q / K4q at
``VARIANT_CASES`` with each in turns, each output compared bit for bit
with the committed sources'; ``trace`` prints where one block's walk
spends its cycles.

Per case it reports:

* the CUDA-event median of ``chip_smoke.Timer`` with the launch queue
  primed (the card's time alone) and without (the wrapper's host time
  included), and the sum of the device times of the case's kernels from
  ``torch.profiler``, in ms;
* the row-relative error against the plain version;
* a determinism check: 100 runs of each split case (the L2 flushed before
  every third), counted where the output differs bitwise from the first
  run or misses ``chip_smoke.ROW_TOL``;
* whether the output equals, bit for bit, the first root run's (saved
  under ``build/decode_ab/``) on the same inputs.

The last line of each run is one JSON object of the times.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

RAGGED = [4096, 0, 3001, 17, 2048, 4000, 1, 1500]
CASES = (   # label, page size (0: dense), Hq, Hkv, D, window, splits, live width, lengths
    #           [, quantized pool's kv_dtype or None[, softcap]]
    ("llama3-8b", 0, 32, 8, 128, None, (1, 4, 7), 4096, "ragged"),
    ("hymba global", 0, 25, 5, 64, None, (1, 4), 4096, "ragged"),
    ("hymba window 1024", 0, 25, 5, 64, 1024, (1, 4), 4096, "ragged"),
    ("hymba serve batch global", 0, 25, 5, 64, None, (1, 4), 1536, "serve"),
    ("hymba serve batch window 1024", 0, 25, 5, 64, 1024, (1, 4), 1536, "serve"),
    ("group 32, D 128", 0, 32, 1, 128, None, (1, 4), 4096, "ragged"),
    ("paged llama3-8b, table 4096", 16, 32, 8, 128, None, (1, 4, 7), 4096, "ragged"),
    ("paged serve decode, 8 x 560", 16, 32, 8, 128, None, (1, 2), 576, "paged serve"),
    # The first paged case again in pages of 64: a stage is one box per
    # column chunk, as the dense kernel's.
    ("paged llama3-8b, table 4096, pages of 64", 64, 32, 8, 128, None, (1, 4), 4096,
     "ragged"),
) + tuple(
    case for kv in ("int8", "fp8") for case in (
        (f"paged {kv} serve decode (a), 8 x 560", 16, 32, 8, 128, None, (1, 2), 576,
         "paged serve", kv),
        (f"paged {kv} serve decode (b), 1 x 4096, table 260", 16, 32, 8, 128, None,
         (1, 2, 4, 8), 4160, "lone", kv)))
GEMMA_CASES = tuple(
    case for model, hq, hkv, window, caps in (("gemma2-2b", 8, 4, 4096, (50.0, None)),
                                             ("gemma3-1b", 4, 1, 512, (None,)))
    for cap in caps for case in (
        (f"D 256 paged {model}{'' if cap else ' no softcap'}", 16, hq, hkv, 256, window,
         (1, 4), 4096, "ragged", None, cap),
        (f"D 256 dense {model}{'' if cap else ' no softcap'}", 0, hq, hkv, 256, window,
         (1, 4), 4096, "ragged", None, cap))) + tuple(
    case for kv in ("int8", "fp8")
    for model, hq, hkv, window, cap in (("gemma2-2b", 8, 4, 4096, 50.0),
                                        ("gemma3-1b", 4, 1, 512, None))
    for case in (
        (f"D 256 paged {kv} {model}", 16, hq, hkv, 256, window, (1, 4), 4096, "ragged", kv,
         cap),
        (f"D 256 paged {kv} {model} serve decode (a), 8 x 560", 16, hq, hkv, 256, window,
         (1, 2), 576, "paged serve", kv, cap),
        (f"D 256 paged {kv} {model} serve decode (b), 1 x 4200, table 268", 16, hq, hkv, 256,
         window, (1, 2, 4, 8), 268 * 16, "gemma lone", kv, cap)))
STRESS_RUNS = 100
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVED = os.path.join(HERE, "build", "decode_ab")
LENGTHS = {
    "ragged": RAGGED,
    "serve": [n + 32 for n in (100, 300, 600, 900, 1100, 1300, 1450, 1500)],
    "paged serve": [560] * 8,
    "lone": [4096],
    "gemma lone": [4200],
}
#: Source substitutions of ``--variants``: name -> [(file under csrc/, old,
#: new)], each old text matched exactly once (old None: new appended). Of
#: K3q / K4q at head_dim 256: one bf16 K stage and two V stages (the same
#: bits); a trace of one block's walk (``show_trace``); and two diagnostics
#: whose outputs differ: the consumers alone (neither loads nor widening),
#: and the producer and the wideners alone (the consumers release each bf16
#: stage as it fills).
_WIDEN_K = ("    if (whole)\n      kc.widen<Code, true>(wk, rel0, live, lane);\n    else\n"
            "      kc.widen<Code, false>(wk, rel0, live, lane);\n")
_WIDEN_V = _WIDEN_K.replace("kc.", "vc.").replace("wk,", "wv,")
_CODE_WAIT = "    mbar_wait(&cfull[st], (t / R::STAGES) & 1);\n    dtc::CodeChunk kc, vc;\n"
_CONSUMERS_ALONE = [
    ("paged_decode.cu", _WIDEN_K, ""), ("paged_decode.cu", _WIDEN_V, ""),
    ("paged_decode.cu",
     "    if (warp != 2 * CONSUMER_WARPS || ntiles == 0 || i >= per_stage) return;\n",
     "    return;\n"),
    ("paged_decode.cu", _CODE_WAIT, "    dtc::CodeChunk kc, vc;\n")]
_PRODUCER_ALONE = [("paged_decode.cu", """    dtc::consume_d256<MT, SPLIT>(tiles, q, out, acc_out, m_out, l_out, Hkv, G, first_page * ps,
                                 lo, hi, ntiles, scale, softcap);
""", """    for (int t = 0; t < ntiles; ++t) {
      mbar_wait(&tiles.full()[t % R::KSTAGES], (t / R::KSTAGES) & 1);
      tiles.v_chunk(t, 0, 0, 0u, lane);
      tiles.done(t, lane);
    }
""")]


def _depth(ring: str, old: int, new: int):
    return ("decode_tc.cuh", f"  static constexpr int {ring} = {old};",
            f"  static constexpr int {ring} = {new};")


# Clock stamps of block (0, 0, 0)'s walk (``--variants trace``): widening
# thread 0 at the start of each tile t, after the code stage's wait, after
# its loads, fence and release, after the K stage's wait, after K's
# widening, after the V stage's wait and after V's widening (rows 0-6);
# consumer thread 0 before and after the K stage's wait, before and after
# the V stage's wait (v_chunk), and at the V stage's release (rows 7-11).
# read_trace copies them out.
_TRACE_AT = "namespace rt {\nnamespace dtc {\n"
_TRACE = [
    ("decode_tc.cuh", _TRACE_AT, _TRACE_AT + """__device__ long long g_trace[12][64];
#define TRACE(i, t) \\
  do { if ((blockIdx.x | blockIdx.y | blockIdx.z) == 0 && (t) < 64) \\
    ::rt::dtc::g_trace[i][t] = clock64(); } while (0)
"""),
    ("decode_tc.cuh", """    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    const uint32_t kbase = tiles.k_chunk(t, w, rel0, live, lane);   // column chunk w
""", """    if (Chunks::SCALED && threadIdx.x == 0) TRACE(7, t);
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    if (Chunks::SCALED && threadIdx.x == 0) TRACE(8, t);
    const uint32_t kbase = tiles.k_chunk(t, w, rel0, live, lane);   // column chunk w
"""),
    ("decode_tc.cuh", "    const uint32_t vbase = tiles.v_chunk(t, w, rel0, live, lane);   // column chunk w\n",
     """    if (Chunks::SCALED && threadIdx.x == 0) TRACE(9, t);
    const uint32_t vbase = tiles.v_chunk(t, w, rel0, live, lane);   // column chunk w
    if (Chunks::SCALED && threadIdx.x == 0) TRACE(10, t);
"""),
    ("decode_tc.cuh", "    tiles.done(t, lane);\n  }\n\n  // Each warp's key slices' row sums",
     "    if (Chunks::SCALED && threadIdx.x == 0) TRACE(11, t);\n"
     "    tiles.done(t, lane);\n  }\n\n  // Each warp's key slices' row sums"),
    ("paged_decode.cu", _CODE_WAIT,
     "    if (ct == 0) TRACE(0, t);\n" + _CODE_WAIT.replace(
         "\n    dtc::", "\n    if (ct == 0) TRACE(1, t);\n    dtc::")),
    ("paged_decode.cu", "    mbar_wait(&wb.kempty[ks], ((t / R::KSTAGES) & 1) ^ 1);\n",
     "    if (ct == 0) TRACE(2, t);\n    mbar_wait(&wb.kempty[ks], ((t / R::KSTAGES) & 1) ^ 1);\n"
     "    if (ct == 0) TRACE(3, t);\n"),
    ("paged_decode.cu", "    mbar_arrive(&wb.kfull[ks]);\n",
     "    if (ct == 0) TRACE(4, t);\n    mbar_arrive(&wb.kfull[ks]);\n"),
    ("paged_decode.cu", "    mbar_wait(&wb.vempty[vs], ((t / R::VSTAGES) & 1) ^ 1);\n",
     "    mbar_wait(&wb.vempty[vs], ((t / R::VSTAGES) & 1) ^ 1);\n    if (ct == 0) TRACE(5, t);\n"),
    ("paged_decode.cu", "    mbar_arrive(&wb.vfull[vs]);\n",
     "    if (ct == 0) TRACE(6, t);\n    mbar_arrive(&wb.vfull[vs]);\n"),
    ("paged_decode.cu", None, """
extern "C" int read_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, rt::dtc::g_trace, sizeof(rt::dtc::g_trace));
}
"""),
]
TRACE_ROWS = ("widen: tile start", "code stage waited", "codes read, released", "K stage waited",
              "K widened", "V stage waited", "V widened", "consumer: before K wait",
              "K waited", "scores done", "V waited", "P V done")
VARIANTS = {
    "trace": _TRACE,
    "k1_v2": [_depth("KSTAGES", 2, 1), _depth("VSTAGES", 1, 2)],
    "consumers_alone": _CONSUMERS_ALONE,
    "producer_alone": _PRODUCER_ALONE,
}
#: The cases ``--variants`` times (labels of GEMMA_CASES), bf16 K3 / K4 D 256
#: beside them for scale.
VARIANT_CASES = ("D 256 paged int8 gemma2-2b", "D 256 paged int8 gemma3-1b",
                 "D 256 paged gemma2-2b")


def case_inputs(torch, gen, case):
    """(plain, fn, kernel names, args, keyword arguments) of one case of
    CASES / GEMMA_CASES, made on the card from ``gen``."""
    from repro_torch.cache import quant
    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import paged_decode_attention as pd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    label, page, hq, hkv, d, window, splits, width, lens, *rest = case
    kv = [rest[0]] if rest and rest[0] else []
    softcap = rest[1] if len(rest) > 1 else None
    lens = torch.tensor(LENGTHS[lens], dtype=torch.int32, device="cuda")
    b = len(lens)
    q = randn(b, hq, d)
    if not page:
        kc, vc = (randn(8, hkv, 4096, d)[:, :, :width] for _ in range(2))
        return (dd.flash_decode_plain, dd.flash_decode, ("dense_decode",), (q, kc, vc, lens),
                dict(window=window, chunk=64, softcap=softcap))
    num_pages = 1 + b * (width // page)
    kp, vp = randn(hkv, num_pages, page, d), randn(hkv, num_pages, page, d)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, width // page).to(torch.int32).contiguous()
    extra = dict(window=window, softcap=softcap)
    if kv:
        (kp, k_sc), (vp, v_sc) = (quant.quantize_pages(x.float(), kv[0]) for x in (kp, vp))
        extra.update(k_scales=k_sc, v_scales=v_sc)
    return (pd.paged_flash_decode_plain, pd.paged_flash_decode, ("paged_decode",),
            (q, kp, vp, table, lens), extra)


def run_one(root: str, tag: str, first: bool, d256: bool) -> None:
    # The port from `root`; the timer and the bars from this checkout's
    # chip_smoke.py, so both roots are measured alike.
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build_all(["dense_decode", "paged_decode"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)

    times = {}
    os.makedirs(SAVED, exist_ok=True)
    for case in GEMMA_CASES if d256 else CASES + GEMMA_CASES:
        label, splits = case[0], case[6]
        plain, fn, names, args, extra = case_inputs(torch, gen, case)
        for ns in splits:
            kw = dict(extra, num_splits=ns)
            ref = plain(*args, **kw)
            first_out = fn(*args, **kw)
            e = cs.row_err(first_out, ref)
            path = os.path.join(SAVED, f"{label} splits {ns}.pt".replace(" ", "_"))
            if first:
                torch.save(first_out.cpu(), path)
            same = torch.equal(first_out.cpu(), torch.load(path))
            ms = timer.ms(lambda: fn(*args, **kw), primed=True)
            event_ms = timer.ms(lambda: fn(*args, **kw))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(cs.REPS):
                    timer.flush.zero_()
                    fn(*args, **kw)
                torch.cuda.synchronize()
            device_ms = sum(getattr(ev, "device_time_total", 0) or 0
                            for ev in prof.key_averages()
                            if any(n in ev.key for n in names + ("combine",))
                            ) / cs.REPS / 1e3
            differ = over = 0
            if ns > 1:
                for i in range(STRESS_RUNS):
                    if i % 3 == 0:
                        timer.flush.zero_()
                    o = fn(*args, **kw)
                    differ += not torch.equal(o, first_out)
                    over += cs.row_err(o, ref) > cs.ROW_TOL
            times[f"{label} splits {ns}"] = dict(ms=ms, event_ms=event_ms, device_ms=device_ms,
                                                 row_err=e, bitwise_equal_first_root=same)
            print(f"[{tag}] {label} splits {ns}: {ms:.4f} ms (queue primed), {event_ms:.4f} ms "
                  f"(not primed), device {device_ms:.4f} ms, row err {e:.3e}, bitwise equal "
                  f"to the first root's: {same}" + (
                      f", {differ} of {STRESS_RUNS} runs differ, {over} over the bar"
                      if ns > 1 else ""), flush=True)
    print(json.dumps({"root": root, "tag": tag, "card": cs.smi_line(), "times": times}),
          flush=True)


def build_variants(build, names) -> dict:
    """name -> the loaded library of each variant of ``paged_decode.cu``
    (VARIANTS), built in parallel under build/decode_variants/, with
    ptxas' registers of its head_dim 256 code kernels printed."""
    import ctypes

    out_root = os.path.join(HERE, "build", "decode_variants")
    procs = {}
    for name in names:
        subs = VARIANTS[name]
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for source, old, new in subs:   # old None: append
            path = os.path.join(d, source)
            with open(path) as f:
                text = f.read()
            if old is None:
                text += new
            elif text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} matched {text.count(old)} times")
            with open(path, "w") as f:
                f.write(text if old is None else text.replace(old, new))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", d, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "paged_decode.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1) if "q_tc256_kernel" in m.group(1) else None
            elif kernel and "Used" in line:
                regs = line.split("Used")[1].split()[0]
                print(f"{name}: {kernel[kernel.index('q_tc256'):][:40]} {regs} registers",
                      flush=True)
        libs[name] = ctypes.CDLL(os.path.join(d, "lib.so"))
    return libs


def variants(names) -> int:
    """Times the committed K3q / K4q at head_dim 256 and each of ``names`` in
    turns (committed, the variants, the variants reversed, committed) at
    VARIANT_CASES, queue primed, each output compared bit for bit with the
    committed sources'."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_decode_attention as pd

    build.build_all(["paged_decode"])
    libs = dict(build_variants(build, names), committed=build.library("paged_decode"))
    print(cs.smi_line(), flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [(case[0], case[6], case_inputs(torch, gen, case)) for case in GEMMA_CASES
             if case[0] in VARIANT_CASES]
    times, outs = {}, {}
    for name in ["committed"] + names + names[::-1] + ["committed"]:
        build._libs["paged_decode"] = libs[name]
        pd._fns.clear()
        for label, splits, (_, fn, _, args, extra) in cases:
            for ns in splits:
                key = f"{label} splits {ns}"
                o = fn(*args, **extra, num_splits=ns)
                same = torch.equal(o, outs.setdefault(key, o))   # the committed run's first
                ms = timer.ms(lambda: fn(*args, **extra, num_splits=ns), primed=True)
                times.setdefault(name, {}).setdefault(key, []).append(ms)
                print(f"{name:16s} {key}: {ms:.4f} ms, bits of the committed sources: {same}",
                      flush=True)
    if "trace" in libs:
        show_trace(torch, build, pd, libs["trace"], cases[1][2])
    print(json.dumps({"card": cs.smi_line(), "times": times}), flush=True)
    return 0


def show_trace(torch, build, pd, lib, inputs) -> None:
    """One run of the trace variant on ``inputs`` (one pass): the clock
    stamps of block (0, 0, 0)'s walk, each phase's median over the walk's
    middle tiles in cycles from the tile's first stamp, and each side's
    median tile period."""
    import ctypes

    import numpy as np

    _, fn, _, args, extra = inputs
    build._libs["paged_decode"] = lib
    pd._fns.clear()
    fn(*args, **extra, num_splits=1)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (12 * 64))()
    lib.read_trace.argtypes = [ctypes.c_void_p]
    if lib.read_trace(ctypes.addressof(buf)):
        raise RuntimeError("read_trace failed")
    tr = np.array(buf, dtype=np.int64).reshape(12, 64)[:, 8:56]
    for i, label in enumerate(TRACE_ROWS):
        base = tr[0] if i < 7 else tr[7]
        print(f"trace {label:26s}: {int(np.median(tr[i] - base)):6d} cycles after the tile's "
              f"first stamp", flush=True)
    for i, side in ((0, "widening"), (7, "consumer")):
        print(f"trace {side} period: {int(np.median(np.diff(tr[i])))} cycles", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--variants"]:
        names = sys.argv[2:] or list(VARIANTS)
        return variants(names)
    if len(sys.argv) == 6 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3], sys.argv[4] == "first", sys.argv[5] == "d256")
        return 0
    args = sys.argv[1:]
    d256 = "--d256" in args
    others = [(os.path.abspath(p), os.path.basename(os.path.abspath(p)))
              for p in args if p != "--d256"]
    order = others + [(HERE, "this")] * (2 if others else 1) + others[::-1]
    rc = 0
    for i, (root, tag) in enumerate(order):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, tag,
                              "first" if i == 0 else "later", "d256" if d256 else "-"],
                             cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
