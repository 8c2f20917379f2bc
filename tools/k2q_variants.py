#!/usr/bin/env python3
"""K2q's register split, ring depths and the costs of its parts, on one card.

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/k2q_variants.py [--d256 [NAME ...]]

This builds variants of the committed ``csrc/paged_prefill.cu`` under
``build/k2q_variants/``, each one or more text substitutions in the
sources, one ``nvcc`` each in parallel, prints ptxas' registers and spills
for each K2q instantiation, then times each variant in turns (the variants,
then again in reverse) with ``chip_smoke.Timer`` (CUDA-event medians, the
launch queue primed, the L2 flushed), beside bf16 K2 on the same call, each
output checked bit for bit against K2 over bf16 pools of the dequantized
values (a diagnostic variant is expected to differ).

Without ``--d256``: ``paged_prefill_q_tc_kernel`` at llama3-8b widths (Hq
32, Hkv 8, D 128, pages of 16) over int8 and fp8 codes, at
``chip_smoke.py``'s kernel shape (B 2, prefix 1000, tail 256) and the paged
serve run's extend shape (7 rows, prefix 256, tail 256). Its variants:

* ``committed``: the source as it is;
* ``c<N>_p<M>``: the consumers at N registers and the producer warpgroup at
  M (224 / 56, 216 / 72, 200 / 104; 2 x N + M = 3 x 168);
* ``copy_only``: the widening replaced by a copy of the raw code words into
  the bf16 stage (wrong values, timing only).

With ``--d256``: ``paged_prefill_q_tc256_kernel`` (``QRing256``) at
gemma2-2b's widths (Hq 8, Hkv 4, window 4096, softcap 50) and gemma3-1b's
(Hq 4, Hkv 1, window 512), pages of 16, over int8 codes at the same two
shapes. Its variants (``D256_VARIANTS``; NAMEs pick some):

* ``committed``;
* ``k<K>_v<V>_c<CK>_c<CV>``: K bf16 K stages, V bf16 V stages, CK stages of
  K codes and CV of V codes (32 KB a bf16 stage, 16 KB a code stage, 160
  KB in all beside Q);
* ``c<N>_p<M>``: setmaxnreg N for the consumers and M for the wideners
  (committed 216 / 72);
* ``g8``: the wideners read all eight units of their codes of K (then of
  V) at once (committed: four at a time);
* ``refill_at_v_release``: both code stages refilled once the V codes are
  read, before the bf16 V stage's wait (committed: each after its half is
  published);
* ``copy_only``: as above, for this kernel;
* ``consumers_alone``: the widening warpgroup neither loads nor widens, it
  only arrives on the bf16 barriers (the consumers read stale stages);
* ``wideners_alone``: the consumers hand each bf16 stage back as soon as it
  is full (loads and widening alone);
* ``loads_alone``: as ``wideners_alone``, and the wideners read no codes
  and widen nothing (the code loads and the barriers alone);
* ``trace``: the committed kernel with clock stamps of block 0's walk,
  printed after the timings: each step's median cycles after the tile's
  first stamp over the walk's middle tiles, and each side's tile period.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
HQ, HKV, D, PS = 32, 8, 128, 16
WIDEN = "        Code::widen16(c, sc[kv * MAX_SLOTS + (row >> ps_shift)], o);\n"
COPY = ("        o[0] = c.x; o[1] = c.y; o[2] = c.z; o[3] = c.w;\n"
        "        o[4] = c.x; o[5] = c.y; o[6] = c.z; o[7] = c.w;\n")


def regs(consumer: int, producer: int):
    """QSmem's split (head_dim 64 and 128)."""
    return [("paged_prefill.cu", f"  static constexpr int {role}_REGS = {old};",
             f"  static constexpr int {role}_REGS = {n};")
            for role, old, n in (("CONSUMER", 208, consumer), ("PRODUCER", 88, producer))]


VARIANTS = {
    "committed": [],
    "c224_p56": regs(224, 56),
    "c216_p72": regs(216, 72),
    "c200_p104": regs(200, 104),
    "copy_only": [("paged_prefill.cu", WIDEN, COPY)],
}


def depths(k: int, v: int, ck: int, cv: int):
    """QRing256's ring depths (committed 2, 1, 2, 2)."""
    return [("paged_prefill.cu", f"  static constexpr int {name} = {old};{note}",
             f"  static constexpr int {name} = {new};{note}")
            for name, old, new, note in (
                ("KSTAGES", 2, k, "                  // bf16 K stages"),
                ("VSTAGES", 1, v, "                  // bf16 V stages"),
                ("CKSTAGES", 2, ck, "                 // K code stages"),
                ("CVSTAGES", 2, cv, "                 // V code stages"))
            if old != new]


def split(consumer: int, producer: int):
    """QRing256's setmaxnreg split (committed 216 / 72)."""
    return [("paged_prefill.cu", f"  static constexpr int {role}_REGS = {old};",
             f"  static constexpr int {role}_REGS = {new};")
            for role, old, new in (("CONSUMER", 216, consumer), ("PRODUCER", 72, producer))]


_WIDEN256 = "        Code::widen16(c[i], s, o);\n"
_COPY256 = ("        o[0] = c[i].x; o[1] = c[i].y; o[2] = c[i].z; o[3] = c[i].w;\n"
            "        o[4] = c[i].x; o[5] = c[i].y; o[6] = c[i].z; o[7] = c[i].w;\n")
_CODE_WAIT = "    mbar_wait(full, (t / stages) & 1);\n"
_READ = "      read_codes(c, codes, g);\n"
_WIDEN = "      widen(bf16, c, s, live, g);\n"
_BF16_WAIT = ("      if (g == 0)\n        mbar_wait((kv ? bars.vempty : bars.kempty) + bs, "
              "((t / bf16_stages) & 1) ^ 1);\n")
_BF16_FULL = "    mbar_arrive((kv ? bars.vfull : bars.kfull) + bs);\n"
_LIVE = "    const bool live = row < blk.walk.live - blk.walk.col0(t);\n"
_LOADS = "  const bool loads = ct < 4 * per_stage && n_pref > 0;\n"
_CONSUME = """    ptc::consume<D, SOFTCAP, false, R::CONSUMER_REGS, SplitRing>(
        smem, blk.walk, blk.ntiles, blk.q0, blk.b * Hq + blk.h, &to, nullptr, St, scale,
        softcap);
"""
# The consumers hand each stage back once it is full (and wait for Q, so
# that no TMA is in flight when the block ends).
_RELEASE_ONLY = """    const SplitRing ring{smem};
    mbar_wait(ring.qbar(), 0);
    for (int t = 0; t < blk.ntiles; ++t) {
      ring.wait_k(t);
      ring.done_k(t, threadIdx.x & 31);
      ring.wait_v(t);
      ring.done_v(t, threadIdx.x & 31);
    }
"""
_GROUP8 = ("paged_prefill.cu", "  constexpr int GROUP = 4;", "  constexpr int GROUP = 8;")
_NO_WIDEN = [("paged_prefill.cu", _READ, ""), ("paged_prefill.cu", _WIDEN, "")]

# Clock stamps of block 0's walk, by four threads: consumer warpgroup 0's
# and 1's first threads (0, 128) before and after the K stage's wait, after
# S (done_k), before and after the V stage's wait, and after P V (steps
# 0-5, every tile; K2's consumers too, whose block runs the same walk);
# widening threads 0 and 96 (warps 0 and 3) at the start of tile t, after
# the K code stage's wait, after the bf16 K stage's wait, after K's
# arrival, the same three for V, and after thread 0's wait to refill its K
# code stage (steps 0-7, prefix tiles).
_TRACE_AT = "namespace rt {\nnamespace ptc {\n"
_TRACE = [
    ("prefill_tc.cuh", _TRACE_AT, _TRACE_AT + """__device__ long long g_trace[4][8][64];
#define TRACE(i, t) do { const int who_ = threadIdx.x == 0 ? 0 : threadIdx.x == 128 ? 1 \\
    : threadIdx.x == 256 ? 2 : threadIdx.x == 352 ? 3 : -1; \\
  if (who_ >= 0 && blockIdx.x == 0 && (t) < 64) ::rt::ptc::g_trace[who_][i][t] = clock64(); \\
  } while (0)
"""),
    ("prefill_tc.cuh", "    ring.wait_k(t);\n",
     "    TRACE(0, t);\n    ring.wait_k(t);\n    TRACE(1, t);\n"),
    ("prefill_tc.cuh", "    ring.done_k(t, lane);\n",
     "    ring.done_k(t, lane);\n    TRACE(2, t);\n"),
    ("prefill_tc.cuh", "    ring.wait_v(t);\n",
     "    TRACE(3, t);\n    ring.wait_v(t);\n    TRACE(4, t);\n"),
    ("prefill_tc.cuh", "    ring.done_v(t, lane);\n",
     "    ring.done_v(t, lane);\n    TRACE(5, t);\n"),
    ("paged_prefill.cu", _LIVE, "    TRACE(0, t);\n" + _LIVE),
    ("paged_prefill.cu", _CODE_WAIT, _CODE_WAIT + "    TRACE(1 + 3 * kv, t);\n"),
    ("paged_prefill.cu", _BF16_WAIT, _BF16_WAIT + "      if (g == 0) TRACE(2 + 3 * kv, t);\n"),
    ("paged_prefill.cu", _BF16_FULL, _BF16_FULL + "    TRACE(3 + 3 * kv, t);\n"),
    ("paged_prefill.cu", "      load_codes(t + depth);\n",
     "      TRACE(7, t);\n      load_codes(t + depth);\n"),
    ("paged_prefill.cu", None, """
extern "C" int read_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, rt::ptc::g_trace, sizeof(rt::ptc::g_trace));
}

extern "C" int reset_trace() {
  static const long long zero[sizeof(rt::ptc::g_trace) / sizeof(long long)] = {};
  return (int)cudaMemcpyToSymbol(rt::ptc::g_trace, zero, sizeof(zero));
}
"""),
]
CONSUMER_STEPS = ("before K wait", "K waited", "scores done", "before V wait", "V waited",
                  "P V done")
WIDEN_STEPS = ("tile start", "K codes waited", "K stage waited", "K widened, arrived",
               "V codes waited", "V stage waited", "V widened, arrived", "K refill waited")
WHO = ("consumer warpgroup 0", "consumer warpgroup 1", "widening warp 0", "widening warp 3")
D256_VARIANTS = {
    "committed": [],
    "k1_v2_c2_c2": depths(1, 2, 2, 2),
    "k1_v1_c3_c3": depths(1, 1, 3, 3),
    "k2_v2_c1_c1": depths(2, 2, 1, 1),
    "c224_p56": split(224, 56),
    "c208_p88": split(208, 88),
    "g8": [_GROUP8],
    "refill_at_v_release": [
        ("paged_prefill.cu", _BF16_FULL + "    refill(kv, t);\n", _BF16_FULL),
        ("paged_prefill.cu", "        mbar_arrive(empty);\n      }\n",
         "        mbar_arrive(empty);\n        if (kv == 1) {\n          refill(0, t);\n"
         "          refill(1, t);\n        }\n      }\n")],
    "copy_only": [("paged_prefill.cu", _WIDEN256, _COPY256)],
    "consumers_alone": [("paged_prefill.cu", _LOADS, "  const bool loads = false;\n"),
                        ("paged_prefill.cu", _CODE_WAIT, ""), *_NO_WIDEN],
    "wideners_alone": [("paged_prefill.cu", _CONSUME, _RELEASE_ONLY)],
    "loads_alone": [("paged_prefill.cu", _CONSUME, _RELEASE_ONLY), *_NO_WIDEN],
    "trace": _TRACE,
}
#: Diagnostic variants whose outputs are expected to differ.
DIAGNOSTIC = ("copy_only", "consumers_alone", "wideners_alone", "loads_alone")


def build_variants(build, variants: dict, kernel_tag: str) -> dict:
    """name -> the loaded library of each variant of ``paged_prefill.cu``,
    built in parallel; prints ptxas' registers and spills of every kernel
    whose name holds ``kernel_tag``."""
    root = HERE / "build" / "k2q_variants"
    procs = {}
    for name, subs in variants.items():
        d = root / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        for source, old, new in subs:   # old None: append
            path = d / source
            text = path.read_text()
            if old is None:
                text += new
            elif text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} matched {text.count(old)} times")
            else:
                text = text.replace(old, new)
            path.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(d / "paged_prefill.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m and kernel_tag in m.group(1):
                kernel = re.search(r"(q_tc\w*_kernel)I(?:Li(\d+)E)?Lb(\d)EN\S*?(Int8|E4m3)",
                                   m.group(1))
                info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3])
                print(f"{name}: {kernel[1]} D {kernel[2] or 256} softcap {kernel[3]} "
                      f"{kernel[4]}: {info}", flush=True)
        libs[name] = ctypes.CDLL(str(root / name / "lib.so"))
    return libs


def main() -> int:
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch.cache import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_prefill_attention as pp

    if not torch.cuda.is_available():
        print("k2q_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    d256 = "--d256" in args
    if d256:
        names = [a for a in args if a != "--d256"] or list(D256_VARIANTS)
        variants = {n: D256_VARIANTS[n] for n in ["committed"] + names if n in D256_VARIANTS}
        widths = (("gemma2-2b", 8, 4, 256, 4096, 50.0), ("gemma3-1b", 4, 1, 256, 512, None))
        formats = ("int8",)
    else:
        variants = VARIANTS
        widths = (("llama3-8b", HQ, HKV, D, None, None),)
        formats = ("int8", "fp8")
    libs = build_variants(build, variants, "q_tc256_kernel" if d256 else "q_tc_kernel")
    print(cs.smi_line(), flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def case(b, plen, st, tlens, kv_dtype, hq, hkv, d):
        mp = -(-plen // PS)
        n = 1 + b * mp
        randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        kp, vp = randn(hkv, n, PS, d), randn(hkv, n, PS, d)
        perm = torch.randperm(n - 1, generator=gen, device="cuda") + 1
        table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
        q, kt, vt = (randn(*s).to(torch.bfloat16)
                     for s in ((b, hq, st, d), (b, hkv, st, d), (b, hkv, st, d)))
        (kc, ks), (vc, vs) = (quant.quantize_pages(x, kv_dtype) for x in (kp, vp))
        plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
        tl = torch.tensor(tlens, dtype=torch.int32, device="cuda")
        kd, vd = (quant.dequantize_pages(c, s).to(torch.bfloat16) for c, s in ((kc, ks), (vc, vs)))
        return ((q, kc, vc, table, kt, vt, plens, tl), dict(k_scales=ks, v_scales=vs),
                (q, kd, vd, table, kt, vt, plens, tl))

    cases = {}
    for model, hq, hkv, d, window, cap in widths:
        for label, shape in (("smoke shape", (2, 1000, 256, [256, 219])),
                             ("serve extend shape", (7, 256, 256, [256] * 7))):
            for kv_dtype in formats:
                qargs, kw, bfargs = case(*shape, kv_dtype, hq, hkv, d)
                cases[f"{model} {label} {kv_dtype}"] = (
                    qargs, dict(kw, window=window, softcap=cap), bfargs,
                    dict(window=window, softcap=cap))
    order = list(variants)
    for name in order + order[::-1]:
        build._libs["paged_prefill"] = libs[name]
        pp._fns.clear()
        for label, (qargs, kw, bfargs, bkw) in cases.items():
            same = torch.equal(pp.paged_flash_prefill(*qargs, **kw),
                               pp.paged_flash_prefill(*bfargs, **bkw))
            ms = timer.ms(lambda: pp.paged_flash_prefill(*qargs, **kw), primed=True)
            k2_ms = timer.ms(lambda: pp.paged_flash_prefill(*bfargs, **bkw), primed=True)
            note = " (diagnostic: expected to differ)" if name in DIAGNOSTIC else ""
            print(f"{name:16s} {label:36s} K2q {ms:.4f} ms, bf16 K2 {k2_ms:.4f} ms "
                  f"({ms / k2_ms:.3f}x), bitwise equal to K2 over the dequantized values "
                  f"{same}{note}", flush=True)
    if "trace" in libs:
        show_trace(torch, build, pp, libs["trace"], next(iter(cases.values())))
    return 0


def show_trace(torch, build, pp, lib, inputs) -> None:
    """One run of bf16 K2 and one of K2q in the trace variant on ``inputs``:
    the clock stamps of block 0's walk. For each traced thread, each step's
    median over the prefix walk's middle tiles in cycles from the tile's
    first stamp; then every tile's start on each thread, in cycles from
    consumer warpgroup 0's first stamp, which shows the warpgroups' lag, the
    first tiles' and the tail's periods, beside K2's consumers on the same
    walk."""
    import numpy as np

    qargs, kw, bfargs, bkw = inputs
    build._libs["paged_prefill"] = lib
    pp._fns.clear()
    lib.read_trace.argtypes = [ctypes.c_void_p]

    def run(fn):
        torch.cuda.synchronize()
        if lib.reset_trace():
            raise RuntimeError("reset_trace failed")
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (4 * 8 * 64))()
        if lib.read_trace(ctypes.addressof(buf)):
            raise RuntimeError("read_trace failed")
        return np.array(buf, dtype=np.int64).reshape(4, 8, 64)

    k2 = run(lambda: pp.paged_flash_prefill(*bfargs, **bkw))
    tr = run(lambda: pp.paged_flash_prefill(*qargs, **kw))
    n_pref = int((tr[2, 1] > 0).sum())   # prefix tiles, by widening thread 0
    ntiles = int((tr[0, 0] > 0).sum())
    mid = slice(2, max(3, n_pref - 2))
    for w, who in enumerate(WHO):
        steps = CONSUMER_STEPS if w < 2 else WIDEN_STEPS
        for i, label in enumerate(steps):
            d = tr[w, i, mid] - tr[w, 0, mid]
            d = d[tr[w, i, mid] > 0]
            print(f"trace {who}, {label:22s}: {int(np.median(d)) if d.size else -1:6d} cycles "
                  f"after its tile's first stamp", flush=True)
    for i, label in enumerate(CONSUMER_STEPS):
        d = k2[0, i, mid] - k2[0, 0, mid]
        print(f"trace K2 consumer warpgroup 0, {label:22s}: {int(np.median(d)):6d} cycles",
              flush=True)
    t0, k0 = tr[0, 0, 0], k2[0, 0, 0]
    for t in range(ntiles):
        starts = " ".join(f"{int(tr[w, 0, t] - t0):8d}" if tr[w, 0, t] else "       -"
                          for w in range(4))
        print(f"trace tile {t:2d}{' (tail)' if t >= n_pref else '       '} starts (cycles; "
              f"{', '.join(WHO)}): {starts}; K2q's P V done at {int(tr[0, 5, t] - t0)}, K2's "
              f"{int(k2[0, 5, t] - k0)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
