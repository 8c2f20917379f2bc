#!/usr/bin/env python3
"""The FA2 backward kernels (K5 dQ, K6 dK/dV) of checkouts side by side on
one card: bf16, float32, and the softcap forms of the head_dim 256 kernels.

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/bwd_ab.py [--d256 | --f32] [OTHER_ROOT ...]
    python3 tools/bwd_ab.py --sass OTHER_ROOT [SOURCE ...]
    python3 tools/bwd_ab.py --variants

With roots, each (this checkout, and every OTHER_ROOT, for example the
parent commit unpacked with ``git archive``) runs in a process of its own,
in the order others, this, this, others reversed, so that drift of the card
over the call falls on all alike. Each run builds that root's
``flash_attention`` and ``flash_attention_bwd`` libraries and, timed by
this checkout's ``chip_smoke.Timer`` (CUDA-event medians of 20 runs, the L2
flushed; each time read twice: with the queue primed, the card's time alone,
and without, the wrapper's host time included), runs K5 and K6
(``flash_attention_bwd_dq`` / ``_dkv``) at:

* head_dim 128, ``chip_smoke.py``'s K5 / K6 case: B 2, S 2048, Hq 32, Hkv
  8, causal; and the same with window 512 and softcap 50;
* the first of those in float32, with SDPA's float32 backward on the same
  inputs (K and V expanded to Hq) timed beside it in every run;
* head_dim 256, ``chip_smoke.py``'s ``check_gemma_backward`` shapes, in a
  root whose K5 / K6 take it: gemma2-2b's train microbatch (B 1, S 8192, Hq
  8, Hkv 4, softcap 50, global and window 4096) and gemma3-1b's (B 2, S
  4096, Hq 4, Hkv 1, global and window 512). In a root whose K6 takes
  ``parts`` (its walk split over blocks, summed in a fixed order), K6 is
  also timed with the walk forced into 1, 2, 4, 8 and 16 parts.

``--d256`` runs the head_dim 256 cases alone, ``--f32`` the float32 case
alone. Every bf16 case's dQ, dK and dV are compared bit for bit with those
of the first root that ran it (saved under ``build/bwd_ab/``), and K6
forced into one part with the first root's default; the head_dim 256 ones
are also held per (b, head) slice against the root's plain backward. The
float32 case is held per slice against the root's plain backward in
float32 within ``GRAD_F32_TOL`` (its bits differ from root to root where
the kernels do: the CUDA-core kernels before the 3xTF32 ones).

``--sass OTHER_ROOT [SOURCE ...]`` compiles ``flash_attention_bwd.cu`` (or
each SOURCE of ``csrc/``, for example ``paged_decode.cu``) of this checkout
and of OTHER_ROOT for sm_90a and compares the SASS (``cuobjdump -sass``) of
every kernel the two have in common, names taken without the anonymous
namespace's per-file hash: identical machine code runs in the same time.

``--variants`` instead builds this checkout's ``flash_attention_bwd.cu``
once as committed and once per entry of ``VARIANTS`` under
``build/bwd_variants/``, each a substitution in the source:
``ascending`` issues causal K5's blocks at head dim 256 in ascending tile
order (shortest walks first); then times all at the head_dim 256 cases, in
turns; ``--variants --f32`` does the same with ``F32_VARIANTS`` (the float32
kernels' warp tiling and unroll depth) at the float32 case, held within
``GRAD_F32_TOL``, in turns
(committed, each variant, the variants reversed, committed), each held
against the plain backward. The last line of each run is one JSON object
of the times.
"""

from __future__ import annotations

import ctypes
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVED = os.path.join(HERE, "build", "bwd_ab")
#: (label, B, Hq, Hkv, D, S, window, softcap), all causal, head-first.
D128_CASES = (("K5/K6 D 128 (B 2, S 2048, Hq 32, Hkv 8)", 2, 32, 8, 128, 2048, None, None),
              ("K5/K6 D 128 (B 2, S 2048, window 512, softcap 50)", 2, 32, 8, 128, 2048, 512,
               50.0))
#: The float32 case: chip_smoke.py's float32 K5 / K6 timing shape.
F32_CASES = (("K5/K6 float32 D 128 (B 2, S 2048, Hq 32, Hkv 8)", 2, 32, 8, 128, 2048, None,
              None),)
D256_CASES = (("K5/K6 D 256 gemma2-2b (B 1, S 8192, global, softcap 50)", 1, 8, 4, 256, 8192,
               None, 50.0),
              ("K5/K6 D 256 gemma2-2b (B 1, S 8192, window 4096, softcap 50)", 1, 8, 4, 256,
               8192, 4096, 50.0),
              ("K5/K6 D 256 gemma3-1b (B 2, S 4096, global)", 2, 4, 1, 256, 4096, None, None),
              ("K5/K6 D 256 gemma3-1b (B 2, S 4096, window 512)", 2, 4, 1, 256, 4096, 512,
               None))
#: K6's part counts forced in a root that takes them.
FORCED_PARTS = (1, 2, 4, 8, 16)
#: --variants: name -> substitutions (old, new) in flash_attention_bwd.cu,
#: each old string replaced wherever it stands.
VARIANTS = {
    "ascending": [("  if (causal) mb = nm - 1 - mb;   // the longest walks",
                   "  // the longest walks")],
}
#: --variants --f32: the same for the float32 kernels.
F32_VARIANTS = {
    # Causal blocks on one own tile each (not paired with its mirror).
    "unpaired": [("constexpr bool PAIRED = true;", "constexpr bool PAIRED = false;")],
    # The splits by cvt.rna (split_tf32) in place of the two integer
    # operations of split_rna.
    "cvt_split": [("  split_rna(", "  split_tf32(")],
}


def cases_inputs(torch, gen, cases, dtype=None):
    """label -> (q, k, v, do, o, lse, delta, kw) of each case, in ``dtype``
    (bf16 by default)."""
    from repro_torch.kernels import flash_attention as fa

    dtype = dtype or torch.bfloat16
    out = {}
    for label, b, hq, hkv, d, s, window, cap in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
        do = randn(b, hq, s, d)
        kw = dict(causal=True, window=window, softcap=cap)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        out[label] = (q, k, v, do, o, lse, delta, kw)
    return out


def time_case(torch, cs, timer, args, parts=None, keys=("k5", "k6")):
    """(times, (dq, dk, dv)) of one case; ``parts`` forces K6's. ``times``
    holds, for each kernel of ``keys``, k5_ms / k6_ms (queue primed) and
    k5_host_ms / k6_host_ms (not primed: the wrapper's host time included)."""
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, do, o, lse, delta, kw = args
    kw6 = kw if parts is None else dict(kw, parts=parts)
    run = {"k5": lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
           "k6": lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw6)}
    grads = (run["k5"](), *run["k6"]())
    times = {}
    for key in keys:
        fn = run[key]
        times[f"{key}_ms"] = timer.ms(fn, primed=True)
        times[f"{key}_host_ms"] = timer.ms(fn)
    return times, grads


def show(t) -> str:
    return (f"K5 {t['k5_ms']:.4f} ms, K6 {t['k6_ms']:.4f} ms, pair "
            f"{t['k5_ms'] + t['k6_ms']:.4f} ms (queue primed; with the wrappers' host time "
            f"K5 {t['k5_host_ms']:.4f}, K6 {t['k6_host_ms']:.4f})")


def slice_err_to_plain(cs, args, grads) -> float:
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, do, o, lse, delta, kw = args
    ref = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    return max(cs.slice_err(g, r) for g, r in zip(grads, ref))


def takes_parts() -> bool:
    from repro_torch.kernels import flash_attention_bwd as fb

    return "parts" in inspect.signature(fb.flash_attention_bwd_dkv).parameters


def sdpa_bwd_ms(torch, timer, args) -> float:
    """SDPA's backward (K and V expanded to Hq) on one case's inputs."""
    import torch.nn.functional as F

    q, k, v, do, o, lse, delta, kw = args
    group = q.shape[1] // k.shape[1]
    leaves = [t.detach().requires_grad_(True)
              for t in (q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    return timer.ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                    primed=True)


def run_f32(torch, cs, timer, gen, tag) -> dict:
    """The float32 case: times, SDPA's float32 backward, and each gradient
    per slice against the root's plain backward in float32."""
    times = {}
    for label, args in cases_inputs(torch, gen, F32_CASES, torch.float32).items():
        row, grads = time_case(torch, cs, timer, args)
        row["slice_err"] = slice_err_to_plain(cs, args, grads)
        row["sdpa_f32_ms"] = sdpa_bwd_ms(torch, timer, args)
        print(f"[{tag}] {label}: {show(row)}; SDPA float32 backward {row['sdpa_f32_ms']:.4f} "
              f"ms; per-slice error to plain {row['slice_err']:.3e} (tol "
              f"{cs.GRAD_F32_TOL:.0e})", flush=True)
        if row["slice_err"] > cs.GRAD_F32_TOL:
            raise AssertionError(f"[{tag}] {label}: disagrees with the plain backward")
        times[label] = row
        del grads, args
    return times


def run_one(root: str, tag: str, first: bool, mode: str) -> None:
    # The port from `root`; the timer and the bars from this checkout's
    # chip_smoke.py, so every root is measured alike.
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build_all(["flash_attention", "flash_attention_bwd"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    timer = cs.Timer(torch)
    os.makedirs(SAVED, exist_ok=True)
    times = {}
    if mode in ("all", "f32"):
        times.update(run_f32(torch, cs, timer, gen, tag))
    for i, cases in enumerate((D128_CASES, D256_CASES)):
        if mode == "f32" or (mode == "d256" and i == 0):
            continue
        for j, (label, args) in enumerate(cases_inputs(torch, gen, cases).items()):
            try:
                row, grads = time_case(torch, cs, timer, args)
            except ValueError as e:   # a root whose K5 / K6 refuse head_dim 256
                print(f"[{tag}] {label}: refused ({e})", flush=True)
                continue
            path = os.path.join(SAVED, f"case_{i}_{j}.pt")
            if first or not os.path.exists(path):   # the first root that runs the case
                torch.save([g.cpu() for g in grads], path)
            saved = torch.load(path)
            same = [torch.equal(g.cpu(), x) for g, x in zip(grads, saved)]
            row["bitwise_equal_first_root"] = dict(zip("q k v".split(), same))
            d256 = args[0].shape[-1] == 256
            if d256:
                row["slice_err"] = slice_err_to_plain(cs, args, grads)
            print(f"[{tag}] {label}: {show(row)}; bitwise equal to the first root's dq/dk/dv "
                  f"{same}"
                  + (f"; per-slice error to plain {row['slice_err']:.3e}" if d256 else ""),
                  flush=True)
            del grads
            if d256 and takes_parts():
                from repro_torch.kernels import flash_attention_bwd as fb

                q, k = args[0], args[1]
                auto = fb.dkv_parts(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                                    causal=True, window=args[-1]["window"],
                                    sms=torch.cuda.get_device_properties(0).multi_processor_count)
                row["k6_parts"] = auto
                print(f"[{tag}] {label}: K6's own pick {auto} part(s)", flush=True)
                for parts in FORCED_PARTS:
                    tp, grads = time_case(torch, cs, timer, args, parts=parts, keys=("k6",))
                    e = slice_err_to_plain(cs, args, grads)
                    one = parts == 1 and all(torch.equal(g.cpu(), x)
                                             for g, x in zip(grads[1:], saved[1:]))
                    row[f"k6_ms_parts_{parts}"] = tp["k6_ms"]
                    row[f"k6_host_ms_parts_{parts}"] = tp["k6_host_ms"]
                    print(f"[{tag}] {label}: K6 in {parts} parts {tp['k6_ms']:.4f} ms (queue "
                          f"primed; {tp['k6_host_ms']:.4f} ms with the wrapper's host time); "
                          f"per-slice error to plain {e:.3e}"
                          + (f"; dk/dv bitwise equal to the first root's {one}" if parts == 1
                             else ""), flush=True)
                    if e > cs.ROW_TOL:
                        raise AssertionError(f"{label}: K6 in {parts} parts disagrees")
                    del grads
            times[label] = row
            del args, saved
    print(json.dumps({"root": root, "tag": tag, "card": cs.smi_line(), "times": times}),
          flush=True)


def build_variants(build, variants_of) -> dict:
    """name -> the loaded library of that variant of flash_attention_bwd.cu,
    with ptxas' registers and spills of its head_dim 256 and float32
    kernels printed."""
    out_root = os.path.join(HERE, "build", "bwd_variants")
    procs = {}
    for name, subs in [("committed", [])] + list(variants_of.items()):
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = os.path.join(d, "flash_attention_bwd.cu")
        with open(src) as f:
            text = f.read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", d, "-o", os.path.join(d, "lib.so"),
               src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            kernel = m and re.search(r"(fa2_\w+_(?:tc256|tf32)_kernel)I(?:Li(\d+)E)?Lb(\d)",
                                     m.group(1))
            if kernel:
                info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3])
                dim = f"D {kernel[2]}, " if kernel[2] else ""
                print(f"{name}: {kernel[1]}<{dim}softcap {kernel[3]}>: {info}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(d, "lib.so"))
    return libs


def variants(f32: bool) -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as fb

    build.build_all(["flash_attention"])
    variants_of = F32_VARIANTS if f32 else VARIANTS
    libs = build_variants(build, variants_of)
    print(cs.smi_line(), flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    if f32:
        inputs = cases_inputs(torch, gen, F32_CASES, torch.float32)
    else:
        inputs = cases_inputs(torch, gen, D256_CASES)
    tol = cs.GRAD_F32_TOL if f32 else cs.ROW_TOL
    times = {}
    rc = 0
    names = list(variants_of)
    for name in ["committed"] + names + names[::-1] + ["committed"]:
        build._libs["flash_attention_bwd"] = libs[name]
        fb._fns.clear()
        for label, args in inputs.items():
            tv, grads = time_case(torch, cs, timer, args)
            e = slice_err_to_plain(cs, args, grads)
            times.setdefault(name, {}).setdefault(label, []).append(tv)
            print(f"{name:9s} {label}: {show(tv)}; per-slice error to plain {e:.3e}",
                  flush=True)
            if e > tol:
                print(f"{name} {label}: DISAGREES with the plain backward (tol {tol:.0e})",
                      flush=True)
                rc = 1
    print(json.dumps({"card": cs.smi_line(), "times": times}), flush=True)
    return rc


def sass(other: str, source: str = "flash_attention_bwd.cu") -> int:
    """Kernel by kernel, whether two roots' ``source`` compiles to the same
    SASS."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = os.path.join(HERE, "build", "bwd_sass")
    os.makedirs(out, exist_ok=True)
    funcs = []
    for i, root in enumerate((other, HERE)):
        csrc = os.path.join(root, "src", "repro_torch", "csrc")
        cubin = os.path.join(out, f"root{i}.cubin")
        subprocess.run([build.nvcc_path(), *flags, "-cubin", "-I", csrc, "-o", cubin,
                        os.path.join(csrc, source)], check=True, capture_output=True)
        dump = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
                               "-sass", cubin], check=True, capture_output=True,
                              text=True).stdout
        parts = re.split(r"\n\s*Function : (\S+)\n", dump)[1:]
        # cuobjdump pads each line to the width of the file's longest name;
        # the anonymous namespace's name holds a hash of the file and, in
        # some files, a second one after "_cu_".
        strip = lambda text: re.sub(r"[ \t]+", " ", re.sub(
            r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_(?:[0-9a-f]{8})?", "", text))
        funcs.append({strip(name): strip(body) for name, body in zip(parts[::2], parts[1::2])})
    rc = 0
    for name in sorted(set(funcs[0]) | set(funcs[1])):
        if name not in funcs[0] or name not in funcs[1]:
            print(f"{name}: only in {'this' if name in funcs[1] else other}", flush=True)
            continue
        same = funcs[0][name] == funcs[1][name]
        rc |= not same
        print(f"{name}: SASS {'identical' if same else 'DIFFERS'} "
              f"({funcs[1][name].count(chr(10))} lines)", flush=True)
        if not same:   # the first differing lines, OTHER_ROOT's then this checkout's
            lines = [f[name].splitlines() for f in funcs]
            pairs = [(a, b) for a, b in zip(*lines) if a != b]
            for a, b in pairs[:2]:
                print(f"    {a.strip()}\n    {b.strip()}", flush=True)
            if not pairs:   # one is the other with lines added at its end
                n = min(map(len, lines))
                for i, extra in enumerate(lines):
                    for line in extra[n:n + 4]:
                        print(f"    {'other' if i == 0 else 'this'} only: {line.strip()}",
                              flush=True)
    return rc


def main() -> int:
    if len(sys.argv) == 6 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3], sys.argv[4] == "first", sys.argv[5])
        return 0
    args = sys.argv[1:]
    mode = "d256" if "--d256" in args else "f32" if "--f32" in args else "all"
    args = [a for a in args if a not in ("--d256", "--f32")]
    if args == ["--variants"]:
        return variants(mode == "f32")
    if len(args) >= 2 and args[0] == "--sass":
        rc = 0
        for source in args[2:] or ["flash_attention_bwd.cu"]:
            print(f"-- {source}", flush=True)
            rc |= sass(os.path.abspath(args[1]), source)
        return rc
    others = [(os.path.abspath(p), os.path.basename(os.path.abspath(p))) for p in args]
    order = others + [(HERE, "this")] * (2 if others else 1) + others[::-1]
    rc = 0
    for i, (root, tag) in enumerate(order):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, tag,
                              "first" if i == 0 else "later", mode],
                             cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
