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
  with ragged lengths up to 4096 and a length-0 row, at 1 and 4 splits.

``--d256`` runs the head_dim 256 cases alone.

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
         (1, 4), 4096, "ragged", None, cap)))
STRESS_RUNS = 100
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVED = os.path.join(HERE, "build", "decode_ab")


def run_one(root: str, tag: str, first: bool, d256: bool) -> None:
    # The port from `root`; the timer and the bars from this checkout's
    # chip_smoke.py, so both roots are measured alike.
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.cache import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import paged_decode_attention as pd

    build.build_all(["dense_decode", "paged_decode"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    lengths = {
        "ragged": RAGGED,
        "serve": [n + 32 for n in (100, 300, 600, 900, 1100, 1300, 1450, 1500)],
        "paged serve": [560] * 8,
        "lone": [4096],
    }
    times = {}
    os.makedirs(SAVED, exist_ok=True)
    for label, page, hq, hkv, d, window, splits, width, lens, *rest in (
            GEMMA_CASES if d256 else CASES + GEMMA_CASES):
        kv = [rest[0]] if rest and rest[0] else []
        softcap = rest[1] if len(rest) > 1 else None
        lens = torch.tensor(lengths[lens], dtype=torch.int32, device="cuda")
        b = len(lens)
        q = randn(b, hq, d)
        if not page:
            kc, vc = (randn(8, hkv, 4096, d)[:, :, :width] for _ in range(2))
            plain, fn, names = dd.flash_decode_plain, dd.flash_decode, ("dense_decode",)
            args, extra = (q, kc, vc, lens), dict(window=window, chunk=64, softcap=softcap)
        else:
            num_pages = 1 + b * (width // page)
            kp, vp = randn(hkv, num_pages, page, d), randn(hkv, num_pages, page, d)
            perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
            table = perm.reshape(b, width // page).to(torch.int32).contiguous()
            plain, fn, names = pd.paged_flash_decode_plain, pd.paged_flash_decode, (
                "paged_decode",)
            extra = dict(window=window, softcap=softcap)
            if kv:
                (kp, k_sc), (vp, v_sc) = (quant.quantize_pages(x.float(), kv[0])
                                          for x in (kp, vp))
                extra.update(k_scales=k_sc, v_scales=v_sc)
            args = (q, kp, vp, table, lens)
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


def main() -> int:
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
