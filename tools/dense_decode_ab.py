#!/usr/bin/env python3
"""K7/K8 (dense flash-decode) of two checkouts side by side on one card.

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/dense_decode_ab.py [OTHER_ROOT ...]

Each root (this checkout, and every OTHER_ROOT, for example the parent
commit unpacked with ``git archive``) runs in a process of its own, twice,
in the order others, this, this, others reversed, so that drift of the
card over the call falls on all alike. Each run builds that root's ``dense_decode`` library
and, timed by this checkout's ``chip_smoke.Timer`` at the shapes of
``chip_smoke.py``'s dense-decode phase (B 8, capacity 4096, ragged
lengths; hymba-1.5b global and window 1024, llama3-8b widths; hymba's
serve batch cut to its 1536-row live width), reports per case:

* the CUDA-event median of ``chip_smoke.Timer`` with the launch queue
  primed (the card's time alone) and the sum of the device times of the
  case's kernels from ``torch.profiler``, in ms;
* the row-relative error against the plain version;
* a determinism check: 100 runs of each split case (the L2 flushed before
  every third), counted where the output differs bitwise from the first
  run or misses ``chip_smoke.ROW_TOL``.

The last line of each run is one JSON object of the times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CASES = (   # label, Hq, Hkv, D, window, splits, live width, lengths
    ("llama3-8b", 32, 8, 128, None, (1, 4, 7), 4096, "ragged"),
    ("hymba global", 25, 5, 64, None, (1, 4), 4096, "ragged"),
    ("hymba window 1024", 25, 5, 64, 1024, (1, 4), 4096, "ragged"),
    ("hymba serve batch global", 25, 5, 64, None, (1, 4), 1536, "serve"),
    ("hymba serve batch window 1024", 25, 5, 64, 1024, (1, 4), 1536, "serve"),
    ("group 32, D 128", 32, 1, 128, None, (1, 4), 4096, "ragged"),
)
STRESS_RUNS = 100
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(root: str, tag: str) -> None:
    # The port from `root`; the timer and the bars from this checkout's
    # chip_smoke.py, so both roots are measured alike.
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dd

    build.build_all(["dense_decode"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)
    lengths = {
        "ragged": torch.tensor([4096, 0, 3001, 17, 2048, 4000, 1, 1500], dtype=torch.int32,
                               device="cuda"),
        "serve": torch.tensor([100, 300, 600, 900, 1100, 1300, 1450, 1500], dtype=torch.int32,
                              device="cuda") + 32,
    }
    times = {}
    for label, hq, hkv, d, window, splits, width, lens in CASES:
        lens = lengths[lens]
        q = torch.randn((8, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        kc, vc = (torch.randn((8, hkv, 4096, d), generator=gen, device="cuda")
                  .to(torch.bfloat16)[:, :, :width] for _ in range(2))
        for ns in splits:
            kw = dict(window=window, chunk=64, num_splits=ns)
            ref = dd.flash_decode_plain(q, kc, vc, lens, **kw)
            first = dd.flash_decode(q, kc, vc, lens, **kw)
            e = cs.row_err(first, ref)
            ms = timer.ms(lambda: dd.flash_decode(q, kc, vc, lens, **kw), primed=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(cs.REPS):
                    timer.flush.zero_()
                    dd.flash_decode(q, kc, vc, lens, **kw)
                torch.cuda.synchronize()
            device_ms = sum(getattr(ev, "device_time_total", 0) or 0
                            for ev in prof.key_averages()
                            if "dense_decode" in ev.key or "combine" in ev.key) / cs.REPS / 1e3
            differ = over = 0
            if ns > 1:
                for i in range(STRESS_RUNS):
                    if i % 3 == 0:
                        timer.flush.zero_()
                    o = dd.flash_decode(q, kc, vc, lens, **kw)
                    differ += not torch.equal(o, first)
                    over += cs.row_err(o, ref) > cs.ROW_TOL
            times[f"{label} splits {ns}"] = dict(ms=ms, device_ms=device_ms)
            print(f"[{tag}] {label} splits {ns}: {ms:.4f} ms (queue primed), device "
                  f"{device_ms:.4f} ms, row err {e:.3e}" + (
                      f", {differ} of {STRESS_RUNS} runs differ, {over} over the bar"
                      if ns > 1 else ""), flush=True)
    print(json.dumps({"root": root, "tag": tag, "times": times}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3])
        return 0
    others = [(os.path.abspath(p), os.path.basename(os.path.abspath(p))) for p in sys.argv[1:]]
    order = others + [(HERE, "this")] * (2 if others else 1) + others[::-1]
    rc = 0
    for root, tag in order:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, tag],
                             cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
