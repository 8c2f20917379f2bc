#!/usr/bin/env python3
"""K9 (the Mamba-2 SSD intra-chunk block) of two checkouts side by side on
one card, alone and inside the whole ``ssd_chunked_cuda`` scan.

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/ssd_ab.py [OTHER_ROOT ...]

Each root (this checkout, and every OTHER_ROOT, for example the parent
commit unpacked with ``git archive``) runs in a process of its own, twice,
in the order others, this, this, others reversed, so that drift of the
card over the call falls on all alike. Each run builds that root's ``ssd``
library and, timed by this checkout's ``chip_smoke.Timer``, runs the two
shapes of ``chip_smoke.py``'s K9 phase (B 1, L 4096, chunk 256, one group
of B and C; hymba-1.5b H 50, P 64, N 16 and mamba2-1.3b H 64, P 64, N 128,
x, B and C in bf16 as the SSM block passes them):

* K9 on the inputs that root's ``ssd_chunked_cuda`` gives its kernel (a
  root with ``ssd.chunk_inputs`` passes B and C per group, in place; an
  older one repeats them per head and permutes every input into (B, nc, H,
  q, ·) copies, made here outside the timed region);
* the whole ``ssd_chunked_cuda`` call.

Per case it reports the CUDA-event median of ``chip_smoke.Timer`` with the
launch queue primed (the card's time alone), the sum of the device times of
the case's kernels from ``torch.profiler`` (for the whole scan, every
kernel it launches), the error against the root's plain version (per
(b, chunk, head) slice for K9; relative to max |y| for the scan), and how
many of 100 reruns differ bitwise from the first run. The last line of each
run is one JSON object of the times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = (("hymba-1.5b", 50, 64, 16), ("mamba2-1.3b", 64, 64, 128))
LENGTH, CHUNK = 4096, 256
RERUNS = 100
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(root: str, tag: str) -> None:
    # The port from `root`; the timer and the bars from this checkout's
    # chip_smoke.py, so both roots are measured alike.
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build, ssd
    from repro_torch.models import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["ssd"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    timer = cs.Timer(torch)
    perm = (0, 1, 3, 2, 4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def device_ms(fn, names) -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(cs.REPS):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "device_time_total", 0) or 0 for ev in prof.key_averages()
                   if names is None or any(n in ev.key for n in names)) / cs.REPS / 1e3

    def reruns_differ(fn, first) -> int:
        differ = 0
        for i in range(RERUNS):
            if i % 3 == 0:
                timer.flush.zero_()
            differ += not all(torch.equal(u, v) for u, v in zip(fn(), first))
        return differ

    times = {}
    for label, h, p, n in SHAPES:
        x = randn(1, LENGTH, h, p, dtype=torch.bfloat16)
        dt = F.softplus(randn(1, LENGTH, h))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        bm, cm = (randn(1, LENGTH, 1, n, dtype=torch.bfloat16) for _ in range(2))
        if hasattr(ssd, "chunk_inputs"):
            xdt, bq, cq, acum = ssd.chunk_inputs(x, dt, a, bm, cm, CHUNK)
            args = (xdt, bq, cq, acum)
            k9 = lambda: ssd.ssd_intra_chunk_seq(*args)
            plain_args = (xdt.permute(perm), bq.permute(perm), cq.permute(perm),
                          acum.permute(0, 1, 3, 2))
            as_jax = lambda y, s: (y.permute(perm), s.transpose(-1, -2))
        else:
            nc = LENGTH // CHUNK
            dtc = dt.reshape(1, nc, CHUNK, h)
            acum = torch.cumsum(dtc * a[None, None, None, :], dim=2)
            xdt = x.reshape(1, nc, CHUNK, h, p).float() * dtc[..., None]
            bh, ch = (m.reshape(1, nc, CHUNK, 1, n).float().repeat_interleave(h, dim=3)
                      for m in (bm, cm))
            args = tuple(t.permute(perm).contiguous() for t in (xdt, bh, ch)) + (
                acum.permute(0, 1, 3, 2).contiguous(),)
            k9 = lambda: ssd.ssd_intra_chunk(*args)
            plain_args = args
            as_jax = lambda y, s: (y, s)
        first = k9()
        y_ref, s_ref = ssd.ssd_intra_chunk_plain(*plain_args)
        yk, sk = as_jax(*first)
        e = max(cs.slice_err(yk, y_ref), cs.slice_err(sk, s_ref))
        ms = timer.ms(k9, primed=True)
        dev = device_ms(k9, ("ssd_chunk",))
        differ = reruns_differ(k9, first)
        times[f"{label} K9"] = dict(ms=ms, device_ms=dev)
        print(f"[{tag}] {label} K9: {ms:.4f} ms (queue primed), device {dev:.4f} ms, "
              f"per-slice error {e:.3e}, {differ} of {RERUNS} reruns differ", flush=True)
        del first, y_ref, s_ref, yk, sk

        scan = lambda: ssd.ssd_chunked_cuda(x, dt, a, bm, cm, CHUNK)
        first = scan()
        y_ref, h_ref = ssm.ssd_chunked(x, dt, a, bm, cm, CHUNK)
        e = max(float((u.float() - v.float()).abs().max() / v.float().abs().max())
                for u, v in zip(first, (y_ref, h_ref)))
        ms = timer.ms(scan, primed=True)
        dev = device_ms(scan, None)
        differ = reruns_differ(scan, first)
        times[f"{label} ssd_chunked_cuda"] = dict(ms=ms, device_ms=dev)
        print(f"[{tag}] {label} ssd_chunked_cuda: {ms:.4f} ms (queue primed), device "
              f"{dev:.4f} ms (all its kernels), error {e:.3e} of max |ref|, {differ} of "
              f"{RERUNS} reruns differ", flush=True)
        del first, y_ref, h_ref
    print(json.dumps({"root": root, "tag": tag, "card": cs.smi_line(), "times": times}),
          flush=True)


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
