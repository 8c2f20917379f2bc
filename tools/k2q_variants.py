#!/usr/bin/env python3
"""K2q's register split and the cost of its widening, on one card.

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/k2q_variants.py

``paged_prefill_q_tc_kernel`` (``csrc/paged_prefill.cu``) splits the
registers of its 384 threads between the two consumer warpgroups and the
producer warpgroup, which widens the codes (``QSmem``'s ``CONSUMER_REGS`` /
``PRODUCER_REGS`` at head_dim 64 and 128, 2 x consumer + producer = 3 x
168). This builds
variants of the committed source under ``build/k2q_variants/``, each one
text substitution, one ``nvcc`` each in parallel:

* ``committed``: the source as it is;
* ``c<N>_p<M>``: the consumers at N registers and the producer warpgroup at
  M (224 / 56, 216 / 72, 200 / 104);
* ``copy_only``: the widening replaced by a copy of the raw code words into
  the bf16 stage (wrong values, timing only): what K2q would take if
  widening and scaling were free.

It prints ptxas' registers and spills for each K2q instantiation, then
times each variant at llama3-8b widths (Hq 32, Hkv 8, D 128, pages of 16)
over int8 and fp8 codes, at ``chip_smoke.py``'s kernel shape (B 2, prefix
1000, tail 256) and the paged serve run's extend shape (7 rows, prefix 256,
tail 256), beside bf16 K2 on the same call, in turns (the variants, then
again in reverse), with ``chip_smoke.Timer`` (CUDA-event medians, the
launch queue primed, the L2 flushed). Each output is checked bit for bit
against K2 over bf16 pools of the dequantized values (``copy_only`` is
expected to differ).
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
    """QSmem's split at head_dim 64 and 128 (the head_dim 256 one kept)."""
    return [(re.compile(rf"({role}_REGS = D == 256 \? \d+ : )\d+"),
             lambda m, n=n: m.group(1) + str(n))
            for role, n in (("CONSUMER", consumer), ("PRODUCER", producer))]


VARIANTS = {
    "committed": [],
    "c224_p56": regs(224, 56),
    "c216_p72": regs(216, 72),
    "c200_p104": regs(200, 104),
    "copy_only": [(re.compile(re.escape(WIDEN)), COPY)],
}


def build_variants(build) -> dict:
    """name -> the loaded library of that variant's paged_prefill.cu."""
    root = HERE / "build" / "k2q_variants"
    procs = {}
    for name, subs in VARIANTS.items():
        d = root / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        src = d / "paged_prefill.cu"
        text = src.read_text()
        for pattern, repl in subs:
            text, n = pattern.subn(repl if callable(repl) else lambda _: repl, text)
            if n != 1:
                raise RuntimeError(f"{name}: {pattern.pattern!r} matched {n} times")
        src.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(src)]
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
            if m and "paged_prefill_q_tc" in m.group(1):
                kernel = re.search(r"kernelILi(\d+)ELb(\d)EN\S*?(Int8|E4m3)", m.group(1))
                info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3])
                print(f"{name}: K2q D {kernel[1]} softcap {kernel[2]} {kernel[3]}: {info}",
                      flush=True)
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
    libs = build_variants(build)
    print(cs.smi_line(), flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def case(b, plen, st, tlens, kv_dtype):
        mp = -(-plen // PS)
        n = 1 + b * mp
        randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        kp, vp = randn(HKV, n, PS, D), randn(HKV, n, PS, D)
        perm = torch.randperm(n - 1, generator=gen, device="cuda") + 1
        table = perm[: b * mp].reshape(b, mp).to(torch.int32).contiguous()
        q, kt, vt = (randn(*s).to(torch.bfloat16)
                     for s in ((b, HQ, st, D), (b, HKV, st, D), (b, HKV, st, D)))
        (kc, ks), (vc, vs) = (quant.quantize_pages(x, kv_dtype) for x in (kp, vp))
        plens = torch.full((b,), plen, dtype=torch.int32, device="cuda")
        tl = torch.tensor(tlens, dtype=torch.int32, device="cuda")
        kd, vd = (quant.dequantize_pages(c, s).to(torch.bfloat16) for c, s in ((kc, ks), (vc, vs)))
        return ((q, kc, vc, table, kt, vt, plens, tl), dict(k_scales=ks, v_scales=vs),
                (q, kd, vd, table, kt, vt, plens, tl))

    cases = {f"{label} {kv_dtype}": case(*shape, kv_dtype)
             for label, shape in (("smoke shape", (2, 1000, 256, [256, 219])),
                                  ("serve extend shape", (7, 256, 256, [256] * 7)))
             for kv_dtype in ("int8", "fp8")}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        build._libs["paged_prefill"] = libs[name]
        pp._fns.clear()
        for label, (qargs, kw, bfargs) in cases.items():
            same = torch.equal(pp.paged_flash_prefill(*qargs, **kw),
                               pp.paged_flash_prefill(*bfargs))
            ms = timer.ms(lambda: pp.paged_flash_prefill(*qargs, **kw), primed=True)
            k2_ms = timer.ms(lambda: pp.paged_flash_prefill(*bfargs), primed=True)
            print(f"{name:10s} {label:23s} K2q {ms:.4f} ms, bf16 K2 {k2_ms:.4f} ms "
                  f"({ms / k2_ms:.3f}x), bitwise equal to K2 over the dequantized values "
                  f"{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
