#!/usr/bin/env python3
"""Where the kernel path's train gradients part from the plain path's, route
by route, on one card.

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``::

    python3 tools/train_grads.py [--arch ARCH ...] [--seeds N] [--layers L]

For each arch (default hymba-1.5b, mamba2-1.3b, llama3-8b) at full width,
cut to L layers (default 2), and each seed s in 1..N, one step's gradients
of a batch of one 1024-token row, from weights and data of seed s, as
``chip_smoke.py``'s gradient check takes them (bf16 compute, float32
parameters, remat; a vision model with its cross gates open and a seeded
image in the batch, ``chip_smoke.open_gates`` / ``vision_images``; a
multi-codebook model, musicgen-medium, on (1, 1024, K) codes), under
six settings of the routes:

* ``cuda``: every kernel (``attn_impl`` and ``ssm.impl`` "auto");
* ``attention kernels``: K1 / K5 / K6, the SSM on its plain route;
* ``SSM route``: K9 and its written-out backward, attention plain;
* ``plain``: both plain (the check's reference);
* ``plain, float64 attention``: the plain path with its attention forward
  computed in float64 before the same bf16 rounding of o (a more exact
  attention than the plain path's own float32);
* ``plain float32``: both plain, float32 compute.

Each of the others is compared with ``plain`` leaf by leaf by the check's
measure, ``||g - g_plain|| / ||g_plain||``: the largest, its leaf, the
median and the next five. Then each bf16 setting with ``plain float32``,
``||g - g_f32|| / ||g_f32||``: its distance on the SSM vectors ``dt_bias``
and ``a_log`` and on the cross layers' gates, and on its farthest leaf,
and the most it lies
further from float32 than ``plain`` does on any leaf (what
``chip_smoke.py`` holds on a hybrid stack). An arch without attention or
without SSM layers gives the same gradients under two of the settings.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def float64_attention(torch, ops):
    """A stand-in for ``ops.flash_attention_fwd_plain`` (the training
    signature: no query offset) that computes o and lse in float64 and
    rounds o to the inputs' dtype."""
    def fwd(q, k, v, *, causal=True, window=None, softcap=None, scale=None, kv_len=None):
        group = q.shape[1] // k.shape[1]
        qq, kk, vv = (t.double() for t in (q, k.repeat_interleave(group, 1),
                                           v.repeat_interleave(group, 1)))
        s = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * (scale or q.shape[-1] ** -0.5)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = cols < (k.shape[2] if kv_len is None else kv_len)
        if causal:
            mask = mask & (cols <= rows)
        if window:
            mask = mask & (cols > rows - window)
        s = s.masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s, -1)
        o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), vv)
        return o.to(q.dtype), lse.float()

    return fwd


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", nargs="+",
                        default=["hymba-1.5b", "mamba2-1.3b", "llama3-8b"])
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--layers", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    if not torch.cuda.is_available():
        print("train_grads: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import registry
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.models import transformer
    from repro_torch.training import train_step as ts

    build.build_all()
    plain_fwd, exact_fwd = ops.flash_attention_fwd_plain, float64_attention(torch, ops)
    sys.path.insert(0, HERE)
    import chip_smoke

    def routes(cfg, attn, ssm):
        cfg = dataclasses.replace(cfg, attn_impl=attn)
        if cfg.ssm is not None:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, impl=ssm))
        return cfg

    for arch in args.arch:
        cfg = dataclasses.replace(registry.get_config(arch), n_layers=args.layers)
        settings = {"cuda": routes(cfg, "auto", "auto"),
                    "attention kernels": routes(cfg, "auto", "plain"),
                    "SSM route": routes(cfg, "plain", "auto"),
                    "plain": routes(cfg, "plain", "plain")}
        settings["plain, float64 attention"] = settings["plain"]
        settings["plain float32"] = dataclasses.replace(settings["plain"],
                                                        compute_dtype="float32")
        for seed in range(1, args.seeds + 1):
            params = transformer.init_model(cfg, seed=seed, device="cuda",
                                            param_dtype=torch.float32)
            batch = ts.to_device(make_pipeline(DataConfig(
                seq_len=1024, global_batch=1, seed=seed, vocab=cfg.vocab,
                num_codebooks=cfg.num_codebooks)).batch_at(0), "cuda")
            if cfg.vision_tokens:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(seed + 11)
                chip_smoke.open_gates(torch, params, gen)
                batch["image_embeds"] = chip_smoke.vision_images(torch, cfg, 1, gen)
            grads, losses = {}, {}
            for name, c in settings.items():
                ops.flash_attention_fwd_plain = exact_fwd if "float64" in name else plain_fwd
                try:
                    g, loss, _ = ts._accumulate_grads(params, c, batch, ts.TrainConfig())
                finally:
                    ops.flash_attention_fwd_plain = plain_fwd
                torch.cuda.synchronize()
                grads[name] = {tree_lib.key_of(p): t.clone()
                               for p, t in tree_lib.leaves_with_paths(g)}
                losses[name] = float(loss)
            print(f"{arch} seed {seed}: losses " + ", ".join(
                f"{k} {v:.6f}" for k, v in losses.items()), flush=True)

            def rel(name, ref):
                return {k: float((grads[name][k] - r).float().norm() / r.float().norm())
                        for k, r in grads[ref].items()}

            for name in [n for n in settings if n != "plain"]:
                rels = rel(name, "plain")
                top = sorted(rels, key=rels.get, reverse=True)
                print(f"  {name} vs plain: max {rels[top[0]]:.3e} at {top[0]}, median "
                      f"{statistics.median(rels.values()):.3e}; next "
                      + ", ".join(f"{k} {rels[k]:.2e}" for k in top[1:6]), flush=True)
            floor = rel("plain", "plain float32")
            ssm_leaves = [k for k in floor if k.endswith(("dt_bias", "a_log", "cross_gate"))]
            for name in [n for n in settings if n != "plain float32"]:
                d = rel(name, "plain float32")
                far = max(d, key=d.get)
                excess = {k: d[k] - floor[k] for k in d}
                worst = max(excess, key=excess.get)
                print(f"  {name} vs plain float32: " + ", ".join(
                    f"{k} {d[k]:.3e}" for k in ssm_leaves)
                    + f"; farthest {d[far]:.3e} at {far}; past plain's distance at most "
                    f"{excess[worst]:.3e} at {worst}", flush=True)
            del params, grads
            torch.cuda.empty_cache()
    print(f"card: {chip_smoke.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
