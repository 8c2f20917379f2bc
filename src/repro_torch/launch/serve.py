"""Serving launcher: the port's LLMEngine over a synthetic request stream.

The flags are those of ``repro.launch.serve``, plus ``--device`` (default
``cuda``). ``--kv-layout auto`` (the default) serves SSM and hybrid models
(mamba2, hymba) from dense stripes and ranks dense against paged for the
rest. ``--steps-per-sync N`` (or ``auto``) runs N decode ticks per host
sync, one CUDA graph replay on the card. Options the port has not ported
yet (``--mesh``, ``--kv-dtype`` other than fp32, ``--host-pool-bytes``)
reach the engine, which raises ``NotImplementedError`` naming the ROADMAP
item.

Examples:
  python -m repro_torch.launch.serve --arch llama3-8b
  python -m repro_torch.launch.serve --arch hymba-1.5b --cache-len 2048
  python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu \
      --requests 4 --max-new-tokens 8
  python -m repro_torch.launch.serve --arch llama3-8b --smoke --device cpu \
      --requests 4 --max-new-tokens 8 --shared-prefix 16
  python -m repro_torch.launch.serve --arch llama3-8b --steps-per-sync auto
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--kv-layout", choices=("auto", "dense", "paged"), default="auto")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4, help="decode rows (max_batch)")
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--num-pages", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by every request "
                         "(exercises paged prefix sharing)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard serving over N devices (0 = single device)")
    ap.add_argument("--steps-per-sync", default="1",
                    help="decode ticks per host sync (an int, or 'auto')")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8", "fp8"), default="fp32")
    ap.add_argument("--host-pool-bytes", type=int, default=0,
                    help="host-memory KV tier budget in bytes (0 = off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    steps = (args.steps_per_sync if args.steps_per_sync == "auto"
             else int(args.steps_per_sync))
    params = transformer.init_model(cfg, seed=args.seed, device=args.device)
    engine = LLMEngine(
        cfg, params,
        kv_layout=args.kv_layout,
        max_batch=args.slots,
        cache_len=args.cache_len,
        num_pages=args.num_pages,
        page_size=args.page_size,
        prompt_buckets=(args.prompt_len, 2 * args.prompt_len),
        mesh=args.mesh if args.mesh > 1 else None,
        steps_per_sync=steps,
        kv_dtype=args.kv_dtype,
        host_pool_bytes=args.host_pool_bytes or None,
        device=args.device,
    )
    print(f"kv_layout={engine.kv_layout} device={engine.device}")
    rng = np.random.default_rng(args.seed)
    system = (rng.integers(1, cfg.vocab, size=(args.shared_prefix,))
              if args.shared_prefix else None)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=(args.prompt_len,))
        if system is not None:
            prompt = np.concatenate([system, prompt[: args.prompt_len - args.shared_prefix]])
        reqs.append(Request(
            uid=i, prompt=prompt,
            sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                    top_p=args.top_p, max_tokens=args.max_new_tokens),
        ))
    results = engine.generate(reqs)
    for r in sorted(results, key=lambda r: r.uid)[:4]:
        toks = [int(t) for t in r.tokens]
        print(f"  uid={r.uid} prompt_len={r.prompt_len} finish={r.finish_reason} out={toks}")
    print(engine.stats().summary())


if __name__ == "__main__":
    main()
