"""Training launcher: the fault-tolerant trainer on one device.

The flags are those of ``repro.launch.train``, plus ``--device`` (default
``cuda``); ``--smoke --device cpu`` runs the plain PyTorch path on the CPU.
On the card attention runs the hand-written FA2 kernels: K1 forward, K5
(dQ) and K6 (dK/dV) backward. Checkpointing, resume and the data pipeline
are the trainer's.

Examples:
  python -m repro_torch.launch.train --arch llama3-8b --smoke --device cpu \
      --steps 20 --seq-len 64 --global-batch 8 --ckpt-dir /tmp/run1
  python -m repro_torch.launch.train --arch llama3-8b --smoke --steps 50
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.configs import registry
from repro_torch.core import device as device_lib
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
    to_device,
)
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    device = device_lib.resolve(args.device)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    state = init_train_state(args.seed, cfg, tcfg, device=device)
    pipe = make_pipeline(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch, seed=args.seed,
        vocab=cfg.vocab, num_codebooks=cfg.num_codebooks))
    trainer = Trainer(
        make_train_step(cfg, tcfg), state, pipe,
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=args.log_every),
        put_batch=lambda b: to_device(b, device),
    )
    trainer.try_resume()
    metrics = trainer.run()
    print(f"device={device.type} steps={trainer.step} retries={trainer.retries}")
    print("final metrics:", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
