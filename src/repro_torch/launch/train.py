"""Training launcher (the port of repro/launch/train.py). Runs on the card;
`--device cpu` is the only way to ask for the CPU, and without a card it
raises.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch yi-6b --reduced --steps 40 --batch 8 --seq 128 \
        --ckpt-dir build/ckpt --ckpt-every 10 [--resume] [--kill-at 25] \
        [--device cpu]

It builds Model(cfg, remat=True) (no kernels: they have no backward),
AdamW with a 5-step warmup, the deterministic resumable token stream and
atomic checkpoints. `--kill-at N` simulates a failure after N steps (exit
42); re-running with --resume picks up from the newest COMMITTED
checkpoint and continues the same batch stream. The checkpoint directory
defaults to `repro_torch_ckpt` under the temporary directory ($TMPDIR).
The launcher passes no frames and no image embeddings, as the
reference's does not: whisper-small and llama-3.2-vision-90b fail at their
first step with a KeyError that names them.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.models.model import Model
from repro_torch.runtime import to_host
from repro_torch.train.checkpoint import (latest_step, prune_checkpoints,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import DataConfig, batches
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.train_step import TrainConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="simulate a host failure after N steps")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one). `cpu` runs on the CPU")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = Model(cfg, remat=True, device=args.device)
    print(f"arch={cfg.name} params={model.param_count() / 1e6:.1f}M")

    ocfg = AdamWConfig(lr_peak=args.lr, warmup_steps=5,
                       total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches, optimizer=ocfg)
    train_step = make_train_step(model, tcfg)

    params = model.init(torch.Generator(model.device).manual_seed(0))
    opt_state = init_adamw(params)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        print(f"resumed from step {start}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    stream = batches(dcfg, start_step=start)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in next(stream).items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            m = {k: float(to_host(v)) for k, v in metrics.items()}
            print(f"step {step:4d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} "
                  f"({(time.time() - t0) / max(1, step - start + 1):.2f}s/it)",
                  flush=True)
        if (step + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step + 1,
                                   (params, opt_state))
            prune_checkpoints(args.ckpt_dir, keep=3)
            print(f"checkpointed -> {path}")
        if args.kill_at is not None and step + 1 >= args.kill_at:
            print(f"simulated failure at step {step + 1} "
                  f"(restart with --resume)")
            raise SystemExit(42)
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
