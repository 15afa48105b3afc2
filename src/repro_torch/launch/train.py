"""End-to-end training driver: ``--arch <id>`` of any LM of the model zoo.

Port of `repro.launch.train`, with the same flags and output lines.
``--smoke`` trains the reduced config of the family; without it the full
config runs (internlm2-1.8b and seamless-m4t-medium fit one 80 GB card
at full width and depth).  The encoder-decoder is fed random frame
embeddings beside its tokens, drawn from the same stream as the
reference's.  Fault tolerance: periodic async checkpoints + resume-from-latest
(`repro_torch.ckpt`, `repro_torch.dist.fault.Heartbeat`).

``--device`` (default ``cuda``) picks where the model trains.  With
``cuda`` and no visible GPU the driver raises; it never carries on on
the CPU.  Pass ``--device cpu`` to run the same code on the CPU.

    python -m repro_torch.launch.train --arch yi-6b --smoke --steps 8 \\
        --device cpu --ckpt-dir /tmp/ck --save-every 4
    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 6 \\
        --seq 512 --batch 4 --ckpt-dir build/lm_ck --save-every 3
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
# a name the reference module binds too
from repro_torch.configs.base import ShapeConfig  # noqa: F401
from repro_torch.dist.fault import Heartbeat
from repro_torch.models import model_zoo
from repro_torch.train import loop as train_loop
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param example)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "without a GPU, pass cpu to run on the CPU)")
    args = ap.parse_args(argv)
    device = model_zoo.resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        n_heads=max(args.d_model // 64, 4),
                        n_kv_heads=max(args.d_model // 128, 2),
                        head_dim=64, d_ff=args.d_model * 3, vocab=8192)
        if args.layers:
            over["n_layers"] = args.layers * len(cfg.pattern)
        cfg = reduced(cfg, **over)

    tcfg = train_loop.TrainConfig(
        microbatches=args.micro,
        adamw=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
    )
    params, opt_state = train_loop.init_state(
        cfg, tcfg, torch.Generator(device=device).manual_seed(0), device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")

    step_fn = train_loop.build_train_step(cfg, tcfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step():
        # As in the reference, only the parameters are checkpointed: a
        # resumed run starts from a fresh optimizer state (zero moments,
        # the schedule at step 0).
        start = mgr.latest_step()
        params = mgr.restore(start, params)
        print(f"resumed from step {start}")

    rng = np.random.default_rng(7)
    # synthetic-but-learnable stream: a small pool of sequences cycles, so
    # the loss curve demonstrates optimization (random tokens would floor at
    # ln(vocab)); swap in a token corpus in production.
    pool = [rng.integers(0, cfg.vocab, size=(args.batch, args.seq))
            for _ in range(4)]
    hb = Heartbeat()
    step_s = []
    t0 = time.time()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        toks = pool[step % len(pool)]
        batch = {
            "tokens": torch.as_tensor(toks, dtype=torch.int32, device=device),
            "targets": torch.as_tensor(np.roll(toks, -1, axis=1),
                                       dtype=torch.int32, device=device),
            "mask": torch.ones((args.batch, args.seq), dtype=torch.float32,
                               device=device),
        }
        if model_zoo.is_encdec(cfg):
            fd = cfg.frontend_dim or cfg.d_model
            batch["frames"] = torch.as_tensor(
                rng.normal(0, 0.02, (args.batch, args.seq, fd)),
                dtype=torch.float32, device=device)
        elif cfg.frontend == "vision_stub":
            fd = cfg.frontend_dim or cfg.d_model
            batch["prefix_embeds"] = torch.as_tensor(
                rng.normal(0, 0.02, (args.batch, cfg.frontend_len or 16, fd)),
                dtype=torch.float32, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the heartbeat times the device step
        step_s.append(time.perf_counter() - t_step)
        slow = hb.beat()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['acc']):.3f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}"
                  + (" [straggler]" if slow else ""), flush=True)
        if mgr and (step + 1) % args.save_every == 0:
            mgr.save(step + 1, params)
    if mgr:
        mgr.save(args.steps, params, blocking=True)
    dt = time.time() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({(args.steps - start) / max(dt, 1e-9):.2f} steps/s)")
    if step_s:
        med = statistics.median(step_s)
        line = (f"timing: device={device} step_s_median={med:.4f} "
                f"tokens_per_s={args.batch * args.seq / med:.1f}")
        if device.type == "cuda":
            line += (f" peak_mem_bytes={torch.cuda.max_memory_allocated(device)}"
                     f" card={torch.cuda.get_device_name(device)!r}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
