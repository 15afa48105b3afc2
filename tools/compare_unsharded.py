#!/usr/bin/env python3
"""Compare the port's unsharded LM paths of two trees, bit for bit.

    python tools/compare_unsharded.py OLD_TREE NEW_TREE

For every arch (reduced config, seeded weights and batch), each tree
computes on the CPU: the prefill logits, the loss and every gradient,
six decode steps' logits from an empty cache with the bf16 and the int8
KV cache, and the decode state after them.  Each tree runs in a process
of its own (``--dump TREE OUT.npz``); the two dumps must be equal array
for array.  Use it to show that a change to the sharded paths leaves the
``mesh=None`` paths as they were (unpack the parent with ``git archive
<commit> | tar -x -C build/parent``).
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path


def dump(tree: str, out: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, f"{tree}/src")
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import model_zoo, transformer

    res = {}

    def flat(tag, tree_, prefix=""):
        for k, v in tree_.items():
            if isinstance(v, dict):
                flat(tag, v, f"{prefix}{k}.")
            else:
                res[f"{tag}|state|{prefix}{k}"] = (
                    v.float().numpy() if v.is_floating_point() else v.numpy())

    for arch in ARCH_IDS:
        cfg = reduced(get_config(arch))
        for int8 in (False, True):
            transformer.KV_INT8 = int8
            model = model_zoo.init(cfg, torch.Generator().manual_seed(1),
                                   device="cpu")
            rng = np.random.default_rng(3)
            b, s = 2, 32
            batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                         .astype(np.int32))
                     for k in ("tokens", "targets")}
            batch["mask"] = torch.ones(b, s)
            fd = cfg.frontend_dim or cfg.d_model
            if cfg.enc_layers:
                batch["frames"] = torch.from_numpy(
                    rng.normal(0, .02, (b, s, fd)).astype(np.float32))
            elif cfg.frontend == "vision_stub":
                batch["prefix_embeds"] = torch.from_numpy(rng.normal(
                    0, .02, (b, cfg.frontend_len, fd)).astype(np.float32))
            tag = f"{arch}|{int8}"
            if not int8:
                res[f"{tag}|prefill"] = model_zoo.prefill_fn(
                    cfg, model, batch).float().numpy()
                loss, _ = model_zoo.loss_fn(cfg, model, batch)
                loss.backward()
                res[f"{tag}|loss"] = loss.detach().numpy()
                for k, p in model.named_parameters():
                    if p.grad is not None:
                        res[f"{tag}|grad|{k}"] = p.grad.numpy()
            st = model_zoo.decode_state_init(cfg, b, 16, device="cpu")
            extra = {}
            if cfg.enc_layers:
                extra["memory"] = torch.from_numpy(rng.normal(
                    0, .02, (b, 12, cfg.d_model)).astype(np.float32)).to(
                        torch.bfloat16)
            for pos in range(6):
                logits, st = model_zoo.decode_fn(
                    cfg, model, st,
                    {"tokens": batch["tokens"][:, pos: pos + 1], **extra}, pos)
                res[f"{tag}|decode{pos}"] = logits.float().numpy()
            flat(tag, st)
    transformer.KV_INT8 = False
    np.savez(out, **res)


def main() -> int:
    if sys.argv[1:2] == ["--dump"]:
        dump(sys.argv[2], sys.argv[3])
        return 0
    import numpy as np

    old, new = (str(Path(t).resolve()) for t in sys.argv[1:3])
    with tempfile.TemporaryDirectory() as tmp:
        outs = [f"{tmp}/old.npz", f"{tmp}/new.npz"]
        procs = [subprocess.Popen([sys.executable, __file__, "--dump", tree, out])
                 for tree, out in zip((old, new), outs)]
        if any(p.wait() for p in procs):
            print("a dump failed", file=sys.stderr)
            return 1
        a, b = (np.load(o) for o in outs)
        differ = sorted(set(a.files) ^ set(b.files)) + [
            k for k in sorted(set(a.files) & set(b.files))
            if not (a[k].shape == b[k].shape
                    and np.array_equal(a[k], b[k], equal_nan=True))]
    print(f"{len(a.files)} arrays compared, {len(differ)} differ")
    for k in differ[:20]:
        print("  DIFFER:", k)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
