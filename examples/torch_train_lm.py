"""Train a ~100M-parameter LM for a few hundred steps with the port's
trainer (the end-to-end training entry point over the model zoo).

The twin of `examples/train_lm.py`, on the card by default.  The
checkpoints go to ``--ckpt-dir`` (default ``build/torch_train_lm_ckpt``
in the repository); a second run resumes from them.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
"""
import argparse
from pathlib import Path

from repro_torch.launch.train import main

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--steps", default="200")
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; pass cpu without a GPU)")
ap.add_argument("--ckpt-dir", default=str(
    Path(__file__).resolve().parents[1] / "build" / "torch_train_lm_ckpt"))
args = ap.parse_args()
main(["--arch", "yi-6b", "--smoke", "--d-model", "1024", "--layers", "6",
      "--steps", args.steps, "--seq", "128", "--batch", "4",
      "--ckpt-dir", args.ckpt_dir, "--device", args.device])
