"""Run `chip_smoke.py`'s surface child alone on one GPU.

    python3 tools/surface_child_alone.py

Builds the kernels, serves the chip smoke's 8,192-read linear deployment
once on ``cuda_dc_v2`` (the 1-shard PAF that the ``shard_per_device``
phase compares with), then runs ``chip_smoke.py --surface-child`` (the
``surface``, ``examples`` and ``shard_per_device`` phases) and prints
its lines and its wall seconds.  Exits with the child's exit code.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve_genomics as sg  # noqa: E402


def main() -> int:
    cs.OUT.mkdir(parents=True, exist_ok=True)
    print(cs.card_line(), flush=True)
    _build.build_all()
    sg.main(cs.FULL_ARGS + ["--reads", str(cs.FULL_READS), "--device", "cuda",
                            "--align-backend", "cuda_dc_v2",
                            "--out", str(cs.OUT / "full_cuda_dc_v2.paf")])
    t0 = time.time()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--surface-child"], cwd=ROOT, capture_output=True,
                          text=True, timeout=1500)
    print(proc.stdout, end="")
    print(proc.stderr[-6000:], file=sys.stderr)
    print(f"surface child s {time.time() - t0} rc {proc.returncode}")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
