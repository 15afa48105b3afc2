"""The check catches a broken timed path: each fault the cells can have,
planted under a whole CPU-sized run, and the control (the plain
reference with the filter cut to 64 bases) turn ``correct`` false.

The cells run on one card and exchange nothing between chips, so that
fault has no place here.  The card test runs a CPU-sized cell on the
card and skips without one.
"""
from __future__ import annotations

import time
import types

import numpy as np
import pytest

from conftest import make_root
from portbench import harness
from portbench.control import control_program


def run(root, workload, program_cls=None, device="cpu", seed=2, seconds=20.0):
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                                 trace=0, t_start=time.perf_counter())
    return harness.run(args, device=device, root=root, program_cls=program_cls)


def faulty(mode, fault):
    """The mode's program with ``fault`` applied to each batch's answers."""

    class Faulty(mode.Program):
        last = None

        def __call__(self, reads, lens):
            out = super().__call__(reads, lens)
            if fault == "stale":  # the state of the call before, unchanged
                prev, self.last = self.last, out
                return prev if prev is not None else out
            if fault == "half":  # the second half left out, the first's copied
                h = len(out["position"]) // 2
                return {k: np.concatenate([v[:h], v[:len(v) - h]]) for k, v in out.items()}
            # an answer altered where it is produced: every 16th read's position
            out = {k: v.copy() for k, v in out.items()}
            out["position"][::16] += 1
            return out

    return Faulty


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload", ["linear-bulk", "graph-bulk"])
def test_a_fault_under_the_timed_path_fails_the_run(tiny_root, workload, fault):
    mode = harness.cell(workload, tiny_root).mode
    out = run(tiny_root, workload, faulty(mode, fault))
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["mismatched_reads"]["value"] > 0


@pytest.mark.parametrize("workload", ["linear-bulk", "graph-bulk"])
def test_the_control_fails_the_run(tmp_path, workload):
    root = make_root(tmp_path, batch=96, check_per_batch=96)
    c = harness.cell(workload, root)
    # the plain reference maps a batch in seconds on the CPU
    out = run(root, workload, control_program(c.mode, c.cfg["control"]["filter_bits"]),
              seconds=40.0)
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["mismatched_reads"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["linear-bulk", "graph-bulk"])
def test_a_cpu_sized_cell_on_the_card_is_correct(tiny_root, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on one")
    out = run(tiny_root, workload, device="cuda")
    assert out["result"]["correct"] is True
