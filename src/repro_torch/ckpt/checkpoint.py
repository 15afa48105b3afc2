"""Mesh-agnostic checkpointing with async writes, in the reference's layout.

Port of `repro.ckpt.checkpoint`.  Layout:  <dir>/step_<N>/
  manifest.json      — step, flat key list, extra, device count
  arrays.npz         — one entry per flattened leaf (host copies)

Keys are the reference's flat ``"::"`` keys: a model (`DecoderLM` or
`EncDecLM`) is saved through `models.convert.params_to_jax_tree`
(blocks stacked), so a
checkpoint written by either package restores in the other.  A dict of
tensors (nested or flat) is flattened the same way.  bf16/fp16 leaves are saved
as fp32 and recast on restore.  Saving snapshots to the host, then
writes on a background thread with one write in flight; the ``step_``
directory is renamed into place from ``.tmp_step_N`` so a crash never
leaves a half-written checkpoint visible, and only the newest ``keep``
checkpoints stay.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.models import convert

SEP = convert.SEP


def _host(a: torch.Tensor) -> np.ndarray:
    a = a.detach()
    if a.dtype in (torch.bfloat16, torch.float16):
        a = a.float()  # npz-safe; restore recasts to the leaf dtype
    return a.cpu().numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    if isinstance(tree, nn.Module):
        return convert.params_to_jax_tree(tree)
    return {k: _host(v) for k, v in convert.flatten(tree).items()}


def _unflatten(template: Mapping, arrays: dict, prefix: str = "") -> dict:
    """A new tree of tensors shaped like ``template``, on its leaves'
    devices and dtypes."""
    out = {}
    for k, leaf in template.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(leaf, Mapping):
            out[k] = _unflatten(leaf, arrays, key)
            continue
        a = arrays[key]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape} != "
                             f"{tuple(leaf.shape)}")
        out[k] = torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)
    return out


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save ---
    def save(self, step: int, tree, *, blocking: bool = False,
             extra: dict | None = None):
        """Snapshot to host, then write on a background thread."""
        host = _flatten(tree)  # device->host copy happens here (blocking)
        meta = {
            "step": int(step),
            "keys": sorted(host),
            "extra": extra or {},
            "n_devices": max(torch.cuda.device_count(), 1),
        }
        self.wait()  # one in flight (double buffer)

        def write():
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            (tmp / "manifest.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def write_async():
            try:
                write()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_async, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the write in flight; re-raise its failure, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore ---
    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if (p / "manifest.json").exists()
        )

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, template):
        """Load into the template's structure: a model is filled in place
        and returned; a dict gives a new dict like it."""
        d = self.dir / f"step_{step}"
        with np.load(d / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        if isinstance(template, nn.Module):
            return convert.load_jax_tree(template, arrays)
        return _unflatten(template, arrays)
