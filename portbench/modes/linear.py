"""Linear read mapping (PAF): the program's side and the reference's side.

The deployment is a random reference of the configuration's length.  The
program indexes it (`repro_torch.core.minimizer_index`) and maps each
batch with `LinearMapExecutor`, the executor the serving engine flushes
through; the reference (`portbench.reference.linear`) builds its own
index from the same sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import generate
from portbench.reference import index as ref_index
from portbench.reference import linear as ref_linear

FIELDS = ("position", "distance", "ops", "n_ops")


class HostCopy:
    """Result fields copied to the host: on the card into pinned buffers
    made on the first batch and reused, one synchronisation a batch (a
    copy to pageable memory runs at the host's memory speed, which other
    tenants of the host share)."""

    def __init__(self):
        self.bufs: dict = {}

    def __call__(self, fields: dict) -> dict:
        out = {}
        for name, t in fields.items():
            if t.device.type != "cuda":
                out[name] = t.numpy()
                continue
            buf = self.bufs.get(name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self.bufs[name] = torch.empty(t.shape, dtype=t.dtype,
                                                    pin_memory=True)
            buf.copy_(t, non_blocking=True)
            out[name] = buf.numpy()
        if self.bufs:
            torch.cuda.current_stream().synchronize()
        return out


def deployment(cfg: dict, seed: int) -> dict:
    """The host data the deployment is made of."""
    return {"ref": generate.reference(cfg["reference_length"], seed)}


def read_source(cfg: dict, data: dict, device):
    """``(n, read_len, g) -> [n, read_len]`` error-free reads on ``device``."""
    ref = torch.as_tensor(data["ref"], device=device)
    return lambda n, read_len, g: generate.linear_sources(ref, n, read_len, g)


def mapper_params(cfg: dict) -> dict:
    return {**cfg["mapper"], **cfg["index"]}


class Program:
    """The program under test, built for one deployment on the card."""

    def __init__(self, cfg: dict, data: dict, device):
        from repro_torch.core.genasm import GenASMConfig
        from repro_torch.core.mapper import LinearMapExecutor
        from repro_torch.core.minimizer_index import build_reference_index

        ix, mp = cfg["index"], cfg["mapper"]
        self.index = build_reference_index(
            data["ref"], w=ix["minimizer_w"], k=ix["minimizer_k"],
            freq_frac=ix["freq_frac"], device=device)
        self.geo = GenASMConfig(w=mp["w"], o=mp["o"], k=mp["k"])
        self.mp = mp
        self.executor = LinearMapExecutor(
            cfg=self.geo, p_cap=mp["p_cap"], filter_bits=mp["filter_bits"],
            filter_k=mp["filter_k"], max_candidates=mp["max_candidates"],
            minimizer_w=ix["minimizer_w"], minimizer_k=ix["minimizer_k"],
            backend=None if mp["backend"] == "auto" else mp["backend"])
        self.to_host = HostCopy()

    def __call__(self, reads, lens) -> dict:
        """Map one device batch; every result field copied to the host
        (into buffers the next batch overwrites)."""
        res = self.executor(self.index, reads, lens)
        return self.to_host({f: getattr(res, f) for f in FIELDS})

    @property
    def stage_times(self) -> list:
        return self.executor.last_times

    def work(self, batch: int) -> list:
        """What the last batch launched on the kernels the roofline
        metrics read: one GenASM-DC window a read a window step."""
        return [("genasm_dc", {"windows": batch * self.geo.n_windows(self.mp["p_cap"]),
                               "w": self.mp["w"], "k": self.mp["k"]})]


class Reference:
    """The plain reference for one deployment, on ``device``."""

    def __init__(self, cfg: dict, data: dict, device):
        self.p = mapper_params(cfg)
        self.ref = torch.as_tensor(data["ref"], device=device)
        self.index = ref_index.build_index(
            self.ref, w=self.p["minimizer_w"], k=self.p["minimizer_k"],
            freq_frac=self.p["freq_frac"])

    def __call__(self, reads: torch.Tensor, lens: torch.Tensor, *,
                 filter_bits: int | None = None) -> dict:
        out = ref_linear.map_reads(self.ref, self.index, reads, lens, p=self.p,
                                   filter_bits=filter_bits)
        return {f: out[f].cpu().numpy() for f in FIELDS}


def same(prog: dict, ref: dict) -> np.ndarray:
    """Per read, whether the program's answer is the reference's: the
    same position and distance, and for a mapped read the same CIGAR."""
    ok = (prog["position"] == ref["position"]) & (prog["distance"] == ref["distance"])
    mapped = ref["position"] >= 0
    ok &= ~mapped | (prog["n_ops"] == ref["n_ops"])
    cols = np.arange(ref["ops"].shape[1])
    valid = cols < ref["n_ops"][:, None]
    width = min(prog["ops"].shape[1], ref["ops"].shape[1])
    ops_ok = np.where(valid[:, :width], prog["ops"][:, :width] == ref["ops"][:, :width],
                      True).all(1) & (ref["n_ops"] <= width)
    return ok & (~mapped | ops_ok)
