"""Sequence-to-graph read mapping (GAF): the program's side and the reference's.

The deployment is a random backbone of the configuration's length with
simulated variants.  The program builds its tiled graph index
(`repro_torch.graph.index`) from the sequence and the variant list and
maps each batch with `GraphMapExecutor`, the executor the serving engine
flushes through; the reference (`portbench.reference.graph`) builds its
own graph and index from the same sequence and variants.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import generate
from portbench.modes import linear
from portbench.reference import graph as ref_graph
from portbench.reference import index as ref_index

FIELDS = ("position", "distance", "ops", "n_ops", "path")


def deployment(cfg: dict, seed: int) -> dict:
    """The host data: the backbone, its variants, and the benchmark's own
    graph of them (which spells the reads)."""
    ref = generate.reference(cfg["reference_length"], seed)
    v = cfg["variants"]
    var = generate.variants(ref, per_bp=v["per_bp"], ratio=v["snp_ins_del"], seed=seed)
    return {"ref": ref, "variants": var, "graph": ref_graph.build(ref, var)}


def read_source(cfg: dict, data: dict, device):
    """``(n, read_len, g) -> [n, read_len]`` error-free reads spelled along
    the benchmark's own graph, on ``device``."""
    g = ref_graph.to_device(data["graph"], device)
    return lambda n, read_len, rg: generate.graph_sources(
        g.bases, g.succ, g.node_of_backbone, n, read_len, rg)


def mapper_params(cfg: dict) -> dict:
    return {**cfg["mapper"], **cfg["index"], **cfg["tiles"]}


def variant_list(var) -> list:
    """The variants in the program's form (`core.segram.graph.Variant`)."""
    from repro_torch.core.segram.graph import Variant

    out = []
    for pos, kind, alt in zip(var.pos.tolist(), var.kind.tolist(), var.alt.tolist()):
        if kind == 0:
            out.append(Variant(pos, "snp", (alt[0],)))
        elif kind == 1:
            out.append(Variant(pos, "ins", (alt[0], alt[1])))
        else:
            out.append(Variant(pos, "del", span=generate.DEL_SPAN))
    return out


class Program:
    """The program under test, built for one deployment on the card."""

    def __init__(self, cfg: dict, data: dict, device):
        from repro_torch.core.genasm import GenASMConfig
        from repro_torch.graph.index import build_graph_index
        from repro_torch.graph.mapper import GraphMapExecutor

        ix, mp, tl = cfg["index"], cfg["mapper"], cfg["tiles"]
        self.geo = GenASMConfig(w=mp["w"], o=mp["o"], k=mp["k"])
        self.mp = mp
        self.index = build_graph_index(
            data["ref"], variant_list(data["variants"]), w=ix["minimizer_w"],
            k=ix["minimizer_k"], freq_frac=ix["freq_frac"],
            window=mp["p_cap"] + 2 * mp["w"], tile_stride=tl["tile_stride"],
            margin=tl["tile_margin"], device=device)
        self.executor = GraphMapExecutor(
            tile_stride=tl["tile_stride"], cfg=self.geo, p_cap=mp["p_cap"],
            filter_bits=mp["filter_bits"], filter_k=mp["filter_k"],
            max_candidates=mp["max_candidates"], minimizer_w=ix["minimizer_w"],
            minimizer_k=ix["minimizer_k"],
            backend=None if mp["backend"] == "auto" else mp["backend"],
            prefilter=True)
        self.hops = ref_graph.hops_per_node(cfg["reference_length"],
                                            data["variants"].counts)
        self.to_host = linear.HostCopy()

    def __call__(self, reads, lens) -> dict:
        res = self.executor(self.index.arrays, reads, lens)
        return self.to_host({f: getattr(res, f) for f in FIELDS})

    @property
    def stage_times(self) -> list:
        return self.executor.last_times

    def work(self, batch: int) -> list:
        """What the last batch launched on the BitAlign kernel: the
        filter's compacted rows over whole tiles, then one window a read a
        window step (nothing when every candidate was screened out)."""
        rows = self.executor.last_stats.get("dc_rows", 0)
        if not rows:
            return []
        mp = self.mp
        return [("bitalign", {"rows": rows, "nodes": self.index.tile_len,
                              "m_bits": min(mp["filter_bits"], mp["p_cap"]),
                              "k": mp["filter_k"], "store_r": False,
                              "hops_per_node": self.hops}),
                ("bitalign", {"rows": batch * self.geo.n_windows(mp["p_cap"]),
                              "nodes": mp["w"], "m_bits": mp["w"], "k": mp["k"],
                              "store_r": True, "hops_per_node": self.hops})]


class Reference:
    """The plain reference for one deployment, on ``device``."""

    def __init__(self, cfg: dict, data: dict, device):
        self.p = mapper_params(cfg)
        self.graph = ref_graph.to_device(data["graph"], device)
        self.index = ref_index.build_index(
            torch.as_tensor(data["ref"], device=device), w=self.p["minimizer_w"],
            k=self.p["minimizer_k"], freq_frac=self.p["freq_frac"])

    def __call__(self, reads: torch.Tensor, lens: torch.Tensor, *,
                 filter_bits: int | None = None) -> dict:
        out = ref_graph.map_reads(self.graph, self.index, reads, lens, p=self.p,
                                  filter_bits=filter_bits)
        return {f: out[f].cpu().numpy() for f in FIELDS}


def same(prog: dict, ref: dict) -> np.ndarray:
    """`linear.same`, and for a mapped read the same node path."""
    ok = linear.same(prog, ref)
    width = min(prog["path"].shape[1], ref["path"].shape[1])
    valid = np.arange(width) < ref["n_ops"][:, None]
    path_ok = np.where(valid, prog["path"][:, :width] == ref["path"][:, :width],
                       True).all(1)
    return ok & ((ref["position"] < 0) | path_ok)
