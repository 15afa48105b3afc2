"""The read generator: one seed, one set of batches; the benchmark's own
graph equal to the program's."""
from __future__ import annotations

import numpy as np
import torch

from portbench import generate
from portbench.modes import graph as graph_mode
from portbench.modes import linear as linear_mode
from portbench.reference import graph as ref_graph

TRAFFIC = {"read_len": 150, "deployment_share": 1.0, "batch": 64, "pool_batches": 3,
           "profile": {"error_rate": 0.05, "frac_sub": 0.8, "frac_ins": 0.1,
                       "frac_del": 0.1}}
CFG = {"reference_length": 40000, "variants": {"per_bp": 200, "snp_ins_del": [2, 1, 1]}}


def pool(seed, share=1.0, mode=linear_mode):
    data = mode.deployment(CFG, seed)
    return generate.read_pool({**TRAFFIC, "deployment_share": share}, seed,
                              mode.read_source(CFG, data, "cpu"))


def test_same_seed_same_batches_other_seed_other_batches():
    big = 2 ** 31 + 12345
    a, b, c = pool(big), pool(big), pool(big + 1)
    assert np.array_equal(a.arr, b.arr) and np.array_equal(a.lens, b.lens)
    assert not np.array_equal(a.arr, c.arr)
    assert len(a.reads) == 64 * 3
    assert np.array_equal(generate.check_sample(a, 16, big),
                          generate.check_sample(b, 16, big))


def test_reads_carry_the_profiles_errors():
    p = pool(5)
    assert abs(p.lens.mean() - 150) < 3  # insertions and deletions balance
    ref = torch.as_tensor(linear_mode.deployment(CFG, 5)["ref"])
    g = generate.torch_rng(5, "reads", "cpu")
    src = generate.linear_sources(ref, 20000, 150, g)
    out, lens = generate.mutate(src, TRAFFIC["profile"], g)
    subs_only = lens == 150
    diff = (out[subs_only, :150] != src[subs_only]).float().mean().item()
    assert 0.03 < diff < 0.3  # substitutions, and shifts past an indel
    # with every error an insertion, each read grows and keeps its bases
    ins = {"error_rate": 0.05, "frac_sub": 0.0, "frac_ins": 1.0, "frac_del": 0.0}
    out, lens = generate.mutate(src[:50], ins, g)
    for i in range(50):
        kept = out[i, :lens[i]]
        j = 0
        for x in kept.tolist():  # the source is a subsequence of the read
            if j < 150 and x == src[i, j]:
                j += 1
        assert j == 150


def test_deployment_share_is_exact_in_every_batch():
    p = pool(9, share=0.1)
    per = p.from_deployment.reshape(3, 64).sum(1)
    assert np.all(per == round(64 * 0.1))


def test_the_check_samples_as_many_mapping_reads_in_a_foreign_mix():
    bulk, mix = pool(9), pool(9, share=0.25)
    s = generate.check_sample(bulk, 8, 9)
    assert s.shape == (3, 8) and np.all(np.diff(s, axis=1) > 0)
    s = generate.check_sample(mix, 8, 9)
    dep = mix.from_deployment.reshape(3, 64)
    # 8 of the 16 deployment reads and 8 of the 48 foreign reads a batch
    assert s.shape == (3, 16)
    assert np.all(np.take_along_axis(dep, s, 1).sum(1) == 8)
    assert np.array_equal(s, generate.check_sample(pool(9, share=0.25), 8, 9))


def test_graph_reads_spell_paths_of_the_graph():
    data = graph_mode.deployment(CFG, 4)
    g = ref_graph.to_device(data["graph"], "cpu")
    src = generate.graph_sources(g.bases, g.succ, g.node_of_backbone, 300, 150,
                                 generate.torch_rng(4, "reads", "cpu"))
    bases, succ = data["graph"].bases, data["graph"].succ
    for read in src.numpy():
        # some path spells the read: the set of nodes it can end on stays
        # non-empty, starting from every node with its first base
        ends = set(np.nonzero(bases == read[0])[0].tolist())
        for x in read[1:]:
            ends = {i + 1 + h for i in ends for h in range(16)
                    if (succ[i] >> h) & 1 and bases[i + 1 + h] == x}
            assert ends


def test_reference_graph_equals_the_programs():
    from repro_torch.core.segram.graph import build_graph

    data = graph_mode.deployment(CFG, 6)
    want = build_graph(data["ref"], graph_mode.variant_list(data["variants"]))
    g = data["graph"]
    assert np.array_equal(g.bases, want.bases)
    assert np.array_equal(g.succ, want.succ_bits.astype(np.int64))
    assert np.array_equal(g.backbone, want.backbone)
    assert np.array_equal(g.node_of_backbone, want.node_of_backbone)
    assert data["variants"].counts == {"snp": 100, "ins": 50, "del": 50}
    assert ref_graph.hops_per_node(40000, data["variants"].counts) > 1
