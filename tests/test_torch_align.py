"""Port parity: GenASM traceback and batched alignment against the JAX reference.

Inputs are seeded numpy pairs from `repro_torch.align.inputs.mutated_pair`
(substitutions, insertions and deletions); `repro` and `repro_torch` get
the same arrays and every `AlignResult` field must match exactly.  The
port's ``cuda_dc``/``cuda_dc_v2`` backends run their batched window loop
with the kernels' plain versions on the CPU, against the reference's
Pallas backends in interpret mode.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import align as jalign
from repro.core import bitvector as jbv
from repro.core import genasm_dc as jdc
from repro.core import genasm_tb as jtb
from repro.core.genasm import GenASMConfig as JConfig
from repro_torch import align as talign
from repro_torch.align import inputs
from repro_torch.core import genasm_tb as ttb
from repro_torch.core.genasm import GenASMConfig

W, O, K = 64, 24, 24
P_CAP, T_CAP = 128, 192


def window_inputs(seed: int, b: int = 12):
    """[b, W] windows cut from mutated pairs, plus per-lane commit caps."""
    rng = np.random.default_rng(seed)
    texts = np.full((b, W), 4, np.int8)
    pats = np.full((b, W), 4, np.int8)
    for i in range(b):
        pattern, text = inputs.mutated_pair(
            rng, int(rng.integers(30, 80)), n_sub=i % 4, n_ins=i % 3,
            n_del=(i + 1) % 3, t_extra=W)
        pats[i, :min(W, len(pattern))] = pattern[:W]
        texts[i] = text[:W]
        if i % 3 == 1:  # N (id 4) inside the pattern and the text
            pats[i, [3, 17]] = 4
            texts[i, 9] = 4
    cap_p = rng.integers(1, W - O + 1, size=b).astype(np.int32)
    return texts, pats, cap_p


def pair_batch(seed: int, b: int = 8):
    rng = np.random.default_rng(seed)
    pairs = [inputs.mutated_pair(rng, int(rng.integers(20, P_CAP - 8)),
                                 n_sub=i % 5, n_ins=i % 3, n_del=(i + 2) % 3,
                                 t_extra=48)
             for i in range(b)]
    texts, pats, p_lens, t_lens = inputs.padded_batch(pairs, P_CAP, T_CAP)
    for i in range(1, b, 3):  # N (id 4) inside p_len, in the read and text
        pats[i, [2, p_lens[i] // 2]] = 4
        texts[i, t_lens[i] // 3] = 4
    return texts, pats, p_lens, t_lens


def words(x) -> torch.Tensor:
    """A reference uint32 array as the port's int32 bit patterns (a copy)."""
    return torch.tensor(np.asarray(x).view(np.int32))


def assert_result_equal(got, want, what=""):
    """Every field of an `AlignResult` equal to the reference's; a field
    both leave out (``nodes`` on the linear backends) is None on both."""
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if g is None or w is None:
            assert g is None and w is None, f"{what}{name}"
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{what}{name}")


def assert_tb_equal(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("affine", [True, False])
def test_window_tb(affine):
    texts, pats, cap_p = window_inputs(3)
    d, tb = jax.vmap(partial(jdc.window_dc, w=W, k=K))(jnp.asarray(texts),
                                                      jnp.asarray(pats))
    d_start = jnp.minimum(d, K)
    ref = jax.vmap(partial(jtb.window_tb, w=W, o=O, k=K, affine=affine))(
        tb, d_start, jnp.asarray(cap_p))
    got = ttb.window_tb(words(tb),
                        torch.tensor(np.asarray(d_start)),
                        torch.from_numpy(cap_p), w=W, o=O, k=K, affine=affine)
    assert_tb_equal(got, ref)


@pytest.mark.parametrize("affine", [True, False])
def test_window_tb_r(affine):
    texts, pats, cap_p = window_inputs(4)
    d, store = jax.vmap(partial(jdc.window_dc_r, w=W, k=K))(jnp.asarray(texts),
                                                           jnp.asarray(pats))
    pm = jax.vmap(lambda p: jbv.pattern_bitmasks(p, W))(jnp.asarray(pats))
    d_start = jnp.minimum(d, K)
    ref = jax.vmap(partial(jtb.window_tb_r, w=W, o=O, k=K, affine=affine))(
        store, jnp.asarray(texts), pm, d_start, jnp.asarray(cap_p))
    got = ttb.window_tb_r(
        words(store),
        torch.from_numpy(texts), words(pm),
        torch.tensor(np.asarray(d_start)), torch.from_numpy(cap_p),
        w=W, o=O, k=K, affine=affine)
    assert_tb_equal(got, ref)


def test_cigar_counts():
    texts, pats, cap_p = window_inputs(5)
    d, tb = jax.vmap(partial(jdc.window_dc, w=W, k=K))(jnp.asarray(texts),
                                                      jnp.asarray(pats))
    _, _, _, ops, n_ops, _ = jax.vmap(partial(jtb.window_tb, w=W, o=O, k=K))(
        tb, jnp.minimum(d, K), jnp.asarray(cap_p))
    ref = jtb.cigar_counts(ops, n_ops)
    got = ttb.cigar_counts(torch.tensor(np.asarray(ops)),
                           torch.tensor(np.asarray(n_ops)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("port,ref", [("torch", "lax"), ("cuda_dc", "pallas_dc"),
                                      ("cuda_dc_v2", "pallas_dc_v2")])
def test_align_batch_matches_reference(port, ref):
    texts, pats, p_lens, t_lens = pair_batch(11)
    want = jalign.align_batch(jnp.asarray(texts), jnp.asarray(pats),
                              jnp.asarray(p_lens), jnp.asarray(t_lens),
                              cfg=JConfig(), backend=ref, p_cap=P_CAP)
    got = talign.align_batch(torch.from_numpy(texts), torch.from_numpy(pats),
                             torch.from_numpy(p_lens), torch.from_numpy(t_lens),
                             cfg=GenASMConfig(), backend=port, p_cap=P_CAP)
    assert_result_equal(got, want, f"{port} vs {ref}: ")
    assert np.asarray(want.failed).sum() < len(p_lens)  # real alignments


@pytest.mark.parametrize("cfg_kw", [dict(w=32, o=8, k=4), dict(store_r=True),
                                    dict(affine=False)])
@pytest.mark.parametrize("emit_cigar", [True, False])
def test_torch_backend_configs_match_lax(cfg_kw, emit_cigar):
    texts, pats, p_lens, t_lens = pair_batch(12, b=6)
    want = jalign.align_batch(jnp.asarray(texts), jnp.asarray(pats),
                              jnp.asarray(p_lens), jnp.asarray(t_lens),
                              cfg=JConfig(**cfg_kw), backend="lax", p_cap=P_CAP,
                              emit_cigar=emit_cigar)
    got = talign.align_batch(torch.from_numpy(texts), torch.from_numpy(pats),
                             torch.from_numpy(p_lens), torch.from_numpy(t_lens),
                             cfg=GenASMConfig(**cfg_kw), backend="torch",
                             p_cap=P_CAP, emit_cigar=emit_cigar)
    assert_result_equal(got, want)


def test_ref_backend_matches_reference_ref():
    texts, pats, p_lens, t_lens = pair_batch(13, b=4)
    want = jalign.align_batch(jnp.asarray(texts), jnp.asarray(pats),
                              jnp.asarray(p_lens), jnp.asarray(t_lens),
                              backend="ref", p_cap=P_CAP)
    got = talign.align_batch(torch.from_numpy(texts), torch.from_numpy(pats),
                             torch.from_numpy(p_lens), torch.from_numpy(t_lens),
                             backend="ref", p_cap=P_CAP)
    assert_result_equal(got, want)


def test_resolve_backend_by_device(monkeypatch):
    monkeypatch.delenv("REPRO_ALIGN_BACKEND", raising=False)
    assert talign.resolve_backend("auto", "cpu").name == "torch"
    assert talign.resolve_backend(None, torch.device("cuda", 0)).name == "cuda_dc"
    assert talign.resolve_backend("cuda_dc_v2", "cpu").name == "cuda_dc_v2"
    monkeypatch.setenv("REPRO_ALIGN_BACKEND", "cuda_dc_v2")
    assert talign.resolve_backend("auto", "cpu").name == "cuda_dc_v2"
    with pytest.raises(ValueError):
        talign.resolve_backend("lax")
