"""Port parity: the int8 KV cache's quantizer, bit for bit.

`repro_torch.models.transformer._quant` against the reference's own
lines: the reference quantizes inside `repro.models.transformer.
_slot_decode` (src/repro/models/transformer.py, its nested ``quant``),
so its attention slot runs here with ``decode_attention`` replaced by
one that returns chosen new K and V rows, and the int8 rows and bf16
scales it writes into the cache are read back.  The rows are seeded
normals in bf16, a row whose largest magnitude is 127 (scale exactly 1)
with entries at rounding halves (0.5, 1.5, 2.5, -0.5, -2.5: half to
even), a row of zeros (the 1e-8 scale floor) and rows of tiny and large
magnitudes.  The port divides by a tensor, so on a card it rounds as the
reference does (chip_smoke.py's lm phase holds the card against the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro_torch.models import transformer as ttr
from torch_lm_common import configs, jax_params

B, HKV, DH = 3, 2, 16


def _rows(seed: int) -> np.ndarray:
    """[B, 1, HKV, DH] float32 values exact in bf16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 1, HKV, DH)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[1, 0, 0] = 0.0  # an all-zero head: the scale floor
    x[1, 0, 1] *= 1e-6
    x[2, 0, 1] *= 3e4
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _reference_quant(jcfg, k, v):
    """The reference's int8 rows and scales of ``k``/``v`` [B, 1, Hkv, dh],
    written at position 0 by its own ``_slot_decode``."""
    params = jax_params(jcfg)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["slot0"])
    st = {"k": jnp.zeros((B, 4, HKV, DH), jnp.int8),
          "v": jnp.zeros((B, 4, HKV, DH), jnp.int8),
          "k_scale": jnp.zeros((B, 4, HKV), jnp.bfloat16),
          "v_scale": jnp.zeros((B, 4, HKV), jnp.bfloat16),
          "pos": jnp.full((4,), -1, jnp.int32)}
    x = jnp.zeros((B, 1, jcfg.d_model), jtr.COMPUTE_DTYPE)

    def chosen(cfg, p_, h, ck, cv, cpos, pos):
        return (jnp.zeros_like(h), jnp.asarray(k, jtr.COMPUTE_DTYPE),
                jnp.asarray(v, jtr.COMPUTE_DTYPE))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr.attn, "decode_attention", chosen)
        _, new = jtr._slot_decode(jcfg, p, st, x, jnp.int32(0), "attn")
    return {key: np.asarray(new[key][:, :1]) for key in
            ("k", "v", "k_scale", "v_scale")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_bit_for_bit_against_reference(seed):
    jcfg, _ = configs("yi-6b")
    assert (jcfg.n_kv_heads, jcfg.hd) == (HKV, DH)
    k, v = _rows(seed), _rows(seed + 10)
    want = _reference_quant(jcfg, k, v)
    for name, rows in (("k", k), ("v", v)):
        q, s = ttr._quant(torch.from_numpy(rows).to(ttr.COMPUTE_DTYPE))
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
        np.testing.assert_array_equal(q.numpy(), want[name])
        np.testing.assert_array_equal(s.float().numpy(),
                                      want[f"{name}_scale"].astype(np.float32))
    # the halves round to even, at scale exactly 1
    q, s = ttr._quant(torch.from_numpy(k).to(ttr.COMPUTE_DTYPE))
    assert float(s[0, 0, 0]) == 1.0
    assert q[0, 0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    assert float(s[1, 0, 0]) == pytest.approx(1e-8, rel=1e-2)
