"""Port vs the JAX package: row 12, the per-residue byte-radix NTT of the
residue-sharded DCRT path (``primus_fhe_tpu_torch/ops/ntt_mxu8_dyn.py``).

The JAX ``mxu8_dyn_forward64``/``mxu8_dyn_inverse64`` (interpret mode, as
``tests/test_mxu8_dyn.py`` runs them) on one residue's slice of
``stack_dyn_tables``/``stack_dyn_inv_tables`` against the port's
``mxu8_forward64``/``mxu8_inverse64`` on the tables of that residue's shard
plan (``stack_dyn_plans``; on the CPU the plain ``mxu8_forward64_plain``/
``mxu8_inverse64_plain``):
two 50-bit moduli (7 planes, each its own shard) at ``out_factor`` 1 and 4,
and a 60-bit modulus (8 planes), log_n 8.  The lazy-word rule of
``ops/ntt_mxu8.py``: at ``out_factor`` 1 word-equal; above it the port's
words are congruent to the JAX's mod q and below ``out_factor * q`` (the
JAX forward may leave words in ``[0, 4q)`` at ``out_factor`` 4, the port's
are canonical).

Tolerance: zero (exact integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from primus_fhe_tpu.numeric.limb import from_u64_pair, to_u64_pair
from primus_fhe_tpu.ops.ntt_mxu8_dyn import (
    mxu8_dyn_forward64 as jforward,
    mxu8_dyn_inverse64 as jinverse,
    stack_dyn_inv_tables,
    stack_dyn_tables,
)
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt_mxu8, ntt_mxu8_dyn
from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64

LOG_N = 8
MODULI50 = [1125899906826241, 1125899906629633]
Q60 = 1152921504606830593


def test_shard_plans_split_the_residues():
    plan = build_dcrt_plan64(LOG_N, MODULI50 + [Q60, 1152921504606748673])
    shards = ntt_mxu8_dyn.stack_dyn_plans(plan, 2)
    assert [s.moduli for s in shards] == [tuple(MODULI50), (Q60, 1152921504606748673)]
    assert [s.mxu.planes for s in shards] == [7, 8]
    with pytest.raises(ValueError):
        ntt_mxu8_dyn.stack_dyn_plans(plan, 3)


@pytest.mark.parametrize("moduli,index,out_factor", [
    (MODULI50, 0, 1), (MODULI50, 1, 4), ([Q60], 0, 1)])
def test_dyn_transforms_match_jax(moduli, index, out_factor):
    q = moduli[index]
    rng = np.random.default_rng(index + out_factor)
    x = rng.integers(0, q, size=(2, 1 << LOG_N), dtype=np.uint64)
    shard = ntt_mxu8_dyn.stack_dyn_plans(build_dcrt_plan64(LOG_N, moduli), len(moduli))[index]
    assert shard.moduli == (q,)

    fwd, shapes = stack_dyn_tables(LOG_N, moduli)
    want = from_u64_pair(jforward(tuple(jnp.asarray(t[index]) for t in fwd), shapes,
                                  to_u64_pair(x), out_factor))
    got = ntt_mxu8.mxu8_forward64(shard.mxu, u64_tensor(x)[None], out_factor)[0]
    np.testing.assert_array_equal(u64_numpy(got), want % np.uint64(q))
    assert (u64_numpy(got).astype(object) < out_factor * q).all()
    assert (want.astype(object) < out_factor * q).all()
    if out_factor == 1:
        np.testing.assert_array_equal(u64_numpy(got), want)
    np.testing.assert_array_equal(
        u64_numpy(got), u64_numpy(ntt_mxu8.mxu8_forward64_plain(shard.mxu, u64_tensor(x)[None])[0]))

    inv, ishapes = stack_dyn_inv_tables(LOG_N, moduli)
    f = want % np.uint64(q)
    want_i = from_u64_pair(jinverse(tuple(jnp.asarray(t[index]) for t in inv), ishapes,
                                    to_u64_pair(f), 1))
    got_i = ntt_mxu8.mxu8_inverse64(shard.mxu, u64_tensor(f)[None])[0]
    np.testing.assert_array_equal(u64_numpy(got_i), want_i)
    np.testing.assert_array_equal(want_i, x)
