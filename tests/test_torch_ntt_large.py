"""Port vs reference: the large-n four-step u64 NTT (``transforms/ntt_large.py``).

- ``large_forward64``/``large_inverse64`` on both routes (``"butterfly"``:
  the ``ntt64_*`` plain versions; ``"mxu8"``: the ``mxu8_*64`` plain
  versions, on sub-tables built from the same explicit roots) against the
  JAX functions at log_n 8, 9 and 10 (``tests/test_ntt_large.py:93-110``),
  which run ``pallas_forward64``/``pallas_inverse64`` in interpret mode;
- the sub-tables' roots (explicit powers of the top-level root) against
  ``GoldenNtt(root=)`` and the plan's twiddles against ``LargeNttPlan64``'s;
- the lazy forward (``out_factor=4``) round-trips through the inverse, and
  the route resolution follows the factors.

Inputs from a numpy seed; tolerance zero (bit-equal words).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.golden.model import GoldenNtt as JGolden
from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.transforms import ntt_large as jlarge
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.transforms import ntt_large

Q62 = 4611686018425815041  # 62-bit, 2^17 | q - 1 (the config-2 headline modulus)


@pytest.mark.parametrize("log_n,q", [(8, 1125899906826241), (9, 1152921504606830593), (10, Q62)])
def test_large_matches_reference(log_n, q):
    rng = np.random.default_rng(41 + log_n)
    x = rng.integers(0, q, (2, 1 << log_n), dtype=np.uint64)
    jplan, plan = jlarge.LargeNttPlan64(log_n, q), ntt_large.LargeNttPlan64(log_n, q)
    assert (plan.A, plan.B, plan.root) == (jplan.A, jplan.B, jplan.root)
    np.testing.assert_array_equal(u64_numpy(plan.tw), jfrom(jplan.tw))
    np.testing.assert_array_equal(u64_numpy(plan.t2_pre), jfrom(jplan.t2_pre))
    for mine, h, e in ((plan.ntt_a.plans[0], plan.h1, plan.B), (plan.ntt_b.plans[0], plan.h2,
                                                                plan.A)):
        ref = JGolden(h, q, pow(jplan.root, e, q))
        np.testing.assert_array_equal(u64_numpy(mine.roots), np.array(ref.roots, dtype=np.uint64))
    want_f = jfrom(jlarge.large_forward64(jplan, jto(x), 1))
    want_i = jfrom(jlarge.large_inverse64(jplan, jto(x), 1))
    for route in ("butterfly", "mxu8"):
        got_f = ntt_large.large_forward64(plan, u64_tensor(x), 1, route)
        np.testing.assert_array_equal(u64_numpy(got_f), want_f, err_msg=route)
        got_i = ntt_large.large_inverse64(plan, u64_tensor(x), 1, route)
        np.testing.assert_array_equal(u64_numpy(got_i), want_i, err_msg=route)
        lazy = ntt_large.large_forward64(plan, u64_tensor(x), 4, route)
        assert (u64_numpy(lazy) < 4 * q).all()
        np.testing.assert_array_equal(u64_numpy(ntt_large.large_inverse64(plan, lazy, 1, route)), x)


def test_routes_and_contract():
    small, big = ntt_large.LargeNttPlan64(8, Q62), ntt_large.LargeNttPlan64(16, Q62)
    assert ntt_large.resolve_route(small) == "butterfly"
    assert ntt_large.resolve_route(big) == "mxu8" and (big.A, big.B) == (256, 256)
    assert ntt_large.resolve_route(big, "butterfly") == "butterfly"
    with pytest.raises(ValueError):
        ntt_large.resolve_route(big, "xla")
    with pytest.raises(ValueError):
        ntt_large.large_forward64(small, torch.zeros((1, 256), dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        ntt_large.LargeNttPlan64(8, (1 << 62) + 1)
