"""The MXU bootstrap key past kernel A's caps, on the CPU.

- ``mxu_step_route``: kernel A wherever its C entry takes the shape
  (BOOLEAN_128), else the NTT key's route (``"fused"`` at log_n 12 with
  k1 L = 6, ``"staged"`` past the fused step and at log_n 13-26, where the
  card is not asked), a ``ValueError`` past every route (log_n 27, 5
  primes, log_n 7) and for a gadget basis of 2^16 (``digit_planes``); the
  C entry's answers stand in a fake library here, its real ones are held
  on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``
  phase 22.1);
- ``mxu_holds``: the shape it asks the C entry, its cache, and the C
  entry's refusal against a CUDA error;
- at log_n 8-9 with k = 1 and 2, on JAX-made MXU keys (JAX
  ``prepare_mxu_bsk``), the staged functions (``cmux_stage1`` then
  ``cmux_stage2`` on the pack's values) and ``CmuxStepPlan`` on the
  pack's values on CPU tensors equal JAX ``mxu_cmux_step_nat`` (Pallas in
  interpret mode);
- ``prepare_mxu_bsk`` at log_n 13 on 4 rows a prime equals the JAX's
  (values and Shoup quotients), and ``plan_for`` there builds no int8
  plane matrix.

Tolerance: zero (bit-equal words).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu.ops import cmux_mxu as jcm
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import build, cmux_fused, cmux_mxu


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


class FakeCard:
    """Stands in for the kernels' library: ``pft_cmux_mxu_clusters``
    returns ``rc`` (0: the card holds one cluster; 1, cudaErrorInvalidValue:
    the C entry refuses the shape; anything else a CUDA error) and records
    each shape asked."""

    def __init__(self, rc: int):
        self.rc, self.asked = rc, []

    def pft_cmux_mxu_clusters(self, ntru, kp, k1, log_n, dp, level, cl, addr):
        self.asked.append((ntru, kp, k1, log_n, dp, level, cl))
        ctypes.c_int.from_address(addr).value = 1 if self.rc == 0 else 0
        return self.rc

    def pft_error_string(self, err):
        return b"fake"


@pytest.fixture
def fake_card(monkeypatch):
    """``fake_card(rc)`` puts a :class:`FakeCard` in the library's place,
    with ``mxu_holds``' cache cleared before and after."""
    def make(rc):
        lib = FakeCard(rc)
        monkeypatch.setattr(build, "library", lambda: lib)
        cmux_mxu.mxu_holds.cache_clear()
        return lib
    yield make
    cmux_mxu.mxu_holds.cache_clear()


@pytest.mark.parametrize("kp,k1,level,log_n,dp,rc,want", [
    (2, 2, 3, 11, 1, 0, "mxu"),  # BOOLEAN_128
    (2, 2, 2, 12, 1, 0, "mxu"),
    (2, 2, 3, 12, 1, 1, "fused"),  # BOOLEAN_128's gadget at N = 4096: k1 L = 6
    (4, 1, 20, 10, 1, 1, "staged"),  # 20 levels: past the fused step too
    (2, 2, 3, 13, 1, None, "staged"), (2, 2, 3, 14, 1, None, "staged"),
    (2, 2, 3, 15, 1, None, "staged"), (3, 2, 3, 16, 2, None, "staged"),
    (2, 2, 3, 17, 1, None, "staged"),
])
def test_route(fake_card, kp, k1, level, log_n, dp, rc, want):
    lib = fake_card(2 if rc is None else rc)  # 13-17: never asked, so never an error
    assert cmux_mxu.mxu_step_route(kp, k1, level, log_n, dp) == want
    assert lib.asked == ([] if rc is None else [(0, kp, k1, log_n, dp, level, 1)])


@pytest.mark.parametrize("kp,k1,level,log_n,dp,match", [
    (2, 2, 3, 27, 1, "log_n = 27"), (5, 2, 3, 13, 1, "kp = 5"), (2, 2, 3, 7, 1, "log_n >= 8"),
    (2, 2, 33, 13, 1, "L = 33"), (2, 2, 3, 11, 3, "digit planes"),
])
def test_route_refuses(kp, k1, level, log_n, dp, match):
    with pytest.raises(ValueError, match=match):
        cmux_mxu.mxu_step_route(kp, k1, level, log_n, dp)


def test_route_refuses_a_basis_of_2_16():
    basis = ApproxSignedBasis32(None, 16, reverse_length=2)
    with pytest.raises(ValueError, match="2\\^15"):
        cmux_mxu.digit_planes(basis)
    with pytest.raises(ValueError, match="digit planes"):
        cmux_mxu.mxu_step_route(2, 2, 2, 13, 3)


@pytest.mark.parametrize("ntru", [False, True])
@pytest.mark.parametrize("rc,want", [(0, True), (1, False), (2, None)])
def test_mxu_holds_asks_the_c_entry(fake_card, ntru, rc, want):
    """One question a shape (cached), at ``cl = 1``; the C entry's refusal
    is ``False`` and any other CUDA error raises."""
    lib = fake_card(rc)
    if want is None:
        with pytest.raises(RuntimeError, match="CUDA error 2"):
            cmux_mxu.mxu_holds(ntru, 1, 1, 6, 10, 1)
    else:
        for _ in range(2):
            assert cmux_mxu.mxu_holds(ntru, 1, 1, 6, 10, 1) is want
    assert lib.asked == [(int(ntru), 1, 1, 10, 1, 6, 1)]
    assert not cmux_mxu.mxu_holds(ntru, 1, 1, 6, 13, 1) and len(lib.asked) == 1


# (log_n, k, log_basis, level, batch)
STEP_SHAPES = [(8, 1, 8, 2, 2), (9, 2, 7, 2, 1)]


@pytest.mark.parametrize("log_n,k,log_basis,level,bsz", STEP_SHAPES)
def test_staged_step_matches_jax(log_n, k, log_basis, level, bsz):
    n, k1 = 1 << log_n, k + 1
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    jbasis = JaxBasis(None, log_basis, reverse_length=level)
    jconv = jtfhe.make_convolver(log_n, level, k, log_basis)
    assert conv.primes == list(jconv.primes)
    rng = np.random.default_rng(log_n * 10 + k)
    acc = rng.integers(0, 1 << 32, (bsz, k1, n), dtype=np.uint64).astype(np.uint32)
    degrees = np.array([1, 2 * n - 1][:bsz] if bsz > 1 else [n + 3], dtype=np.int32)
    ggsw = rng.integers(0, 1 << 32, (1, k1, level, k1, n), dtype=np.uint64).astype(np.uint32)
    jkv, jkpre = (x[0] for x in jcm.prepare_mxu_bsk(jconv, jnp.asarray(ggsw)))
    jplan = jcm.get_plan(log_n, tuple(jconv.primes), jconv.product)
    want = jcm.mxu_cmux_step_nat(jplan, jbasis, jplan.crt_consts(jconv.product),
                                 jnp.asarray(acc).reshape(bsz, k1, jplan.A, jplan.B),
                                 jnp.asarray(degrees), jkv, jkpre, k1, level)
    want = np.asarray(want).reshape(bsz, k1, n).astype(np.int64)
    kv = _t(jkv)
    f = cmux_fused.cmux_stage1(conv, basis, _t(acc), torch.from_numpy(degrees))
    got = cmux_fused.cmux_stage2(conv, f, kv.reshape(conv.count, k1, level, k1, n), _t(acc))
    np.testing.assert_array_equal(got.numpy(), want)
    step = cmux_fused.CmuxStepPlan(conv, basis, k1, "cpu")
    got32 = step(_t(acc).to(torch.int32), torch.from_numpy(degrees),
                 kv.to(torch.int32).reshape(conv.count, k1, level, k1, n))
    np.testing.assert_array_equal((got32.to(torch.int64) & 0xFFFFFFFF).numpy(), want)


def test_prepare_mxu_bsk_at_log_n_13_matches_jax():
    conv = tfhe.make_convolver(13, 1, 1, 7)
    jconv = jtfhe.make_convolver(13, 1, 1, 7)
    plan = cmux_mxu.plan_for(conv)
    assert plan._per_prime is None  # nothing built for kernel A
    ggsw = np.random.default_rng(13).integers(0, 1 << 32, (1, 2, 1, 2, 1 << 13),
                                              dtype=np.uint64).astype(np.uint32)
    kv, kpre = cmux_mxu.prepare_mxu_bsk(conv, _t(ggsw))
    jkv, jkpre = jcm.prepare_mxu_bsk(jconv, jnp.asarray(ggsw))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv).astype(np.int64))
    np.testing.assert_array_equal(kpre.numpy(), np.asarray(jkpre).astype(np.int64))
    assert plan._per_prime is None
