"""Port vs reference: the u64 NTTs and the four kernels of the DCRT path.

- ``build_plan64`` tables and ``forward64``/``inverse64`` against JAX at
  log_n 4-8, every ``out_factor``;
- the butterfly kernels' plain versions (``ntt64_forward_plain``,
  ``ntt64_inverse_plain``) against ``pallas_forward64``/``pallas_inverse64``
  in interpret mode: bit-equal at ``out_factor=1``, equal mod q at the lazy
  factors (the TPU forward defers its reductions, so its lazy words differ);
  ``in_factor`` 2 and 4 on the inverse;
- ``Mxu8NttPlan64`` tables (cut to P operand planes) and the MXU plain
  versions against ``Mxu8NttPlan64``/``mxu8_fused_forward64``/
  ``mxu8_fused_inverse64`` in interpret mode at log_n=8 (A=2, B=128) for
  the two 50-bit moduli (7 planes) and the 60-bit golden prime (8 planes);
- a numpy model of the u64 MXU kernels' data flow (``csrc/ntt_mxu8.cu``:
  kernel-layout plane matrices, 8 unsigned operand bytes, the 2^32 split
  fold, the same indexing) equals the plain versions at 7 and 8 planes, on
  inputs past 2^63, so the tables the card reads are right before any card
  runs them; the same model with the fixed operand's key multiply (kernel
  D at load; the forward then D, the route whose words kernel E gives)
  equals the plain versions of ``mxu8_inverse64_mul`` and
  ``mxu8_roundtrip64_mul`` (kernel E's own schedule, on row 10's passes, is
  modelled in ``tests/test_torch_ntt_rt64_model.py``).

Tolerance: zero (bit-equal words), or equality mod q where stated.
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.ops import ntt_mxu8 as jmxu
from primus_fhe_tpu.ops.ntt_pallas import PallasNttPlan64, pallas_forward64, pallas_inverse64
from primus_fhe_tpu.transforms import ntt as jntt
from primus_fhe_tpu.transforms.plan import build_plan64 as jbuild_plan64
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
from primus_fhe_tpu_torch.transforms.ntt import forward64, inverse64
from primus_fhe_tpu_torch.transforms.plan import build_plan64

Q50 = [1125899906826241, 1125899906629633]
Q60 = 1152921504606830593
Q62 = 4611686018427322369  # lazy [0, 4q) words pass 2^63
M64 = (1 << 64) - 1


def _below(rng, q, factor, shape):
    return rng.integers(0, factor * q, shape, dtype=np.uint64)


@pytest.mark.parametrize("log_n,q", [(4, Q50[0]), (6, Q60), (8, Q50[1]), (5, Q62)])
def test_plan64_and_transforms_match_reference(log_n, q):
    rng = np.random.default_rng(log_n)
    plan, jplan = build_plan64(log_n, q), jbuild_plan64(log_n, q)
    for name in ("roots", "roots_precon", "inv_roots", "inv_roots_precon", "ordinal_roots"):
        np.testing.assert_array_equal(u64_numpy(getattr(plan, name)), jfrom(getattr(jplan, name)))
    for name in ("inv_n", "inv_n_precon", "inv_n_w", "inv_n_w_precon"):
        assert getattr(plan, name) == int(jfrom(getattr(jplan, name))), name
    np.testing.assert_array_equal(plan.monomial_base.numpy(), np.asarray(jplan.monomial_base))
    n = 1 << log_n
    x = _below(rng, q, 4, (3, n))
    for of in (1, 4):
        np.testing.assert_array_equal(u64_numpy(forward64(plan, u64_tensor(x), of)),
                                      jfrom(jntt.forward64(jplan, jto(x), of)))
    y = _below(rng, q, 2, (3, n))
    for of in (1, 2):
        np.testing.assert_array_equal(u64_numpy(inverse64(plan, u64_tensor(y), of)),
                                      jfrom(jntt.inverse64(jplan, jto(y), of)))


def _mod(a, q):
    return np.array([int(v) % q for v in np.ravel(a)], dtype=object)


@pytest.mark.parametrize("log_n,q", [(4, Q50[0]), (6, Q60), (8, Q50[1])])
def test_butterfly_plain_matches_pallas(log_n, q):
    n = 1 << log_n
    rng = np.random.default_rng(20 + log_n)
    moduli = [q]
    tables = ntt64.NttTables64(log_n, moduli)
    x = np.stack([_below(rng, q, 4, (2, n)) for q in moduli])
    for of in (1, 4):
        got = u64_numpy(ntt64.ntt64_forward(tables, u64_tensor(x), of))
        for i, q in enumerate(moduli):
            want = jfrom(pallas_forward64(PallasNttPlan64(log_n, q), jto(x[i]), of))
            if of == 1:
                np.testing.assert_array_equal(got[i], want)
            else:
                assert (got[i] < 4 * q).all()
                np.testing.assert_array_equal(_mod(got[i], q), _mod(want, q))
    for in_factor in (2, 4):
        y = np.stack([_below(rng, q, in_factor, (2, n)) for q in moduli])
        for of in (1, 2):
            got = u64_numpy(ntt64.ntt64_inverse(tables, u64_tensor(y), of, in_factor))
            for i, q in enumerate(moduli):
                want = jfrom(pallas_inverse64(PallasNttPlan64(log_n, q), jto(y[i]), of, 8,
                                              in_factor))
                if of == 1:
                    np.testing.assert_array_equal(got[i], want)
                else:
                    assert (got[i] < 2 * q).all()
                    np.testing.assert_array_equal(_mod(got[i], q), _mod(want, q))


@pytest.mark.parametrize("q", Q50 + [Q60])
def test_mxu8_plan64_and_plain_match_reference(q):
    """Tables and plain versions against the JAX byte-radix kernels at
    log_n=8; the four-step natural order is the butterfly's bit-reversed
    order at 7 and 8 planes."""
    rng = np.random.default_rng(q % 1000)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(8, [q]))
    jplan = jmxu.Mxu8NttPlan64(8, q)
    plan = tables.plans[0]
    assert (plan.planes, plan.A, plan.B) == (jplan.planes, jplan.A, jplan.B)
    for key, val in plan.jax_tables().items():
        np.testing.assert_array_equal(val, getattr(jplan, key), err_msg=key)
    x = rng.integers(0, q, (3, 256), dtype=np.uint64)
    got = u64_numpy(ntt_mxu8.mxu8_forward64(tables, u64_tensor(x)[None]))[0]
    np.testing.assert_array_equal(got, jfrom(jmxu.mxu8_fused_forward64(jplan, jto(x), 1)))
    got = u64_numpy(ntt_mxu8.mxu8_inverse64(tables, u64_tensor(x)[None]))[0]
    np.testing.assert_array_equal(got, jfrom(jmxu.mxu8_fused_inverse64(jplan, jto(x), 1)))


# -- a numpy model of the u64 MXU kernels ------------------------------------


def _bytes64(words, kb):
    """u64 words ``(m, k)`` -> their little-endian bytes ``(m, kb)``."""
    b = np.ascontiguousarray(words.astype(np.uint64)).view(np.uint8).reshape(words.shape[0], -1)
    out = np.zeros((b.shape[0], kb), dtype=np.int64)
    out[:, : b.shape[1]] = b
    return out


def _shoup(y, w, wp, q):
    """``w*y - q*hi(y*wp)`` mod 2^64 on object ints (csrc shoup64_lazy)."""
    return (w * y - q * ((y * wp) >> 64)) & M64


def _fold(d, P, c):
    """csrc ``fold_planes``: ``(L + off) + Shoup(H + off, 2^32 mod q)``."""
    lo = sum(d[:, c_] * (1 << (8 * c_)) for c_ in range(4))
    hi = sum(d[:, c_] * (1 << (8 * (c_ - 4))) for c_ in range(4, P))
    assert max(abs(v) for v in lo) < 2 ** 49.1 and max(abs(v) for v in hi) < 2 ** 49.1
    y = (lo + c["off"]) + _shoup(hi + c["off"], c["c32"], c["c32_p"], c["q"])
    assert max(y) < 1 << 64
    return y


def _planes64(op_bytes, w, P, np_, n_real, c):
    """The plane products + ``fold_planes``: ``(m, n_real)`` object words."""
    d = (op_bytes @ w.astype(np.int64).T).reshape(op_bytes.shape[0], P, np_)[:, :, :n_real]
    m = d.shape[0]
    flat = d.transpose(0, 2, 1).reshape(m * n_real, P).astype(object)
    return _fold(flat, P, c).reshape(m, n_real)


def _canonical(y, c):
    r = _shoup(y, 1, c["p1"], c["q"])
    return np.where(r >= c["q"], r - c["q"], r)


def _consts(tables, mi):
    pack = tables.ntt.mod_pack.reshape(-1, 9)[mi].astype(object)
    return dict(zip(("q", "inv_n", "inv_n_p", "inv_n_w", "inv_n_w_p", "c32", "c32_p", "p1",
                     "off"), (int(v) for v in pack)))


def _model(tables, mi, rows, inverse, key=None):
    """The forward (or inverse) kernel on ``rows (R, n)`` u64 -> ``(R, n)``;
    with ``key`` (``(2, n)`` object ints: values, Shoup quotients) the
    inverse is kernel D (the key multiply as each word is loaded) and the
    forward is the forward + D route (the key on the folded pass-2 word,
    then the inverse's two passes): kernel E's words."""
    tabs = {k: v.numpy() for k, v in tables.kernel_tables("cpu").items()}
    P, A, B, n = tables.planes, tables.A, tables.B, tables.n
    c = _consts(tables, mi)
    tw = tabs["tw"][mi].view(np.uint64).astype(object).reshape(4, A, B)
    R = rows.shape[0]
    wa, wb = (tabs["wi1"], tabs["wi2"]) if inverse else (tabs["w1"], tabs["w2"])
    wa, wb = wa[mi], wb[mi]
    if not inverse:
        x = rows.reshape(R, A, B).transpose(0, 2, 1).reshape(R * B, A)  # [(row, k0)][k1]
        X = _planes64(_bytes64(x, wa.shape[1]), wa, P, wa.shape[0] // P, A, c)  # (R*B, A)
        X = X.reshape(R, B, A).transpose(0, 2, 1)  # [row][r0][k0]
        Y = _shoup(X, tw[0][None], tw[1][None], c["q"]).reshape(R * A, B)
        F = _planes64(_bytes64(Y.astype(np.uint64), 8 * B), wb, P, B, B, c)
        if key is not None:
            return _model(tables, mi, _shoup(F.reshape(R, n), key[0], key[1], c["q"]), True)
        return _canonical(F, c).reshape(R, n)
    if key is not None:
        rows = _shoup(rows.astype(object), key[0], key[1], c["q"])
    Z = _planes64(_bytes64(rows.reshape(R * A, B), 8 * B), wa, P, B, B, c).reshape(R, A, B)
    Z = _shoup(Z, tw[2][None], tw[3][None], c["q"]).transpose(0, 2, 1).reshape(R * B, A)
    y = _planes64(_bytes64(Z.astype(np.uint64), wb.shape[1]), wb, P, wb.shape[0] // P, A, c)
    return _canonical(y, c).reshape(R, B, A).transpose(0, 2, 1).reshape(R, n)


@pytest.mark.parametrize("log_n,moduli", [(8, Q50), (8, [Q60, Q62]), (12, [Q50[0]])])
def test_mxu8_64_kernel_model_matches_plain(log_n, moduli):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    assert tables.planes == (7 if max(moduli) < 1 << 53 else 8)
    rng = np.random.default_rng(log_n + len(moduli))
    rows = 2 if log_n == 8 else 1
    x = rng.integers(0, 1 << 64, (len(moduli), rows, 1 << log_n), dtype=np.uint64)
    x[:, 0, :4] = [0, M64, 1 << 63, moduli[0]]
    fwd = u64_numpy(ntt_mxu8.mxu8_forward64(tables, u64_tensor(x)))
    inv = u64_numpy(ntt_mxu8.mxu8_inverse64(tables, u64_tensor(x)))
    for mi in range(len(moduli)):
        np.testing.assert_array_equal(_model(tables, mi, x[mi], False).astype(np.uint64), fwd[mi])
        np.testing.assert_array_equal(_model(tables, mi, x[mi], True).astype(np.uint64), inv[mi])


@pytest.mark.parametrize("log_n,moduli", [(8, Q50), (8, [Q60, Q62]), (12, [Q50[0]])])
def test_mxu8_64_mul_kernel_model_matches_plain(log_n, moduli):
    """Kernel D, and the forward + D route against kernel E's plain
    version, on the same tables: the fused key multiply."""
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    rng = np.random.default_rng(100 + log_n + len(moduli))
    n = 1 << log_n
    x = rng.integers(0, 1 << 64, (len(moduli), 2 if log_n == 8 else 1, n), dtype=np.uint64)
    x[:, 0, :4] = [0, M64, 1 << 63, moduli[0]]
    key = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    key[:, :2] = [[0, q - 1] for q in moduli]
    mt = tables.mul_table(u64_tensor(key))
    inv = u64_numpy(ntt_mxu8.mxu8_inverse64_mul(tables, u64_tensor(x), mt))
    rt = u64_numpy(ntt_mxu8.mxu8_roundtrip64_mul(tables, u64_tensor(x), mt))
    for mi in range(len(moduli)):
        k = u64_numpy(mt[mi]).astype(object)
        np.testing.assert_array_equal(_model(tables, mi, x[mi], True, k).astype(np.uint64), inv[mi])
        np.testing.assert_array_equal(_model(tables, mi, x[mi], False, k).astype(np.uint64), rt[mi])


def test_kernel_wrappers_refuse_other_devices():
    tables = ntt64.NttTables64(4, Q50)
    meta = torch.zeros((2, 1, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ntt64.ntt64_forward(tables, meta)
    with pytest.raises(ValueError):
        ntt_mxu8.mxu8_forward64(ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(8, Q50)),
                                torch.zeros((2, 1, 256), dtype=torch.int64, device="meta"))
