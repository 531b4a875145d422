"""Noise-tracked gates and key files, against the JAX package, at TOY.

- The port's ``tracked`` module on JAX-made TOY keys
  (``from_jax_context(..., device="cpu")``): the same ciphertext words and
  the same variances (the same float formulas) as the JAX ``tracked`` on
  the same inputs, for the linear ops, ``bootstrap`` and NAND/AND/OR, and
  the same "unsafe" refusal.
- ``noise.py``'s bookkeeping extras equal the JAX's floats.
- Key files go both ways: a JAX ``save_keys`` file loads in the port
  (``load_keys(device="cpu")``) and its gates give the JAX's words; a port
  ``save_keys`` file loads in the JAX package with equal arrays, and both
  files hold the same names, dtypes and shapes.
Tolerance: none (exact integers; variances as equal floats).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu import noise as jnoise
from primus_fhe_tpu import params as jparams
from primus_fhe_tpu import tracked as jtracked
from primus_fhe_tpu_torch import noise, tracked
from primus_fhe_tpu_torch import params as P

KINDS = ("nand", "and", "or")


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def ctxs():
    jctx = jparams.make_context(jax.random.PRNGKey(33), jparams.TOY, bsk_kind="ntt")
    ctx = P.from_jax_context(jparams.TOY, np.asarray(jctx.bsk), np.asarray(jctx.ksk),
                             np.asarray(jctx.lwe_secret), np.asarray(jctx.glwe_secret),
                             device="cpu")
    return jctx, ctx


@pytest.fixture(scope="module")
def inputs(ctxs):
    """JAX-encrypted bits for the four input pairs, as one batch of 4."""
    jctx, _ = ctxs
    key = jax.random.PRNGKey(2)
    pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]
    ja = [jtracked.encrypt_bit(jctx, jax.random.fold_in(key, 2 * i), a)
          for i, (a, _) in enumerate(pairs)]
    jb = [jtracked.encrypt_bit(jctx, jax.random.fold_in(key, 2 * i + 1), b)
          for i, (_, b) in enumerate(pairs)]
    stack = lambda cs: jtracked.TrackedLwe(jnp.stack([c.ct for c in cs]), cs[0].noise)  # noqa: E731
    return stack(ja), stack(jb), pairs


def _port(j: "jtracked.TrackedLwe") -> tracked.TrackedLwe:
    return tracked.TrackedLwe(_t(j.ct), noise.NoiseEstimate(j.noise.variance))


def _same(got: tracked.TrackedLwe, want):
    np.testing.assert_array_equal(got.ct.numpy(), np.asarray(want.ct).astype(np.int64))
    assert got.noise.variance == want.noise.variance


def test_noise_extras_equal_the_jax_floats():
    for sigma in (3.2, 2.0**18.6):
        f, jf = noise.fresh_lwe(sigma), jnoise.fresh_lwe(sigma)
        assert f.variance == jf.variance and f.bits() == jf.bits()
        for mb in (1, 2, 4):
            assert f.decryption_failure_margin(mb) == jf.decryption_failure_margin(mb)
        assert noise.add(f, f).variance == jnoise.add(jf, jf).variance
        assert noise.scalar_mul(f, -3).variance == jnoise.scalar_mul(jf, -3).variance
        args = (3.2, 2048, 1, 3, 7, 11)
        assert noise.cmux(f, *args).variance == jnoise.cmux(jf, *args).variance
        assert noise.modulus_switch(f, 630, 12).variance == jnoise.modulus_switch(jf, 630, 12).variance
    assert noise.NoiseEstimate(0.0).bits() == jnoise.NoiseEstimate(0.0).bits() == 0.0


def test_linear_ops_words_and_variances(ctxs, inputs):
    jctx, ctx = ctxs
    ja, jb, _ = inputs
    a, b = _port(ja), _port(jb)
    _same(tracked.add(a, b), jtracked.add(ja, jb))
    _same(tracked.sub(a, b), jtracked.sub(ja, jb))
    _same(tracked.neg(a), jtracked.neg(ja))
    _same(tracked.scalar_mul(a, 3), jtracked.scalar_mul(ja, 3))
    _same(tracked.scalar_mul(a, -5), jtracked.scalar_mul(ja, -5))
    _same(tracked.trivial(ctx, -(1 << 29)), jtracked.trivial(jctx, -(1 << 29)))
    pre, jpre = tracked.pre_rotation_noise(ctx, a.noise), jtracked.pre_rotation_noise(jctx, ja.noise)
    assert pre.variance == jpre.variance and a.margin(2) == ja.margin(2)
    np.testing.assert_array_equal(tracked.decrypt_phase(ctx, a).numpy(),
                                  jtracked.decrypt_phase(jctx, ja))
    # the port's own fresh encryptions carry the JAX's fresh noise
    g = torch.Generator().manual_seed(1)
    fresh = tracked.encrypt_bit(ctx, g, torch.tensor([0, 1, 1]))
    assert fresh.ct.shape == (3, ctx.params.lwe_dim + 1)
    assert fresh.noise.variance == ja.noise.variance
    assert (tracked.decrypt_phase(ctx, fresh) > 0).tolist() == [False, True, True]


@pytest.mark.parametrize("kind", KINDS)
def test_gate_words_and_variances(ctxs, inputs, kind):
    jctx, ctx = ctxs
    ja, jb, pairs = inputs
    want = jtracked.gate(jctx, kind, ja, jb)
    got = tracked.gate(ctx, kind, _port(ja), _port(jb))
    _same(got, want)
    truth = {"nand": lambda x, y: not (x and y), "and": lambda x, y: x and y,
             "or": lambda x, y: x or y}[kind]
    assert (tracked.decrypt_phase(ctx, got) > 0).tolist() == [bool(truth(x, y)) for x, y in pairs]
    assert got.margin(2) == want.margin(2) > 1


def test_bootstrap_words_and_unsafe_refusal(ctxs, inputs):
    jctx, ctx = ctxs
    ja, _, _ = inputs
    _same(tracked.bootstrap(ctx, _port(ja)), jtracked.bootstrap(jctx, ja))
    bad, jbad = (tracked.TrackedLwe(_t(ja.ct), noise.NoiseEstimate(2.0**58)),
                 jtracked.TrackedLwe(ja.ct, jnoise.NoiseEstimate(2.0**58)))
    with pytest.raises(ValueError, match="unsafe") as e1:
        tracked.gate(ctx, "nand", bad, bad)
    with pytest.raises(ValueError, match="unsafe") as e2:
        jtracked.gate(jctx, "nand", jbad, jbad)
    assert str(e1.value) == str(e2.value)


def test_key_files_load_both_ways(ctxs, inputs, tmp_path):
    jctx, ctx = ctxs
    ja, jb, _ = inputs
    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jparams.save_keys(str(jpath), jctx)
    P.save_keys(ppath, ctx)
    with np.load(jpath) as zj, np.load(ppath) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for name in zj.files:
            assert zj[name].dtype == zp[name].dtype and zj[name].shape == zp[name].shape, name
            np.testing.assert_array_equal(zj[name], zp[name])
    loaded = P.load_keys(jpath, device="cpu")
    assert loaded.params == P.TOY and loaded.conv.primes == ctx.conv.primes
    for name in ("bsk", "ksk", "lwe_secret", "glwe_secret"):
        assert torch.equal(getattr(loaded, name), getattr(ctx, name)), name
    _same(tracked.gate(loaded, "nand", _port(ja), _port(jb)), jtracked.gate(jctx, "nand", ja, jb))
    back = jparams.load_keys(str(ppath))
    assert back.params == jctx.params
    for name in ("bsk", "ksk", "lwe_secret", "glwe_secret"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jctx, name)))


def test_save_keys_refuses_the_mxu_pack(ctxs, tmp_path):
    jctx, ctx = ctxs
    with pytest.raises(ValueError) as e1:
        P.save_keys(tmp_path / "x.npz", dataclasses.replace(ctx, bsk=(ctx.bsk, ctx.bsk)))
    with pytest.raises(ValueError) as e2:
        jparams.save_keys(str(tmp_path / "y.npz"),
                          dataclasses.replace(jctx, bsk=(jctx.bsk, jctx.bsk)))
    assert str(e1.value) == str(e2.value)
    good, bad = tmp_path / "ok.npz", tmp_path / "bad.npz"
    P.save_keys(good, ctx)
    with np.load(good) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["bsk"] = arrays["bsk"].copy()
    arrays["bsk"].reshape(-1)[0] = 0xFFFFFFFF  # not a residue of any 30-bit prime
    np.savez_compressed(bad, **arrays)
    with pytest.raises(ValueError, match="canonical residue"):
        P.load_keys(bad, device="cpu")
