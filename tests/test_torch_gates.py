"""The slice as a whole: TOY gates through the port.

1. Keys made by the JAX package (``make_context(..., bsk_kind="ntt")``)
   pass through ``from_jax_context``; the port's ``bootstrap`` and
   NAND/AND/OR outputs must equal the JAX outputs bit for bit on all four
   input pairs (tolerance: zero).
2. The port's own torch-generated TOY context: truth tables, NOT and
   composition by decryption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu import params as jparams
from primus_fhe_tpu.boot import bootstrap as jax_bootstrap
from primus_fhe_tpu.boot import gates as jgates
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot import gates
from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap

TABLES = {
    "nand_gate": lambda a, b: not (a and b),
    "and_gate": lambda a, b: a and b,
    "or_gate": lambda a, b: a or b,
}


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def jax_ctx():
    jctx = jparams.make_context(jax.random.PRNGKey(1), jparams.TOY, bsk_kind="ntt")
    ctx = P.from_jax_context(
        jparams.TOY, np.asarray(jctx.bsk), np.asarray(jctx.ksk),
        np.asarray(jctx.lwe_secret), np.asarray(jctx.glwe_secret), device="cpu",
    )
    return jctx, ctx


def _jax_encrypt(key, bit, secret):
    a = jax.random.bits(key, secret.shape, dtype=jnp.uint32)
    mu = jgates.TRUE_MU if bit else jgates.FALSE_MU
    b = jnp.sum(a * secret, dtype=jnp.uint32) + jnp.uint32(mu)
    return jnp.concatenate([a, b[None]])


def test_from_jax_context_shapes(jax_ctx):
    jctx, ctx = jax_ctx
    assert ctx.conv.primes == list(jctx.conv.primes)
    assert ctx.bsk.shape == tuple(jctx.bsk.shape)
    assert ctx.ksk.shape == tuple(jctx.ksk.shape)


def test_bootstrap_bit_equal_on_jax_keys(jax_ctx):
    jctx, ctx = jax_ctx
    p = jparams.TOY
    rng = np.random.default_rng(3)
    cts = rng.integers(0, 1 << 32, (4, p.lwe_dim + 1), dtype=np.uint64).astype(np.uint32)
    tp = np.full(p.n, 1 << 28, dtype=np.uint32)
    want = np.asarray(
        jax_bootstrap(jctx.conv, jctx.basis, jctx.bsk, jnp.asarray(cts), jnp.asarray(tp), p.log_n)
    ).astype(np.int64)
    got = bootstrap(ctx.conv, ctx.basis, ctx.bsk, _t(cts), _t(tp), p.log_n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_gate_bit_equal_on_jax_keys(jax_ctx, name):
    jctx, ctx = jax_ctx
    p = jparams.TOY
    key = jax.random.PRNGKey(9)
    for b1 in (0, 1):
        for b2 in (0, 1):
            kk = jax.random.fold_in(key, 2 * b1 + b2)
            c1 = _jax_encrypt(jax.random.fold_in(kk, 0), b1, jctx.lwe_secret)
            c2 = _jax_encrypt(jax.random.fold_in(kk, 1), b2, jctx.lwe_secret)
            want = getattr(jgates, name)(
                jctx.conv, jctx.basis, jctx.bsk, jctx.ksk, jctx.ks_basis, c1, c2, p.log_n
            )
            got = getattr(gates, name)(
                ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis, _t(c1), _t(c2), p.log_n
            )
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
            assert bool(ctx.decrypt(got)) == TABLES[name](b1, b2), (b1, b2)


@pytest.fixture(scope="module")
def torch_ctx():
    g = torch.Generator().manual_seed(2)
    return P.make_context(P.TOY, "cpu", g), g


@pytest.mark.parametrize("name", sorted(TABLES))
def test_gate_truth_table_on_port_keys(torch_ctx, name):
    ctx, g = torch_ctx
    a = torch.tensor([0, 0, 1, 1])
    b = torch.tensor([0, 1, 0, 1])
    out = getattr(gates, name)(
        ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis, ctx.encrypt(a, g), ctx.encrypt(b, g),
        ctx.params.log_n,
    )
    assert out.shape == (4, ctx.params.lwe_dim + 1)
    want = [TABLES[name](int(x), int(y)) for x, y in zip(a, b)]
    assert ctx.decrypt(out).tolist() == want


def test_not_and_composition_on_port_keys(torch_ctx):
    ctx, g = torch_ctx
    bits = torch.tensor([0, 1])
    assert ctx.decrypt(gates.not_gate(ctx.encrypt(bits, g))).tolist() == [True, False]
    a = ctx.encrypt(torch.tensor([1, 1, 0]), g)
    b = ctx.encrypt(torch.tensor([1, 0, 0]), g)
    args = (ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis)
    nand = gates.nand_gate(*args, a, b, ctx.params.log_n)
    out = gates.nand_gate(*args, nand, nand, ctx.params.log_n)
    assert ctx.decrypt(out).tolist() == [True, False, False]


def test_make_context_keeps_noise_widths_apart():
    """bsk at glwe_sigma, ksk rows and fresh encryptions at lwe_sigma: with
    lwe_sigma = 4e4 >> glwe_sigma = 3.2 a bootstrap of the port's own key
    stays near 2^28 (a bsk keyed at lwe_sigma scrambles it)."""
    import dataclasses

    p = dataclasses.replace(P.TOY, lwe_sigma=4.0e4, glwe_sigma=3.2)
    g = torch.Generator().manual_seed(6)
    ctx = P.make_context(p, "cpu", g)
    assert ctx.gaussian.sigma == p.lwe_sigma
    bits = torch.arange(64) % 2 == 0
    cts = ctx.encrypt(bits, g)
    tp = torch.full((p.n,), 1 << 28, dtype=torch.int64)
    out = bootstrap(ctx.conv, ctx.basis, ctx.bsk, cts, tp, p.log_n)
    from primus_fhe_tpu_torch.lattice.lwe import phase_torus32

    ph = phase_torus32(out, ctx.glwe_secret.reshape(-1))
    ph = torch.where(ph >= 1 << 31, ph - (1 << 32), ph)
    assert ((ph > 0) == bits).all()
    assert ((ph.abs() - (1 << 28)).abs() < 1 << 27).all()


def test_test_polynomials_match_reference():
    # the boot packages export a function named blind_rotate, so import
    # the names from their modules directly
    from primus_fhe_tpu.boot.blind_rotate import lut_test_polynomial as jax_lut
    from primus_fhe_tpu.boot.blind_rotate import test_polynomial as jax_sign
    from primus_fhe_tpu_torch.boot.blind_rotate import lut_test_polynomial as port_lut
    from primus_fhe_tpu_torch.boot.blind_rotate import test_polynomial as port_sign

    np.testing.assert_array_equal(port_sign(64, 2).numpy(), jax_sign(64, 2).astype(np.int64))
    values = np.array([0, 1 << 29, 1 << 30, 3 << 29], dtype=np.uint32)
    np.testing.assert_array_equal(
        port_lut(values, 6, 2).numpy(), np.asarray(jax_lut(values, 6, 2)).astype(np.int64)
    )


def test_gate_noise_prediction_composes_the_model():
    """BOOLEAN_128: blind rotation (drop 11 bits) then the 2^1 x 12 key
    switch (drop 20 bits), by primus_fhe_tpu.noise."""
    from primus_fhe_tpu import noise

    p = P.BOOLEAN_128
    br = noise.blind_rotate(p.lwe_dim, p.glwe_sigma, p.n, p.glwe_dim, p.level, p.log_basis, 11)
    ks = noise.key_switch(br, p.lwe_sigma, p.n, p.ks_level, p.ks_log_basis, 20)
    assert P.gate_noise_stddev(p) == ks.stddev


def test_modulus_switch_and_extract_match_reference():
    from primus_fhe_tpu.boot.blind_rotate import modulus_switch as jax_switch
    from primus_fhe_tpu.lattice.rlwe import extract_lwe_torus32 as jax_extract
    from primus_fhe_tpu_torch.boot.blind_rotate import modulus_switch
    from primus_fhe_tpu_torch.lattice.rlwe import extract_lwe_torus32

    rng = np.random.default_rng(13)
    lwe = rng.integers(0, 1 << 32, (5, 33), dtype=np.uint64).astype(np.uint32)
    lwe[0, :4] = [0, (1 << 32) - 1, (1 << 31) - 1, 1 << 31]
    for log_2n in (6, 12):
        got = modulus_switch(_t(lwe), log_2n)
        assert got.dtype == torch.int32
        want = np.asarray(jax_switch(jnp.asarray(lwe), log_2n)).astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), want)
    glwe = rng.integers(0, 1 << 32, (3, 2, 32), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        extract_lwe_torus32(_t(glwe)).numpy(),
        np.asarray(jax_extract(jnp.asarray(glwe))).astype(np.int64),
    )
