"""The port at the rings the card took last: N = 2^17 for kernels 1-2, F, G,
H and J, log_w 17 for row 11, on the CPU.

- the bootstrap key made in chunks of LWE indices (``make_bootstrap_key``,
  whose draws stay one batch) equals the one-batch key of the same draws,
  word for word, and leaves the generator where the one-batch key does; so
  do the NTRU keys (``make_ntru_keys``: both evaluation-key forms, made by
  ``make_ntru_evks`` in chunks, and the key-switch key after them);
- every wrapper's ring cap is 2^17 (the C entries' ``MAX_LOG_N``,
  ``FG_MAX_LOG_N``, ``H_MAX_LOG_N``, ``J_MAX_LOG_N``, ``ST_MAX_LOG_W``), and
  row 11's launch refuses log_w 18 by name before it reads the device.

Tolerance: zero (bit-equal words).
"""

import dataclasses
import importlib
import pathlib
import re

import pytest
import torch

from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian, sample_binary, sample_uniform
from primus_fhe_tpu_torch.lattice.ntru import to_ntt
from primus_fhe_tpu_torch.ops.ntru_cmux_mxu import prepare_mxu_evk
from primus_fhe_tpu_torch.ops import cmux_fused, ntt32, ntt_stages, rotate

br = importlib.import_module("primus_fhe_tpu_torch.boot.blind_rotate")


@pytest.mark.parametrize("indices", [1, 3])
def test_chunked_bootstrap_key_equals_one_batch(monkeypatch, indices):
    """TOY (N = 32, n_lwe 8): chunks of one LWE index and of three (the last
    ragged), against the GGSWs encrypted in one batch and transformed
    together."""
    ctx = P.make_context(P.TOY, "cpu", torch.Generator().manual_seed(5), bsk_kind="ntt")
    per_index = ctx.conv.count * (P.TOY.glwe_dim + 1) ** 2 * P.TOY.level * P.TOY.n
    monkeypatch.setattr(br, "KEY_CHUNK_WORDS", indices * per_index)
    g_chunked, g_batch = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    key = br.make_bootstrap_key(ctx.lwe_secret, ctx.glwe_secret, ctx.basis, ctx.gaussian,
                                ctx.conv, g_chunked)
    one = ctx.conv.forward(br._bsk_coeff(ctx.lwe_secret, ctx.glwe_secret, ctx.basis,
                                         ctx.gaussian, ctx.conv, g_batch)).movedim(0, 1)
    assert key.is_contiguous() and key.shape == one.shape
    assert torch.equal(key, one)
    assert torch.equal(g_chunked.get_state(), g_batch.get_state())


def test_ring_caps_are_2_17():
    """The Python caps, and kernels F and G's C constant, which
    ``rotate.check_row`` reads from the library on the card."""
    source = (pathlib.Path(rotate.__file__).parent.parent / "csrc" / "cmux_front.cu").read_text()
    assert re.search(r"constexpr int FG_MAX_LOG_N = (\d+);", source).group(1) == "17"
    assert ntt32.MAX_LOG_N == 17
    assert cmux_fused.STAGED_LOG_N == (4, 17)
    assert ntt_stages.MAX_LOG_W32 == ntt_stages.MAX_LOG_W64 == 17


@pytest.mark.parametrize("wrapper,cap", [
    (ntt_stages.ntt32_stages_forward, ntt_stages.MAX_LOG_W32),
    (ntt_stages.ntt32_stages_inverse, ntt_stages.MAX_LOG_W32),
    (ntt_stages.ntt64_stages_forward, ntt_stages.MAX_LOG_W64),
    (ntt_stages.ntt64_stages_inverse, ntt_stages.MAX_LOG_W64),
])
def test_stage_launch_refuses_log_w_18_by_name(wrapper, cap):
    """The launch's first check names the cap, before any table, shape or
    device is read; the launch count does not move."""
    x = torch.zeros((1, 1 << 18), dtype=torch.int64)
    before = wrapper.launches
    with pytest.raises(ValueError, match="log_w <= 17"):
        ntt_stages._launch(wrapper, "unused", 18, cap, x, x, x, 3)
    assert wrapper.launches == before


nbr = importlib.import_module("primus_fhe_tpu_torch.boot.ntru_blind_rotate")


@pytest.mark.parametrize("indices", [1, 3])
def test_chunked_ntru_keys_equal_one_batch(monkeypatch, indices):
    """NTRU_128's gadget at N = 2^8, n_lwe 8: ``make_ntru_keys`` with the
    evaluation key made in chunks of one LWE index and of three (the last
    ragged), against the NGS rows encrypted in one batch and transformed
    together (both forms), the key-switch key after them, and the generator
    state."""
    params = dataclasses.replace(P.NTRU_128, log_n=8, lwe_dim=8)
    monkeypatch.setattr(nbr, "EVK_CHUNK_WORDS", indices * params.level * params.n)
    g_chunked, g_batch = torch.Generator().manual_seed(13), torch.Generator().manual_seed(13)
    keys = P.make_ntru_keys(params, "cpu", g_chunked)
    ctx, ks_basis = P.make_ntru_context(params)
    sk = nbr.ntru_keygen(g_batch, ctx)
    s = sample_binary(g_batch, (params.lwe_dim,))
    coeff = nbr.ngs_encrypt_bit(g_batch, ctx, sk, s, DiscreteGaussian(params.sigma))
    ksk = nbr.make_ntru_keyswitch_key(g_batch, ctx, sk, s, ks_basis,
                                      DiscreteGaussian(params.lwe_sigma))
    assert torch.equal(keys.sk.f, sk.f) and torch.equal(keys.lwe_secret, s)
    assert keys.evk.is_contiguous() and torch.equal(keys.evk, to_ntt(coeff, ctx.ntt))
    for got, want in zip(keys.evk_mxu, prepare_mxu_evk(ctx, coeff)):
        assert got.is_contiguous() and torch.equal(got, want)
    assert torch.equal(keys.ksk, ksk)
    assert torch.equal(g_chunked.get_state(), g_batch.get_state())


def test_ntru_keyswitch_key_rows():
    """The key-switch key made in chunks of input coefficients: every row
    is an LWE sample of ``f_i B^l 2^drop`` under the LWE secret, mask and
    body from the same draws (the masks' inner products, summed whole)."""
    params = dataclasses.replace(P.NTRU_128, log_n=8, lwe_dim=8)
    ctx, ks_basis = P.make_ntru_context(params)
    gen = torch.Generator().manual_seed(17)
    sk = nbr.ntru_keygen(gen, ctx)
    s = sample_binary(gen, (params.lwe_dim,))
    gauss = DiscreteGaussian(params.lwe_sigma)
    state = gen.get_state()
    ksk = nbr.make_ntru_keyswitch_key(gen, ctx, sk, s, ks_basis, gauss)
    gen.set_state(state)
    q, level = ctx.q_int, ks_basis.decompose_length
    a = sample_uniform(gen, (ctx.n, level, params.lwe_dim), q)
    e = gauss.sample_mod(gen, (ctx.n, level), q)
    scal = torch.tensor([x % q for x in ks_basis.scalars], dtype=torch.int64)
    assert torch.equal(ksk[..., :-1], a)
    assert torch.equal(ksk[..., -1], ((a * s).sum(dim=-1) + sk.f[:, None] * scal + e) % q)
