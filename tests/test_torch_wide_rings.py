"""The port at the rings the card took up to 2^17, and past it, on the CPU.

- the bootstrap key made in chunks of LWE indices (``make_bootstrap_key``,
  whose draws stay one batch) equals the one-batch key of the same draws,
  word for word, and leaves the generator where the one-batch key does; so
  do the NTRU keys (``make_ntru_keys``: both evaluation-key forms, made by
  ``make_ntru_evks`` in chunks, and the key-switch key after them);
- the caps that were 2^17 are gone: kernels 1-2, row 10 (and row 9's
  functions on its passes), H and J take log_n up to 26 through the
  four-step (``ops/ntt_columns.MAX_LOG_N``, ``FOUR_STEP_MAX_LOG_N`` in
  ``csrc/ntt_columns.cuh``), F and G rows of up to 2^29 words
  (``FG_MAX_LOG_N``); row 11's stage kernels keep log_w 17
  (``ST_MAX_LOG_W``), and their launch refuses log_w 18 by name before it
  reads the device.

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
from primus_fhe_tpu_torch.numeric.limb import widen_u32
from primus_fhe_tpu_torch.ops import (cmux_fused, ntru_cmux_mxu, ntt32, ntt64, ntt_columns,
                                      ntt_mxu8, ntt_stages, rotate)

br = importlib.import_module("primus_fhe_tpu_torch.boot.blind_rotate")


@pytest.mark.parametrize("indices", [1, 3])
def test_chunked_bootstrap_key_equals_one_batch(monkeypatch, indices):
    """TOY (N = 32, n_lwe 8): chunks of one LWE index and of three (the last
    ragged), against the GGSWs encrypted in one batch and transformed
    together; the key stores its canonical words as int32, compared
    widened."""
    ctx = P.make_context(P.TOY, "cpu", torch.Generator().manual_seed(5), bsk_kind="ntt")
    per_index = ctx.conv.count * (P.TOY.glwe_dim + 1) ** 2 * P.TOY.level * P.TOY.n
    monkeypatch.setattr(br, "KEY_CHUNK_WORDS", indices * per_index)
    g_chunked, g_batch = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    key = br.make_bootstrap_key(ctx.lwe_secret, ctx.glwe_secret, ctx.basis, ctx.gaussian,
                                ctx.conv, g_chunked)
    one = ctx.conv.forward(br._bsk_coeff(ctx.lwe_secret, ctx.glwe_secret, ctx.basis,
                                         ctx.gaussian, ctx.conv, g_batch)).movedim(0, 1)
    assert key.is_contiguous() and key.shape == one.shape and key.dtype == torch.int32
    assert torch.equal(widen_u32(key), one)
    assert torch.equal(g_chunked.get_state(), g_batch.get_state())


def test_ring_caps_are_2_17():
    """The caps that were 2^17, in the new contract: no 2^17 cap on kernels
    1-2, row 10 (row 9's four functions and row 12 on its passes), the
    staged CMux step (G, kernel 1, the split H) and the NTRU staged step (I,
    kernel 1, the split J): log_n up to 26 (the four-step's columns of up to
    2^12 words beside sub-rows of 2^14), its C constants; kernels F and G's
    C constant, which ``rotate.check_row`` reads from the library on the
    card, 29; row 11's cap unchanged, log_w 17."""
    csrc = pathlib.Path(rotate.__file__).parent.parent / "csrc"

    def const(name, file):
        text = (csrc / file).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("FG_MAX_LOG_N", "cmux_front.cu") == 29
    assert const("CLUSTER_MAX_LOG_N", "ntt_columns.cuh") == ntt_columns.CLUSTER_LOG_N == 17
    assert const("FOUR_STEP_MAX_LOG_N", "ntt_columns.cuh") == ntt_columns.MAX_LOG_N == 26
    assert ntt32.MAX_LOG_N == ntt64.MAX_LOG_N == 26
    assert ntt_mxu8.WIDE_LOG_N == (13, 26)
    assert cmux_fused.STAGED_LOG_N == (4, 26)
    assert [cmux_fused.step_route(3, 2, 3, log_n) for log_n in (17, 18, 26)] == ["staged"] * 3
    assert [ntru_cmux_mxu.ntru_step_route(6, log_n, 1) for log_n in (17, 18, 26)] == \
        ["staged"] * 3
    with pytest.raises(ValueError, match="log_n 4-26"):
        cmux_fused.step_route(3, 2, 3, 27)
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
