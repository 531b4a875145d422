"""The MXU bootstrap key made in chunks (``boot/blind_rotate.py``'s
``make_bootstrap_key_mxu``), on the CPU.

- At a toy ring (N = 256, 5 LWE bits) with the chunk forced to one and to
  two LWE indices (``KEY_CHUNK_WORDS``, a ragged last chunk), the pack is
  the one-batch pack word for word (``prepare_mxu_bsk`` on all the GGSWs
  encrypted in one batch, the same generator draws), the generator's state
  after the call is the one-batch call's, and the values are the NTT key's
  rows (``make_bootstrap_key`` from the same draws).
- The pack carries Shoup quotients only where a rotation reads them
  (``mxu_pack_reads_quotients``): on the CPU, not on the card past kernel A
  (decided from the shape: log_n 13-17 never asks the card); there the pack
  is ``(vals, None)`` with the same values.

Tolerance: zero (bit-equal words).
"""

import dataclasses
import importlib

import pytest
import torch

from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian, sample_binary
from primus_fhe_tpu_torch.numeric.limb import widen_u32
from primus_fhe_tpu_torch.ops.cmux_mxu import prepare_mxu_bsk

# the module (``primus_fhe_tpu_torch.boot`` exports a function of its name)
br = importlib.import_module("primus_fhe_tpu_torch.boot.blind_rotate")
SEED = 28


def _setup(log_n: int = 8, lwe_dim: int = 5):
    p = dataclasses.replace(P.TOY, log_n=log_n, lwe_dim=lwe_dim)
    basis, _, conv = P._bases(p)
    gen = torch.Generator().manual_seed(SEED)
    lwe_secret = sample_binary(gen, (p.lwe_dim,))
    glwe_secret = sample_binary(gen, (p.glwe_dim, p.n))
    return p, basis, conv, lwe_secret, glwe_secret, DiscreteGaussian(p.glwe_sigma)


def _pack_words(p, conv, indices: int) -> int:
    """``KEY_CHUNK_WORDS`` for a chunk of ``indices`` LWE indices."""
    k1 = p.glwe_dim + 1
    return indices * conv.count * k1 * p.level * k1 * p.n


@pytest.mark.parametrize("indices", [1, 2])
def test_chunked_mxu_pack_equals_one_batch_pack(monkeypatch, indices):
    p, basis, conv, lwe_s, glwe_s, gauss = _setup()
    monkeypatch.setattr(br, "KEY_CHUNK_WORDS", _pack_words(p, conv, indices))
    gen = torch.Generator().manual_seed(SEED + 1)
    vals, precons = br.make_bootstrap_key_mxu(lwe_s, glwe_s, basis, gauss, conv, gen)

    one = torch.Generator().manual_seed(SEED + 1)
    want = prepare_mxu_bsk(conv, br._bsk_coeff(lwe_s, glwe_s, basis, gauss, conv, one))
    assert torch.equal(vals, want[0]) and torch.equal(precons, want[1])
    assert vals.is_contiguous() and precons.is_contiguous()
    assert torch.equal(gen.get_state(), one.get_state())

    ntt = br.make_bootstrap_key(lwe_s, glwe_s, basis, gauss, conv,
                                torch.Generator().manual_seed(SEED + 1))
    assert ntt.dtype == torch.int32  # the NTT key's words in their 32-bit storage
    assert torch.equal(vals.reshape(ntt.shape), widen_u32(ntt))


def test_pack_carries_quotients_only_where_read(monkeypatch):
    p, basis, conv, lwe_s, glwe_s, gauss = _setup()
    k1 = p.glwe_dim + 1
    assert br.mxu_pack_reads_quotients(conv, basis, k1, "cpu")
    wide_basis, _, wide_conv = P._bases(dataclasses.replace(p, log_n=13))
    assert not br.mxu_pack_reads_quotients(wide_conv, wide_basis, k1, "cuda")
    want = br.make_bootstrap_key_mxu(lwe_s, glwe_s, basis, gauss, conv,
                                     torch.Generator().manual_seed(SEED + 2))[0]
    monkeypatch.setattr(br, "mxu_pack_reads_quotients", lambda *args: False)
    vals, precons = br.make_bootstrap_key_mxu(lwe_s, glwe_s, basis, gauss, conv,
                                              torch.Generator().manual_seed(SEED + 2))
    assert precons is None and torch.equal(vals, want)
