"""Noise-tracked ciphertexts: variance bookkeeping beside the values (port of
``primus_fhe_tpu/tracked.py``).

Each LWE sample rides with a :class:`~.noise.NoiseEstimate`, so a pipeline
can check its decryption-failure margin *before* it decrypts: :func:`gate`
refuses a gate whose pre-rotation margin is unsafe, before any launch.
Linear ops propagate variance exactly (independence heuristic); a bootstrap
resets it to the fresh-bootstrap value of the same formulas.

:func:`bootstrap` runs the port's ``boot/blind_rotate.bootstrap`` and
``lattice/keyswitch.key_switch`` on the context's device: on the card an
NTT-key gate launches the fused CMux step once a key slice and kernel F
once.  Every function takes a batch ``(..., n+1)`` of samples that share
one noise estimate.
"""

from __future__ import annotations

import dataclasses

import torch

from . import noise
from .boot.blind_rotate import bootstrap as _bootstrap
from .boot.gates import TRUE_MU
from .lattice.keyswitch import key_switch
from .numeric.limb import MASK32
from .params import TfheContext


@dataclasses.dataclass
class TrackedLwe:
    """LWE samples ``(..., n+1)`` with their running noise estimate."""

    ct: torch.Tensor
    noise: noise.NoiseEstimate

    def margin(self, message_bits: int) -> float:
        """Decryption-failure margin (>1 = safe) for the message space."""
        return self.noise.decryption_failure_margin(message_bits)


def encrypt_bit(ctx: TfheContext, generator: torch.Generator, bit) -> TrackedLwe:
    """Encrypts TRUE/FALSE (±1/8) under the LWE secret with fresh noise;
    ``bit`` is a bool or a tensor of bits (a batch)."""
    return TrackedLwe(ctx.encrypt(bit, generator), noise.fresh_lwe(ctx.params.lwe_sigma))


def trivial(ctx: TfheContext, mu: int) -> TrackedLwe:
    ct = torch.zeros(ctx.params.lwe_dim + 1, dtype=torch.int64, device=ctx.device)
    ct[-1] = mu % (1 << 32)
    return TrackedLwe(ct, noise.NoiseEstimate(0.0))


def add(a: TrackedLwe, b: TrackedLwe) -> TrackedLwe:
    return TrackedLwe((a.ct + b.ct) & MASK32, noise.add(a.noise, b.noise))


def sub(a: TrackedLwe, b: TrackedLwe) -> TrackedLwe:
    return TrackedLwe((a.ct - b.ct) & MASK32, noise.add(a.noise, b.noise))


def neg(a: TrackedLwe) -> TrackedLwe:
    return TrackedLwe((-a.ct) & MASK32, a.noise)


def scalar_mul(a: TrackedLwe, c: int) -> TrackedLwe:
    """``c * a``: the int64 product wraps, and its low 32 bits are exact."""
    return TrackedLwe((a.ct * (c % (1 << 32))) & MASK32, noise.scalar_mul(a.noise, c))


def _fresh_bootstrap_noise(ctx: TfheContext) -> noise.NoiseEstimate:
    p = ctx.params
    br = noise.blind_rotate(p.lwe_dim, p.glwe_sigma, p.n, p.glwe_dim, p.level, p.log_basis,
                            ctx.basis.drop_bits)
    return noise.key_switch(br, p.lwe_sigma, p.glwe_dim * p.n, p.ks_level, p.ks_log_basis,
                            ctx.ks_basis.drop_bits)


def pre_rotation_noise(ctx: TfheContext, lin: noise.NoiseEstimate) -> noise.NoiseEstimate:
    """Noise entering the sign test: affine noise plus the modulus switch's
    rounding.  Its 4-sigma tail must stay inside the half bucket (q/16 for
    the ±1/8 gate encoding) for the gate to be right."""
    return noise.modulus_switch(lin, ctx.params.lwe_dim, ctx.params.log_n + 1)


def bootstrap(ctx: TfheContext, c: TrackedLwe, test_poly=None) -> TrackedLwe:
    """Sign bootstrap and key switch on the context's device; the output
    noise does not depend on the input's."""
    p = ctx.params
    tp = test_poly if test_poly is not None else torch.full(
        (p.n,), TRUE_MU, dtype=torch.int64, device=ctx.device)
    big = _bootstrap(ctx.conv, ctx.basis, ctx.bsk, c.ct, tp, p.log_n)
    return TrackedLwe(key_switch(big, ctx.ksk, ctx.ks_basis), _fresh_bootstrap_noise(ctx))


_OFFSETS = {"nand": -(5 << 29), "and": -(1 << 29), "or": 1 << 29}


def gate(ctx: TfheContext, kind: str, a: TrackedLwe, b: TrackedLwe,
         min_margin: float = 1.0) -> TrackedLwe:
    """Tracked boolean gate (``kind``: "nand", "and" or "or"); raises
    ``ValueError`` before any launch if the tracked inputs leave a
    pre-rotation margin below ``min_margin``."""
    off = _OFFSETS[kind]
    lin = add(a, b)
    pre = pre_rotation_noise(ctx, lin.noise)
    margin = pre.decryption_failure_margin(message_bits=2)
    if margin < min_margin:
        raise ValueError(f"gate '{kind}' unsafe: pre-rotation margin {margin:.3f} < {min_margin}")
    # the affine offset touches only the body coefficient (noise-free);
    # lin.ct is a new tensor, so it is updated in place
    lin.ct[..., -1] = (lin.ct[..., -1] + off) & MASK32
    return bootstrap(ctx, TrackedLwe(lin.ct, pre))


def decrypt_phase(ctx: TfheContext, c: TrackedLwe) -> torch.Tensor:
    """Centered phase (int64), for tests and measured-against-predicted
    checks."""
    return ctx.phase(c.ct)
