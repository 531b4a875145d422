"""Byte round-trips for ciphertexts and keys (port of
``primus_fhe_tpu/utils/serialize.py``; the bytes are the JAX package's).

Reference: the ``impl_bytes_conversion!`` macro gives every container
``from_bytes``/``to_bytes`` via bytemuck casts
(``crates/primus_lattice/src/macros/mod.rs:39-97``).  Here every container
is a tensor of words, so serialization is a little-endian byte cast of its
host copy.

Words and tiers: a u32 container is an int64 tensor of words in ``[0,
2^32)`` (or int32 storage, or numpy uint32); a u64 container an int64
tensor of u64 bit patterns (or numpy uint64).  An int64 tensor is the u32
tier unless ``bits=64`` says otherwise; a word outside ``[0, 2^32)`` in
the u32 tier raises.  Tensors may live on the card or the CPU; what comes
back is an int64 tensor on ``device`` (the card unless the caller asks for
the CPU).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..numeric.limb import u64_numpy


def _host(value, bits):
    """A container value -> ``(tier, little-endian numpy array)``."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.int32:
            if bits == 64:
                raise TypeError("int32 storage holds u32 words, not u64")
            return _TIER_U32, value.detach().cpu().numpy().view("<u4")
        if value.dtype != torch.int64:
            raise TypeError(f"container words must be int64 or int32 tensors, got {value.dtype}")
        if bits == 64:
            return _TIER_U64, u64_numpy(value).astype("<u8")
        arr = value.detach().cpu().numpy()
        if arr.size and (arr.min() < 0 or arr.max() >= 1 << 32):
            raise ValueError("a u32 container holds words in [0, 2^32); pass bits=64 for u64")
        return _TIER_U32, arr.astype("<u4")
    arr = np.asarray(value)
    if arr.dtype == np.uint64:
        return _TIER_U64, arr.astype("<u8")
    if arr.dtype == np.uint32:
        return _TIER_U32, arr.astype("<u4")
    raise TypeError(f"container elements must be uint32 or uint64, got {arr.dtype}")


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Little-endian u32 or u64 words -> an int64 tensor on ``device``."""
    if arr.dtype.itemsize == 4:
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    return torch.from_numpy(arr.astype(np.uint64).view(np.int64)).to(device)


def u32_to_bytes(arr) -> bytes:
    """u32 words -> little-endian bytes (shape-flattened)."""
    return np.ascontiguousarray(_host(arr, 32)[1]).tobytes()


def u32_from_bytes(data: bytes, shape, device="cuda") -> torch.Tensor:
    return _tensor(np.frombuffer(data, dtype="<u4").reshape(shape), device)


def u64_to_bytes(x) -> bytes:
    """u64 words (int64 patterns or numpy uint64) -> little-endian bytes."""
    return np.ascontiguousarray(_host(x, 64)[1]).tobytes()


def u64_from_bytes(data: bytes, shape, device="cuda") -> torch.Tensor:
    return _tensor(np.frombuffer(data, dtype="<u8").reshape(shape), device)


# ---------------------------------------------------------------------------
# Container-aware serialization.
#
# The reference's ``impl_bytes_conversion!`` gives each container type a
# bytes round trip where the *type* carries the layout; containers here are
# layout conventions over tensors (the container table of the JAX
# package's lattice/__init__.py), so the
# byte stream itself is self-describing: a small header records the
# container kind, element tier (u32 / u64), evaluation domain, shape,
# and the moduli it is defined over.  ``KINDS`` registers a rank/shape
# validator per kind so a GGSW cannot round-trip with a GLWE's layout.
# ---------------------------------------------------------------------------

_MAGIC = b"PFT1"
_TIER_U32, _TIER_U64 = 0, 1
_DOMAINS = ("coeff", "ntt")


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def _v_lwe(s):  # (..., n+1)
    return len(s) >= 1 and s[-1] >= 2


def _v_poly(s):  # (..., N), N a power of two
    return len(s) >= 1 and _is_pow2(s[-1])


def _v_rlwe(s):  # (..., 2, N)
    return len(s) >= 2 and s[-2] == 2 and _is_pow2(s[-1])


def _v_glwe(s):  # (..., k+1, N)
    return len(s) >= 2 and s[-2] >= 2 and _is_pow2(s[-1])


def _v_glev(s):  # (..., L, k+1, N)
    return len(s) >= 3 and s[-2] >= 2 and _is_pow2(s[-1])


def _v_ggsw(s):  # (..., k+1, L, k+1, N) — the two k+1 axes must agree
    return (
        len(s) >= 4 and s[-4] == s[-2] and s[-2] >= 2 and _is_pow2(s[-1])
    )


def _v_bsk(s):  # (n_lwe, k+1, L, k+1, N) — a GGSW per LWE secret bit
    return len(s) >= 5 and _v_ggsw(s[-4:])


def _v_ksk(s):  # (n_in, L, n_out+1)
    return len(s) >= 3 and s[-1] >= 2


def _v_any(s):
    return True


KINDS = {
    "lwe": _v_lwe,           # src/lwe/single_message.rs:14
    "multi_lwe": _v_lwe,     # src/lwe/multiple_message.rs:14
    "rlwe": _v_rlwe,         # src/rlwe/coeff.rs:26
    "glwe": _v_glwe,         # src/glwe/*.rs
    "glev": _v_glev,         # src/glev/mod.rs
    "rlev": _v_glev,         # src/rlev/mod.rs (k = 1)
    "ggsw": _v_ggsw,         # src/ggsw/mod.rs
    "rgsw": _v_ggsw,         # src/rgsw/mod.rs (k = 1)
    "ntru": _v_poly,         # src/ntru/mod.rs
    "poly": _v_poly,         # bare ring element
    "bootstrap_key": _v_bsk,
    "keyswitch_key": _v_ksk,
    "secret_key": _v_any,
    "raw": _v_any,
}


def _validate(kind: str, shape, domain: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown container kind {kind!r}")
    if domain not in _DOMAINS:
        raise ValueError(f"unknown domain {domain!r}")
    if not KINDS[kind](tuple(int(d) for d in shape)):
        raise ValueError(f"shape {tuple(shape)} is not a valid {kind} layout")


def pack_container(kind: str, value, *, domain: str = "coeff", moduli=(), bits=None) -> bytes:
    """Container (tensor on any device, or numpy) -> self-describing bytes.

    ``moduli`` records the modulus chain (CRT containers carry a leading
    modulus-major axis matching ``len(moduli)``); a single int is fine.
    ``bits=64`` marks an int64 tensor as u64 words.
    """
    if isinstance(moduli, int):
        moduli = (moduli,)
    moduli = tuple(int(m) for m in moduli)
    tier, arr = _host(value, bits)
    _validate(kind, arr.shape, domain)
    kb = kind.encode()
    head = struct.pack(
        "<4sBBBBB",
        _MAGIC,
        1,  # version
        tier,
        _DOMAINS.index(domain),
        len(kb),
        arr.ndim,
    )
    head += kb
    head += struct.pack(f"<{arr.ndim}Q", *arr.shape) if arr.ndim else b""
    head += struct.pack("<B", len(moduli))
    head += struct.pack(f"<{len(moduli)}Q", *moduli) if moduli else b""
    return head + np.ascontiguousarray(arr).tobytes()


def unpack_container(data: bytes, expect_kind: str | None = None, device="cuda"):
    """Bytes -> ``(kind, value, meta)``; ``value`` is an int64 tensor on
    ``device`` (u32 words, or u64 patterns for the u64 tier); ``meta`` has
    domain + moduli.

    ``expect_kind`` makes type confusion a loud error (the typed
    ``from_bytes`` of the reference macro)."""
    magic, version, tier, dom, klen, ndim = struct.unpack_from("<4sBBBBB", data, 0)
    if magic != _MAGIC or version != 1:
        raise ValueError("not a PFT1 container byte stream")
    off = struct.calcsize("<4sBBBBB")
    kind = data[off : off + klen].decode()
    off += klen
    shape = struct.unpack_from(f"<{ndim}Q", data, off) if ndim else ()
    off += 8 * ndim
    (nmod,) = struct.unpack_from("<B", data, off)
    off += 1
    moduli = struct.unpack_from(f"<{nmod}Q", data, off) if nmod else ()
    off += 8 * nmod
    domain = _DOMAINS[dom]
    _validate(kind, shape, domain)
    if expect_kind is not None and kind != expect_kind:
        raise ValueError(f"expected a {expect_kind!r} stream, got {kind!r}")
    count = int(np.prod(shape)) if shape else 1
    dtype = "<u8" if tier == _TIER_U64 else "<u4"
    value = _tensor(np.frombuffer(data, dtype=dtype, count=count, offset=off).reshape(shape), device)
    meta = {"domain": domain, "moduli": tuple(int(m) for m in moduli)}
    return kind, value, meta


def _make_pair(kind: str):
    def to_bytes(value, *, domain="coeff", moduli=(), bits=None):
        return pack_container(kind, value, domain=domain, moduli=moduli, bits=bits)

    def from_bytes(data: bytes, device="cuda"):
        _, value, meta = unpack_container(data, expect_kind=kind, device=device)
        return value, meta

    to_bytes.__name__ = f"{kind}_to_bytes"
    from_bytes.__name__ = f"{kind}_from_bytes"
    to_bytes.__doc__ = f"Serialize a {kind} container (layout-validated)."
    from_bytes.__doc__ = (
        f"Deserialize a {kind} container; raises on any other kind."
    )
    return to_bytes, from_bytes


lwe_to_bytes, lwe_from_bytes = _make_pair("lwe")
rlwe_to_bytes, rlwe_from_bytes = _make_pair("rlwe")
glwe_to_bytes, glwe_from_bytes = _make_pair("glwe")
glev_to_bytes, glev_from_bytes = _make_pair("glev")
ggsw_to_bytes, ggsw_from_bytes = _make_pair("ggsw")
rgsw_to_bytes, rgsw_from_bytes = _make_pair("rgsw")
ntru_to_bytes, ntru_from_bytes = _make_pair("ntru")
bootstrap_key_to_bytes, bootstrap_key_from_bytes = _make_pair("bootstrap_key")
keyswitch_key_to_bytes, keyswitch_key_from_bytes = _make_pair("keyswitch_key")
