"""Kernels 1-4, A-G and the four u64 NTT kernels against their plain PyTorch
versions on a CUDA card, at shapes ``chip_smoke.py`` does not reach: N from
32 (16 threads a block) to 4096, three primes, the 2^1 x 12 gadget in stage
1, k=2, odd batches, and int32 storage; for the int8 kernels log_n 8-11,
k=1 and 2, L 2-4, 1- and 2-byte digits, and NTRU moduli of 20 and 30 bits;
for the u64 kernels log_n 4-15 (a row over two blocks at 15), 50- to 62-bit moduli (lazy words past 2^63),
both input chains of the inverse, 7 and 8 byte planes on inputs past 2^63,
and a small DCRT rotation on both routes against the CPU; kernels D and E
(the fused key multiply and round trip) at log_n 8-12, 7 and 8 planes, two
moduli and ragged row groups, and the four-step at 2^16 on both routes;
kernels F and G at N 32-2048, degrees of any sign, both gadgets, and
``cmux_delta`` against kernels 3-4; the four stage kernels of the
coefficient-sharded NTT at log_n 9-16 over 2-8 shards (u32, 50- and 62-bit
u64, every ``out_factor`` and both ``in_factor``s), and a (2, 2)
``LocalMesh`` DCRT rotation on both routes against the single-card one.
Tolerance: zero (bit-equal).

The kernels have no CPU mode, so every test here needs the card and skips
without one.  On the card (the root conftest imports JAX, which that
machine lacks, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda_kernels.py
"""

import dataclasses

import pytest
import torch

from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.boot import ntru_gates
from primus_fhe_tpu_torch.boot.ntru_blind_rotate import NtruContext
from primus_fhe_tpu_torch.ops import (cmux_front, cmux_fused, cmux_mxu, ntru_cmux_mxu, ntt32,
                                      ntt64, ntt_mxu8, rotate)
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

pytestmark = pytest.mark.cuda

PRIMES3 = [1073692673, 1073668097, 1073651713]  # 30-bit NTT primes, = 1 mod 2^13


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _residues(gen, primes, shape, factor, dev):
    q = torch.tensor(primes, dtype=torch.int64, device=dev).reshape((-1,) + (1,) * len(shape))
    r = torch.randint(0, 1 << 40, (len(primes),) + tuple(shape), generator=gen, device=dev)
    return r % (factor * q)


@pytest.mark.parametrize("log_n", [5, 8, 11, 12])
def test_ntt_kernels_match_plain(dev, log_n):
    tables = ntt32.NttTables32(log_n, PRIMES3)
    gen = torch.Generator(device=dev).manual_seed(log_n)
    n = 1 << log_n
    x = _residues(gen, PRIMES3, (3, 2, n), 4, dev)
    for out_factor in (1, 4):
        want = ntt32.forward32_plain(tables, x, out_factor)
        assert torch.equal(ntt32.forward32(tables, x, out_factor), want)
        got32 = ntt32.forward32(tables, x.to(torch.int32), out_factor)
        assert got32.dtype == torch.int32
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
    y = _residues(gen, PRIMES3, (3, 2, n), 2, dev)
    for out_factor in (1, 2):
        want = ntt32.inverse32_plain(tables, y, out_factor)
        assert torch.equal(ntt32.inverse32(tables, y, out_factor), want)
    roundtrip = ntt32.inverse32(tables, ntt32.forward32(tables, y % torch.tensor(
        PRIMES3, device=dev).reshape(3, 1, 1, 1)))
    assert torch.equal(roundtrip, y % torch.tensor(PRIMES3, device=dev).reshape(3, 1, 1, 1))


@pytest.mark.parametrize(
    "log_n,log_basis,level,k",
    [(5, 8, 3, 1), (8, 1, 12, 1), (11, 7, 3, 1), (8, 8, 2, 2)],
)
def test_cmux_kernels_match_plain(dev, log_n, log_basis, level, k):
    n = 1 << log_n
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    gen = torch.Generator(device=dev).manual_seed(log_n * 100 + log_basis)
    acc = torch.randint(0, 1 << 32, (3, k + 1, n), generator=gen, device=dev)
    degrees = torch.tensor([0, 7, 2 * n - 1], dtype=torch.int32, device=dev)
    f_want = cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees)
    assert torch.equal(cmux_fused.cmux_stage1(conv, basis, acc, degrees), f_want)
    key = _residues(gen, conv.primes, (k + 1, level, k + 1, n), 1, dev)
    want = cmux_fused.cmux_stage2_plain(conv, f_want, key, acc)
    assert torch.equal(cmux_fused.cmux_stage2(conv, f_want, key, acc), want)
    step = cmux_fused.fused_cmux_step(
        conv, basis, acc.to(torch.int32), degrees, key.to(torch.int32)
    )
    assert torch.equal(step.to(torch.int64) & 0xFFFFFFFF, want)


def test_launch_counts_and_toy_bootstrap(dev):
    """A TOY bootstrap on the card equals the CPU one on the same keys and
    launches each CMux kernel once per key slice."""
    gen = torch.Generator(device=dev).manual_seed(7)
    ctx = P.make_context(P.TOY, dev, gen)
    cts = ctx.encrypt(torch.tensor([0, 1, 1], device=dev), gen)
    tp = torch.full((ctx.params.n,), 1 << 29, dtype=torch.int64, device=dev)
    before = (cmux_fused.cmux_stage1.launches, cmux_fused.cmux_stage2.launches)
    out = bootstrap(ctx.conv, ctx.basis, ctx.bsk, cts, tp, ctx.params.log_n)
    after = (cmux_fused.cmux_stage1.launches, cmux_fused.cmux_stage2.launches)
    assert after[0] - before[0] == ctx.params.lwe_dim
    assert after[1] - before[1] == ctx.params.lwe_dim
    cpu = bootstrap(ctx.conv, ctx.basis, ctx.bsk.cpu(), cts.cpu(), tp.cpu(), ctx.params.log_n)
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("log_n,kp", [(8, 1), (9, 2), (10, 3), (11, 2)])
def test_mxu8_forward_matches_plain(dev, log_n, kp):
    plan = cmux_mxu.CmuxMxuPlan(log_n, PRIMES3[:kp])
    gen = torch.Generator(device=dev).manual_seed(log_n)
    x = _residues(gen, PRIMES3[:kp], (5, 1 << log_n), 1, dev)
    want = ntt_mxu8.mxu8_forward32_plain(plan, x)
    assert torch.equal(ntt_mxu8.mxu8_forward32(plan, x), want)
    assert torch.equal(ntt_mxu8.mxu8_forward32(plan, x.to(torch.int32)).to(torch.int64), want)


@pytest.mark.parametrize(
    "log_n,log_basis,level,k",
    [(8, 8, 2, 1), (9, 10, 2, 2), (10, 4, 4, 1), (11, 7, 3, 1), (11, 7, 3, 2)],
)
def test_mxu_cmux_step_matches_plain(dev, log_n, log_basis, level, k):
    n, k1 = 1 << log_n, k + 1
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    plan = cmux_mxu.plan_for(conv)
    gen = torch.Generator(device=dev).manual_seed(log_n * 10 + k)
    acc = torch.randint(0, 1 << 32, (4, k1, n), generator=gen, device=dev)
    degrees = torch.tensor([0, 1, n, 2 * n - 1], dtype=torch.int32, device=dev)
    ggsw = torch.randint(0, 1 << 32, (1, k1, level, k1, n), generator=gen, device=dev)
    kv, kpre = cmux_mxu.prepare_mxu_bsk(conv, ggsw)
    want = cmux_mxu.mxu_cmux_step_plain(conv, basis, acc, degrees, kv[0])
    got = cmux_mxu.mxu_cmux_step(plan, basis, conv, acc, degrees, kv[0], kpre[0])
    assert torch.equal(got, want)
    one = cmux_mxu.mxu_cmux_step(plan, basis, conv, acc[:1].to(torch.int32), degrees[:1],
                                 kv[0], kpre[0])
    assert torch.equal(one.to(torch.int64) & 0xFFFFFFFF, want[:1])


@pytest.mark.parametrize("log_n,q_bits,log_basis,level", [(10, 20, 3, 6), (8, 30, 10, 3),
                                                          (11, 22, 4, 4), (9, 20, 1, 16)])
def test_ntru_cmux_step_matches_plain(dev, log_n, q_bits, log_basis, level):
    n, q = 1 << log_n, next_ntt_prime(q_bits, log_n)
    plan = ntru_cmux_mxu.get_ntru_plan(log_n, q)
    basis = ApproxSignedBasis32(q, log_basis, level)
    gen = torch.Generator(device=dev).manual_seed(q_bits)
    acc = torch.randint(0, q, (5, n), generator=gen, device=dev)
    acc[0, :3] = torch.tensor([0, q - 1, basis.wrap_threshold or 1])
    degrees = torch.tensor([0, 1, n, 2 * n - 1, 7], dtype=torch.int32, device=dev)
    coeff = torch.randint(0, q, (1, level, n), generator=gen, device=dev)
    kv, kpre = ntru_cmux_mxu.prepare_mxu_evk(NtruContext(log_n, q, log_basis, level), coeff)
    want = ntru_cmux_mxu.ntru_cmux_step_plain(plan, basis, acc, degrees, kv[0])
    got = ntru_cmux_mxu.ntru_cmux_step(plan, basis, acc, degrees, kv[0], kpre[0])
    assert torch.equal(got, want)


def test_mxu_bootstrap_and_ntru_gate(dev):
    """A small MXU-route TFHE bootstrap and an NTRU NAND on the card equal
    their CPU runs on the same keys; kernels A and B launch once per key
    slice."""
    p = dataclasses.replace(P.TOY, log_n=8, lwe_dim=6)
    gen = torch.Generator(device=dev).manual_seed(8)
    ctx = P.make_context(p, dev, gen, bsk_kind="mxu")
    cts = ctx.encrypt(torch.tensor([0, 1, 1], device=dev), gen)
    tp = torch.full((p.n,), 1 << 29, dtype=torch.int64, device=dev)
    before = cmux_mxu.mxu_cmux_step.launches
    out = bootstrap(ctx.conv, ctx.basis, ctx.bsk, cts, tp, p.log_n)
    assert cmux_mxu.mxu_cmux_step.launches - before == p.lwe_dim
    cpu_bsk = tuple(x.cpu() for x in ctx.bsk)
    assert torch.equal(out.cpu(), bootstrap(ctx.conv, ctx.basis, cpu_bsk, cts.cpu(), tp.cpu(),
                                            p.log_n))

    keys = P.make_ntru_keys(dataclasses.replace(P.NTRU_128, log_n=8, lwe_dim=8, lwe_sigma=4.0),
                            dev, gen)
    ca, cb = keys.encrypt([0, 0, 1, 1], gen), keys.encrypt([0, 1, 0, 1], gen)
    before = ntru_cmux_mxu.ntru_cmux_step.launches
    got = ntru_gates.ntru_nand(keys.ctx, keys.evk_mxu, keys.ksk, keys.ks_basis, ca, cb)
    assert ntru_cmux_mxu.ntru_cmux_step.launches - before == keys.params.lwe_dim
    ntt = ntru_gates.ntru_nand(keys.ctx, keys.evk, keys.ksk, keys.ks_basis, ca, cb)
    assert torch.equal(got, ntt)
    cpu = ntru_gates.ntru_nand(keys.ctx, tuple(x.cpu() for x in keys.evk_mxu), keys.ksk.cpu(),
                               keys.ks_basis, ca.cpu(), cb.cpu())
    assert torch.equal(got.cpu(), cpu)
    assert keys.decrypt(got).int().tolist() == [1, 1, 1, 0]


Q50 = [1125899906826241, 1125899906629633]  # the DCRT benchmark's moduli
Q60 = 1152921504606830593  # the reference's 60-bit golden prime


def _u64_words(gen, shape, dev):
    """Uniform u64 words (int64 bit patterns), about half of them past 2^63."""
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev)
    hi = torch.randint(0, 1 << 32, shape, generator=gen, device=dev)
    return (hi << 32) | lo


def _below(gen, moduli, shape, factor, dev):
    """Words in ``[0, factor * q_i)`` (any factor * q below 2^64)."""
    from primus_fhe_tpu_torch.numeric.limb import mul_hi_u64

    return torch.stack([mul_hi_u64(_u64_words(gen, shape, dev), factor * q) for q in moduli])


@pytest.mark.parametrize("log_n,moduli", [
    (4, Q50), (8, Q50 + [Q60]), (12, Q50), (12, [Q60, next_ntt_prime(62, 14)]),
    (14, [next_ntt_prime(61, 14)]), (15, [next_ntt_prime(61, 15), next_ntt_prime(50, 15)]),
])
def test_ntt64_kernels_match_plain(dev, log_n, moduli):
    tables = ntt64.NttTables64(log_n, moduli)
    gen = torch.Generator(device=dev).manual_seed(log_n)
    n = 1 << log_n
    x = _below(gen, moduli, (3, n), 4, dev)
    for out_factor in (1, 4):
        want = ntt64.ntt64_forward_plain(tables, x, out_factor)
        assert torch.equal(ntt64.ntt64_forward(tables, x, out_factor), want)
    for in_factor in (2, 4):
        y = _below(gen, moduli, (3, n), in_factor, dev)
        for out_factor in (1, 2):
            want = ntt64.ntt64_inverse_plain(tables, y, out_factor, in_factor)
            assert torch.equal(ntt64.ntt64_inverse(tables, y, out_factor, in_factor), want)


@pytest.mark.parametrize("log_n,moduli", [(8, Q50), (10, [Q60]), (12, Q50), (12, [Q50[0], Q60])])
def test_mxu8_64_kernels_match_plain(dev, log_n, moduli):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    assert tables.planes == (7 if max(moduli) < 1 << 53 else 8)
    gen = torch.Generator(device=dev).manual_seed(log_n + len(moduli))
    for rows in (1, 5):
        x = _u64_words(gen, (len(moduli), rows, 1 << log_n), dev)
        assert torch.equal(ntt_mxu8.mxu8_forward64(tables, x), ntt_mxu8.mxu8_forward64_plain(tables, x))
        assert torch.equal(ntt_mxu8.mxu8_inverse64(tables, x), ntt_mxu8.mxu8_inverse64_plain(tables, x))


def test_dcrt_rotation_routes_and_cpu_agree(dev):
    """A DCRT rotation at log_n=8 (n_lwe=3, batch 2) on the MXU route, the
    butterfly route and the CPU plain versions: the same words; each route
    launches only its own kernels, once per transform call."""
    from primus_fhe_tpu_torch.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64

    log_n, n_lwe, bsz = 8, 3, 2
    n = 1 << log_n
    base = RNSBase64(Q50)
    basis = BigUintApproxSignedBasis(base, 25)
    plan = build_dcrt_plan64(log_n, Q50)
    gen = torch.Generator(device=dev).manual_seed(11)
    bsk = _below(gen, Q50, (n_lwe, 2, basis.decompose_length, 2, n), 1, dev).movedim(0, 3)
    acc = _below(gen, Q50, (bsz, 2, n), 1, dev).transpose(0, 1).contiguous()
    lwe = torch.randint(0, 2 * n, (bsz, n_lwe + 1), generator=gen, device=dev)
    kernels = (ntt64.ntt64_forward, ntt64.ntt64_inverse, ntt_mxu8.mxu8_forward64,
               ntt_mxu8.mxu8_inverse64)
    outs = {}
    for route in ("auto", "butterfly"):
        for k in kernels:
            k.launches = 0
        outs[route] = dcrt_blind_rotate_batched(plan, basis, base, bsk.contiguous(), lwe, acc,
                                                route=route)
        fwd, inv = (kernels[2], kernels[3]) if route == "auto" else (kernels[0], kernels[1])
        assert fwd.launches == n_lwe and inv.launches == n_lwe
        assert sum(k.launches for k in kernels) == 2 * n_lwe
    cpu = dcrt_blind_rotate_batched(plan, basis, base, bsk.cpu().contiguous(), lwe.cpu(), acc.cpu())
    assert torch.equal(outs["auto"], outs["butterfly"])
    assert torch.equal(outs["auto"].cpu(), cpu)


@pytest.mark.parametrize("log_n,moduli", [(8, Q50), (9, [Q60]), (11, [Q50[0], Q60]), (12, Q50)])
def test_mxu8_64_mul_kernels_match_plain(dev, log_n, moduli):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    gen = torch.Generator(device=dev).manual_seed(100 + log_n)
    mt = tables.mul_table(_below(gen, moduli, (1 << log_n,), 1, dev))
    for rows in (1, 5, 33):
        x = _u64_words(gen, (len(moduli), rows, 1 << log_n), dev)
        assert torch.equal(ntt_mxu8.mxu8_inverse64_mul(tables, x, mt),
                           ntt_mxu8.mxu8_inverse64_mul_plain(tables, x, mt))
        rt = ntt_mxu8.mxu8_roundtrip64_mul(tables, x, mt)
        assert torch.equal(rt, ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, x, mt))
        fwd = ntt_mxu8.mxu8_forward64(tables, x)
        assert torch.equal(rt, ntt_mxu8.mxu8_inverse64_mul(tables, fwd, mt))


def test_large_ntt_routes_match_plain(dev):
    from primus_fhe_tpu_torch.transforms import ntt_large
    from primus_fhe_tpu_torch.transforms.ntt import forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan64

    q = next_ntt_prime(62, 16)
    plan = ntt_large.LargeNttPlan64(16, q)
    gen = torch.Generator(device=dev).manual_seed(16)
    x = _below(gen, [q], (2, 1 << 16), 1, dev)[0]
    want = forward64(build_plan64(16, q, dev), x)
    for route in ("mxu8", "butterfly"):
        f = ntt_large.large_forward64(plan, x, 1, route)
        assert torch.equal(f, want), route
        assert torch.equal(ntt_large.large_inverse64(plan, ntt_large.large_forward64(
            plan, x, 4, route), 1, route), x), route


@pytest.mark.parametrize("log_n,k1", [(5, 2), (10, 1), (11, 2), (11, 3)])
def test_rotate_kernel_matches_plain(dev, log_n, k1):
    n = 1 << log_n
    gen = torch.Generator(device=dev).manual_seed(log_n + k1)
    v = torch.randint(0, 1 << 32, (6, k1, n), generator=gen, device=dev)
    degrees = torch.tensor([0, 1, n, 2 * n - 1, -5, 7 * n + 3], dtype=torch.int64, device=dev)
    for subtract in (False, True):
        want = rotate.rotate_plain(v, degrees, subtract)
        assert torch.equal(rotate.rotate(v, degrees, subtract), want)
        got32 = rotate.rotate(v.to(torch.int32), degrees, subtract)
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
    flat = torch.randint(0, 1 << 32, (3, n), generator=gen, device=dev)
    assert torch.equal(rotate.rotate(flat, degrees[:3]), rotate.rotate_plain(flat, degrees[:3]))


@pytest.mark.parametrize("log_n,log_basis,level,k", [(5, 8, 3, 1), (8, 1, 12, 1), (11, 7, 3, 1),
                                                     (9, 8, 2, 2)])
def test_cmux_front_and_delta_match_plain(dev, log_n, log_basis, level, k):
    n, k1 = 1 << log_n, k + 1
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    gen = torch.Generator(device=dev).manual_seed(log_n * 7 + level)
    acc = torch.randint(0, 1 << 32, (5, k1, n), generator=gen, device=dev)
    degrees = torch.tensor([0, 3, n, 2 * n - 1, -9], dtype=torch.int32, device=dev)
    want = cmux_front.cmux_front_plain(acc, degrees, basis, conv.primes)
    assert torch.equal(cmux_front.cmux_front(acc, degrees, basis, conv.primes), want)
    key = _residues(gen, conv.primes, (k1, level, k1, n), 1, dev)
    delta = tfhe.cmux_delta(conv, basis, acc, degrees, key)
    step = cmux_fused.fused_cmux_step(conv, basis, acc, degrees, key)
    assert torch.equal((acc + delta) & 0xFFFFFFFF, step)
    cpu = tfhe.cmux_delta(conv, basis, acc.cpu(), degrees.cpu(), key.cpu())
    assert torch.equal(delta.cpu(), cpu)


@pytest.mark.parametrize("log_n,d", [(12, 2), (12, 8), (16, 4), (9, 4)])
def test_stage_kernels_match_plain(dev, log_n, d):
    """The four stage kernels on shard 1's table slices: u32 at q = 536813569
    (phase 15's n = 2^12), u64 on the 62-bit q = 4611686018425815041 (exact
    Shoup) and a 50-bit q (deferred, approximate Shoup); lazy outputs too."""
    from primus_fhe_tpu_torch.ops import ntt_stages as st
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs

    gen = torch.Generator(device=dev).manual_seed(log_n + d)
    log_d = d.bit_length() - 1
    log_w, width = log_n - log_d, (1 << log_n) // d
    cols = slice(width, 2 * width)
    if log_n <= 12:
        q = 536813569
        w, p = (t[log_d:, cols].to(dev) for t in cs.build_expanded_tables32(log_n, q))
        wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables32(log_n, q))
        x = torch.randint(0, 4 * q, (8, width), generator=gen, device=dev)
        for of in (1, 4):
            want = st.ntt32_stages_forward_plain(log_w, q, w, p, x, of)
            assert torch.equal(st.ntt32_stages_forward(log_w, q, w, p, x, of), want)
            got32 = st.ntt32_stages_forward(log_w, q, w, p, x.to(torch.int32), of)
            assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
        y = torch.randint(0, 2 * q, (8, width), generator=gen, device=dev)
        assert torch.equal(st.ntt32_stages_inverse(log_w, q, wi, pi, y),
                           st.ntt32_stages_inverse_plain(log_w, q, wi, pi, y))
    for q in (4611686018425815041, next_ntt_prime(50, log_n)):
        w, p = (t[log_d:, cols].to(dev) for t in cs.build_expanded_tables64(log_n, q))
        wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables64(log_n, q))
        x = _below(gen, [q], (2, width), 4, dev)[0]
        for of in (1, 2, 4):
            assert torch.equal(st.ntt64_stages_forward(log_w, q, w, p, x, of),
                               st.ntt64_stages_forward_plain(log_w, q, w, p, x, of))
        for in_factor in (2, 4):
            y = _below(gen, [q], (2, width), in_factor, dev)[0]
            assert torch.equal(st.ntt64_stages_inverse(log_w, q, wi, pi, y, in_factor),
                               st.ntt64_stages_inverse_plain(log_w, q, wi, pi, y, in_factor))


def test_local_mesh_rotation_and_coeff_sharded_match_single_card(dev):
    """A (residue 2, batch 2) LocalMesh rotation step on the card equals the
    single-card ``dcrt_blind_rotate_batched`` on both routes, with one
    inverse and one forward launch a shard a step; the coefficient-sharded
    u64 round trip at n = 2^12 over 4 shards equals the input."""
    from primus_fhe_tpu_torch.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.parallel import (LocalMesh, coeff_sharded_forward64,
                                               coeff_sharded_inverse64, make_sharded_blind_rotation,
                                               shard, shard_rotation_inputs, unshard)
    from primus_fhe_tpu_torch.parallel.sharded_rotation import ACC_SPEC
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64
    from primus_fhe_tpu_torch.transforms.ntt import forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan64

    log_n, n_lwe, bsz = 10, 3, 4
    n = 1 << log_n
    base = RNSBase64(Q50)
    basis = BigUintApproxSignedBasis(base, 25)
    plan = build_dcrt_plan64(log_n, Q50)
    gen = torch.Generator(device=dev).manual_seed(12)
    bsk = _below(gen, Q50, (n_lwe, 2, basis.decompose_length, 2, n), 1, dev).movedim(0, 3)
    acc = _below(gen, Q50, (bsz, 2, n), 1, dev).transpose(0, 1).contiguous()
    lwe = torch.randint(0, 2 * n, (bsz, n_lwe + 1), generator=gen, device=dev)
    mesh = LocalMesh(2, 2, dev)
    for route, fwd, inv in (("auto", ntt_mxu8.mxu8_forward64, ntt_mxu8.mxu8_inverse64),
                            ("butterfly", ntt64.ntt64_forward, ntt64.ntt64_inverse)):
        want = dcrt_blind_rotate_batched(plan, basis, base, bsk.contiguous(), lwe, acc, route=route)
        fn = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, route)
        args = shard_rotation_inputs(mesh, "residue", "batch", bsk.contiguous(), lwe, acc)
        fwd.launches = inv.launches = 0
        got = unshard(mesh, fn(*args), ACC_SPEC)
        assert fwd.launches == inv.launches == mesh.size * n_lwe
        assert torch.equal(got, want)
    q = 4611686018425815041
    x = _below(gen, [q], (2, 1 << 12), 1, dev)[0]
    cmesh = LocalMesh(4, 1, dev)
    f = coeff_sharded_forward64(cmesh, "residue", 12, q, shard(cmesh, x, (None, "residue")))
    assert torch.equal(unshard(cmesh, f, (None, "residue")), forward64(build_plan64(12, q, dev), x))
    back = coeff_sharded_inverse64(cmesh, "residue", 12, q, f)
    assert torch.equal(unshard(cmesh, back, (None, "residue")), x)


def _lazy_equal(got, plain, q):
    """The lazy-word rule: ``got`` below 2q and equal to ``plain`` mod q."""
    from primus_fhe_tpu_torch.modular.modops import reduce_once64

    assert bool((got >= 0).all() and (got < 2 * q).all())
    assert torch.equal(reduce_once64(got, q), plain)


@pytest.mark.parametrize("log_n,q", [(8, Q50[0]), (12, Q50[1]), (8, Q60), (12, Q60)])
def test_split_kernels_match_plain(dev, log_n, q):
    """Row 13's K1, K2, Ki1 (with and without the key) and Ki2 on shard
    ``d - 1`` of D = 1, 2, 4 (where D divides A = n / 128), batch 3 and 64:
    K2 and Ki2 bit-equal to their plain versions, K1 and Ki1 by the lazy
    rule; each launch counted once."""
    from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
    from primus_fhe_tpu_torch.parallel.coeff_sharded_mxu import get_sharded_plan

    plan = get_sharded_plan(log_n, q)
    tables, A, B = plan.tables, plan.A, plan.B
    gen = torch.Generator(device=dev).manual_seed(log_n + q % 97)
    mt = tables.mul_table(_below(gen, [q], (1 << log_n,), 1, dev)[0][None])
    for d in (1, 2, 4):
        if A % d:
            continue
        k0_off, r0_off = plan.offsets(d, d - 1)
        for batch in (3, 64):
            lanes = _u64_words(gen, (1, A, B // d * batch), dev)
            rows = _u64_words(gen, (1, A // d * batch, B), dev)
            key = mt.reshape(1, 2, A, B)[:, :, r0_off:r0_off + A // d].reshape(1, 2, -1)
            key = key.contiguous()
            for fn in (split.split_k1, split.split_k2, split.split_ki1, split.split_ki2):
                fn.launches = 0
            _lazy_equal(split.split_k1(tables, lanes, batch, k0_off),
                        split.split_k1_plain(tables, lanes, batch, k0_off), q)
            assert torch.equal(split.split_k2(tables, rows), split.split_k2_plain(tables, rows))
            for k in (None, key):
                _lazy_equal(split.split_ki1(tables, rows, batch, r0_off, k),
                            split.split_ki1_plain(tables, rows, batch, r0_off, k), q)
            assert torch.equal(split.split_ki2(tables, lanes), split.split_ki2_plain(tables, lanes))
            assert (split.split_k1.launches, split.split_k2.launches, split.split_ki1.launches,
                    split.split_ki2.launches) == (1, 1, 2, 1)


@pytest.mark.parametrize("log_n,q,d", [(10, Q60, 8), (12, Q50[0], 4)])
def test_coeff_sharded_mxu_matches_fused(dev, log_n, q, d):
    """The sharded forward and keyed inverse on a LocalMesh equal
    ``mxu8_forward64`` and kernel D; the plain inverse round-trips."""
    from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard

    plan = csm.get_sharded_plan(log_n, q)
    gen = torch.Generator(device=dev).manual_seed(d)
    x = _below(gen, [q], (16, 1 << log_n), 1, dev)[0]
    mt = plan.tables.mul_table(_below(gen, [q], (1 << log_n,), 1, dev)[0][None])
    mesh = LocalMesh(d, 1, dev)
    coeff, ntt = (None, "residue", None), ("residue", None, None)
    f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q,
                                  shard(mesh, csm.to_coeff_layout(x, plan.A, plan.B), coeff))
    want = ntt_mxu8.mxu8_forward64(plan.tables, x[None])[0]
    assert torch.equal(csm.ntt_layout_to_flat(unshard(mesh, f, ntt)), want)
    back = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f)
    assert torch.equal(csm.from_coeff_layout(unshard(mesh, back, coeff)), x)
    prod = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=mt)
    assert torch.equal(csm.from_coeff_layout(unshard(mesh, prod, coeff)),
                       ntt_mxu8.mxu8_inverse64_mul(plan.tables, want[None], mt)[0])


def test_dcrt32_sharded_product_and_torus64(dev):
    """The 32-bit DCRT transforms (five primes: two launches), the sharded
    external product on a (2, 2) LocalMesh and the 64-bit torus product on
    the card equal their CPU runs."""
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis64
    from primus_fhe_tpu_torch.lattice import tfhe64
    from primus_fhe_tpu_torch.parallel import LocalMesh, sharded, unshard
    from primus_fhe_tpu_torch.transforms import dcrt

    gen = torch.Generator(device=dev).manual_seed(32)
    plan = dcrt.build_dcrt_plan32(10, PRIMES3 + [1073453057, 1073442817])
    x = _residues(gen, plan.moduli, (3, 1 << 10), 4, dev)
    for of in (1, 4):
        assert torch.equal(dcrt.dcrt_forward32(plan, x, of).cpu(),
                           dcrt.dcrt_forward32(plan, x.cpu(), of))
    y = _residues(gen, plan.moduli, (3, 1 << 10), 2, dev)
    assert torch.equal(dcrt.dcrt_inverse32(plan, y).cpu(), dcrt.dcrt_inverse32(plan, y.cpu()))
    conv = tfhe.make_convolver(10, 3, 1, 7)
    basis = ApproxSignedBasis32(None, 7, reverse_length=3)
    glwe = torch.randint(0, 1 << 32, (4, 2, 1 << 10), generator=gen, device=dev)
    key = _residues(gen, conv.primes, (2, 3, 2, 1 << 10), 1, dev)
    mesh = LocalMesh(2, 2, dev)
    g, k = sharded.shard_external_product_inputs(mesh, glwe, key)
    got = unshard(mesh, sharded.sharded_external_product(conv, basis, g, k, mesh),
                  sharded.glwe_spec(3))
    assert torch.equal(got, tfhe.external_product(conv, basis, glwe, key))
    b64 = ApproxSignedBasis64(None, 16, reverse_length=4)
    c64 = tfhe64.make_convolver64(10, 4, 1, 16)
    ggsw = _u64_words(gen, (2, 4, 2, 1 << 10), dev)
    glwe64 = _u64_words(gen, (3, 2, 1 << 10), dev)
    out = tfhe64.external_product64(c64, b64, glwe64, tfhe64.ggsw_to_ntt64(c64, ggsw))
    cpu = tfhe64.external_product64(c64, b64, glwe64.cpu(), tfhe64.ggsw_to_ntt64(c64, ggsw.cpu()))
    assert torch.equal(out.cpu(), cpu)
