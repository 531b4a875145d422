"""The port imports neither JAX nor the JAX package (nor does the gloo tests'
rank module ``tests/_torch_dist_workers.py``), and ``chip_smoke.py``
refuses to run without a CUDA card.  Both run in a subprocess: the root
conftest imports jax into this process.  The port's copies of the JAX
package's host helpers (parameter records, ``golden.model``, ``noise``, ``distr.stats``,
``utils.security``, ``distr.ziggurat``, ``transforms.fft``) equal the originals."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "primus_fhe_tpu_torch",
    "primus_fhe_tpu_torch.params",
    "primus_fhe_tpu_torch.boot.gates",
    "primus_fhe_tpu_torch.boot.blind_rotate",
    "primus_fhe_tpu_torch.lattice.glwe",
    "primus_fhe_tpu_torch.lattice.keyswitch",
    "primus_fhe_tpu_torch.ops.cmux_fused",
    "primus_fhe_tpu_torch.ops.ntt32",
    "primus_fhe_tpu_torch.ops.build",
    "primus_fhe_tpu_torch.distr.sampling",
    "primus_fhe_tpu_torch.transforms.torus",
    "primus_fhe_tpu_torch.ops.mxu_common",
    "primus_fhe_tpu_torch.ops.cmux_mxu",
    "primus_fhe_tpu_torch.ops.ntt_mxu8",
    "primus_fhe_tpu_torch.ops.ntru_cmux_mxu",
    "primus_fhe_tpu_torch.boot.ntru_blind_rotate",
    "primus_fhe_tpu_torch.boot.ntru_gates",
    "primus_fhe_tpu_torch.lattice.ntru",
    "primus_fhe_tpu_torch.poly",
    "primus_fhe_tpu_torch.decompose.primitive",
    "primus_fhe_tpu_torch.modular.modops",
    "primus_fhe_tpu_torch.numeric.bigint",
    "primus_fhe_tpu_torch.ops.ntt64",
    "primus_fhe_tpu_torch.transforms.dcrt",
    "primus_fhe_tpu_torch.rns.base",
    "primus_fhe_tpu_torch.decompose.big_integer",
    "primus_fhe_tpu_torch.lattice.dcrt",
    "primus_fhe_tpu_torch.boot.dcrt_blind_rotate",
    "primus_fhe_tpu_torch.golden.model",
    "primus_fhe_tpu_torch.noise",
    "primus_fhe_tpu_torch.utils.bits",
    "primus_fhe_tpu_torch.utils.gcd",
    "primus_fhe_tpu_torch.utils.primes",
    "primus_fhe_tpu_torch.transforms.ntt",
    "primus_fhe_tpu_torch.transforms.ntt_large",
    "primus_fhe_tpu_torch.ops.rotate",
    "primus_fhe_tpu_torch.ops.cmux_front",
    "primus_fhe_tpu_torch.lattice.tfhe",
    "primus_fhe_tpu_torch.ops.ntt_stages",
    "primus_fhe_tpu_torch.ops.ntt_mxu8_dyn",
    "primus_fhe_tpu_torch.parallel",
    "primus_fhe_tpu_torch.parallel.mesh",
    "primus_fhe_tpu_torch.parallel.coeff_sharded",
    "primus_fhe_tpu_torch.parallel.overlap",
    "primus_fhe_tpu_torch.parallel.sharded_rotation",
    "primus_fhe_tpu_torch.parallel.entry",
    "primus_fhe_tpu_torch.ops.ntt_mxu8_split",
    "primus_fhe_tpu_torch.parallel.coeff_sharded_mxu",
    "primus_fhe_tpu_torch.parallel.sharded",
    "primus_fhe_tpu_torch.rns.converter",
    "primus_fhe_tpu_torch.lattice.tfhe64",
    "primus_fhe_tpu_torch.lattice.glwe_keyswitch",
    "primus_fhe_tpu_torch.lattice.glev",
    "primus_fhe_tpu_torch.lattice.lwe",
    "primus_fhe_tpu_torch.lattice.rlwe",
    "primus_fhe_tpu_torch.boot.circuit_bootstrap",
    "primus_fhe_tpu_torch.distr.stats",
    "primus_fhe_tpu_torch.poly.poly",
    "primus_fhe_tpu_torch.modular",
    "primus_fhe_tpu_torch.modular.compact",
    "primus_fhe_tpu_torch.modular.modulus",
    "primus_fhe_tpu_torch.modular.factor",
    "primus_fhe_tpu_torch.distr",
    "primus_fhe_tpu_torch.distr.ziggurat",
    "primus_fhe_tpu_torch.transforms",
    "primus_fhe_tpu_torch.transforms.fft",
    "primus_fhe_tpu_torch.tracked",
    "primus_fhe_tpu_torch.native",
    "primus_fhe_tpu_torch.golden",
    "primus_fhe_tpu_torch.utils.contracts",
    "primus_fhe_tpu_torch.utils.profiling",
    "primus_fhe_tpu_torch.utils.secrets",
    "primus_fhe_tpu_torch.utils.security",
    "primus_fhe_tpu_torch.utils.serialize",
    "_torch_dist_workers",  # tests/: the gloo ranks' module
]


def _run(code, cwd=ROOT, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        + "sys.path.insert(0, 'tests')\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "import chip_smoke\n"
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'primus_fhe_tpu'))\n"
        + "assert not bad, bad\n"
        + "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_fails_without_cuda():
    proc = _run(
        "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')",
        extra_env={"CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_host_copies_equal_the_jax_package():
    from primus_fhe_tpu import noise as jnoise
    from primus_fhe_tpu import params as jparams
    from primus_fhe_tpu.distr import stats as jstats
    from primus_fhe_tpu.golden.model import GoldenNtt as JGolden
    from primus_fhe_tpu.utils.primes import next_ntt_prime as jprime
    from primus_fhe_tpu_torch import noise, params
    from primus_fhe_tpu_torch.distr import stats
    from primus_fhe_tpu_torch.golden.model import GoldenNtt
    from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

    for name in ("TOY", "BOOLEAN_128", "BOOLEAN_TFHE_LIB", "NTRU_128"):
        assert dataclasses.asdict(getattr(params, name)) == dataclasses.asdict(
            getattr(jparams, name)), name
    assert params.NTRU_128.q == jparams.NTRU_128.q and params.BOOLEAN_128.n == 2048
    for log_n, q in [(4, 998244353), (6, 1125899906826241), (5, 4611686018425815041)]:
        g, j = GoldenNtt(log_n, q), JGolden(log_n, q)
        for attr in ("root", "inv_root", "inv_n", "inv_n_w", "roots", "inv_roots",
                     "ordinal_roots", "reverse_lsbs"):
            assert getattr(g, attr) == getattr(j, attr), attr
        r = pow(g.root, 3, q)
        assert GoldenNtt(log_n, q, r).roots == JGolden(log_n, q, r).roots
    assert next_ntt_prime(30, 11) == jprime(30, 11)
    assert next_ntt_prime(50, 12, 1125899906826241) == jprime(50, 12, 1125899906826241)
    for p in (params.BOOLEAN_128, params.TOY):
        args = (p.lwe_dim, p.glwe_sigma, p.n, p.glwe_dim, p.level, p.log_basis, 3)
        br, jbr = noise.blind_rotate(*args), jnoise.blind_rotate(*args)
        assert br.variance == jbr.variance
        ks_args = (p.lwe_sigma, p.n, p.ks_level, p.ks_log_basis, 20)
        assert noise.key_switch(br, *ks_args).stddev == jnoise.key_switch(jbr, *ks_args).stddev
    samples = np.random.default_rng(0).integers(-12, 13, 3000)
    for name in ("sample_moments", "max_cdf_distance", "chi2_statistic"):
        args = (samples,) if name == "sample_moments" else (samples, 3.2, 20)
        assert getattr(stats, name)(*args) == getattr(jstats, name)(*args), name
    assert np.array_equal(stats.discrete_gaussian_pmf(3.2, 20), jstats.discrete_gaussian_pmf(3.2, 20))
    from primus_fhe_tpu.distr import ziggurat as jzig
    from primus_fhe_tpu.golden import model as jmodel
    from primus_fhe_tpu.transforms import fft as jfft
    from primus_fhe_tpu.utils import security as jsec
    from primus_fhe_tpu_torch.distr import ziggurat
    from primus_fhe_tpu_torch.golden import model
    from primus_fhe_tpu_torch.transforms import fft
    from primus_fhe_tpu_torch.utils import security

    q = 1125899906826241
    assert model.barrett_lazy_reduce_wide(12345, 678, q, 64) == jmodel.barrett_lazy_reduce_wide(
        12345, 678, q, 64)
    a, b = list(range(1, 17)), list(range(30, 14, -1))
    assert model.GoldenNtt(4, q).negacyclic_mul(a, b) == jmodel.naive_negacyclic_mul(a, b, q)
    est, jest = security.lwe_security(630, 2.0**32, 2.0**17), jsec.lwe_security(630, 2.0**32, 2.0**17)
    assert dataclasses.astuple(est) == dataclasses.astuple(jest)
    f = noise.NoiseEstimate(3.0)
    assert noise.modulus_switch(f, 630, 12) == noise.NoiseEstimate(
        jnoise.modulus_switch(jnoise.NoiseEstimate(3.0), 630, 12).variance)
    assert noise.cmux(f, 3.2, 2048, 1, 3, 7, 11).variance == jnoise.cmux(
        jnoise.NoiseEstimate(3.0), 3.2, 2048, 1, 3, 7, 11).variance
    z, jz = ziggurat.DiscreteZiggurat(40.0), jzig.DiscreteZiggurat(40.0)
    assert np.array_equal(z.x, jz.x) and np.array_equal(z.y, jz.y)
    t, jt = fft.Complex128FftTable(4), jfft.Complex128FftTable(4)
    assert np.array_equal(t.twist, jt.twist) and np.array_equal(t.inv_twist_scaled,
                                                                jt.inv_twist_scaled)
