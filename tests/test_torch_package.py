"""The port imports no JAX, and ``chip_smoke.py`` refuses to run without a
CUDA card.  Both run in a subprocess: the root conftest imports jax into
this process."""

import os
import subprocess
import sys
from pathlib import Path

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
        + "".join(f"import {m}\n" for m in MODULES)
        + "import chip_smoke\n"
        + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
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
