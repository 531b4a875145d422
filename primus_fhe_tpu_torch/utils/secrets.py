"""Secret-material hygiene (port of ``primus_fhe_tpu/utils/secrets.py``).

The reference zeroizes secret-capable integers on drop (``zeroize`` on
``Integer``, crates/primus_integer/src/integer.rs:88).  Torch tensors are
mutable, so :func:`delete` overwrites a tensor's words with zeros in place,
on the card as on the CPU, before the caller drops it; views share the
zeroed storage.
"""

from __future__ import annotations

import numpy as np
import torch


def delete(*tensors) -> None:
    """Zeroes tensors holding secret material in place (any device); tuples
    and lists (an MXU key pack) are walked, other objects left alone."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                t.zero_()
        elif isinstance(t, (tuple, list)):
            delete(*t)


def scrub_host(*arrays) -> None:
    """Overwrites writeable host NumPy buffers (and CPU tensors) with zeros in
    place."""
    for a in arrays:
        if isinstance(a, np.ndarray) and a.flags.writeable:
            a.fill(0)
        elif isinstance(a, torch.Tensor) and a.device.type == "cpu":
            delete(a)
