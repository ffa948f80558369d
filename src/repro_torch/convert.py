"""Carry the reference's stacked cell state across to the port.

``repro.core.vectorsim._stack_cells`` (and the port's own copy of it)
lowers a grid to a dict of numpy arrays, one leading cell axis per field.
``cells_from_numpy`` turns that dict into the tensors the port's group
kernel reads, so both sides can run from identical state: for the batch
model this stacked dict is what weights are to a model.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def cells_from_numpy(batch: Dict[str, np.ndarray], device
                     ) -> Dict[str, torch.Tensor]:
    """float32 stays float32, every integer type (incl. the uint32 PRNG
    ``key``) becomes int64, bool stays bool.  Any other dtype raises: a
    float64 field would silently promote the kernel's f32 arithmetic."""
    out = {}
    for name, v in batch.items():
        a = np.asarray(v)
        if a.dtype == np.float32 or a.dtype == np.bool_:
            t = torch.from_numpy(np.ascontiguousarray(a))
        elif a.dtype.kind in "iu":
            t = torch.from_numpy(a.astype(np.int64))
        else:
            raise TypeError(f"cell field {name!r} has dtype {a.dtype}; "
                            f"expected float32, bool or an integer type")
        out[name] = t.to(device)
    return out
