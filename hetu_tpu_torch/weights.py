"""Carry a JAX executor's weights into the port.

``params_from_jax`` takes the JAX package's ``Executor.params`` converted
to numpy (``{name: np.asarray(v)}``) and returns the port's params under
the same variable names and in the same layout: a ``Linear`` weight stays
[in, out], because both graphs compute ``x @ w``.  With it the same
weights run through both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping[str, np.ndarray], device, dtype=None,
                    expect=None) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on ``device``}.

    ``dtype`` casts floating arrays (ints keep theirs).  ``expect``
    ({name: (shape, torch dtype)}, as ``Executor.load_params`` passes it)
    makes a missing name, an extra name or a shape mismatch raise, and
    gives each tensor its variable's dtype.
    """
    if expect is not None:
        missing = sorted(set(expect) - set(params))
        extra = sorted(set(params) - set(expect))
        if missing or extra:
            raise ValueError(
                f"params do not match the graph: missing {missing[:8]}, "
                f"extra {extra[:8]}")
    out = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: numpy cannot hand it over
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))  # a writable copy, 0-d kept
        want = dtype if dtype is not None and t.is_floating_point() else None
        if expect is not None:
            shape, var_dtype = expect[name]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(
                    f"param {name!r} has shape {tuple(t.shape)} but the "
                    f"graph expects {tuple(shape)}")
            want = want or var_dtype
        out[name] = t.to(device=device, dtype=want or t.dtype)
    return out
