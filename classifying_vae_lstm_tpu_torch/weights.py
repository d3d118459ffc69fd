"""Parameter trees: the JAX package's layout as PyTorch tensors.

The JAX package keeps parameters as nested dicts (``params["encoder_h"]
["kernel"]``) with dense and LSTM kernels stored ``[in, out]``. The port keeps
exactly those names and layouts, so a checkpoint written by either package
loads into the other and tests can hand both the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device, dtype=torch.float32) -> dict:
    """Nested dict of arrays (NumPy or tensors) -> the same dict of tensors.

    ``tree`` is what :func:`..train.checkpoint.load_checkpoint` returns, or
    ``jax.tree.map(np.asarray, params)`` of the JAX package's parameters.
    Names and layouts are kept; every leaf becomes a contiguous ``dtype``
    tensor on ``device``.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
    return t.to(device=device, dtype=dtype).contiguous()


def params_on_model_axis(tree, devices, dtype=torch.float32) -> dict:
    """Nested dict of arrays -> the tensor-parallel placement of one mesh
    row whose model devices are ``devices``: each leaf that JAX's rule
    column-shards (rank >= 2, last dimension divisible by
    ``len(devices)``) a :class:`.parallel.ColumnShards`, slice j on
    ``devices[j]``; the rest on ``devices[0]``. What
    ``parallel.shard_params`` gives on ``make_mesh(1, len(devices),
    devices)``, made from the host arrays."""
    from .parallel import make_mesh, shard_params

    return shard_params(params_from_numpy(tree, "cpu", dtype),
                        make_mesh(1, len(devices), devices))[0]
