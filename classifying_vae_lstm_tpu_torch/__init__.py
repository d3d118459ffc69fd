"""PyTorch/CUDA port of ``classifying_vae_lstm_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; module names match it so
each counterpart is easy to find. This package imports ``torch``, NumPy and
the standard library only — never ``jax`` and never the JAX package.

Ported so far: the cl_vrnn serving path (checkpoint loading, the model's
step functions, noise-explicit batched generation through the hand-written
whole-generation CUDA kernel ``csrc/generate_cl_vrnn.cu``, the bucketed
serving engine and its HTTP frontend), its training path (the model's
``apply`` and losses, the optimizers, the epoch trainer, checkpoint saving
and the ``cl_vrnn_train`` CLI, whose ``pallas`` backend runs the two-cell
CUDA kernels of ``csrc/two_cell.cu``), its IW-NLL evaluation and
``--two_cell off`` training (``csrc/lstm_seq.cu``), cl_vae generation and
serving at every width and without hidden layers (the two kernels of
``csrc/generate_cl_vae.cu``), both sample CLIs, and cl_vae training and
evaluation (the model's ``apply`` and losses, the ``cl_vae_train`` CLI,
whose ``pallas`` backend runs the dense-stack CUDA kernels of
``csrc/vae_dense.cu``, in f32 or, with ``--bf16_compute``, in their bf16
mode, and ``evaluate --family cl_vae``), key consistency
(``cli.key_consistency``), the train CLIs' data-based init, numerics check,
logs, profiler trace and host-streamed batches (with the C++ host runtime
of ``runtime/``), a directory of MIDI files as the corpus, and data
parallelism (``parallel/``: ``--dp`` in the train, evaluate and serve
CLIs) and tensor-parallel column sharding over a mesh's ``model`` axis
(``parallel/columns.py``; the library API only, as in the JAX package).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
``cuda`` requested and no card present they raise (:func:`resolve_device`).
Float32 is strict: TF32 is switched off for matmuls and cuDNN, because the
JAX reference computes its f32 products at ``precision="highest"``.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and no card is present (nothing falls back to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
