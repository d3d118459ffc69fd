"""Checkpoint loading in the port vs the JAX package, on the committed
trained checkpoint ``artifacts/jsball_vrnn4``."""

import dataclasses

import jax
import numpy as np
import torch

from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.train import checkpoint as jckpt
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.train import checkpoint as tckpt
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CKPT = "artifacts/jsball_vrnn4.npz"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_load_checkpoint_and_params_from_numpy_match_jax():
    ref = _flat(jckpt.load_checkpoint(CKPT))
    raw = tckpt.load_checkpoint(CKPT)
    got = _flat(params_from_numpy(raw, "cpu"))
    assert set(got) == set(ref) == set(_flat(raw))
    assert "encoder_h/recurrent_kernel" in got and "X_decoded_mean/bias" in got
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.is_contiguous()
        assert tuple(v.shape) == tuple(ref[k].shape), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


def test_params_from_numpy_takes_jax_trees_and_tensors():
    params = jckpt.load_checkpoint(CKPT)  # jax arrays
    got = _flat(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    again = _flat(params_from_numpy(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                                    "cpu", dtype=torch.float64))
    for k, v in got.items():
        assert again[k].dtype == torch.float64
        np.testing.assert_array_equal(again[k].numpy(), v.numpy().astype(np.float64))


def test_load_model_builds_an_equal_config():
    _, jcfg, jmargs = jcommon.load_model(CKPT, "cl_vrnn")
    raw, tcfg, tmargs = tcommon.load_model(CKPT, "cl_vrnn")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tmargs == jmargs
    assert (tcfg.original_dim, tcfg.intermediate_dim, tcfg.latent_dim, tcfg.n_classes) == \
        (88, 256, 8, 10)
    assert tcfg.use_x_prev and not tcfg.bf16_compute
    assert tckpt.load_model_args(CKPT) == jckpt.load_model_args(CKPT)
