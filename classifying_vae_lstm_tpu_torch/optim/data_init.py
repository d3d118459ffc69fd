"""Weight-norm data-dependent initialization.

Counterpart of ``classifying_vae_lstm_tpu/optim/data_init.py``. The
reference's ``data_based_init`` (utils/weightnorm.py:182-210) is a silent
no-op under its pinned Keras 2.0.0 (quirk Q4); the JAX package and this one
give a working version behind ``--data_init`` (default off). The sequential
walks visit every dense layer in forward order, each rescaled from its
pre-activation on a data batch computed through the already-rescaled
earlier layers: per-unit moments over all but the last axis, ``s =
sqrt(var + 1e-10)``, ``kernel /= s`` and ``bias := (bias - mean) / s``. The
LSTM layers are untouched, and run through the plain
:func:`..ops.lstm.lstm_sequence` (the JAX package uses its scan there, no
kernel).

The stochastic nodes (w, z) are drawn once: each family has a
noise-explicit core (``eps_w``, ``eps_z``) and a ``torch.Generator``
wrapper. Pre-activations are f32 products with TF32 off (the package turns
it off), as the JAX ``precision="highest"``.
"""

from __future__ import annotations

import torch

from ..nn.distributions import logistic_normal_from_eps
from ..ops.lstm import lstm_sequence


def _normalized(layer: dict, preact) -> dict:
    """One reference update (weightnorm.py:205-209): per-unit moments over all
    but the last axis; kernel /= s, bias := (bias - mean)/s."""
    dims = tuple(range(preact.ndim - 1))
    mean = torch.mean(preact, dim=dims)
    s = torch.sqrt(torch.var(preact, dim=dims, correction=0) + 1e-10)
    return {
        "kernel": layer["kernel"] / s.reshape((1,) * (layer["kernel"].ndim - 1) + (-1,)),
        "bias": (layer["bias"] - mean) / s,
    }


def data_based_init(params: dict, preactivations: dict) -> dict:
    """Rescale named dense layers by data moments (single-shot form):
    ``preactivations`` maps layer names of ``params`` to their
    pre-activation outputs ``[batch..., out_dim]`` on a data batch. Layers
    without an entry are kept. The sequential per-family functions below
    recompute each layer's input through the earlier, rescaled layers."""
    new_params = dict(params)
    for name, o in preactivations.items():
        layer = params[name]
        if not (isinstance(layer, dict) and "kernel" in layer):
            continue
        new_params[name] = _normalized(layer, o)
    return new_params


def _pre(layer, x):
    return torch.matmul(x, layer["kernel"]) + layer["bias"]


@torch.no_grad()
def data_based_init_cl_vae_noise(params: dict, cfg, batch: dict, eps_w, eps_z) -> dict:
    """Sequential data-dependent init of every cl_vae dense layer (h_w ->
    w heads -> [h] -> z heads -> [decoder_h] -> x_decoded_mean) with the
    draws given: ``eps_w [B, K-1]`` for w, ``eps_z [B, L]`` for z."""
    p = {k: dict(v) for k, v in params.items()}
    x = batch["x"]

    p["h_w"] = _normalized(p["h_w"], _pre(p["h_w"], x))
    h_w = torch.relu(_pre(p["h_w"], x))
    for name in ("w_mean", "w_log_var"):
        p[name] = _normalized(p[name], _pre(p[name], h_w))
    w = logistic_normal_from_eps(_pre(p["w_mean"], h_w), _pre(p["w_log_var"], h_w), eps_w)

    xw = torch.cat([x, w], dim=-1)
    if cfg.has_hidden:
        p["h"] = _normalized(p["h"], _pre(p["h"], xw))
        h = torch.relu(_pre(p["h"], xw))
    else:
        h = xw
    for name in ("z_mean", "z_log_var"):
        p[name] = _normalized(p[name], _pre(p[name], h))
    z = _pre(p["z_mean"], h) + torch.exp(_pre(p["z_log_var"], h) / 2) * eps_z

    xpz = torch.cat([batch["x_prev"], z], dim=-1) if cfg.use_x_prev else z
    wz = torch.cat([w, xpz], dim=-1)
    if cfg.has_hidden:
        p["decoder_h"] = _normalized(p["decoder_h"], _pre(p["decoder_h"], wz))
        hd = torch.relu(_pre(p["decoder_h"], wz))
    else:
        hd = wz
    p["x_decoded_mean"] = _normalized(p["x_decoded_mean"], _pre(p["x_decoded_mean"], hd))
    return p


def data_based_init_cl_vae(params: dict, cfg, batch: dict, generator: torch.Generator) -> dict:
    """:func:`data_based_init_cl_vae_noise` with eps_w, then eps_z, drawn
    from ``generator`` (on the batch's device)."""
    B, dev = batch["x"].shape[0], batch["x"].device
    eps_w = torch.randn((B, cfg.n_classes - 1), generator=generator, device=dev)
    eps_z = torch.randn((B, cfg.latent_dim), generator=generator, device=dev)
    return data_based_init_cl_vae_noise(params, cfg, batch, eps_w, eps_z)


@torch.no_grad()
def data_based_init_cl_vrnn_noise(params: dict, cfg, batch: dict, eps_w, eps_z) -> dict:
    """Sequential data-dependent init of every cl_vrnn dense layer (hW ->
    Wargs -> (encoder LSTM) -> Z_mean / Z_log_var -> (decoder LSTM) ->
    X_decoded_mean) with the draws given: ``eps_w [B, K-1]`` for W,
    ``eps_z [B, T, L]`` for Z."""
    p = {k: dict(v) for k, v in params.items()}
    x = batch["x"]
    K1 = cfg.n_classes - 1

    flat = x.reshape(x.shape[:-2] + (cfg.seq_length * cfg.original_dim,))
    p["hW"] = _normalized(p["hW"], _pre(p["hW"], flat))
    hW = torch.relu(_pre(p["hW"], flat))
    p["Wargs"] = _normalized(p["Wargs"], _pre(p["Wargs"], hW))
    Wargs = _pre(p["Wargs"], hW)
    W = logistic_normal_from_eps(Wargs[..., :K1], Wargs[..., K1:], eps_w)
    W_seq = W[:, None, :].expand(x.shape[0], x.shape[1], W.shape[-1])

    h_seq, _ = lstm_sequence(p["encoder_h"], torch.cat([x, W_seq], dim=-1))
    for name in ("Z_mean", "Z_log_var"):
        p[name] = _normalized(p[name], _pre(p[name], h_seq))
    Z = _pre(p["Z_mean"], h_seq) + torch.exp(_pre(p["Z_log_var"], h_seq) / 2) * eps_z

    xpz = torch.cat([batch["x_prev"], Z], dim=-1) if cfg.use_x_prev else Z
    hd_seq, _ = lstm_sequence(p["decoder_h"], torch.cat([xpz, W_seq], dim=-1))
    p["X_decoded_mean"] = _normalized(p["X_decoded_mean"], _pre(p["X_decoded_mean"], hd_seq))
    return p


def data_based_init_cl_vrnn(params: dict, cfg, batch: dict,
                            generator: torch.Generator) -> dict:
    """:func:`data_based_init_cl_vrnn_noise` with eps_w, then eps_z, drawn
    from ``generator`` (on the batch's device)."""
    B, T = batch["x"].shape[:2]
    dev = batch["x"].device
    eps_w = torch.randn((B, cfg.n_classes - 1), generator=generator, device=dev)
    eps_z = torch.randn((B, T, cfg.latent_dim), generator=generator, device=dev)
    return data_based_init_cl_vrnn_noise(params, cfg, batch, eps_w, eps_z)
