"""The four ELBO terms with Keras-2.0 reduction semantics.

* ``binary_crossentropy`` means over the last axis after clipping the
  probabilities to [1e-7, 1 - 1e-7] (the Keras backend epsilon), and
  ``vae_loss`` multiplies it by ``original_dim``;
* ``kl_loss`` sums over the latent axis (per timestep for rank-3 inputs);
* ``w_rec_loss`` is ``(K-1) *`` the categorical cross-entropy, with Keras's
  renormalization of the predictions;
* the training loss is the weighted sum of the mean of each term over all
  remaining axes.
"""

from __future__ import annotations

import torch

_EPSILON = 1e-7  # Keras 2.0 backend epsilon


def binary_crossentropy(y_true, y_pred):
    """Keras losses.binary_crossentropy: mean BCE over the last axis."""
    p = torch.clamp(y_pred, _EPSILON, 1.0 - _EPSILON)
    bce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
    return torch.mean(bce, dim=-1)


def categorical_crossentropy(y_true, y_pred):
    """Keras losses.categorical_crossentropy: renormalize, clip, -sum t*log(p)."""
    p = y_pred / torch.sum(y_pred, dim=-1, keepdim=True)
    p = torch.clamp(p, _EPSILON, 1.0 - _EPSILON)
    return -torch.sum(y_true * torch.log(p), dim=-1)


def vae_loss(x_true, x_decoded_mean, original_dim):
    """original_dim * BCE: per-frame reconstruction nats."""
    return original_dim * binary_crossentropy(x_true, x_decoded_mean)


def kl_loss(z_mean, z_log_var):
    """Standard Gaussian KL summed over the latent axis."""
    return -0.5 * torch.sum(1 + z_log_var - torch.square(z_mean) - torch.exp(z_log_var), dim=-1)


def w_kl_loss(w_mean, w_log_var, w_log_var_prior=0.0):
    """KL of the logit-Normal posterior against N(0, e^prior I)."""
    prior = torch.exp(torch.as_tensor(w_log_var_prior, dtype=w_mean.dtype, device=w_mean.device))
    vs = 1 - w_log_var_prior + w_log_var - torch.exp(w_log_var) / prior - torch.square(w_mean) / prior
    return -0.5 * torch.sum(vs, dim=-1)


def w_rec_loss(w_true, w, n_classes):
    """(K-1) * categorical CE: supervised key classification."""
    return (n_classes - 1) * categorical_crossentropy(w_true, w)
