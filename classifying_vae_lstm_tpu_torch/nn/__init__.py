from .core import (
    dense,
    glorot_uniform,
    hard_sigmoid,
    init_dense,
    init_lstm,
    orthogonal,
    random_normal_init,
)
from .distributions import (
    gaussian_kl,
    logistic_normal_from_eps,
    logistic_normal_kl,
    sample_gaussian,
    sample_logistic_normal,
    sample_w_discrete,
    sample_w_discrete_from_u,
)
from .losses import (
    binary_crossentropy,
    categorical_crossentropy,
    kl_loss,
    vae_loss,
    w_kl_loss,
    w_rec_loss,
)

__all__ = ["binary_crossentropy", "categorical_crossentropy", "dense", "gaussian_kl",
           "glorot_uniform", "hard_sigmoid", "init_dense", "init_lstm", "kl_loss",
           "logistic_normal_from_eps", "logistic_normal_kl", "orthogonal", "random_normal_init",
           "sample_gaussian", "sample_logistic_normal", "sample_w_discrete",
           "sample_w_discrete_from_u", "vae_loss", "w_kl_loss", "w_rec_loss"]
