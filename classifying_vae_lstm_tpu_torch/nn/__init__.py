from .core import dense, glorot_uniform, hard_sigmoid, init_dense, init_lstm, orthogonal
from .distributions import (
    logistic_normal_from_eps,
    sample_gaussian,
    sample_logistic_normal,
    sample_w_discrete_from_u,
)

__all__ = ["dense", "glorot_uniform", "hard_sigmoid", "init_dense", "init_lstm", "orthogonal",
           "logistic_normal_from_eps", "sample_gaussian", "sample_logistic_normal",
           "sample_w_discrete_from_u"]
