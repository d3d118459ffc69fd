from .core import dense, hard_sigmoid
from .distributions import logistic_normal_from_eps, sample_w_discrete_from_u

__all__ = ["dense", "hard_sigmoid", "logistic_normal_from_eps", "sample_w_discrete_from_u"]
