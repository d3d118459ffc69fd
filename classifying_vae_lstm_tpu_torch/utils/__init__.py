from .numerics import LL_frame, bincrossentropy, logmeanexp, logsumexp

__all__ = ["LL_frame", "bincrossentropy", "logmeanexp", "logsumexp"]
