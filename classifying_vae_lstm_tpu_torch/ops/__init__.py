from .lstm import lstm_step

__all__ = ["lstm_step"]
