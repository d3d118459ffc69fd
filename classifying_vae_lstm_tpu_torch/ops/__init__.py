from .lstm import lstm_sequence, lstm_step

__all__ = ["lstm_sequence", "lstm_step"]
