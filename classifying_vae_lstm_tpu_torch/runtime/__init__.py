from .native import build, gather_rows, is_available, sliding_window_native, song_to_roll_native

__all__ = ["build", "gather_rows", "is_available", "sliding_window_native",
           "song_to_roll_native"]
