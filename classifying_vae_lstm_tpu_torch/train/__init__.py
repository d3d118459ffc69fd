from .callbacks import AnnealSchedule, CheckpointPolicy, EarlyStoppingAfterEpoch
from .checkpoint import (load_checkpoint, load_model_args, load_opt_state, save_checkpoint,
                         save_model_in_pieces)
from .loop import Trainer, fit

__all__ = ["AnnealSchedule", "CheckpointPolicy", "EarlyStoppingAfterEpoch", "Trainer", "fit",
           "load_checkpoint", "load_model_args", "load_opt_state", "save_checkpoint",
           "save_model_in_pieces"]
