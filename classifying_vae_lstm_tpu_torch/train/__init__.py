from .checkpoint import load_checkpoint, load_model_args

__all__ = ["load_checkpoint", "load_model_args"]
