from . import cl_vrnn

__all__ = ["cl_vrnn"]
