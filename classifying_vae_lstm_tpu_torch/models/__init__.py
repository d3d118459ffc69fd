from . import cl_vae, cl_vrnn

__all__ = ["cl_vae", "cl_vrnn"]
