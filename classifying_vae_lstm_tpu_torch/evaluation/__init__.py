from .nll import iw_nll_cl_vrnn, iw_nll_cl_vrnn_noise, iw_nll_dataset

__all__ = ["iw_nll_cl_vrnn", "iw_nll_cl_vrnn_noise", "iw_nll_dataset"]
