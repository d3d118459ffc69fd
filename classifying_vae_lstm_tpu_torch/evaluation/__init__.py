from .nll import (
    iw_nll_cl_vae,
    iw_nll_cl_vae_noise,
    iw_nll_cl_vrnn,
    iw_nll_cl_vrnn_noise,
    iw_nll_dataset,
    iw_nll_dataset_dp,
)

__all__ = ["iw_nll_cl_vae", "iw_nll_cl_vae_noise", "iw_nll_cl_vrnn", "iw_nll_cl_vrnn_noise",
           "iw_nll_dataset", "iw_nll_dataset_dp"]
