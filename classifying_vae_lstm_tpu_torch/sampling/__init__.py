from .generate import (
    draw_generation_noise,
    generate_cl_vae_batch,
    generate_cl_vae_batch_noise,
    generate_cl_vrnn_batch,
    generate_cl_vrnn_batch_noise,
    infer_w_cl_vae,
    infer_w_cl_vrnn,
    infer_w_cl_vrnn_noise,
)

__all__ = [
    "draw_generation_noise",
    "generate_cl_vae_batch",
    "generate_cl_vae_batch_noise",
    "generate_cl_vrnn_batch",
    "generate_cl_vrnn_batch_noise",
    "infer_w_cl_vae",
    "infer_w_cl_vrnn",
    "infer_w_cl_vrnn_noise",
]
