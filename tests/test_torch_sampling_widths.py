"""Sampling at every width the JAX package samples: the routing of the
port's generation kernels on the CPU (the kernels themselves run only on
the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 34).

The JAX package samples a cl_vrnn of any width (its XLA scan past the
Pallas kernel's VMEM) and a cl_vae with hidden layers at any latent width.
So the port's f32 / bf16 cl_vrnn kernel must lay out H past 20 units a block
on 132 SMs (``gen_grid``: blocks of several unit groups), and its cl_vae
kernels must take bf16 past the cooperative kernel's latent width (the wide
kernel's bf16 mode). These tests show that no such config raises, on the
grid of an H100's 132 SMs.
"""

import dataclasses

import pytest

from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("H", [2640, 2641, 2688, 4096, 8192])
def test_cl_vrnn_grid_owns_every_unit_once(H, n_sm):
    """``gen_grid``: groups of at most 20 units (even), at most n_sm blocks
    of nv groups; the groups' columns (``_slice_cols`` at the group's nu)
    hold every gate column of every unit exactly once; up to 2,640 units on
    132 SMs it is ``int8_grid``'s grid with one group a block (today's
    layout, unchanged)."""
    nu, nv, G = cg.gen_grid(H, n_sm)
    groups = -(-H // nu)
    assert nu % 2 == 0 and nu <= cg._G_MAX_UNITS and G <= n_sm
    assert (G - 1) * nv < groups <= G * nv
    if H <= 20 * n_sm:
        assert (nu, nv, G) == (*cg.int8_grid(H, n_sm)[:1], 1, cg.int8_grid(H, n_sm)[1])
    else:
        assert nv > 1
    cols = cg._slice_cols(H, nu)
    assert cols.shape == (groups, 4 * nu)
    flat = cols.reshape(-1)
    owned = flat[flat < 4 * H]
    assert owned.numel() == 4 * H and owned.unique().numel() == 4 * H


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("H", [2640, 2688, 4096])
def test_cl_vrnn_kernel_takes_widths_past_20_units_a_block(H, mode):
    """``fits`` and the launch plan at H = 2,640 / 2,688 / 4,096 (D=88, L=2)
    on 132 SMs: the kernel takes each config, one launch holds all 256
    songs of the largest serving bucket, its state fits a block's shared
    memory, and the slices are resident only with one group a block."""
    cfg = tcl.Config(original_dim=88, intermediate_dim=H, latent_dim=2, n_classes=13,
                     bf16_compute=mode == "bf16")
    assert cg.pick_mode(cfg) == mode and cg.fits(cfg) and cg.fits(cfg, mode)
    assert cg.smem_bytes(cfg, mode) <= cg._SMEM_LIMIT
    nu, nv, _ = cg.gen_grid(H, 132)
    assert cg.launch_songs(nu, nv, 2) == cg._G_MAX_SONGS
    for B in (1, 64, 256):
        assert cg.gen_smem(nu, B, 2, 0, nv) <= cg._SMEM_LIMIT
        if nv > 1:
            assert cg.resident_bytes(88, H, 2, nu, B, True, mode, nv) == 0


def test_cl_vrnn_launch_songs_shrink_with_groups_and_name_the_limit():
    """More groups a block leave room for fewer songs a launch (multiples of
    16; a call takes more in several launches), and only a width whose c of
    16 songs passes the limit is refused, by ``fits``."""
    prev = cg._G_MAX_SONGS
    for H in (4096, 8192, 20000, 40000):
        nu, nv, _ = cg.gen_grid(H, 132)
        n = cg.launch_songs(nu, nv, 2)
        assert 0 < n <= prev and n % 16 == 0
        assert cg.gen_smem(nu, n, 2, 0, nv) <= cg._SMEM_LIMIT
        assert n == cg._G_MAX_SONGS or cg.gen_smem(nu, n + 16, 2, 0, nv) > cg._SMEM_LIMIT
        assert cg.fits(tcl.Config(original_dim=88, intermediate_dim=H, latent_dim=2))
        prev = n
    huge = tcl.Config(original_dim=88, intermediate_dim=100_000, latent_dim=2)
    nu, nv, _ = cg.gen_grid(100_000, 132)
    assert cg.launch_songs(nu, nv, 2) == 0 and not cg.fits(huge)
    assert cg.smem_bytes(huge, "f32") > cg._SMEM_LIMIT


def _vae(L, mode, use_x_prev=False):
    return tvae.Config(original_dim=1024, intermediate_dim=5120, latent_dim=L,
                       intermediate_class_dim=256, n_classes=13, use_x_prev=use_x_prev,
                       bf16_compute=mode == "bf16")


@pytest.mark.parametrize("use_x_prev", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("L", [105, 106, 128])
def test_cl_vae_every_latent_width_gets_a_kernel(L, mode, use_x_prev):
    """D=1,024, H=5,120 at L = 105 / 106 / 128, f32 and bf16: ``kernel_for``
    names a kernel for each, and it lays the config out. The cooperative
    kernel's plan (``coop_plan``) takes L=105 on 132 SMs for 1 and 64 songs;
    past it (where ``coop_plan`` refuses, naming the shared-memory limit)
    the wide kernel takes the config in both modes, its per-song state in
    shared memory or in its global scratch."""
    cfg = _vae(L, mode, use_x_prev)
    assert cgv.pick_mode(cfg) == mode and not cgv.fits(cfg, mode)
    kernel = cgv.kernel_for(cfg, mode)
    if L <= 105:
        assert kernel == "generate_cl_vae_coop"
        for B in (1, 64):
            assert cgv.coop_plan(cfg, B, 132, mode)["G"] <= 132
    else:
        assert kernel == "generate_cl_vae_wide"
        for B in (1, 64):
            with pytest.raises(ValueError, match="shared memory"):
                cgv.coop_plan(cfg, B, 132, mode)
        # the wide kernel has no width limit: its state goes to global
        # memory where a block's shared memory does not hold it
        assert cgv._wide_smem_bytes(1024, 5120, L, True, False) <= cgv._SMEM_LIMIT


def test_cl_vae_bf16_keeps_the_jax_precision_rule():
    """Widening the route changes no precision: ``pick_mode`` is still the
    JAX package's rule (bf16 for a bf16 checkpoint on the XLA backend, int8
    in its band with ``gen_backend == "pallas"``), and an int8 config keeps
    its cooperative kernel at every latent width that kernel lays out."""
    cfg = _vae(106, "bf16")
    assert cgv.pick_mode(cfg) == "bf16"
    int8 = dataclasses.replace(_vae(16, "bf16"), gen_backend="pallas")
    assert cgv.pick_mode(int8) == "int8" and cgv.kernel_for(int8) == "generate_cl_vae_int8"
