"""The cluster cl_vae generation kernel's plan, packing, routing and sum
order, on the CPU.

``csrc/generate_cl_vae.cu`` ``generate_cluster_kernel`` runs every f32 / bf16
config whose weights fit the shared memory of a cluster of at most 8 blocks
(:func:`cluster_plan`): each cluster owns one song, block r of it a
share of the hidden units and of the pitches, its slices packed by
:func:`pack_cluster`. It runs only on the card; what surrounds it is Python
that these tests reach. The plan must own every hidden unit, pitch and song
exactly once and stay within Hopper's shared memory; the routing must give
every config a kernel, the committed checkpoints this one at C = 1; and a
plain-torch emulation of the kernel's arithmetic — the packed slabs read
back as its lanes read them, each column's k split over g lanes in chunks
li, li + g, ..., the lanes' sums added by the butterfly, the z heads' block
sums added in rank order, the epilogues in the JAX kernel's f32 order —
must match ``generate_cl_vae_batch_plain`` and the JAX package (the Pallas
kernel in interpret mode; for a config without hidden layers, the
noise-explicit scan) with the same numpy noise. Tolerances: f32
probabilities (u = 1) within 1e-5, as ``chip_smoke.py`` phase 11 holds the
kernel (only the summation order differs); frames equal away from a near
tie; bf16 within max 2e-2 / mean 2e-3 of the JAX bf16 kernel (bf16 rounding
at the same places, another summation order), as the other bf16 tests.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.ops import pallas_generate_vae
from classifying_vae_lstm_tpu.sampling.generate import generate_cl_vae_batch_noise as jax_noise
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

K = 13
CHECKPOINTS = ("jsball_vae", "jsbcs_vae", "jsball_vanilla", "pm_configs/c3")


def _cfg(D, H, L, use_x_prev=True, mode="f32"):
    return tvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                       intermediate_class_dim=32, n_classes=K, use_x_prev=use_x_prev,
                       bf16_compute=mode == "bf16")


# widths whose fewest blocks are C = 1, 2, 4 and 8 (f32, D=88, L=4, x_prev)
WIDTH_FOR_C = {1: 88, 2: 256, 4: 512, 8: 1024}


@pytest.mark.parametrize("C", sorted(WIDTH_FOR_C))
@pytest.mark.parametrize("n_sm", [132, 114])
def test_plan_owns_every_unit_pitch_and_song_once(C, n_sm):
    """Block b of the grid is rank b % C of cluster b // C: song b // C,
    units r Hc .. below H, pitches r Dc .. below D. Every (song, unit) and
    (song, pitch) pair is some block's exactly once, for B = 1, 5, 64 and
    300; every block's layout is within shared memory, and the waves are
    the grid over the clusters one pass of the card holds."""
    cfg = _cfg(88, WIDTH_FOR_C[C], 4)
    D, H = cfg.original_dim, cfg.intermediate_dim
    for B in (1, 5, 64, 300):
        plan = cgv.cluster_plan(cfg, B, "f32", n_sm=n_sm)
        assert plan["C"] == C and plan["clusters"] == B
        assert plan["bytes"] <= cgv._SMEM_LIMIT
        Hc, Dc = plan["Hc"], plan["Dc"]
        units = np.zeros((B, H), np.int32)
        pitches = np.zeros((B, D), np.int32)
        for blk in range(plan["clusters"] * C):
            song, r = divmod(blk, C)
            units[song, r * Hc : min(H, r * Hc + Hc)] += 1
            pitches[song, r * Dc : min(D, r * Dc + Dc)] += 1
        assert (units == 1).all() and (pitches == 1).all(), (C, B)
        per_wave = n_sm // C
        assert plan["waves"] == -(-plan["clusters"] // per_wave)


def test_layout_is_the_kernels_rule():
    """Slab rows hold every chunk a lane reads (rs >= nck g), an odd
    multiple of g chunks below g = 8 (the lanes of a warp on distinct
    banks: c rs + li distinct mod 8 for the 8 / g columns of a phase), and
    an operand row covers the chunks its layer reads; with hidden layers
    the z heads' slab holds a row of the block's units per head (read a
    unit at a time by the encoder's lanes)."""
    for D, H, L, xp, mode in ((88, 88, 4, True, "f32"), (88, 256, 4, True, "bf16"),
                              (37, 70, 3, True, "bf16"), (88, 0, 4, True, "f32"),
                              (1024, 256, 16, False, "bf16")):
        cfg = _cfg(D, H, L, xp, mode)
        plan = cgv.cluster_plan(cfg, 64, mode)
        kp = 16 // cgv._EBYTES[mode]
        for g, nck, rs, n in zip(plan["g"], plan["nck"], plan["rs"], plan["n"]):
            assert plan["T"] % g == 0 and g & (g - 1) == 0
            if not nck:
                continue
            assert rs >= nck * g and rs % g == 0
            if g < 8:
                assert (rs // g) % 2 == 1
                banks = {(c * rs + li) % 8 for c in range(8 // g) for li in range(g)}
                assert len(banks) == 8
        if cfg.has_hidden:
            assert plan["Da"] >= max(plan["nck"][i] * plan["g"][i] * kp for i in (0, 2))
            assert plan["Ha"] >= plan["nck"][3] * plan["g"][3] * kp >= H
            assert plan["g"][1] == 1 and plan["rs"][1] * kp >= plan["Hc"]  # a unit a column
        else:
            assert plan["Da"] >= max(plan["nck"][i] * plan["g"][i] * kp for i in (1, 3))


def _routing_grid():
    for D in (12, 88, 700, 1024):
        for H in (0, 16, 88, 256, 512, 1024, 2048, 5120):
            for L in (2, 4, 16):
                for xp in (False, True):
                    for mode in ("f32", "bf16"):
                        if H == 0 and mode == "bf16":
                            continue  # a config without hidden layers samples in f32
                        yield _cfg(D, H, L, xp, mode), mode


def test_routing_gives_every_config_a_kernel():
    """Every f32 / bf16 config takes a kernel: the cluster one wherever its
    plan fits (the committed checkpoints at C = 1), else with hidden layers
    the cooperative one where it lays the config out, else the wide one
    (f32 or bf16 weights). The wide kernel keeps exactly these configs:
    without hidden layers and past 8 blocks (x_prev from D ~ 670), and f32
    or bf16 with hidden layers past the cooperative kernel's latent
    width."""
    seen = set()
    for cfg, mode in _routing_grid():
        assert cgv.pick_mode(cfg) == mode
        kernel = cgv.kernel_for(cfg)
        seen.add(kernel)
        plan = cgv.cluster_plan(cfg, 64, mode)
        if kernel == "generate_cl_vae_cluster":
            assert plan is not None and plan["C"] in (1, 2, 4, 8)
        elif kernel == "generate_cl_vae_coop":
            assert cfg.has_hidden and plan is None
            cgv.coop_plan(cfg, 64, 132, mode)
        else:
            assert kernel == "generate_cl_vae_wide" and mode == "f32" and plan is None
            assert not cfg.has_hidden, (cfg, mode)
            assert cfg.original_dim >= 670 and cfg.use_x_prev
    assert seen == {"generate_cl_vae_cluster", "generate_cl_vae_coop", "generate_cl_vae_wide"}
    # past the cooperative kernel's latent width, with hidden layers: the
    # wide kernel in f32 and in bf16
    wide_l = _cfg(1024, 5120, 106, False, "f32")
    assert cgv.kernel_for(wide_l) == "generate_cl_vae_wide"
    assert cgv.kernel_for(dataclasses.replace(wide_l, bf16_compute=True)) == "generate_cl_vae_wide"
    for name in CHECKPOINTS:
        _, cfg, _ = tcommon.load_model(f"artifacts/{name}.npz", "cl_vae")
        mode = cgv.pick_mode(cfg)
        assert cgv.kernel_for(cfg) == "generate_cl_vae_cluster", name
        for B in (1, 64):
            plan = cgv.cluster_plan(cfg, B, mode)
            assert plan["C"] == 1, (name, plan["C"])
    int8 = dataclasses.replace(_cfg(1024, 5120, 16, False, "bf16"), gen_backend="pallas")
    assert cgv.kernel_for(int8) == "generate_cl_vae_int8" and cgv.cluster_plan(int8, 1) is None


# ---- the kernel's arithmetic, emulated in plain torch


def _fma(a, b, c):
    """f32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _halve(parts):
    """The butterfly's sum: pairs i, i + h added for h = len / 2, ..., 1
    (every lane ends with lane 0's bits)."""
    while len(parts) > 1:
        h = len(parts) // 2
        parts = [parts[i] + parts[i + h] for i in range(h)]
    return parts[0]


def _layer(slab, act, g, nck, kp):
    """One layer of one block as the kernel sums it: slab [n, rs kp] (the
    packed weights, upcast to f32), act [B, >= nck g kp] -> [B, n]. Lane li
    sums chunks li, li + g, ... (k in order within a chunk); the lanes' sums
    meet by the butterfly (offsets g/2 .. 1)."""
    B, n = act.shape[0], slab.shape[0]
    parts = []
    for li in range(g):
        acc = torch.zeros(B, n)
        for i in range(nck):
            for j in range(kp):
                k = (li + i * g) * kp + j
                acc = _fma(act[:, k : k + 1], slab[None, :, k], acc)
        parts.append(acc)
    return _halve(parts)


def _zhead_block_sums(he, wz, T, g, L):
    """The z heads' sums of one block as its encoder lanes form them: he [B,
    Hc] (h_e of the block's units, operand-rounded), wz [2L, >= Hc] (the
    block's slab, f32 values) -> [B, 2L]. Column n goes to group n % (T /
    g) (round n // (T / g)); the lane of head c sums h_e[n] wz[c][n] over
    its group's columns in round order (one fma each); the warp adds its
    32 / g groups by the butterfly (offsets 16 down to g); the block adds
    its 16 warp slots in warp order."""
    B, Hc = he.shape
    ng, per_warp = T // g, 32 // g
    out = torch.zeros(B, 2 * L)
    for c in range(2 * L):
        slots = [torch.zeros(B) for _ in range(16)]
        for w in range(T // 32):
            groups = []
            for q in range(per_warp):
                acc = torch.zeros(B)
                for n in range(w * per_warp + q, Hc, ng):
                    acc = _fma(he[:, n], wz[c, n].expand(B), acc)
                groups.append(acc)
            slots[w] = _halve(groups)
        t = slots[0]
        for w in range(1, 16):
            t = t + slots[w]
        out[:, c] = t
    return out


def _folds(params, cfg, ws):
    """The per-song folds as the kernel's prologue forms them: w . (w rows)
    with k in order (one fma each), then + the bias."""
    D, K = cfg.original_dim, cfg.n_classes

    def fold(rows, bias):
        acc = torch.zeros(ws.shape[0], rows.shape[1])
        for k in range(K):
            acc = _fma(ws[:, k : k + 1], rows[k][None], acc)
        return acc + bias

    if cfg.has_hidden:
        return {"encb": fold(params["h"]["kernel"][D:], params["h"]["bias"]),
                "decb": fold(params["decoder_h"]["kernel"][:K], params["decoder_h"]["bias"])}
    zm, zv, xdm = params["z_mean"], params["z_log_var"], params["x_decoded_mean"]
    return {"zb": torch.cat([fold(zm["kernel"][D:], zm["bias"]),
                             fold(zv["kernel"][D:], zv["bias"])], 1),
            "xb": fold(xdm["kernel"][:K], xdm["bias"])}


def emulate(params, cfg, seeds, nsteps, eps, u, ws, mode, plan, use_z_prior=False,
            return_probs=False):
    """The cluster kernel's step for every song, block by block, in f32:
    the products split over lanes (:func:`_layer`), the z heads summed in
    the encoder's lanes (:func:`_zhead_block_sums`) and the blocks' sums
    added in rank order, the epilogues in the JAX kernel's f32 order."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    C, g, nck, Hc, Dc = plan["C"], plan["g"], plan["nck"], plan["Hc"], plan["Dc"]
    kp = 16 // cgv._EBYTES[mode]
    B = seeds.shape[0]
    op = (lambda x: x.bfloat16().float()) if mode == "bf16" else (lambda x: x)
    w = cgv.pack_cluster(params, cfg, mode, plan)
    slabs = [None if s is None else s.float() for s in w["w"]]
    f = _folds(params, cfg, ws)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[1]))
    x_prev = x_prev_t = op(seeds)
    outs = []
    for t in range(nsteps):
        e = eps[:, t]
        if cfg.has_hidden:
            if not use_z_prior:
                zmv = None
                for r in range(C):
                    cols = _layer(slabs[0][r], pad(x_prev, plan["Da"]), g[0], nck[0], kp)
                    encb = pad(f["encb"], C * Hc)[:, r * Hc : r * Hc + Hc]
                    h = op(torch.relu(cols + encb))
                    part = _zhead_block_sums(h, slabs[1][r], plan["T"], g[0], L)
                    zmv = part if zmv is None else zmv + part
                zmv = zmv + w["bz"]
                z = zmv[:, :L] + torch.exp(zmv[:, L:] / 2.0) * e
            else:
                z = e
            hd = torch.zeros(B, C * Hc)
            for r in range(C):
                v = pad(f["decb"], C * Hc)[:, r * Hc : r * Hc + Hc]
                zr = pad(w["zrows"], C * Hc)[:, r * Hc : r * Hc + Hc]
                for l in range(L):
                    v = v + z[:, l : l + 1] * zr[l]
                if cfg.use_x_prev:
                    v = v + _layer(slabs[2][r], pad(x_prev_t, plan["Da"]), g[2], nck[2], kp)
                hd[:, r * Hc : r * Hc + Hc] = op(torch.relu(v))
            hd = pad(hd[:, :H], plan["Ha"])
            p = torch.cat([_layer(slabs[3][r], hd, g[3], nck[3], kp) for r in range(C)], 1)[:, :D]
            p = 1.0 / (1.0 + torch.exp(-(p + w["bx"])))
        else:
            if not use_z_prior:
                zmv = _layer(slabs[1][0], pad(x_prev, plan["Da"]), g[1], nck[1], kp) + f["zb"]
                z = zmv[:, :L] + torch.exp(zmv[:, L:] / 2.0) * e
            else:
                z = e
            v = f["xb"]
            for l in range(L):
                v = v + z[:, l : l + 1] * w["zrows"][l]
            if cfg.use_x_prev:
                v = v + torch.cat([_layer(slabs[3][r], pad(x_prev_t, plan["Da"]), g[3], nck[3], kp)
                                   for r in range(C)], 1)[:, :D]
            p = 1.0 / (1.0 + torch.exp(-v))
        x_t = (u[:, t] < p).float()
        x_prev_t, x_prev = x_prev, x_t
        outs.append(p if return_probs else x_t)
    return torch.stack(outs, 1)


def _inputs(D, H, L, use_x_prev, B, nsteps, seed):
    jcfg = jvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                       intermediate_class_dim=16, n_classes=K, use_x_prev=use_x_prev)
    params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    a = {"seeds": (rng.random((B, D)) < 0.2).astype(np.float32),
         "ws": np.eye(K, dtype=np.float32)[np.arange(B) % K],
         "eps": rng.standard_normal((B, nsteps, L)).astype(np.float32),
         "u": rng.random((B, nsteps, D)).astype(np.float32)}
    return jcfg, params, a


EMULATED = {  # D, H, L, use_x_prev, mode, forced blocks a cluster
    "f32_jsball_width": (88, 88, 4, True, "f32", None),
    "f32_c2": (88, 256, 4, True, "f32", None),
    "f32_c4_no_x_prev": (24, 40, 3, False, "f32", 4),
    "bf16_jsball_width": (88, 88, 4, True, "bf16", None),
    "bf16_c2": (40, 72, 3, True, "bf16", 2),
    "no_hidden": (88, 0, 4, True, "f32", None),
    "no_hidden_c2": (30, 0, 3, True, "f32", 2),
}


def _forced(cfg, mode, B, C):
    """The plan at C blocks a cluster (the fewest that fit, or ``C``)."""
    plan = cgv.cluster_plan(cfg, B, mode)
    if C is None or C == plan["C"]:
        return plan
    lay = cgv.cluster_layout(cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim,
                             cfg.has_hidden, cfg.use_x_prev, cgv._EBYTES[mode], C, plan["T"],
                             plan["g"])
    return {**plan, **lay, "C": C}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_sum_order_matches_plain_and_jax(case):
    D, H, L, xp, mode, C = EMULATED[case]
    B, nsteps = 5, 6
    jcfg, params, a = _inputs(D, H, L, xp, B, nsteps, seed=sorted(EMULATED).index(case))
    cfg = dataclasses.replace(tvae.Config(**dataclasses.asdict(jcfg)), bf16_compute=mode == "bf16")
    tp = params_from_numpy(params, "cpu")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    plan = _forced(cfg, mode, B, C)
    if C:
        assert plan["C"] == C
    u1 = torch.ones_like(t["u"])
    for zp in (False, True):
        em = emulate(tp, cfg, t["seeds"], nsteps, t["eps"], u1, t["ws"], mode, plan, zp, True)
        pl = cgv.generate_cl_vae_batch_plain(tp, cfg, t["seeds"], nsteps, t["eps"], u1, t["ws"],
                                             use_z_prior=zp, return_probs=True, mode=mode)
        args = (a["seeds"], nsteps, a["eps"], np.ones_like(a["u"]), a["ws"])
        if cfg.has_hidden:
            ref = np.asarray(pallas_generate_vae.generate_cl_vae_batch_pallas(
                params, jcfg, *args, use_z_prior=zp, return_probs=True, mode=mode))
        else:
            ref = np.asarray(jax_noise(params, jcfg, *args, use_z_prior=zp, return_probs=True))
        d_plain = (em - pl).abs()
        d_jax = np.abs(em.numpy() - ref)
        if mode == "f32":
            assert d_plain.max().item() <= 1e-5, d_plain.max()
            assert d_jax.max() <= 1e-5, d_jax.max()
            fe = emulate(tp, cfg, t["seeds"], nsteps, t["eps"], t["u"], t["ws"], mode, plan, zp)
            fp = cgv.generate_cl_vae_batch_plain(tp, cfg, t["seeds"], nsteps, t["eps"], t["u"],
                                                 t["ws"], use_z_prior=zp, mode=mode)
            assert torch.equal(fe, fp) and 0 < fp.mean().item() < 1
        else:
            assert d_jax.max() <= 2e-2 and d_jax.mean() <= 2e-3, (d_jax.max(), d_jax.mean())
            assert d_plain.max().item() <= 2e-2 and d_plain.mean().item() <= 2e-3


def test_packed_slabs_read_back_as_the_weights():
    """Each block's slab, read as the kernel's lanes read it (row n of block
    r is output column r n + n, k contiguous, zero past the weight), gives
    back the weights in the mode's type; every block of a config without
    hidden layers holds all of the z heads."""
    for D, H, L, xp, mode, C in ((40, 72, 3, True, "bf16", 2), (30, 0, 3, True, "f32", 2),
                                 (88, 256, 4, True, "f32", None)):
        jcfg, params, _ = _inputs(D, H, L, xp, 1, 1, seed=3)
        cfg = dataclasses.replace(tvae.Config(**dataclasses.asdict(jcfg)),
                                  bf16_compute=mode == "bf16")
        tp = params_from_numpy(params, "cpu")
        plan = _forced(cfg, mode, 8, C)
        w = cgv.pack_cluster(tp, cfg, mode, plan)
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        Cb, n = plan["C"], plan["n"]
        back = lambda s, i, N, Kd: s.reshape(Cb * n[i], -1)[:N, :Kd]
        zk = torch.cat([tp["z_mean"]["kernel"], tp["z_log_var"]["kernel"]], 1)
        if cfg.has_hidden:
            assert torch.equal(back(w["w"][0], 0, H, D), tp["h"]["kernel"][:D].T.to(dt))
            heads = torch.cat([w["w"][1][r][:, : plan["Hc"]] for r in range(Cb)], 1)[:, :H]
            assert torch.equal(heads, zk.T.to(dt))
            dec = tp["decoder_h"]["kernel"][K : K + D]
            assert torch.equal(back(w["w"][2], 2, H, D), dec.T.to(dt))
            assert torch.equal(back(w["w"][3], 3, D, H), tp["x_decoded_mean"]["kernel"].T.to(dt))
        else:
            for r in range(Cb):
                assert torch.equal(w["w"][1][r][:, :D], zk[:D].T.to(dt))
            xk = tp["x_decoded_mean"]["kernel"][K : K + D]
            assert torch.equal(back(w["w"][3], 3, D, D), xk.T.to(dt))
        for s in w["w"]:
            if s is not None:
                rows = s.reshape(-1, s.shape[-1])
                assert rows.shape[-1] * s.element_size() % 16 == 0


def test_packed_weights_are_kept_per_device():
    """The packed slabs are cached by parameters, plan and device: the same
    parameters asked for on another device are checked again, so parameters
    on the CPU with seeds on a card raise instead of launching with the
    first device's slabs."""
    jcfg, params, _ = _inputs(88, 88, 4, True, 1, 1, seed=5)
    cfg = tvae.Config(**dataclasses.asdict(jcfg))
    tp = params_from_numpy(params, "cpu")
    plan = cgv.cluster_plan(cfg, 4, "f32")
    cgv._PACKED.clear()
    first = cgv.cluster_operands(tp, cfg, "f32", plan, torch.device("cpu"))
    assert cgv.cluster_operands(tp, cfg, "f32", plan, torch.device("cpu")) is first
    with pytest.raises(ValueError, match="is on cpu, x_seeds on cuda"):
        cgv.cluster_operands(tp, cfg, "f32", plan, torch.device("cuda", 0))
    cgv._PACKED.clear()
