"""The port's cl_vae dense-stack training core (plain versions) vs the JAX package.

``ops/vae_dense.py`` holds the plain forward and backward that the CUDA
kernels are held against on the card; here, on the CPU, the same functions
run through the port's ``torch.autograd.Function`` and are held against the
JAX package's ``cl_vae.apply`` with ``train_backend="pallas"`` (its Pallas
kernels in interpret mode, as ``tests/test_pallas_vae.py`` runs them) and
with ``xla``. Same JAX-initialised weights and the same NumPy inputs and
noise on both sides, at the sizes of ``tests/test_pallas_vae.py`` (D=16,
Cw=8, H=24, L=3, K=4), with B=12 and B=11 (not a multiple of the port's
4-row tile).

Tolerances: forward rtol 1e-5 / atol 1e-6 (the same f32 products, summed in
another order); gradients rtol 2e-4 / atol 1e-5 (the bound of
``tests/test_pallas_vae.py``); the plain backward against autograd of the
plain forward rtol 1e-5 / atol 1e-6 (the same arithmetic up to the order of
the weight-gradient sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)
OUTS = ("x_decoded_mean", "w", "w_mean", "w_log_var", "z", "z_mean", "z_log_var")


def _setup(B=12, D=16, Cw=8, H=24, L=3, K=4, use_x_prev=True, seed=0):
    jcfg = jvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                       intermediate_class_dim=Cw, n_classes=K, use_x_prev=use_x_prev,
                       train_backend="pallas")
    params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((B, D)) < 0.2).astype(np.float32)
    xp = (rng.random((B, D)) < 0.2).astype(np.float32)
    noise = {"eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
             "eps_z": rng.standard_normal((B, L)).astype(np.float32)}
    return jcfg, tvae.Config(**dataclasses.asdict(jcfg)), params, x, xp, noise


def _loss_terms(out, lib):
    """Touch every output with different weights (all four cotangents of the
    core: dxhat, dwargs, dzargs, dw), as ``tests/test_pallas_vae.py`` does."""
    return (lib.sum(out["x_decoded_mean"] ** 2) + lib.sum(lib.sin(out["w_mean"]))
            + lib.sum(out["w_log_var"] ** 2) + lib.sum(out["z_mean"] * lib.cos(out["z_log_var"]))
            + lib.sum(out["w"] ** 3) + lib.sum(out["z"] * out["z"]))


@pytest.mark.parametrize("B", [12, 11])
@pytest.mark.parametrize("use_x_prev", [True, False])
def test_forward_matches_jax(use_x_prev, B):
    jcfg, tcfg, params, x, xp, noise = _setup(B=B, use_x_prev=use_x_prev)
    xp_in = xp if use_x_prev else None
    t = torch.from_numpy
    got = vd.vae_apply_core(params_from_numpy(params, "cpu"), tcfg, t(x),
                            t(xp) if use_x_prev else None, t(noise["eps_w"]), t(noise["eps_z"]))
    for backend in ("pallas", "xla"):
        ref = jvae.apply(params, dataclasses.replace(jcfg, train_backend=backend), x,
                         jax.random.PRNGKey(0), xp_in, noise=noise)
        for k in OUTS:
            assert got[k].shape == ref[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       err_msg=f"{k} vs {backend}", **FWD)


@pytest.mark.parametrize("B", [12, 11])
@pytest.mark.parametrize("use_x_prev", [True, False])
def test_gradients_match_jax(use_x_prev, B):
    """Every parameter gradient and those of x and x_prev through the port's
    autograd.Function (plain forward and plain backward on the CPU) vs
    ``jax.grad`` of the JAX package's kernel path, including the w fan-out
    (loss + latent encoder + decoder into one softmax vjp)."""
    jcfg, tcfg, params, x, xp, noise = _setup(B=B, use_x_prev=use_x_prev, seed=2)
    tparams = params_from_numpy(params, "cpu")
    for d in tparams.values():
        for v in d.values():
            v.requires_grad_(True)
    tx, txp = (torch.from_numpy(a).requires_grad_(True) for a in (x, xp))
    out = vd.vae_apply_core(tparams, tcfg, tx, txp if use_x_prev else None,
                            torch.from_numpy(noise["eps_w"]), torch.from_numpy(noise["eps_z"]))
    _loss_terms(out, torch).backward()

    def loss(p, x, xp):
        out = jvae.apply(p, jcfg, x, jax.random.PRNGKey(0), xp if use_x_prev else None,
                         noise=noise)
        return _loss_terms(out, jnp)

    gp, gx, gxp = jax.grad(loss, argnums=(0, 1, 2))(params, x, xp)
    n = 0
    for layer, leaves in gp.items():
        for leaf, g in leaves.items():
            np.testing.assert_allclose(tparams[layer][leaf].grad.numpy(), np.asarray(g),
                                       err_msg=f"{layer}/{leaf}", **GRAD)
            n += 1
    assert n == 16  # 8 dense layers x (kernel, bias)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), err_msg="dx", **GRAD)
    if use_x_prev:
        np.testing.assert_allclose(txp.grad.numpy(), np.asarray(gxp), err_msg="dx_prev", **GRAD)
    else:
        assert txp.grad is None


def _core_inputs(B=7, D=10, Cw=6, H=9, L=3, K=5, use_xp=True, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    x = torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32))
    xp = torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32)) if use_xp else None
    K2 = 2 * (K - 1)
    return (x, xp, f(B, K - 1), f(B, L), f(D, Cw, scale=0.4), f(Cw, scale=0.2),
            f(Cw, K2, scale=0.4), f(K2, scale=0.2), f(D, H, scale=0.4), f(K, H, scale=0.4),
            f(H, scale=0.2), f(H, 2 * L, scale=0.3), f(2 * L, scale=0.2), f(K, H, scale=0.4),
            f(D, H, scale=0.4) if use_xp else None, f(L, H, scale=0.4), f(H, scale=0.2),
            f(H, D, scale=0.4), f(D, scale=0.2))


@pytest.mark.parametrize("use_xp", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(use_xp):
    """The layer-by-layer plain backward (the backward kernel's twin) against
    torch autograd of the plain forward, with random cotangents on all four
    outputs."""
    ins = [t.requires_grad_(True) if t is not None else None
           for t in _core_inputs(use_xp=use_xp)]
    xhat, wargs, zargs, w, a1, a2, a3 = vd.vae_dense_fwd_plain(*ins)
    rng = np.random.default_rng(9)
    cot = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in (xhat, wargs, zargs, w)]
    total = sum((o * c).sum() for o, c in zip((xhat, wargs, zargs, w), cot))
    wanted = [t for t in ins if t is not None]
    auto = iter(torch.autograd.grad(total, wanted, allow_unused=True))
    auto = [next(auto) if t is not None else None for t in ins]
    (x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz, bd, wxh,
     bxh) = (t.detach() if t is not None else None for t in ins)
    res = (o.detach() for o in (a1, a2, a3, xhat, wargs, zargs, w))
    got = vd.vae_dense_bwd_plain(x, xp, eps_w, eps_z, *res, *cot, whw, wwz, whx, whw2, wzz, wdw,
                                 wdxp, wdz, wxh)
    names = ("x", "xp", "whw", "bhw", "wwz", "bwz", "whx", "whw2", "bh", "wzz", "bzz", "wdw",
             "wdxp", "wdz", "bd", "wxh", "bxh")
    index = dict(x=0, xp=1, whw=4, bhw=5, wwz=6, bwz=7, whx=8, whw2=9, bh=10, wzz=11, bzz=12,
                 wdw=13, wdxp=14, wdz=15, bd=16, wxh=17, bxh=18)
    assert len(got) == 17
    for name, g in zip(names, got):
        if ins[index[name]] is None:
            assert g is None, name
            continue
        torch.testing.assert_close(g, auto[index[name]], rtol=1e-5, atol=1e-6, msg=name)


def test_autograd_function_routes_cpu_tensors_to_the_plain_versions():
    before = (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)
    ins = [t.requires_grad_(True) if t is not None else None for t in _core_inputs(seed=1)]
    outs = vd.VaeDenseCore.apply(*ins)
    sum(o.square().sum() for o in outs).backward()
    assert ins[0].grad is not None and ins[4].grad is not None
    assert ins[2].grad is None and ins[3].grad is None  # the noise gets no gradient
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == before  # no kernel ran


def test_fits_and_should_use():
    mk = lambda **kw: tvae.Config(original_dim=88, latent_dim=4, intermediate_class_dim=88,
                                  n_classes=13, use_x_prev=True, **kw)
    # jsball_vae's width with the corpus's 13 keys, and the seq-concat width
    assert vd.fits(mk(intermediate_dim=88))
    assert vd.should_use(mk(intermediate_dim=88, train_backend="pallas"))
    wide = tvae.Config(original_dim=976, intermediate_dim=1024, latent_dim=16,
                       intermediate_class_dim=256, n_classes=13, use_x_prev=True)
    assert vd.fits(wide) and vd.smem_bytes(wide) <= 232448
    # no TPU gate: auto and xla never route to the kernels
    assert not vd.should_use(mk(intermediate_dim=88, train_backend="auto"))
    assert not vd.should_use(mk(intermediate_dim=88, train_backend="xla"))
    assert not vd.should_use(mk(intermediate_dim=88))
    assert vd.should_use(mk(intermediate_dim=88), train_backend="pallas")
    # the vanilla VAE (K=1), no hidden layers, more keys than the JAX lanes,
    # and a row tile wider than shared memory stay off the kernels
    assert not vd.should_use(dataclasses.replace(mk(intermediate_dim=88, train_backend="pallas"),
                                                 n_classes=1))
    assert not vd.should_use(mk(intermediate_dim=0, train_backend="pallas"))
    assert not vd.fits(dataclasses.replace(mk(intermediate_dim=88), n_classes=129))
    assert not vd.fits(mk(intermediate_dim=8192))


def test_bf16_and_unsupported_tensors_raise():
    jcfg, tcfg, params, x, xp, noise = _setup()
    t = torch.from_numpy
    tp = params_from_numpy(params, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 7"):
        vd.vae_apply_core(tp, dataclasses.replace(tcfg, bf16_compute=True), t(x), t(xp),
                          t(noise["eps_w"]), t(noise["eps_z"]))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 7"):
        tvae.apply(tp, dataclasses.replace(tcfg, bf16_compute=True), t(x), x_prev=t(xp),
                   noise={k: t(v) for k, v in noise.items()})
    with pytest.raises(ValueError, match="do not take"):
        vd.vae_apply_core(tp, dataclasses.replace(tcfg, intermediate_dim=0), t(x), t(xp),
                          t(noise["eps_w"]), t(noise["eps_z"]))
    # the wrappers take the plain versions for CPU tensors only: another
    # device raises, it is not computed somewhere else
    meta = [a.to("meta") if a is not None else None for a in _core_inputs()]
    with pytest.raises(ValueError, match="unsupported device"):
        vd.vae_dense_fwd(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        vd.vae_dense_bwd(*meta[:4], *([meta[0]] * 11), *meta[4:13])
