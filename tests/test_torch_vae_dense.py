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

The bf16 mode (``bf16_compute=True``) is held against the JAX kernel route in
bf16 at a small shape and at the JAX test's (B=256, D=128, Cw=64, H=256,
L=16, K=13): the same rounding points, f32 sums in another order, so a sum
that lands near a bf16 rounding boundary may round the other way. Forward
max abs 1e-2 and mean abs 1e-4; gradients per leaf within 1e-4 relative
Frobenius, tighter than the forward because it is what catches a rounding
point missed in the backward (dropping the one before the frame head's
transposed product moves a leaf by 1.5e-3 to 3.0e-3); every weight gradient
bf16-representable and the bias gradients not rounded; and the JAX test's
norm bound against the f32 truth.
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


def _bf16_rounded(t):
    return bool(torch.equal(t, t.bfloat16().float()))


def _grads(tparams, tcfg, x, xp, noise):
    """Parameter gradients of the port's ``vae_apply_core`` (CPU: the plain
    versions) under ``_loss_terms``."""
    p = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()} for k, d in tparams.items()}
    t = torch.from_numpy
    out = vd.vae_apply_core(p, tcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    _loss_terms(out, torch).backward()
    return out, {k: {n: v.grad for n, v in d.items()} for k, d in p.items()}


# max |port - JAX| of the forward outputs and the largest per-leaf relative
# Frobenius error of the gradients, measured: small shape 6.0e-08 / 9.5e-08;
# the JAX test's shape 4.8e-07 / 1.2e-07
BF16_SHAPES = {"small": dict(B=12), "jax_test": dict(B=256, D=128, Cw=64, H=256, L=16, K=13)}


@pytest.mark.parametrize("shape", sorted(BF16_SHAPES))
def test_bf16_mode_matches_jax(shape):
    """The bf16 mode of the plain versions, through ``vae_apply_core`` and its
    autograd function, vs ``jax.grad`` of ``cl_vae.apply`` with
    ``bf16_compute=True, train_backend="pallas"`` (the Pallas kernels in
    interpret mode). Every kernel is rounded, the heads' too, as in JAX."""
    jcfg, tcfg, params, x, xp, noise = _setup(seed=3, **BF16_SHAPES[shape])
    jb, tb = (dataclasses.replace(c, bf16_compute=True) for c in (jcfg, tcfg))
    out, grads = _grads(params_from_numpy(params, "cpu"), tb, x, xp, noise)
    ref = jvae.apply(params, jb, x, jax.random.PRNGKey(0), xp, noise=noise)
    for k in OUTS:
        d = np.abs(out[k].detach().numpy() - np.asarray(ref[k]))
        assert d.max() <= 1e-2 and d.mean() <= 1e-4, (k, d.max(), d.mean())
    loss = lambda p, c: _loss_terms(jvae.apply(p, c, x, jax.random.PRNGKey(0), xp, noise=noise),
                                    jnp)
    g_kernel = jax.grad(loss)(params, jb)
    g_f32 = jax.grad(loss)(params, dataclasses.replace(jcfg, train_backend="xla"))
    g_xla = jax.grad(loss)(params, dataclasses.replace(jb, train_backend="xla"))
    n = 0
    for layer, leaves in grads.items():
        for leaf, g in leaves.items():
            name, got = f"{layer}/{leaf}", g.numpy()
            assert g.dtype == torch.float32, name
            want = np.asarray(g_kernel[layer][leaf])
            rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
            assert rel <= 1e-4, (name, rel)
            if leaf == "kernel":
                assert _bf16_rounded(g), name  # products of bf16 operands, cast to bf16
            else:
                assert not _bf16_rounded(g), name  # f32 sums of unrounded cotangents
            # the bound of tests/test_pallas_vae.py:155-161 against the f32 truth
            f = np.asarray(g_f32[layer][leaf])
            err_p = np.linalg.norm(got - f)
            err_x = np.linalg.norm(np.asarray(g_xla[layer][leaf]) - f)
            assert err_p <= 3.0 * err_x + 0.02 * (np.linalg.norm(f) + 1e-3), (name, err_p, err_x)
            n += 1
    assert n == 16


def test_bf16_and_unsupported_tensors_raise():
    """The bf16 mode runs (it raised until it was ported) and trains through
    ``apply``; the unsupported inputs still raise."""
    jcfg, tcfg, params, x, xp, noise = _setup()
    t = torch.from_numpy
    tp = params_from_numpy(params, "cpu")
    bcfg = dataclasses.replace(tcfg, bf16_compute=True, train_backend="pallas")
    ins = vd.pack_inputs(tp, bcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    assert [a.dtype for a in ins[:4]] == [torch.bfloat16, torch.bfloat16] + [torch.float32] * 2
    assert all(ins[i].dtype == torch.bfloat16 for i in (4, 6, 8, 9, 11, 13, 14, 15, 17))
    assert all(ins[i].dtype == torch.float32 for i in (5, 7, 10, 12, 16, 18))
    before = (vd.FWD_LAUNCHES, vd.BF16_FWD_LAUNCHES, vd.BWD_LAUNCHES, vd.BF16_BWD_LAUNCHES)
    via_apply = tvae.apply(tp, bcfg, t(x), x_prev=t(xp), noise={k: t(v) for k, v in noise.items()})
    direct = vd.vae_apply_core(tp, bcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    for k in OUTS:
        torch.testing.assert_close(via_apply[k], direct[k], rtol=0, atol=0)
    assert (vd.FWD_LAUNCHES, vd.BF16_FWD_LAUNCHES, vd.BWD_LAUNCHES,
            vd.BF16_BWD_LAUNCHES) == before  # no kernel on the CPU
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
