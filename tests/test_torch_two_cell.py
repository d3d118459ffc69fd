"""The port's two-cell training core (plain versions) vs the JAX package.

``ops/two_cell.py`` holds the plain forward and backward that the CUDA
kernels are held against on the card; here, on the CPU, the same functions
run through the port's ``torch.autograd.Function`` and are held against the
JAX package's ``two_cell_sequence`` (its Pallas kernels in interpret mode,
as ``tests/test_two_cell.py`` runs them) and its two-scan XLA composition.
Same JAX-initialised weights and the same NumPy inputs and noise on both
sides, at the tiny sizes of ``tests/test_two_cell.py``.

Tolerances: forward rtol 1e-5 / atol 1e-6 (the same f32 products, summed in
another order); gradients rtol 2e-4 / atol 1e-5 (BPTT through T steps
compounds the reordering, the bound ``tests/test_two_cell.py`` uses); the
plain backward against autograd of the plain forward rtol 1e-5 / atol 1e-6
(identical arithmetic up to the order of the weight-gradient sums).

The bf16 stream mode (``compute_dtype=bfloat16``) is held to JAX's
``two_cell_sequence(..., compute_dtype=bf16)`` and to its ``_fwd_call`` /
``_bwd_call``: both sides round the same values at the same places and sum
the bf16-valued products in f32, so the f32 outputs and f32-valued
gradients agree within rtol 1e-4 / atol 1e-5, and the bf16-valued ones
(the six weight-matrix gradients, the gradients of x and x_prev, the
streams ze, zd, hpe, he, hpd, dxe, dxd) are bf16-representable and within
one bf16 step of JAX's: an f32 sum taken in another order may land on the
other side of a bf16 rounding boundary. A missed rounding point moves a
gradient by 1.5-3e-3, far outside both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.ops import lstm as jlstm
from classifying_vae_lstm_tpu.ops import pallas_two_cell as jtc
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import two_cell as ttc
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)
BF16 = dict(rtol=1e-4, atol=1e-5)
BF = jnp.bfloat16


def _setup(B=12, T=5, D=16, H=24, L=2, K=3, use_x_prev=True, seed=0):
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                      n_classes=K, use_x_prev=use_x_prev)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((B, T, D)) < 0.2).astype(np.float32)
    xp = (rng.random((B, T, D)) < 0.2).astype(np.float32)
    W = np.array(jax.nn.softmax(rng.standard_normal((B, K)).astype(np.float32)))
    eps = rng.standard_normal((B, T, L)).astype(np.float32)
    return jcfg, tcl.Config(**dataclasses.asdict(jcfg)), params, x, xp, W, eps


def _xla_core(params, cfg, x, xp, W, eps):
    """The JAX package's two-scan XLA composition (dropout 0, noise explicit)."""
    zm, zlv, _ = jcl.encode_z_sequence(params, cfg, x, W)
    z = zm + jnp.exp(zlv / 2) * eps
    w_rep = jnp.broadcast_to(W[:, None, :], (z.shape[0], z.shape[1], W.shape[-1]))
    dec_in = jnp.concatenate(([xp, z] if cfg.use_x_prev else [z]) + [w_rep], axis=-1)
    hd, _ = jlstm.lstm_sequence(params["decoder_h"], dec_in)
    return hd, zm, zlv, z


def _loss_terms(hd, zm, zlv, z, lib):
    """Touch every output with different weights (both cotangents, dhd and
    dzargs, are nonzero)."""
    return (lib.sum(hd ** 2) + lib.sum(lib.sin(zm)) + lib.sum(zlv ** 2)
            + lib.sum(z * lib.cos(z)))


@pytest.mark.parametrize("use_x_prev", [True, False])
def test_forward_matches_jax(use_x_prev):
    jcfg, tcfg, params, x, xp, W, eps = _setup(use_x_prev=use_x_prev)
    xp_in = xp if use_x_prev else None
    T = torch.from_numpy
    got = ttc.two_cell_sequence(params_from_numpy(params, "cpu"), tcfg, T(x),
                                T(xp) if use_x_prev else None, T(W), T(eps))
    kernel = jtc.two_cell_sequence(params, jcfg, x, xp_in, W, eps)
    xla = _xla_core(params, jcfg, x, xp, W, eps)
    for name, g, k, r in zip(("hd", "Z_mean", "Z_log_var", "Z"), got, kernel, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), err_msg=f"{name} vs pallas", **FWD)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"{name} vs xla", **FWD)


def _grads_port(tparams, tcfg, x, xp, W, eps):
    leaves = [tparams["encoder_h"], tparams["decoder_h"], tparams["Z_mean"], tparams["Z_log_var"]]
    for d in leaves:
        for v in d.values():
            v.requires_grad_(True)
    T = lambda a: torch.from_numpy(a).requires_grad_(True)
    tx, txp, tW = T(x), T(xp), T(W)
    out = ttc.two_cell_sequence(tparams, tcfg, tx, txp if tcfg.use_x_prev else None, tW,
                                torch.from_numpy(eps))
    _loss_terms(*out, torch).backward()
    return tparams, tx.grad, txp.grad, tW.grad


@pytest.mark.parametrize("B", [12, 11])
def test_gradients_match_jax(B):
    """Every gradient through the port's autograd.Function (plain forward and
    plain backward on the CPU) vs ``jax.grad`` of the JAX package's kernel
    path and of its XLA composition: the parameters, x, x_prev and W (all
    four argnums of ``tests/test_two_cell.py``), and an odd batch."""
    jcfg, tcfg, params, x, xp, W, eps = _setup(B=B)
    tparams, gx, gxp, gW = _grads_port(params_from_numpy(params, "cpu"), tcfg, x, xp, W, eps)

    def loss(p, x, xp, W, core):
        return _loss_terms(*core(p, jcfg, x, xp, W, eps), jnp)

    for core in (jtc.two_cell_sequence, _xla_core):
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(params, x, xp, W, core)
        for name in ("encoder_h", "decoder_h", "Z_mean", "Z_log_var"):
            for leaf, g in ref[0][name].items():
                np.testing.assert_allclose(tparams[name][leaf].grad.numpy(), np.asarray(g),
                                           err_msg=f"{core.__name__} {name}/{leaf}", **GRAD)
        for label, got, r in (("x", gx, ref[1]), ("x_prev", gxp, ref[2]), ("W", gW, ref[3])):
            np.testing.assert_allclose(got.numpy(), np.asarray(r),
                                       err_msg=f"{core.__name__} d{label}", **GRAD)


def test_gradients_without_x_prev():
    jcfg, tcfg, params, x, xp, W, eps = _setup(use_x_prev=False, seed=3)
    tparams, gx, _, gW = _grads_port(params_from_numpy(params, "cpu"), tcfg, x, xp, W, eps)
    ref = jax.grad(lambda p, x, W: _loss_terms(*jtc.two_cell_sequence(p, jcfg, x, None, W, eps),
                                               jnp), argnums=(0, 1, 2))(params, x, W)
    for name, leaf in (("encoder_h", "recurrent_kernel"), ("decoder_h", "kernel"),
                       ("decoder_h", "bias"), ("Z_log_var", "kernel")):
        np.testing.assert_allclose(tparams[name][leaf].grad.numpy(),
                                   np.asarray(ref[0][name][leaf]), err_msg=f"{name}/{leaf}",
                                   **GRAD)
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref[1]), **GRAD)
    np.testing.assert_allclose(gW.numpy(), np.asarray(ref[2]), **GRAD)


def _core_inputs(B=7, T=4, INe=9, INd=6, H=10, L=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    return (f(T, B, INe), f(T, B, INd), f(T, B, L), f(INe, 4 * H, scale=0.3), f(4 * H, scale=0.3),
            f(H, 4 * H, scale=0.3), f(INd, 4 * H, scale=0.3), f(4 * H, scale=0.3),
            f(H, 4 * H, scale=0.3), f(L, 4 * H, scale=0.3), f(H, 2 * L, scale=0.3),
            f(2 * L, scale=0.3), f(B, H, scale=0.5), f(B, H, scale=0.5), f(B, H, scale=0.5),
            f(B, H, scale=0.5))


def test_plain_backward_matches_autograd_of_plain_forward():
    """The step-by-step plain backward (the backward kernel's twin) against
    torch autograd of the plain forward, with nonzero initial states and
    random cotangents on both outputs."""
    ins = [t.requires_grad_(True) for t in _core_inputs()]
    outs = ttc.two_cell_fwd_plain(*ins)
    hd, zargs = outs[0], outs[1]
    rng = np.random.default_rng(9)
    dhd = torch.from_numpy(rng.standard_normal(hd.shape).astype(np.float32))
    dza = torch.from_numpy(rng.standard_normal(zargs.shape).astype(np.float32))
    auto = torch.autograd.grad((hd * dhd).sum() + (zargs * dza).sum(), ins, allow_unused=True)
    (xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d) = ins
    (_, _, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd) = (o.detach() for o in outs)
    got = ttc.two_cell_bwd_plain(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps.detach(),
                                 zargs.detach(), xe.detach(), xd.detach(), dhd, dza,
                                 we.detach(), rke.detach(), wdx.detach(), rkd.detach(),
                                 kz.detach(), wz.detach())
    names = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
             "dwz", "dbe", "dbd", "dbz")
    index = dict(dxe=0, dxd=1, dwe=3, dbe=4, drke=5, dwdx=6, dbd=7, drkd=8, dkz=9, dwz=10, dbz=11,
                 dh0e=12, dc0e=13, dh0d=14, dc0d=15)
    for name, g in zip(names, got):
        torch.testing.assert_close(g, auto[index[name]], rtol=1e-5, atol=1e-6, msg=name)


def test_autograd_function_routes_cpu_tensors_to_the_plain_versions():
    before = (ttc.FWD_LAUNCHES, ttc.BWD_LAUNCHES)
    ins = [t.requires_grad_(True) for t in _core_inputs(seed=1)]
    hd, zargs = ttc.TwoCellCore.apply(*ins)
    (hd.sum() + zargs.square().sum()).backward()
    assert ins[0].grad is not None and ins[2].grad is None  # eps gets no gradient
    assert (ttc.FWD_LAUNCHES, ttc.BWD_LAUNCHES) == before  # no kernel ran


def _bf16_steps(got, ref) -> int:
    """The largest distance, in bf16 steps, between two bf16-valued arrays."""
    def order(a):
        a = torch.from_numpy(np.array(a, np.float32))
        assert torch.equal(a, a.bfloat16().float()), "not bf16-representable"
        bits = a.bfloat16().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((order(got) - order(ref)).abs().max())


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("use_x_prev", [True, False])
def test_bf16_forward_matches_jax(use_x_prev):
    jcfg, tcfg, params, x, xp, W, eps = _setup(H=32, use_x_prev=use_x_prev, seed=5)
    T = torch.from_numpy
    got = ttc.two_cell_sequence(params_from_numpy(params, "cpu"), tcfg, T(x),
                                T(xp) if use_x_prev else None, T(W), T(eps),
                                compute_dtype=torch.bfloat16)
    ref = jtc.two_cell_sequence(params, jcfg, x, xp if use_x_prev else None, W, eps,
                                compute_dtype=BF)
    for name, g, r in zip(("hd", "Z_mean", "Z_log_var", "Z"), got, ref):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), _f32(r), err_msg=name, **BF16)


@pytest.mark.parametrize("B", [12, 11])
def test_bf16_gradients_match_jax(B):
    """Every gradient of the bf16 mode: the ten parameter tensors of the
    core, x, x_prev and W, against ``jax.grad`` of JAX's kernel path, and an
    odd batch (JAX pads it to its block). The six weight matrices and x,
    x_prev come back bf16-valued; the biases and W do not."""
    jcfg, tcfg, params, x, xp, W, eps = _setup(B=B, H=32)
    tparams = params_from_numpy(params, "cpu")
    leaves = [tparams[n] for n in ("encoder_h", "decoder_h", "Z_mean", "Z_log_var")]
    for d in leaves:
        for v in d.values():
            v.requires_grad_(True)
    t = lambda a: torch.from_numpy(a).requires_grad_(True)
    tx, txp, tW = t(x), t(xp), t(W)
    out = ttc.two_cell_sequence(tparams, tcfg, tx, txp, tW, torch.from_numpy(eps),
                                compute_dtype=torch.bfloat16)
    _loss_terms(*out, torch).backward()
    ref = jax.grad(lambda p, x, xp, W: _loss_terms(
        *jtc.two_cell_sequence(p, jcfg, x, xp, W, eps, compute_dtype=BF), jnp),
        argnums=(0, 1, 2, 3))(params, x, xp, W)
    representable = lambda g: torch.equal(g, g.bfloat16().float())
    for name in ("encoder_h", "decoder_h", "Z_mean", "Z_log_var"):
        for leaf, r in ref[0][name].items():
            g = tparams[name][leaf].grad
            if leaf == "bias":
                np.testing.assert_allclose(g.numpy(), _f32(r), err_msg=f"{name}/{leaf}",
                                           **BF16)
            else:
                assert representable(g), f"{name}/{leaf}"
                assert _bf16_steps(g, _f32(r)) <= 1, f"{name}/{leaf}"
    assert not representable(tparams["encoder_h"]["bias"].grad)
    assert not representable(tparams["decoder_h"]["bias"].grad)
    for label, g, r in (("x", tx.grad, ref[1]), ("x_prev", txp.grad, ref[2])):
        assert representable(g) and _bf16_steps(g, _f32(r)) <= 1, label
    np.testing.assert_allclose(tW.grad.numpy(), _f32(ref[3]), err_msg="W", **BF16)


def test_bf16_plain_kernel_functions_match_the_jax_kernels():
    """``two_cell_fwd_plain`` / ``two_cell_bwd_plain`` in the bf16 mode
    against ``_fwd_call`` / ``_bwd_call`` fed the operands
    ``two_cell_sequence`` gives them (lane-padded, sliced back here): every
    output with its type, the streams bf16 and within one bf16 step, the
    rest f32; the weight gradients against JAX's f32 sums rounded as
    ``_core_bwd`` rounds them. The backward's f32 outputs are held within
    1e-3 relative Frobenius and 2^-8 of their largest entry: each is fed by
    dz rounded to bf16 as an operand, and one dz that lands on the other
    bf16 neighbour moves a whole row of a carry (this draw: one element of
    dz_d at t=0, so row 5 of dh0d by 9.6e-5 and dbz by 7.8e-5)."""
    B, T, D, H, L, K = 8, 5, 16, 24, 2, 3
    jcfg, tcfg, params, x, xp, W, eps = _setup(B=B, T=T, D=D, H=H, L=L, K=K, seed=7)
    ins = ttc.pack_inputs(params_from_numpy(params, "cpu"), tcfg, torch.from_numpy(x),
                          torch.from_numpy(xp), torch.from_numpy(W), torch.from_numpy(eps),
                          compute_dtype=torch.bfloat16)
    (xe, xd, eps_t, we, be, rke, wdx, bd, rkd, kz, wz, bz, *h0) = ins
    LP, INp = jtc.LP, 128
    j = lambda a: jnp.asarray(a.float().numpy(), a.dtype == torch.bfloat16 and BF or jnp.float32)
    padr = lambda a, n: jnp.pad(j(a), ((0, n - a.shape[0]), (0, 0)))
    padl = lambda a, n: jnp.pad(j(a), [(0, 0)] * (a.dim() - 1) + [(0, n - a.shape[-1])])
    halves = lambda a: jnp.concatenate([padl(a[..., :L], LP), padl(a[..., L:], LP)], -1)
    jins = (padl(xe, INp), padl(xd, INp), padl(eps_t, LP), padr(we, INp), j(be)[None],
            j(rke), padr(wdx, INp), j(bd)[None], j(rkd), padr(kz, LP), halves(wz),
            halves(bz)[None], *(j(h) for h in h0))
    ref = jtc._fwd_call(*jins)
    got = ttc.two_cell_fwd_plain(*ins)
    unpad = {0: lambda a: a, 1: lambda a: jnp.concatenate([a[..., :L], a[..., LP:LP + L]], -1)}
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    for i, (name, g, r) in enumerate(zip(names, got, ref)):
        r = unpad.get(i, lambda a: a)(r)
        if name in ("ze", "zd", "hpe", "he", "hpd"):
            assert g.dtype == torch.bfloat16 and r.dtype == BF, name
            assert _bf16_steps(g.float(), _f32(r)) <= 1, name
        else:
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), _f32(r), err_msg=name, **BF16)

    (hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd) = ref
    rng = np.random.default_rng(8)
    dhd = rng.standard_normal(hd.shape).astype(np.float32)
    dza = rng.standard_normal((T, B, 2 * L)).astype(np.float32)
    tb = lambda a: torch.from_numpy(np.array(_f32(a))).bfloat16()
    tf = lambda a: torch.from_numpy(np.array(a))
    zargs_t = unpad[1](zargs)
    tres = (tb(ze), tb(zd), tf(cpe), tf(ce), tf(cpd), tf(cd), tb(hpe), tb(he), tb(hpd), eps_t,
            tf(zargs_t), xe, xd, tf(dhd), tf(dza), we, rke, wdx, rkd, kz, wz)
    gout = ttc.two_cell_bwd_plain(*tres)
    jt = lambda a: jnp.asarray(j(a).T)
    jout = jtc._bwd_call(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, jins[2], zargs, jins[0],
                         jins[1], dhd, halves(torch.from_numpy(dza)), jt(rke), jt(rkd),
                         jnp.asarray(jins[3].T), jnp.asarray(jins[6].T),
                         jnp.asarray(jins[9].T), jnp.asarray(jins[10].T))
    in_e, in_d = xe.shape[-1], xd.shape[-1]
    cut = {"dxe": lambda a: a[..., :in_e], "dxd": lambda a: a[..., :in_d],
           "dwe": lambda a: a[:in_e], "dwdx": lambda a: a[:in_d], "dkz": lambda a: a[:L],
           "dwz": unpad[1], "dbe": lambda a: a[0], "dbd": lambda a: a[0],
           "dbz": lambda a: unpad[1](a)[0]}
    gnames = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
              "dwz", "dbe", "dbd", "dbz")
    for name, g, r in zip(gnames, gout, jout):
        r = cut.get(name, lambda a: a)(r)
        assert tuple(g.shape) == tuple(r.shape), name
        if name in ("dxe", "dxd"):
            assert g.dtype == torch.bfloat16 and r.dtype == BF, name
            assert _bf16_steps(g.float(), _f32(r)) <= 1, name
        elif name in ("drke", "drkd", "dwe", "dwdx", "dkz", "dwz"):
            assert g.dtype == torch.bfloat16 and r.dtype == jnp.float32, name
            assert _bf16_steps(g.float(), _f32(jnp.asarray(r, BF))) <= 1, name
        else:
            assert g.dtype == torch.float32, name
            r = torch.from_numpy(np.array(_f32(r)))
            err, rel = (g - r).abs().max().item(), ((g - r).norm() / r.norm()).item()
            assert err <= 2 ** -8 * r.abs().max().item() and rel <= 1e-3, (name, err, rel)


def test_bf16_plain_backward_against_autograd_of_plain_forward():
    """The bf16 plain backward against torch autograd of the bf16 plain
    forward. They round the cotangents at different places (autograd rounds
    the cotangent of each rounded operand as the cast's backward does; the
    kernel's backward rounds dz where the Pallas body does), so they agree
    to bf16 precision: within 1e-2 relative Frobenius (this draw: at most
    4.1e-3), the bound ``chip_smoke.py`` holds bf16 backwards to; the
    output types follow the mode."""
    ins = list(_core_inputs(seed=4))
    for i in (0, 1, 3, 5, 6, 8, 9, 10):  # xe, xd, we, rke, wdx, rkd, kz, wz
        ins[i] = ins[i].bfloat16()
    ins = [t.requires_grad_(True) for t in ins]
    outs = ttc.two_cell_fwd_plain(*ins)
    assert [o.dtype for o in outs] == [torch.float32] * 2 + [torch.bfloat16] * 3 + [
        torch.float32] * 2 + [torch.bfloat16] * 2 + [torch.float32] * 2
    hd, zargs = outs[0], outs[1]
    rng = np.random.default_rng(9)
    dhd = torch.from_numpy(rng.standard_normal(hd.shape).astype(np.float32))
    dza = torch.from_numpy(rng.standard_normal(zargs.shape).astype(np.float32))
    auto = torch.autograd.grad((hd * dhd).sum() + (zargs * dza).sum(), ins, allow_unused=True)
    (xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d) = ins
    (_, _, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd) = (o.detach() for o in outs)
    got = ttc.two_cell_bwd_plain(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps.detach(),
                                 zargs.detach(), xe.detach(), xd.detach(), dhd, dza,
                                 we.detach(), rke.detach(), wdx.detach(), rkd.detach(),
                                 kz.detach(), wz.detach())
    names = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
             "dwz", "dbe", "dbd", "dbz")
    index = dict(dxe=0, dxd=1, dwe=3, dbe=4, drke=5, dwdx=6, dbd=7, drkd=8, dkz=9, dwz=10, dbz=11,
                 dh0e=12, dc0e=13, dh0d=14, dc0d=15)
    for name, g in zip(names, got):
        a = auto[index[name]]
        assert g.dtype == a.dtype, name
        rel = ((g.float() - a.float()).norm() / a.float().norm()).item()
        assert rel <= 1e-2, f"{name}: relative Frobenius {rel}"


def test_should_use():
    mk = lambda **kw: tcl.Config(original_dim=88, n_classes=13, use_x_prev=True, **kw)
    # no TPU gate: in f32 the port takes the kernel wherever it accepts the
    # config, in bf16 up to the width where the H100 measured it faster
    assert ttc.should_use(mk(intermediate_dim=88))
    assert ttc.should_use(mk(intermediate_dim=256, latent_dim=8))
    assert ttc.should_use(mk(intermediate_dim=1024))
    assert ttc.should_use(mk(intermediate_dim=2048, latent_dim=8))  # the backward has no cap
    assert ttc.should_use(mk(intermediate_dim=256, bf16_compute=True))
    assert ttc.should_use(mk(intermediate_dim=512, bf16_compute=True))
    assert ttc.should_use(mk(intermediate_dim=ttc.BF16_TWO_CELL_MAX_H, bf16_compute=True))
    assert ttc.should_use(mk(intermediate_dim=768, bf16_compute=True))
    assert ttc.should_use(mk(intermediate_dim=1536, bf16_compute=True))
    assert not ttc.should_use(mk(intermediate_dim=4096, bf16_compute=True))  # not measured
    assert ttc.should_use(mk(intermediate_dim=4096, bf16_compute=True), two_cell=True)
    assert not ttc.should_use(mk(intermediate_dim=256, dropout=0.1))
    assert not ttc.should_use(mk(intermediate_dim=256, remat=True))
    # the forward keeps its state in global memory: no width limit; only an
    # absurd latent width overflows a step block's shared memory
    assert ttc.should_use(mk(intermediate_dim=8192))
    assert ttc.fits(mk(intermediate_dim=8192))
    assert not ttc.fits(mk(intermediate_dim=256, latent_dim=20000))
    assert not ttc.should_use(mk(intermediate_dim=256, latent_dim=20000))
    assert not ttc.should_use(mk(intermediate_dim=8192), two_cell=False)
    # an explicit choice wins both ways, from the argument or the config
    assert ttc.should_use(mk(intermediate_dim=8192), two_cell=True)
    assert not ttc.should_use(mk(intermediate_dim=256), two_cell=False)
    assert not ttc.should_use(mk(intermediate_dim=256, two_cell=False))
