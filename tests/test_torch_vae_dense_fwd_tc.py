"""The layout of the bf16 dense-stack forward (``csrc/vae_dense_tc.cu``), on
the CPU.

The CUDA forward runs the cl_vae forward in 3 launches: the products that do
not depend on w (a1 = relu(x @ Whw + bhw), x @ Whx and x_prev @ Wdxp) as
tensor-core products over the whole batch whose K is split over an 8-block
cluster at whole chunks, the 8 ranks' sums added in rank order, the bias, the
ReLU and the rounding of a1 in the epilogue; one row kernel for the narrow
chain (the w and z heads with the weight's rows split between 16 warps in
order and its columns between the lanes, the warps' sums added in order and
then the bias; the softmax with the pinned zero logit; a2 and a3 a unit a
thread, their K and L terms summed in order and added in the JAX kernel's
order; the z sample); and a3 @ Wxh with the bias and the sigmoid in the
epilogue. Here that arithmetic is written out in plain PyTorch on the same K
split, warp split and sum order (:func:`_tiled_forward`), at the kernel's
chunks (32, split 8) and at small ones (4, split 8) so that the small widths
cut into several ragged shares of K, with ragged batches (11 and 8 rows) and
the odd frame width 101, and held against ``vae_dense_fwd_plain`` in its
bf16 mode (the function the kernels are held against on the card) and,
through the autograd route, against the JAX package's
``cl_vae.apply(bf16_compute=True, train_backend="pallas")`` (its Pallas
kernels in interpret mode). The CUDA kernels run only on the card
(``chip_smoke.py`` phase 18, ``tests/test_torch_cuda.py``).

Tolerances. Both sides round the same values at the same places and sum in
f32 in another order, so a value near a bf16 rounding boundary may round the
other way: the residuals a1, a2, a3 (bf16 values) within one bf16 step; the
f32 outputs within 1e-2 x max(1, max|plain|) and 1e-3 relative Frobenius,
the bounds of the card's test. Against JAX the bounds of
``tests/test_torch_vae_dense.py``'s ``test_bf16_mode_matches_jax``.
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
from classifying_vae_lstm_tpu_torch.ops.lstm import bf16_operand as op
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

KERNEL = (32, 8)  # (kBK of csrc/mma_bf16.cuh, kSplit of csrc/vae_dense_tc.cu)
SMALL = (4, 8)
WARPS = 16        # kFwdWarps of the row kernel
OUTS = ("x_decoded_mean", "w", "w_mean", "w_log_var", "z", "z_mean", "z_log_var")


def _in_order(rows):
    """Rows added one after another, in order (one thread's sum)."""
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    return acc


def _product(a, w, chunk, split):
    """a [M, K] @ w [K, N] (a weight as stored) as the cluster sums it: rank
    r sums the K rows [r per, (r + 1) per), per a whole number of chunks, and
    the ranks' sums are added in rank order."""
    K = a.shape[1]
    per = -(-(-(-K // chunk)) // split) * chunk
    acc = None
    for r in range(split):
        k0, k1 = r * per, min(K, (r + 1) * per)
        part = a[:, k0:k1] @ w[k0:k1] if k0 < K else torch.zeros(a.shape[0], w.shape[1])
        acc = part if acc is None else acc + part
    return acc


def _narrow_head(a, w, bias):
    """a [R, n] @ w [n, J] + bias as ``narrow_head`` sums it: warp w of 16
    takes the rows c of w in [w per, (w + 1) per) in order, the warps' sums
    are added in order, then the bias."""
    n = a.shape[1]
    per = -(-n // WARPS)
    total = None
    for wp in range(WARPS):
        acc = _in_order([a[:, c:c + 1] * w[c] for c in range(wp * per, min(n, (wp + 1) * per))]
                        or [torch.zeros(a.shape[0], w.shape[1])])
        total = acc if total is None else total + acc
    return total + bias


def _unit_sum(a, w):
    """a [R, J] @ w [J, N] as a thread a unit sums it: the J terms in order."""
    return _in_order([a[:, j:j + 1] * w[j] for j in range(a.shape[1])])


def _tiled_forward(x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp,
                   wdz, bd, wxh, bxh, chunk=KERNEL):
    """The redesigned bf16 forward's arithmetic on its K split, warp split and
    sum order, with the signature and results of ``vae_dense_fwd_plain``
    (bf16 mode). ``chunk`` = (chunk, split) of the products."""
    K1, L = eps_w.shape[-1], eps_z.shape[-1]
    f = lambda t: None if t is None else t.float()
    x, xp, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh = (
        f(t) for t in (x, xp, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh))
    prod = lambda a, m: _product(op(a), m, *chunk)
    # the first product launch: a1 (bias, ReLU, rounding in the epilogue), the x parts
    a1 = op(torch.relu(prod(x, whw) + bhw))
    xh = prod(x, whx)
    xpd = prod(xp, wdxp) if xp is not None else None
    # the row kernel: w heads, the logistic-normal sample (one thread a row,
    # its sum in order), a2, z heads, z, a3
    wargs = _narrow_head(a1, wwz, bwz)
    wn = wargs[:, :K1] + torch.exp(wargs[:, K1:] / 2) * eps_w
    logits = torch.cat([wn, wn.new_zeros((wn.shape[0], 1))], dim=-1)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = e / _in_order(e.T)[:, None]
    a2 = op(torch.relu((xh + _unit_sum(op(w), whw2)) + bh))
    zargs = _narrow_head(a2, wzz, bzz)
    z = zargs[:, :L] + torch.exp(zargs[:, L:] / 2) * eps_z
    d = (_unit_sum(op(w), wdw) + _unit_sum(op(z), wdz)) + bd
    if xpd is not None:
        d = d + xpd
    a3 = op(torch.relu(d))
    # the frame head's product launch: bias and sigmoid in the epilogue
    xhat = torch.sigmoid(prod(a3, wxh) + bxh)
    return xhat, wargs, zargs, w, a1, a2, a3


def _bf16_steps(got, ref) -> int:
    """The largest distance, in bf16 steps, between two bf16-valued tensors."""
    order = lambda a: (lambda b: torch.where(b < 0, -(b & 0x7FFF), b))(
        a.bfloat16().view(torch.int16).to(torch.int32))
    return int((order(got) - order(ref)).abs().max())


def _inputs(B, D=101, Cw=8, H=24, L=3, K=4, use_xp=True, seed=0):
    """The bf16 forward's inputs: binary frames, Gaussian noise, seeded
    weights of std ~1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    m = lambda i, o: f(i, o, scale=i ** -0.5).bfloat16()
    bits = lambda: torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32)).bfloat16()
    K2 = 2 * (K - 1)
    return (bits(), bits() if use_xp else None, f(B, K - 1), f(B, L), m(D, Cw), f(Cw, scale=0.2),
            m(Cw, K2), f(K2, scale=0.2), m(D, H), m(K, H), f(H, scale=0.2), m(H, 2 * L),
            f(2 * L, scale=0.2), m(K, H), m(D, H) if use_xp else None, m(L, H), f(H, scale=0.2),
            m(H, D), f(D, scale=0.2))


@pytest.mark.parametrize("chunk", ["kernel", "small"])
@pytest.mark.parametrize("B,use_xp", [(11, True), (8, True), (11, False)])
def test_tiled_forward_matches_plain(chunk, B, use_xp):
    """The K split over the cluster, the warp-split heads, the unit sums in
    order and the JAX order of the additions, against the bf16 plain
    forward: the residuals within one bf16 step, the f32 outputs within the
    card's bounds."""
    ins = _inputs(B, use_xp=use_xp, seed=B + use_xp)
    got = _tiled_forward(*ins, chunk=SMALL if chunk == "small" else KERNEL)
    want = vd.vae_dense_fwd_plain(*ins)
    rel = lambda a, b: ((a - b).norm() / (b.norm() + 1e-30)).item()
    for name, g, w in zip(("xhat", "wargs", "zargs", "w", "a1", "a2", "a3"), got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        if name in ("a1", "a2", "a3"):
            assert torch.equal(g, op(g)), name  # bf16 values, as the kernel stores them
            assert _bf16_steps(g, w) <= 1, name
        else:
            assert (g - w).abs().max().item() <= 1e-2 * max(1.0, w.abs().max().item()), name
            assert rel(g, w) <= 1e-3, name


def _setup(B=11, D=101, Cw=8, H=24, L=3, K=4, seed=3):
    jcfg = jvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                       intermediate_class_dim=Cw, n_classes=K, use_x_prev=True,
                       train_backend="pallas", bf16_compute=True)
    params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((B, D)) < 0.2).astype(np.float32)
    xp = (rng.random((B, D)) < 0.2).astype(np.float32)
    noise = {"eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
             "eps_z": rng.standard_normal((B, L)).astype(np.float32)}
    return jcfg, tvae.Config(**dataclasses.asdict(jcfg)), params, x, xp, noise


def _loss_terms(out, lib):
    """Every output touched with different weights (all four cotangents of
    the core), as ``tests/test_pallas_vae.py`` does."""
    return (lib.sum(out["x_decoded_mean"] ** 2) + lib.sum(lib.sin(out["w_mean"]))
            + lib.sum(out["w_log_var"] ** 2) + lib.sum(out["z_mean"] * lib.cos(out["z_log_var"]))
            + lib.sum(out["w"] ** 3) + lib.sum(out["z"] * out["z"]))


def test_tiled_route_matches_jax(monkeypatch):
    """The autograd route in the bf16 mode with the tiled forward in place of
    the plain one (what the card runs) against ``cl_vae.apply(bf16_compute=
    True, train_backend="pallas")``: every output within max 1e-2 and mean
    1e-4, and ``jax.grad`` of the loss per leaf within 1e-4 relative
    Frobenius (the backward reads the tiled forward's residuals), the weight
    gradients bf16-representable and the bias gradients not rounded; a
    ragged batch (11 rows) and the odd frame width 101."""
    monkeypatch.setattr(vd, "vae_dense_fwd_plain",
                        lambda *a: _tiled_forward(*a, chunk=SMALL))
    jcfg, tcfg, params, x, xp, noise = _setup()
    p = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
         for k, d in params_from_numpy(params, "cpu").items()}
    t = torch.from_numpy
    out = vd.vae_apply_core(p, tcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    ref = jvae.apply(params, jcfg, x, jax.random.PRNGKey(0), xp, noise=noise)
    for k in OUTS:
        d = np.abs(out[k].detach().numpy() - np.asarray(ref[k]))
        assert d.max() <= 1e-2 and d.mean() <= 1e-4, (k, d.max(), d.mean())
    _loss_terms(out, torch).backward()
    loss = lambda q, c: _loss_terms(jvae.apply(q, c, x, jax.random.PRNGKey(0), xp, noise=noise),
                                    jnp)
    g_kernel = jax.grad(loss)(params, jcfg)
    n = 0
    for layer, leaves in p.items():
        for leaf, v in leaves.items():
            name, g = f"{layer}/{leaf}", v.grad
            got, want = g.numpy(), np.asarray(g_kernel[layer][leaf])
            rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
            assert rel <= 1e-4, (name, rel)
            assert bool(torch.equal(g, g.bfloat16().float())) == (leaf == "kernel"), name
            n += 1
    assert n == 16
