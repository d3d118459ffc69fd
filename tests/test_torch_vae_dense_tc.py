"""The layout of the bf16 dense-stack backward (``csrc/vae_dense_tc.cu``),
on the CPU.

The CUDA backward runs the cl_vae backward chain in 8 launches: the frame
head's sigmoid backward; the wide layers (dxh @ Wxhᵀ, dh @ Whxᵀ, dd @
Wdxpᵀ, dhw @ Whwᵀ) as tensor-core products over the whole batch whose K is
split over an 8-block cluster at whole chunks, the 8 ranks' sums added in
rank order, with the ReLU mask (or the addition of dx1) in the epilogue;
two row kernels for the narrow layers (the dot products along the rows of
[Wdw | Wdz] and Whw2 with the columns split between 8 warps, each warp's
lanes added in a fixed butterfly and the warps in order; dza @ Wzzᵀ and
dwa @ Wwzᵀ a unit a thread) with the z and w sample backward and the
softmax backward; the wide weight gradients as products over the rows; the
narrow ones and the bias sums, each summed over the rows in order. Here
that arithmetic is written out in plain PyTorch on the same K split, warp
split and sum order (:func:`_tiled_backward`), at the kernel's chunks (32,
split 8) and at small ones (4, split 8) so that the small widths cut into
several ragged shares of K, with ragged batches (11 and 8 rows) and the odd
frame width 101, and held against ``vae_dense_bwd_plain`` in its bf16 mode
(the function the kernels are held against on the card) and, through the
autograd route, against the JAX package's ``cl_vae.apply(bf16_compute=True,
train_backend="pallas")`` (its Pallas kernels in interpret mode). The CUDA
kernels run only on the card (``chip_smoke.py`` phase 18,
``tests/test_torch_cuda.py``).

Tolerances. Both sides round the same values at the same places and sum in
f32 in another order: the bf16 outputs (dx, dx_prev and the weight
gradients) within one bf16 step, the f32 bias sums rtol 1e-5 / atol 1e-6.
Against JAX the bounds of ``tests/test_torch_vae_dense.py``'s
``test_bf16_mode_matches_jax``.
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

SUMS = dict(rtol=1e-5, atol=1e-6)
KERNEL = (32, 8)  # (kBK of csrc/mma_bf16.cuh, kSplit of csrc/vae_dense_tc.cu)
SMALL = (4, 8)
WARPS = 8         # kWarps of the row kernels
NAMES = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz", "dbzz",
         "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")


def _in_order(rows):
    """Rows added one after another, in order (one thread's sum)."""
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    return acc


def _product(a, w, chunk, split):
    """a [M, K] @ w [N, K]ᵀ as the cluster sums it: rank r sums the K
    columns [r per, (r + 1) per), per a whole number of chunks, and the
    ranks' sums are added in rank order."""
    K = a.shape[1]
    per = -(-(-(-K // chunk)) // split) * chunk
    acc = None
    for r in range(split):
        k0, k1 = r * per, min(K, (r + 1) * per)
        part = a[:, k0:k1] @ w[:, k0:k1].T if k0 < K else torch.zeros(a.shape[0], w.shape[0])
        acc = part if acc is None else acc + part
    return acc


def _row_dot(a, b):
    """sum_c a[c] b[c] as a row kernel's block takes it: warp w of 8 the
    columns [w per, (w + 1) per), lane l of them l, l + 32, ... in order, a
    butterfly (xor 16, 8, 4, 2, 1) adds the lanes' sums (lane 0's value),
    then the warps' sums are added in order."""
    n = a.shape[0]
    per = -(-n // WARPS)
    total = None
    for w in range(WARPS):
        prod = (a * b)[w * per:(w + 1) * per]
        prod = torch.nn.functional.pad(prod, (0, -prod.shape[0] % 32)).reshape(-1, 32)
        lanes = _in_order(prod) if prod.shape[0] else torch.zeros(32)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[torch.arange(32) ^ off]
        total = lanes[0] if total is None else total + lanes[0]
    return total


def _row_dots(a, w):
    """[B, J]: every row of a [B, n] against every row of w [J, n]."""
    return torch.stack([torch.stack([_row_dot(row, wj) for wj in w]) for row in a])


def _tiled_backward(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                    dxhat, dwargs, dzargs, dw, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh,
                    chunk=KERNEL):
    """The redesigned bf16 backward's arithmetic on its K split, warp split
    and sum order, with the signature and results of ``vae_dense_bwd_plain``
    (bf16 mode). ``chunk`` = (chunk, split) of the row-chain products."""
    K1, L = eps_w.shape[-1], eps_z.shape[-1]
    prod = lambda a, m: _product(op(a), m.float(), *chunk)
    relu = lambda v, post: torch.where(post > 0, v, torch.zeros_like(v))
    K = whw2.shape[0]
    # frame head, then dd = (dxh @ Wxhᵀ) (a3 > 0)
    dxh = dxhat * xhat * (1.0 - xhat)
    dd = relu(prod(dxh, wxh), a3)
    # the latent row kernel: dd @ [Wdw | Wdz]ᵀ, the z sample, dh
    dots = _row_dots(op(dd), torch.cat([wdw, wdz]).float())
    dw1, dz = dw + dots[:, :K], dots[:, K:]
    sig_z = torch.exp(zargs[:, L:] / 2)
    dza = torch.cat([dz + dzargs[:, :L], dz * eps_z * sig_z * 0.5 + dzargs[:, L:]], dim=-1)
    zs = zargs[:, :L] + sig_z * eps_z
    dh = relu(op(dza) @ wzz.float().T, a2)
    # dx1 = dh @ Whxᵀ; dxp = dd @ Wdxpᵀ
    dx1 = prod(dh, whx)
    dxp = prod(dd, wdxp) if xp is not None else None
    # the key row kernel: dh @ Whw2ᵀ, the softmax and w sample backward, dhw
    dw2 = dw1 + _row_dots(op(dh), whw2.float())
    dot = _in_order((dw2 * w).T)
    dl = w[:, :K1] * (dw2[:, :K1] - dot[:, None])
    sig_w = torch.exp(wargs[:, K1:] / 2)
    dwa = torch.cat([dl + dwargs[:, :K1], dl * eps_w * sig_w * 0.5 + dwargs[:, K1:]], dim=-1)
    dhw = relu(op(dwa) @ wwz.float().T, a1)
    dx = dx1 + prod(dhw, whw)
    # weight gradients over the rows, rounded once; bias sums of the f32 values
    wg = lambda a, g: (op(a).T @ op(g)).bfloat16()
    bias = lambda g: _in_order(g)
    dwdxp = wg(xp.float(), dd) if xp is not None else None
    return (dx.bfloat16(), None if dxp is None else dxp.bfloat16(), wg(x.float(), dhw),
            bias(dhw), wg(a1, dwa), bias(dwa), wg(x.float(), dh), wg(w, dh), bias(dh),
            wg(a2, dza), bias(dza), wg(w, dd), dwdxp, wg(zs, dd), bias(dd), wg(a3, dxh),
            bias(dxh))


def _bf16_steps(got, ref) -> int:
    """The largest distance, in bf16 steps, between two bf16 tensors."""
    order = lambda a: (lambda b: torch.where(b < 0, -(b & 0x7FFF), b))(
        a.view(torch.int16).to(torch.int32))
    return int((order(got) - order(ref)).abs().max())


def _residuals(B, D=101, Cw=8, H=24, L=3, K=4, use_xp=True, seed=0):
    """The bf16 backward's inputs from a run of the bf16 plain forward on
    seeded weights and inputs, with seeded cotangents."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    x = torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32)).bfloat16()
    xp = torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32)).bfloat16()
    K2 = 2 * (K - 1)
    b = lambda t: t.bfloat16()
    ws = dict(whw=b(f(D, Cw, scale=0.3)), bhw=f(Cw, scale=0.2), wwz=b(f(Cw, K2, scale=0.4)),
              bwz=f(K2, scale=0.2), whx=b(f(D, H, scale=0.3)), whw2=b(f(K, H, scale=0.4)),
              bh=f(H, scale=0.2), wzz=b(f(H, 2 * L, scale=0.3)), bzz=f(2 * L, scale=0.2),
              wdw=b(f(K, H, scale=0.4)), wdxp=b(f(D, H, scale=0.3)) if use_xp else None,
              wdz=b(f(L, H, scale=0.4)), bd=f(H, scale=0.2), wxh=b(f(H, D, scale=0.3)),
              bxh=f(D, scale=0.2))
    eps_w, eps_z = f(B, K - 1), f(B, L)
    xp = xp if use_xp else None
    xhat, wargs, zargs, w, a1, a2, a3 = vd.vae_dense_fwd_plain(x, xp, eps_w, eps_z, *ws.values())
    cot = [f(*t.shape, scale=0.5) for t in (xhat, wargs, zargs, w)]
    return (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, *cot, ws["whw"], ws["wwz"],
            ws["whx"], ws["whw2"], ws["wzz"], ws["wdw"], ws["wdxp"], ws["wdz"], ws["wxh"])


@pytest.mark.parametrize("chunk", ["kernel", "small"])
@pytest.mark.parametrize("B,use_xp", [(11, True), (8, True), (11, False)])
def test_tiled_backward_matches_plain(chunk, B, use_xp):
    """The K split over the cluster, the warp-split dot products, the
    narrow products a unit a thread and the weight gradients over all rows,
    against the bf16 plain backward: bf16 outputs within one bf16 step, the
    f32 bias sums to the order of their sums."""
    res = _residuals(B, use_xp=use_xp, seed=B + use_xp)
    got = _tiled_backward(*res, chunk=SMALL if chunk == "small" else KERNEL)
    want = vd.vae_dense_bwd_plain(*res)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith("db"):
            assert g.dtype == torch.float32, name
            torch.testing.assert_close(g, w, msg=name, **SUMS)
        else:
            assert g.dtype == torch.bfloat16, name
            assert _bf16_steps(g, w) <= 1, name


def _setup(B=11, D=16, Cw=8, H=24, L=3, K=4, seed=3):
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
    """The autograd route in the bf16 mode with the tiled backward in place
    of the plain one (what the card runs) against ``jax.grad`` of
    ``cl_vae.apply(bf16_compute=True, train_backend="pallas")``: every
    parameter gradient within 1e-4 relative Frobenius, the weight gradients
    bf16-representable and the bias gradients not rounded, and the JAX
    test's norm bound against the f32 truth; a ragged batch (11 rows) and
    the odd frame width 101."""
    monkeypatch.setattr(vd, "vae_dense_bwd_plain",
                        lambda *a: _tiled_backward(*a, chunk=SMALL))
    jcfg, tcfg, params, x, xp, noise = _setup(D=101)
    p = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
         for k, d in params_from_numpy(params, "cpu").items()}
    t = torch.from_numpy
    out = vd.vae_apply_core(p, tcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    _loss_terms(out, torch).backward()
    loss = lambda q, c: _loss_terms(jvae.apply(q, c, x, jax.random.PRNGKey(0), xp, noise=noise),
                                    jnp)
    g_kernel = jax.grad(loss)(params, jcfg)
    g_f32 = jax.grad(loss)(params, dataclasses.replace(jcfg, train_backend="xla",
                                                       bf16_compute=False))
    g_xla = jax.grad(loss)(params, dataclasses.replace(jcfg, train_backend="xla"))
    n = 0
    for layer, leaves in p.items():
        for leaf, v in leaves.items():
            name, g = f"{layer}/{leaf}", v.grad
            got, want = g.numpy(), np.asarray(g_kernel[layer][leaf])
            rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
            assert rel <= 1e-4, (name, rel)
            rounded = bool(torch.equal(g, g.bfloat16().float()))
            assert rounded == (leaf == "kernel"), name
            f = np.asarray(g_f32[layer][leaf])
            err_p = np.linalg.norm(got - f)
            err_x = np.linalg.norm(np.asarray(g_xla[layer][leaf]) - f)
            assert err_p <= 3.0 * err_x + 0.02 * (np.linalg.norm(f) + 1e-3), (name, err_p, err_x)
            n += 1
    assert n == 16


def test_bf16_route_reads_the_stored_weights(monkeypatch):
    """The bf16 mode hands the backward the weights as ``pack_inputs`` made
    them, in their stored [in, out] layout: the CUDA route reads them so (no
    transposed or concatenated copies per call)."""
    seen = []
    real = vd.vae_dense_bwd_plain
    monkeypatch.setattr(vd, "vae_dense_bwd_plain",
                        lambda *a: seen.append(a) or real(*a))
    jcfg, tcfg, params, x, xp, noise = _setup()
    p = params_from_numpy(params, "cpu")
    for d in p.values():
        for v in d.values():
            v.requires_grad_(True)
    t = torch.from_numpy
    ins = vd.pack_inputs(p, tcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    out = vd.vae_apply_core(p, tcfg, t(x), t(xp), t(noise["eps_w"]), t(noise["eps_z"]))
    _loss_terms(out, torch).backward()
    (args,) = seen
    weights = args[15:]  # whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh
    packed = (ins[4], ins[6], ins[8], ins[9], ins[11], ins[13], ins[14], ins[15], ins[17])
    for got, want in zip(weights, packed):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.shape == want.shape and torch.equal(got, want)
