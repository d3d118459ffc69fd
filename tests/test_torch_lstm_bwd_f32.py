"""The layout of the f32 whole-sequence LSTM full backward
(``csrc/lstm_bwd_f32.cu``), on the CPU.

The CUDA backward walks time in reverse with one product launch a step over
the whole batch: tiles of BM rows x BN hidden units whose K (the 4H columns
of dz) is split between the KS blocks of a cluster in whole chunks, the
ranks' sums added in rank order; each block then takes BM / KS of the
tile's rows and runs the gate gradients in the epilogue (dh = product +
dh_seq[t], dc = carry + dc_seq[t]), writing dz(t) and a bias partial sum per
(step, row tile, rank) whose rows are added warp by warp (rows w, w+4, ...)
and the four warps in order. A last launch gives dh0. dx, dRk and dW are
products over all T*B rows after the walk, db the in-order sum of the
partial sums. Here that arithmetic is written out in plain PyTorch on the
same tiles, K split and sum order (:func:`_tiled_backward`), at the
kernel's tiles (32 x 32, chunks of 32, KS = 4 as ``ops/lstm_seq.py``
launches it) and at small ones (4 x 8, chunks of 8) so that a small batch
and width cut into several ragged tiles and shares of K, with the
odd input width 101, and held against ``lstm_seq_bwd_plain`` (the function
the kernels are held against on the card) and, through the autograd route,
against the JAX package's ``lstm_sequence_pallas`` at fusion (T, T, T) (its
Pallas kernels in interpret mode). The CUDA kernels run only on the card
(``chip_smoke.py`` phase 8, ``tests/test_torch_cuda.py``).

Tolerances. The split of K and the sums over all rows at once are another
order of the plain version's sums: rtol 1e-5 / atol 1e-6. Against JAX the
bound of ``tests/test_torch_lstm_seq.py`` (rtol 1e-4 / atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.ops import lstm as jlstm
from classifying_vae_lstm_tpu_torch.ops import lstm as tlstm
from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
from classifying_vae_lstm_tpu_torch.ops.lstm import _gate_grads
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

SUMS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
KERNEL = (32, 32, 32, 4)  # (kFM, kFN, kFK) of csrc/ffma_f32.cuh, kSplit of csrc/lstm_bwd_f32.cu
SMALL = (4, 8, 8, 4)
NAMES = ("dx", "dh0", "dc0", "drk", "dw", "db")


def _in_order(rows):
    """Rows added one after another, in order (one thread's sum)."""
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    return acc


def _tile_bias_sum(dz):
    """A block's bias partial sum over its rows of a tile: warp w adds rows
    w, w + 4, ... in order, then the four warps' sums are added in order."""
    warps = [_in_order(dz[w::4]) if len(dz[w::4]) else torch.zeros_like(dz[0])
             for w in range(4)]
    return ((warps[0] + warps[1]) + warps[2]) + warps[3]


def _tiled_backward(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t, tile=KERNEL):
    """The redesigned backward's arithmetic on its tiles, K split and
    indices, with the signature and results of ``lstm_seq_bwd_plain``.
    ``tile`` = (BM, BN, chunk, KS) of the walk's product."""
    T, B, H4 = z.shape
    H, IN = H4 // 4, x.shape[-1]
    BM, BN, chunk, KS = tile
    nM, share = -(-B // BM), BM // KS
    per = -(-(-(-H4 // chunk)) // KS) * chunk  # rank r sums K columns [r per, (r + 1) per)
    rk = rk_t.T
    dz = torch.zeros(T, B, H4)
    part = torch.zeros(T * KS * nM, H4)
    dc_c = torch.zeros(B, H)
    gate_cols = lambda u0, u1: torch.cat([torch.arange(g * H + u0, g * H + u1) for g in range(4)])
    for t in range(T - 1, -2, -1):
        prod = torch.zeros(B, H)
        if t + 1 < T:
            for r in range(KS):
                ks = slice(r * per, (r + 1) * per)
                prod = dz[t + 1, :, ks] @ rk[:, ks].T if r == 0 else prod + (
                    dz[t + 1, :, ks] @ rk[:, ks].T)
        if t < 0:
            dh0 = prod
            break
        # each tile's KS blocks (the shares of K) take BM / KS of its rows each
        for mt, rank in ((mt, rank) for mt in range(nM) for rank in range(KS)):
            r0 = mt * BM + rank * share
            r1 = min(B, r0 + share)
            if r0 >= B:
                continue
            for u0 in range(0, H, BN):
                u1 = min(H, u0 + BN)
                cols, rows, units = gate_cols(u0, u1), slice(r0, r1), slice(u0, u1)
                d, dc_c[rows, units] = _gate_grads(
                    z[t, rows][:, cols], c[t, rows, units], c_prev[t, rows, units],
                    prod[rows, units] + dh_seq[t, rows, units],
                    dc_c[rows, units] + dc_seq[t, rows, units])
                dz[t, rows, cols] = d
                part[(t * nM + mt) * KS + rank, cols] = _tile_bias_sum(d)
    R = T * B
    flat = lambda a: a.reshape(R, a.shape[-1])
    dx = (flat(dz) @ w_t).reshape(T, B, IN)
    return dx, dh0, dc_c, flat(h_prev).T @ flat(dz), flat(x).T @ flat(dz), _in_order(part)


def _residuals(B, T=4, IN=101, H=20, seed=0):
    """The backward's inputs from a run of the plain training forward on
    seeded inputs, with seeded cotangents of the h and c sequences."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    x, w, b, rk = f(T, B, IN), f(IN, 4 * H, scale=0.2), f(4 * H, scale=0.3), f(H, 4 * H, scale=0.3)
    _, c, z, hp, cp = ls.lstm_seq_train_fwd_plain(x, w, b, rk, f(B, H, scale=0.5),
                                                  f(B, H, scale=0.5))
    return z, cp, c, hp, x, f(T, B, H, scale=0.5), f(T, B, H, scale=0.5), rk.T, w.T


@pytest.mark.parametrize("tile", ["kernel", "small"])
@pytest.mark.parametrize("B", [11, 8])
def test_tiled_backward_matches_plain(tile, B):
    """The tiles, the K split across the cluster, the hoisted dx, the
    weight-gradient products over all rows and the partial bias sums,
    against the step-by-step plain backward: every output agrees to the
    order of its sums."""
    res = _residuals(B, seed=B)
    got = _tiled_backward(*res, tile=SMALL if tile == "small" else KERNEL)
    want = ls.lstm_seq_bwd_plain(*res)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, msg=name, **SUMS)


def test_tiles_cover_every_row_and_unit_once():
    """Ragged tiles (B=11 rows in tiles of 4, H=20 units in tiles of 8) give
    every output but db bit for bit as the kernel's own tiles (one tile here)
    at the same K split: each dz entry is written once, by the same
    arithmetic; db, whose partial sums follow the row tiles, agrees to the
    order of its sums."""
    res = _residuals(11, seed=3)
    small = _tiled_backward(*res, tile=(4, 8, *KERNEL[2:]))
    whole = _tiled_backward(*res)
    for name, a, b in zip(NAMES, small, whole):
        if name == "db":
            torch.testing.assert_close(a, b, msg=name, **SUMS)
        else:
            assert torch.equal(a, b), name


def test_core_hands_the_kernels_the_stored_weights(monkeypatch):
    """``LstmSeqCore`` passes Rk and W to the full backward as transposed
    views of the tensors it saved, so the CUDA wrapper reads them as stored
    and copies nothing (the first design concatenated and transposed them
    every call)."""
    seen = {}
    real = ls.lstm_seq_bwd_plain

    def spy(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t):
        seen["views"] = (rk_t.T.is_contiguous(), w_t.T.is_contiguous())
        seen["ptrs"] = (rk_t.data_ptr(), w_t.data_ptr())
        return real(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t)

    monkeypatch.setattr(ls, "lstm_seq_bwd_plain", spy)
    rng = np.random.default_rng(5)
    p = {"kernel": rng.standard_normal((101, 80)).astype(np.float32) * 0.2,
         "recurrent_kernel": rng.standard_normal((20, 80)).astype(np.float32) * 0.3,
         "bias": np.zeros(80, np.float32)}
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((3, 4, 101)).astype(np.float32))
    h0 = c0 = torch.zeros(3, 20)
    h, _ = tlstm.lstm_sequence(tp, x, h0, c0, backend="pallas")
    h.square().sum().backward()
    assert seen["views"] == (True, True)
    assert seen["ptrs"] == (tp["recurrent_kernel"].data_ptr(), tp["kernel"].data_ptr())


def test_tiled_route_matches_jax(monkeypatch):
    """The autograd route with the tiled backward in place of the plain one
    (what the card runs) against ``jax.grad`` of the JAX package's
    ``lstm_sequence(backend="pallas")`` (fusion (T, T, T), f32): every
    gradient, at a ragged batch, the input width 101 and a cotangent on c_T."""
    monkeypatch.setattr(ls, "lstm_seq_bwd_plain",
                        lambda *a: _tiled_backward(*a, tile=SMALL))
    B, T, IN, H = 11, 5, 101, 20
    rng = np.random.default_rng(7)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    p = {"kernel": f(IN, 4 * H, scale=0.2), "recurrent_kernel": f(H, 4 * H, scale=0.3),
         "bias": f(4 * H, scale=0.3)}
    x, h0, c0 = f(B, T, IN), f(B, H, scale=0.5), f(B, H, scale=0.5)
    loss = lambda h, hT, cT, lib: (lib.sum(h ** 2 * lib.cos(lib.arange(h.shape[-1])))
                                   + lib.sum(cT * hT))
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx, th0, tc0 = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, h0, c0))
    th, (thT, tcT) = tlstm.lstm_sequence(tp, tx, th0, tc0, backend="pallas")
    loss(th, thT, tcT, torch).backward()

    def jloss(p, x, h0, c0):
        h, (hT, cT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas")
        return loss(h, hT, cT, jnp)

    gp, gx, gh0, gc0 = jax.grad(jloss, argnums=(0, 1, 2, 3))(p, x, h0, c0)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]), err_msg=k, **GRAD)
    for name, got, ref in (("x", tx, gx), ("h0", th0, gh0), ("c0", tc0, gc0)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), err_msg=name, **GRAD)
