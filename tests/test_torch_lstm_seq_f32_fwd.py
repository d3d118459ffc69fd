"""The layout and sum order of the f32 whole-sequence LSTM forward
(``csrc/lstm_seq.cu`` ``lstm_fwd_kernel``), on the CPU.

The CUDA forward is one launch for all T steps: each block owns nu hidden
units (all four gate columns of each) for every row of its group, a group of
NB blocks covers H, the groups split the rows (:func:`fwd_plan`), and a
block builds its slice of ``[W ; Rk]`` in shared memory from the stored
weights, ``[kx + kh][nu][4]`` (the x rows, then the h rows, each padded to
32), reading each element where ``slice_src`` in ``csrc/lstm_seq.cu``
reads it. Each output is summed by one thread over 32-k chunks in order:
the x rows, then b, then the h rows (in the xz mode from xz, then the h
rows). Here the plan is checked for ownership (every unit in one block of
a group, every row in one group's tiles) and residency at the widths and
batches the port runs, and the kernel's arithmetic is written out in plain
PyTorch on slices read from the stored weights as ``slice_src`` reads
them, chunk by chunk in its order, block by block, group by group and tile
by tile, and held against ``lstm_seq_train_fwd_plain`` and ``lstm_seq_xz_train_fwd_plain``
(the functions the kernel is held against on the card) within 1e-5, the
bound ``chip_smoke.py`` holds the kernel to (``FWD_LIMIT``; c and z at
their scale). The plain versions are held against the JAX package by
``tests/test_torch_lstm_seq.py``; the kernel runs only on the card
(``chip_smoke.py`` phases 8, 26, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
from classifying_vae_lstm_tpu_torch.ops.lstm import _gates

N_SM = 132
FWD = dict(rtol=0, atol=1e-5)


def _problem(T, B, IN, H, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = np.concatenate([(rng.random((T, B, min(IN, 88))) < 0.1),
                        0.5 * rng.standard_normal((T, B, max(IN - 88, 0)))], -1)
    lim = lambda i, o: np.sqrt(6.0 / (i + o))
    w = rng.uniform(-lim(IN, 4 * H), lim(IN, 4 * H), (IN, 4 * H))
    rk = rng.uniform(-lim(H, 4 * H), lim(H, 4 * H), (H, 4 * H))
    b = 0.1 * rng.standard_normal(4 * H)
    h0, c0 = 0.1 * rng.standard_normal((B, H)), 0.1 * rng.standard_normal((B, H))
    return tuple(t(a) for a in (x, w, b, rk, h0, c0))


@pytest.mark.parametrize("B", [20, 200, 12800])
@pytest.mark.parametrize("H", [88, 128, 256, 1024])
def test_plan_owns_every_unit_and_row_once(H, B):
    """Units: nu even and at most 64, NB = cdiv(H, nu) blocks a group (8 up
    to H = 512, more past it; every group's blocks in one cooperative
    launch, one an SM); rows: the groups' row ranges cover the batch once, walked in tiles of 1, 2 or 4 rows a thread; residency: the slice of
    ``[W ; Rk]`` resident where it and the ring fit 227 KB, else streamed,
    and the layout taken fits."""
    IN = 105
    for xz in (False, True):
        p = ls.fwd_plan(B, 0 if xz else IN, H, N_SM)
        nu, NB = p["nu"], p["NB"]
        assert nu % 2 == 0 and nu <= 64 and NB == -(-H // nu) and (NB - 1) * nu < H
        owner = np.concatenate([np.full(nu, g) for g in range(NB)])[:H]
        assert sorted(np.unique(owner)) == list(range(NB))
        assert (NB == 8) == (H <= 512) and p["groups"] <= N_SM // NB
        tile = ls.fwd_tile_rows(nu, p["rt"])
        base = ls.fwd_tile_rows(nu, 1)
        want = next((rt for rt in (1, 2) if p["rpg"] <= rt * base), 4)
        assert p["rt"] == want or (p["rt"] < want) == p["resident"]
        assert p["groups"] * NB <= N_SM and -(-p["rpg"] // tile) * tile >= p["rpg"]
        rows = np.concatenate([np.arange(g * p["rpg"], min(B, (g + 1) * p["rpg"]))
                               for g in range(p["groups"])])
        np.testing.assert_array_equal(rows, np.arange(B))
        assert p["kx"] == (0 if xz else 128) and p["kh"] == -(-H // 32) * 32
        smem = lambda res: ls.fwd_smem_bytes(nu, p["rt"], p["kx"], p["kh"], res)
        assert smem(p["resident"]) <= ls._SMEM_LIMIT
        assert p["resident"] == (smem(True) <= ls._SMEM_LIMIT)
    # the port's shapes: resident at H = 256 (the training and the evaluation
    # shape), rt = 1 for 13 rows a group, rt = 4 for 800; streamed at H = 1,024
    train, ev = ls.fwd_plan(200, IN, 256, N_SM), ls.fwd_plan(12800, IN, 256, N_SM)
    assert (train["nu"], train["NB"], train["rt"], train["rpg"], train["groups"]) == (
        32, 8, 1, 13, 16)
    assert (ev["rt"], ev["rpg"], ev["groups"]) == (4, 800, 16)
    assert [ls.fwd_tile_rows(32, rt) for rt in (1, 2, 4)] == [16, 32, 64]
    # 16 groups of 8 blocks on 132 SMs: 13 tiles of 64 rows a group a step
    # at 12,800 rows, one tile of 16 at B=200
    assert -(-ev["rpg"] // ls.fwd_tile_rows(32, 4)) == 13
    assert train["resident"] and ev["resident"] and ls.fwd_plan(200, 0, 256, N_SM)["resident"]
    assert not ls.fwd_plan(200, IN, 1024, N_SM)["resident"]


def _block_slice(w, rk, plan, IN, H, g):
    """Block g's slice ``[kx + kh, nu, 4]``, each element read where
    ``slice_src`` (``csrc/lstm_seq.cu``) reads it from the stored weights:
    row k < kx of W (zero past IN), else row k - kx of Rk (zero past H), gate
    q of unit u = g nu + j at column q H + u (zero past H)."""
    kx, kh, nu = plan["kx"], plan["kh"], plan["nu"]
    out = torch.zeros(kx + kh, nu, 4)
    for j in range(nu):
        u = g * nu + j
        if u >= H:
            continue
        for q in range(4):
            if w is not None:
                out[:IN, j, q] = w[:, q * H + u]
            out[kx:kx + H, j, q] = rk[:, q * H + u]
    return out


@pytest.mark.parametrize("xz", [False, True], ids=["fused", "xz"])
@pytest.mark.parametrize("IN,H", [(105, 256), (101, 88), (13, 1024)])
def test_block_slices_gather_to_the_gate_interleaved_weights(IN, H, xz):
    """The blocks' slices, read from the stored weights as ``slice_src``
    reads them, hold W's rows, then Rk's, with zero rows where IN and H are
    padded to 32 and zero units past H; gathered block by block they are
    ``interleave_gates`` of ``[W ; Rk]``: every weight in one block, once."""
    _, w, _, rk, _, _ = _problem(1, 2, IN, H)
    plan = ls.fwd_plan(200, 0 if xz else IN, H, N_SM)
    kx, kh, nu, NB = plan["kx"], plan["kh"], plan["nu"], plan["NB"]
    blocks = [_block_slice(None if xz else w, rk, plan, 0 if xz else IN, H, g)
              for g in range(NB)]
    assert all(b.shape == (kx + kh, nu, 4) for b in blocks)
    units = torch.cat(blocks, 1)  # [K, NB nu, 4]
    assert not units[:, H:].any()
    ref = torch.cat(([w, torch.zeros(kx - IN, 4 * H)] if not xz else [])
                    + [rk, torch.zeros(kh - H, 4 * H)])
    torch.testing.assert_close(units[:, :H].reshape(kx + kh, 4 * H), ls.interleave_gates(ref),
                               rtol=0, atol=0)


def _emulate(x, xz, w, b, rk, h0, c0, n_sm=N_SM):
    """The kernel's forward in plain torch: per step, per group and tile of
    rows and per block, the operand [x_t | h_{t-1}] (zero-padded to the
    slice's rows) times the block's slice chunk by chunk in order, b added
    before the first h chunk (the sums starting from xz in the xz mode),
    then the gates; h and c read back as the next step's operands. Returns
    (h, c, z, h_prev, c_prev)."""
    src = x if x is not None else xz
    T, B, _ = src.shape
    H = rk.shape[0]
    IN = 0 if x is None else x.shape[-1]
    plan = ls.fwd_plan(B, IN, H, n_sm)
    kx, kh, nu, NB = plan["kx"], plan["kh"], plan["nu"], plan["NB"]
    slices = [_block_slice(w, rk, plan, IN, H, g).reshape(kx + kh, 4 * nu) for g in range(NB)]
    tile = ls.fwd_tile_rows(nu, plan["rt"])
    h, c = h0, c0
    outs = [[] for _ in range(5)]
    for t in range(T):
        hn, cn, zt = torch.empty(B, H), torch.empty(B, H), torch.empty(B, 4 * H)
        for grp in range(plan["groups"]):
            for r0 in range(grp * plan["rpg"], min(B, (grp + 1) * plan["rpg"]), tile):
                rows = slice(r0, min(B, r0 + tile, (grp + 1) * plan["rpg"]))
                n = rows.stop - r0
                a = torch.zeros(n, kx + kh)
                if x is not None:
                    a[:, :IN] = x[t, rows]
                a[:, kx:kx + H] = h[rows]
                for g in range(NB):
                    units = torch.arange(g * nu, min(H, (g + 1) * nu))
                    cols = (torch.arange(4)[:, None] * H + units).reshape(-1)  # gate-ordered
                    acc = torch.zeros(n, 4, nu)  # [row, gate, unit of the block]
                    if x is None:
                        acc[:, :, :len(units)] = xz[t, rows][:, cols].reshape(n, 4, -1)
                    for k0 in range(0, kx + kh, ls._FWD_KC):
                        if k0 == kx and x is not None:
                            acc[:, :, :len(units)] += b[cols].reshape(4, -1)
                        prod = a[:, k0:k0 + ls._FWD_KC] @ slices[g][k0:k0 + ls._FWD_KC]
                        acc = acc + prod.reshape(n, nu, 4).transpose(1, 2)
                    zt[rows, cols] = acc[:, :, :len(units)].reshape(n, -1)
                hn[rows], cn[rows] = _gates(zt[rows], c[rows], H)
        for acc_, v in zip(outs, (hn, cn, zt, h, c)):
            acc_.append(v)
        h, c = hn, cn
    return tuple(torch.stack(o) for o in outs)


@pytest.mark.parametrize("T,B,IN,H,n_sm", [(4, 20, 105, 256, N_SM), (3, 77, 101, 88, 16),
                                           (3, 9, 13, 1024, N_SM)])
def test_emulated_order_matches_the_plain_forwards(T, B, IN, H, n_sm):
    """The emulation against ``lstm_seq_train_fwd_plain`` (every output)
    and, on xz = x @ W + b, ``lstm_seq_xz_train_fwd_plain``, within 1e-5 (c
    and z at their scale): at the training width with several groups of one
    tile, at H = 88 on a 20-SM card (several tiles a group, ragged units), and
    at H = 1,024 (16-block groups)."""
    x, w, b, rk, h0, c0 = _problem(T, B, IN, H, seed=H)
    got = _emulate(x, None, w, b, rk, h0, c0, n_sm)
    ref = ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)
    for name, g, r in zip(("h", "c", "z", "h_prev", "c_prev"), got, ref):
        scale = 1.0 if name in ("h", "h_prev") else max(1.0, r.abs().max().item())
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * scale, msg=name)
    xz = (x.reshape(T * B, IN) @ w + b).reshape(T, B, 4 * H)
    got = _emulate(None, xz, None, None, rk, h0, c0, n_sm)
    ref = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    for name, g, r in zip(("h", "c", "z"), got, ref):
        scale = 1.0 if name == "h" else max(1.0, r.abs().max().item())
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * scale, msg=name)
