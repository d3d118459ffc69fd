"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel has no CPU mode)
and skip without one. They cover what ``chip_smoke.py`` does not: ragged
song tiles (B not a multiple of the block's tile), no ``use_x_prev``, a
hidden width that takes two passes of the gate stages, a one-frame seed,
and the input checks on CUDA tensors. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the repository's conftest imports JAX, which a machine
for the port need not have). Tolerances: f32 probabilities within 1e-5
(same f32 products, other summation order) and frames exactly equal at
these fixed seeds; bf16 probabilities with u=1 within 2e-3 (bf16 rounding
at the same places, other summation order); the bf16 streams of the
whole-sequence LSTM kernels, every fusion rung's, within 1e-3 (forward) and
1e-2 (backward) relative Frobenius of their bf16 plain versions; the bf16 streams of the
two-cell kernels: f32 forward outputs within 1e-2 x max(1, max|plain|) and
1e-3 relative Frobenius, bf16 streams within one bf16 step at their largest
entry, backward outputs within 1e-2 of their largest entry (``chip_smoke.py``
phase 23's bounds). The int8 kernels: probabilities with u=1 within 1e-5 of
their plain versions (exact int32 products, the same f32 epilogue; only the
bf16 z head's summation order differs) and sampled frames equal in 99.9% of
entries (a near-tie of h * 127 can flip one code, which then persists).
"""

import math

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu_torch.models import cl_vrnn
from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _problem(dev, B, Tseed, nsteps, H, use_x_prev=True, D=12, L=3, K=3, seed=0,
             bf16=False):
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=4,
                         n_classes=K, use_x_prev=use_x_prev, bf16_compute=bf16)
    rng = np.random.default_rng(seed)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    n_xp = D if use_x_prev else 0
    raw = {
        "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": rng.normal(0, 0.1, 4 * H).astype(np.float32)},
        "decoder_h": {"kernel": glorot(n_xp + L + K, 4 * H),
                      "recurrent_kernel": glorot(H, 4 * H),
                      "bias": rng.normal(0, 0.1, 4 * H).astype(np.float32)},
        "Z_mean": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "Z_log_var": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -1.0, np.float32)},
    }
    total = Tseed + nsteps
    T = lambda a: torch.from_numpy(a).to(dev)
    arrays = (T((rng.random((B, Tseed, D)) < 0.3).astype(np.float32)), nsteps,
              T(rng.standard_normal((B, total, L)).astype(np.float32)),
              T(rng.random((B, total, D)).astype(np.float32)),
              T(np.eye(K, dtype=np.float32)[np.arange(B) % K]))
    return params_from_numpy(raw, dev), cfg, arrays


CASES = {
    "one_song": dict(B=1, Tseed=3, nsteps=20, H=40),
    "ragged_no_x_prev": dict(B=5, Tseed=4, nsteps=16, H=40, use_x_prev=False),
    "two_unit_passes": dict(B=20, Tseed=1, nsteps=12, H=300, seed=1),
    "full_tiles": dict(B=16, Tseed=6, nsteps=10, H=64, seed=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_f32(dev, case):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, **CASES[case])
    u1 = torch.ones_like(u)
    before = cg.LAUNCHES
    pk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True)
    fk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2
    pp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u1, ws,
                                         return_probs=True)
    fp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u, ws)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    torch.testing.assert_close(fk, fp, rtol=0, atol=0)


def test_kernel_matches_plain_bf16(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, B=6, Tseed=5, nsteps=16, H=64,
                                                        seed=3, bf16=True)
    u1 = torch.ones_like(u)
    pk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True)
    pp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u1, ws,
                                         return_probs=True)
    torch.testing.assert_close(pk, pp, rtol=0, atol=2e-3)
    # bf16 really ran: the f32 kernel gives other probabilities
    pf = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True, mode="f32")
    assert (pk - pf).abs().max().item() > 1e-6


def test_wrapper_raises_instead_of_falling_back(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, B=4, Tseed=2, nsteps=4, H=16)
    before = cg.LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps.cpu(), u, ws)
    with pytest.raises(ValueError, match="contiguous"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u.transpose(0, 1)
                                       .contiguous().transpose(0, 1), ws)
    with pytest.raises(ValueError, match="unknown mode"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int4")
    assert cg.LAUNCHES == before
    # int8 runs its own kernel on CUDA tensors, and samples other frames than bf16
    before8 = cg.INT8_LAUNCHES
    run = lambda mode: cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws,
                                                      return_probs=True, mode=mode)
    p8, p16 = run("int8"), run("bf16")
    torch.cuda.synchronize()
    assert (cg.INT8_LAUNCHES, cg.LAUNCHES) == (before8 + 1, before + 1)
    assert (p8 - p16).abs().max().item() > 1e-6
    f8 = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int8")
    assert set(torch.unique(f8).tolist()) <= {0.0, 1.0}


INT8_CASES = {
    "h64": dict(B=6, Tseed=5, nsteps=16, H=64, seed=3),
    # D and H not multiples of 4 (zero-padded words), a ragged song tile,
    # H not a multiple of the units a block owns
    "ragged_no_x_prev": dict(B=5, Tseed=3, nsteps=12, H=262, D=13, use_x_prev=False, seed=4),
    # the band's shape (D=88, L=2, 13 keys) at its edges and a narrow width:
    # one song, a ragged 16-song tile, the largest serving bucket, and two
    # song groups (100 songs: 112 rows, the last group ragged)
    **{f"b{B}_h{H}": dict(B=B, Tseed=3, nsteps=8, H=H, D=88, L=2, K=13, seed=5)
       for B in (1, 5, 64, 100) for H in (64, 1536, 1752)},
}


def frames_mostly_equal(fk, fp):
    """Frames binary and equal in >= 99.9% of entries: a near-tie of h * 127
    may flip one code, and the flip persists."""
    assert set(torch.unique(fk).tolist()) <= {0.0, 1.0}
    assert (fk == fp).float().mean().item() >= 0.999


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_kernel_matches_plain(dev, case):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, bf16=True, **INT8_CASES[case])
    u1 = torch.ones_like(u)
    before = (cg.INT8_LAUNCHES, cg.LAUNCHES)
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, return_probs=rp,
                              mode="int8")
    pk, fk = run(cg.generate_cl_vrnn_batch_cuda, u1, True), run(cg.generate_cl_vrnn_batch_cuda,
                                                                u, False)
    torch.cuda.synchronize()
    assert (cg.INT8_LAUNCHES, cg.LAUNCHES) == (before[0] + 2, before[1])
    again = run(cg.generate_cl_vrnn_batch_cuda, u, False)  # the same bits: no atomics
    torch.cuda.synchronize()
    assert torch.equal(again, fk)
    pp, fp = run(cg.generate_cl_vrnn_batch_plain, u1, True), run(cg.generate_cl_vrnn_batch_plain,
                                                                 u, False)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    frames_mostly_equal(fk, fp)


# ---- the two-cell training kernels (csrc/two_cell.cu, csrc/two_cell_tc.cu)
#
# Forward outputs within 1e-5 (same f32 products, other summation order);
# backward outputs within max|a - b| <= 1e-4 * max|b| + 1e-6 (the weight
# gradients sum B*T rows in another order).

from classifying_vae_lstm_tpu_torch.ops import two_cell as tc  # noqa: E402

TWO_CELL_CASES = {
    "ragged_tile": dict(B=7, T=5, H=40, L=3),
    "no_x_prev": dict(B=8, T=4, H=32, L=2, use_x_prev=False),
    "two_unit_passes": dict(B=9, T=3, H=300, L=4),
    "one_step": dict(B=6, T=1, H=24, L=2),
    # the input width 101 (D=88, K=13), H not a multiple of 8, rows past a
    # backward tile and a hand-off group
    "width_101": dict(B=70, T=3, H=20, L=9, D=88, K=13),
}


def _two_cell_inputs(dev, B, T, H, L, use_x_prev=True, D=12, K=3, seed=0):
    rng = np.random.default_rng(seed)
    in_e, in_d = D + K, (D if use_x_prev else 0) + K
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    return (f(T, B, in_e), f(T, B, in_d), f(T, B, L), f(in_e, 4 * H, scale=0.3),
            f(4 * H, scale=0.3), f(H, 4 * H, scale=0.2), f(in_d, 4 * H, scale=0.3),
            f(4 * H, scale=0.3), f(H, 4 * H, scale=0.2), f(L, 4 * H, scale=0.3),
            f(H, 2 * L, scale=0.2), f(2 * L, scale=0.2), f(B, H, scale=0.5),
            f(B, H, scale=0.5), f(B, H, scale=0.5), f(B, H, scale=0.5))


def _assert_bwd_close(got, ref, name):
    err = (got - ref).abs().max().item()
    limit = 1e-4 * ref.abs().max().item() + 1e-6
    assert err <= limit, f"{name}: max |kernel - plain| {err} > {limit}"


@pytest.mark.parametrize("case", sorted(TWO_CELL_CASES))
def test_two_cell_kernels_match_plain(dev, case):
    ins = _two_cell_inputs(dev, **TWO_CELL_CASES[case])
    before = (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES)
    outs = tc.two_cell_fwd(*ins)
    torch.cuda.synchronize()
    ref = tc.two_cell_fwd_plain(*ins)
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    for name, k, p in zip(names, outs, ref):
        torch.testing.assert_close(k, p, rtol=0, atol=1e-5, msg=name)
    (xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, *_) = ins
    hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = ref
    rng = np.random.default_rng(1)
    dhd = torch.from_numpy(rng.standard_normal(hd.shape).astype(np.float32)).to(dev)
    dza = torch.from_numpy(rng.standard_normal(zargs.shape).astype(np.float32)).to(dev)
    res = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dza,
           we, rke, wdx, rkd, kz, wz)
    got = tc.two_cell_bwd(*res)
    torch.cuda.synchronize()
    want = tc.two_cell_bwd_plain(*res)
    names = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
             "dwz", "dbe", "dbd", "dbz")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _assert_bwd_close(g, w, name)
    assert (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)


def test_two_cell_gradients_on_cuda_match_cpu_plain(dev):
    """Every gradient of the model's two-cell entry through the
    autograd.Function: kernels on the card against the plain versions on
    the CPU, from the same weights and inputs."""
    D, H, L, K, B, T = 12, 40, 3, 4, 10, 6
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                         n_classes=K, use_x_prev=True, lstm_backend="pallas")
    raw = cl_vrnn.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    arrays = {"x": (rng.random((B, T, D)) < 0.3).astype(np.float32),
              "x_prev": (rng.random((B, T, D)) < 0.3).astype(np.float32),
              "W": np.eye(K, dtype=np.float32)[np.arange(B) % K] * 0.7 + 0.075,
              "eps": rng.standard_normal((B, T, L)).astype(np.float32)}

    def grads(device):
        params = params_from_numpy({k: {n: v.numpy() for n, v in d.items()}
                                    for k, d in raw.items()}, device)
        leaves = [v.requires_grad_(True) for d in params.values() for v in d.values()]
        t = {k: torch.from_numpy(v).to(device).requires_grad_(k != "eps")
             for k, v in arrays.items()}
        hd, zm, zlv, z = tc.two_cell_sequence(params, cfg, t["x"], t["x_prev"], t["W"], t["eps"])
        loss = (hd ** 2).sum() + zm.sin().sum() + (zlv ** 2).sum() + (z * z.cos()).sum()
        loss.backward()
        return [v.grad for v in leaves if v.grad is not None] + [t[k].grad
                                                                 for k in ("x", "x_prev", "W")]

    before = (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES)
    on_card = grads(dev)
    torch.cuda.synchronize()
    assert (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    on_cpu = grads("cpu")
    assert len(on_card) == len(on_cpu) == 10 + 3  # 2 LSTMs x 3, 2 z heads x 2; x, x_prev, W
    for i, (g, w) in enumerate(zip(on_card, on_cpu)):
        _assert_bwd_close(g.cpu(), w, f"gradient {i}")


def test_two_cell_wrapper_raises_instead_of_falling_back(dev):
    ins = list(_two_cell_inputs(dev, B=4, T=2, H=16, L=2))
    before = (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="cpu"):
        tc.two_cell_fwd(*ins[:3], ins[3].cpu(), *ins[4:])
    with pytest.raises(ValueError, match="contiguous"):
        tc.two_cell_fwd(*ins[:5], ins[5].T.contiguous().T, *ins[6:])
    with pytest.raises(ValueError, match="float32"):
        tc.two_cell_fwd(ins[0].double(), *ins[1:])
    assert (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES) == before


# ---- the bf16 stream mode of the two-cell kernels
#
# Both sides round the same values at the same places and sum in f32 in
# another order, so an operand may land on the other bf16 neighbour and move
# its row's later steps: f32 forward outputs within 1e-2 x max(1, max|plain|)
# and 1e-3 relative Frobenius, the bf16 streams within one bf16 step at their
# largest entry, the backward's outputs within 1e-2 of their largest entry.

TWO_CELL_BF16_INPUTS = (0, 1, 3, 5, 6, 8, 9, 10)  # xe, xd, we, rke, wdx, rkd, kz, wz


def _two_cell_bf16_inputs(dev, **kw):
    ins = list(_two_cell_inputs(dev, **kw))
    for i in TWO_CELL_BF16_INPUTS:
        ins[i] = ins[i].bfloat16()
    return ins


def _bf16_step_at_max(t):
    """One bf16 step at the largest magnitude of ``t``."""
    m = t.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _two_cell_bf16_launches():
    return tc.BF16_FWD_LAUNCHES, tc.BF16_BWD_LAUNCHES


@pytest.mark.parametrize("case", sorted(TWO_CELL_CASES))
def test_two_cell_bf16_kernels_match_plain(dev, case):
    ins = _two_cell_bf16_inputs(dev, **TWO_CELL_CASES[case])
    before, before16 = (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES), _two_cell_bf16_launches()
    outs = tc.two_cell_fwd(*ins)
    torch.cuda.synchronize()
    ref = tc.two_cell_fwd_plain(*ins)
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    streams = {"ze", "zd", "hpe", "he", "hpd"}
    for name, k, p in zip(names, outs, ref):
        assert k.dtype == p.dtype == (torch.bfloat16 if name in streams else torch.float32), name
        err = (k.float() - p.float()).abs().max().item()
        if name in streams:
            assert err <= _bf16_step_at_max(p), f"{name}: max |kernel - plain| {err}"
        else:
            assert err <= 1e-2 * max(1.0, p.abs().max().item()), f"{name}: {err}"
            assert _rel_fro(k, p) <= 1e-3, name
    (xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, *_) = ins
    hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = ref
    rng = np.random.default_rng(1)
    dhd = torch.from_numpy(rng.standard_normal(hd.shape).astype(np.float32)).to(dev)
    dza = torch.from_numpy(rng.standard_normal(zargs.shape).astype(np.float32)).to(dev)
    res = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dza,
           we, rke, wdx, rkd, kz, wz)
    got = tc.two_cell_bwd(*res)
    torch.cuda.synchronize()
    want = tc.two_cell_bwd_plain(*res)
    gnames = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
              "dwz", "dbe", "dbd", "dbz")
    rounded = {"dxe", "dxd", "drke", "drkd", "dwe", "dwdx", "dkz", "dwz"}
    for name, g, w in zip(gnames, got, want):
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype == (torch.bfloat16 if name in rounded else torch.float32), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1e-2 * w.float().abs().max().item(), f"{name}: {err}"
    for name in ("dbe", "dbd"):  # the bias sums take the unrounded dz
        g = got[gnames.index(name)]
        assert not torch.equal(g, g.bfloat16().float()), name
    assert (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES) == before
    assert _two_cell_bf16_launches() == (before16[0] + 1, before16[1] + 2)


def test_two_cell_bf16_gradients_on_cuda_match_cpu_plain(dev):
    """Every gradient of ``two_cell_sequence(..., compute_dtype=bf16)``: the
    bf16 kernels on the card against the bf16 plain versions on the CPU,
    within 1e-2 relative Frobenius; the six weight matrices' and x's
    gradients bf16-valued, the biases' not."""
    D, H, L, K, B, T = 12, 40, 3, 4, 10, 6
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                         n_classes=K, use_x_prev=True, lstm_backend="pallas", bf16_compute=True)
    raw = cl_vrnn.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    arrays = {"x": (rng.random((B, T, D)) < 0.3).astype(np.float32),
              "x_prev": (rng.random((B, T, D)) < 0.3).astype(np.float32),
              "W": np.eye(K, dtype=np.float32)[np.arange(B) % K] * 0.7 + 0.075,
              "eps": rng.standard_normal((B, T, L)).astype(np.float32)}

    def grads(device):
        params = params_from_numpy({k: {n: v.numpy() for n, v in d.items()}
                                    for k, d in raw.items()}, device)
        named = {(k, n): v.requires_grad_(True) for k, d in params.items() for n, v in d.items()}
        t = {k: torch.from_numpy(v).to(device).requires_grad_(k != "eps")
             for k, v in arrays.items()}
        hd, zm, zlv, z = tc.two_cell_sequence(params, cfg, t["x"], t["x_prev"], t["W"], t["eps"],
                                              compute_dtype=torch.bfloat16)
        loss = (hd ** 2).sum() + zm.sin().sum() + (zlv ** 2).sum() + (z * z.cos()).sum()
        loss.backward()
        out = {k: v.grad for k, v in named.items() if v.grad is not None}
        out.update({k: t[k].grad for k in ("x", "x_prev", "W")})
        return out

    before = _two_cell_bf16_launches()
    on_card = grads(dev)
    torch.cuda.synchronize()
    assert _two_cell_bf16_launches() == (before[0] + 1, before[1] + 2)
    on_cpu = grads("cpu")
    assert len(on_card) == len(on_cpu) == 10 + 3
    for k, w in on_cpu.items():
        g = on_card[k].cpu()
        assert g.dtype == torch.float32 and _rel_fro(g, w) <= 1e-2, k
    representable = lambda g: torch.equal(g, g.bfloat16().float())
    for cell in ("encoder_h", "decoder_h"):
        assert representable(on_card[(cell, "kernel")]), cell
        assert representable(on_card[(cell, "recurrent_kernel")]), cell
        assert not representable(on_card[(cell, "bias")]), cell
    assert representable(on_card["x"]) and representable(on_card["x_prev"])


def test_two_cell_bf16_wrappers_raise_instead_of_falling_back(dev):
    """A bf16 set with one input of the other type, or on the CPU, raises
    before any launch; nothing falls back to a plain version."""
    ins = _two_cell_bf16_inputs(dev, B=4, T=2, H=16, L=2)
    before = _two_cell_bf16_launches() + (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="rke must be bfloat16"):
        tc.two_cell_fwd(*ins[:5], ins[5].float(), *ins[6:])
    with pytest.raises(ValueError, match="be must be float32"):
        tc.two_cell_fwd(*ins[:4], ins[4].bfloat16(), *ins[5:])
    with pytest.raises(ValueError, match="cpu"):
        tc.two_cell_fwd(*ins[:3], ins[3].cpu(), *ins[4:])
    outs = tc.two_cell_fwd_plain(*ins)
    hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = outs
    res = [ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, ins[2], zargs, ins[0], ins[1],
           torch.zeros_like(hd), torch.zeros_like(zargs), ins[3], ins[5], ins[6], ins[8], ins[9],
           ins[10]]
    with pytest.raises(ValueError, match="he must be bfloat16"):
        tc.two_cell_bwd(*res[:7], he.float(), *res[8:])
    assert _two_cell_bf16_launches() + (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES) == before


# ---- the whole-sequence LSTM kernels (csrc/lstm_seq.cu; the f32 full
# backward csrc/lstm_bwd_f32.cu)
#
# Forward outputs within 1e-5 (same f32 products, other summation order);
# backward outputs within max|a - b| <= 1e-4 * max|b| + 1e-6 (the weight
# gradients sum T*B rows in another order).

from classifying_vae_lstm_tpu_torch.ops import lstm as lstm_ops  # noqa: E402
from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls  # noqa: E402

LSTM_SEQ_CASES = {
    "ragged_tile": dict(B=7, T=5, H=40, IN=13),
    "one_step": dict(B=6, T=1, H=24, IN=9),
    "two_unit_passes": dict(B=9, T=3, H=300, IN=21),
    "wide_tile_ragged": dict(B=None, T=3, H=32, IN=11),  # B = 16 * SMs + 8: 16-row tiles
    "odd_hidden": dict(B=70, T=3, H=37, IN=5),  # bf16: operands staged element by element
}


def _lstm_seq_inputs(dev, B, T, H, IN, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    return (f(T, B, IN), f(IN, 4 * H, scale=0.3), f(4 * H, scale=0.3), f(H, 4 * H, scale=0.2),
            f(B, H, scale=0.5), f(B, H, scale=0.5))


def _launches():
    return ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES, ls.BWD_LAUNCHES


@pytest.mark.parametrize("case", sorted(LSTM_SEQ_CASES))
def test_lstm_seq_kernels_match_plain(dev, case):
    kw = dict(LSTM_SEQ_CASES[case])
    if kw["B"] is None:
        kw["B"] = 16 * torch.cuda.get_device_properties(dev).multi_processor_count + 8
    ins = _lstm_seq_inputs(dev, **kw)
    before = _launches()
    h, c = ls.lstm_seq_fwd(*ins)
    outs = ls.lstm_seq_train_fwd(*ins)
    torch.cuda.synchronize()
    ref = ls.lstm_seq_train_fwd_plain(*ins)
    torch.testing.assert_close(h, ref[0], rtol=0, atol=1e-5, msg="inference h")
    torch.testing.assert_close(c, ref[1], rtol=0, atol=1e-5, msg="inference c")
    for name, k, p in zip(("h", "c", "z", "h_prev", "c_prev"), outs, ref):
        torch.testing.assert_close(k, p, rtol=0, atol=1e-5, msg=name)
    x, w, _, rk, _, _ = ins
    h, c, z, hp, cp = ref
    rng = np.random.default_rng(1)
    dh = torch.from_numpy(rng.standard_normal(tuple(h.shape)).astype(np.float32)).to(dev)
    dc = torch.from_numpy(rng.standard_normal(tuple(c.shape)).astype(np.float32)).to(dev)
    res = (z, cp, c, hp, x, dh, dc, rk.T.contiguous(), w.T.contiguous())
    got = ls.lstm_seq_bwd(*res)
    torch.cuda.synchronize()
    want = ls.lstm_seq_bwd_plain(*res)
    for name, g, wv in zip(("dx", "dh0", "dc0", "drk", "dw", "db"), got, want):
        assert g.shape == wv.shape, name
        _assert_bwd_close(g, wv, name)
    assert _launches() == (before[0] + 1, before[1] + 1, before[2] + 2)


def test_lstm_seq_gradients_on_cuda_match_cpu_plain(dev):
    """Every gradient of ``lstm_sequence(backend="pallas")`` through the
    autograd.Function, with nonzero h0/c0 and a cotangent on c_T: kernels on
    the card against the plain versions on the CPU; under ``no_grad`` the
    inference kernel alone."""
    B, T, IN, H = 10, 6, 14, 40
    rng = np.random.default_rng(3)
    arrays = {"x": rng.standard_normal((B, T, IN)), "h0": 0.5 * rng.standard_normal((B, H)),
              "c0": 0.5 * rng.standard_normal((B, H)),
              "kernel": 0.3 * rng.standard_normal((IN, 4 * H)),
              "recurrent_kernel": 0.2 * rng.standard_normal((H, 4 * H)),
              "bias": 0.3 * rng.standard_normal(4 * H)}

    def grads(device):
        t = {k: torch.from_numpy(v.astype(np.float32)).to(device).requires_grad_(True)
             for k, v in arrays.items()}
        params = {k: t[k] for k in ("kernel", "recurrent_kernel", "bias")}
        h, (hT, cT) = lstm_ops.lstm_sequence(params, t["x"], t["h0"], t["c0"], backend="pallas")
        ((h ** 2).sum() + (cT * hT).sum()).backward()
        return [t[k].grad for k in sorted(t)]

    before = _launches()
    on_card = grads(dev)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1, before[2] + 2)
    for i, (g, w) in enumerate(zip(on_card, grads("cpu"))):
        _assert_bwd_close(g.cpu(), w, f"gradient {sorted(arrays)[i]}")
    x = torch.from_numpy(arrays["x"].astype(np.float32)).to(dev)
    params = {k: torch.from_numpy(arrays[k].astype(np.float32)).to(dev)
              for k in ("kernel", "recurrent_kernel", "bias")}
    with torch.no_grad():
        h, _ = lstm_ops.lstm_sequence(params, x, backend="pallas")
    assert _launches() == (before[0] + 1, before[1] + 1, before[2] + 2)
    torch.testing.assert_close(h.cpu(), lstm_ops.lstm_sequence(
        {k: v.cpu() for k, v in params.items()}, x.cpu())[0], rtol=0, atol=1e-5)


def test_lstm_seq_wrappers_raise_instead_of_falling_back(dev):
    ins = list(_lstm_seq_inputs(dev, B=4, T=2, H=16, IN=5))
    before = _launches()
    with pytest.raises(ValueError, match="cpu"):
        ls.lstm_seq_fwd(*ins[:1], ins[1].cpu(), *ins[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ls.lstm_seq_train_fwd(*ins[:3], ins[3].T.contiguous().T, *ins[4:])
    with pytest.raises(ValueError, match="float32"):
        ls.lstm_seq_fwd(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="must be"):
        ls.lstm_seq_fwd(ins[0], ins[1][:-1].contiguous(), *ins[2:])
    # the full backward keeps its state in global memory (no shared-memory
    # ceiling): a wide H is refused only for its mismatched shapes
    with pytest.raises(ValueError, match="must be"):
        ls.lstm_seq_bwd(*(torch.zeros(1, 1, 4 * 4096, device=dev),) * 9)
    assert _launches() == before


@pytest.mark.parametrize("B,T,H,IN", [(37, 3, 2400, 101), (200, 4, 256, 103), (1, 2, 8, 3)])
def test_lstm_bwd_f32_matches_plain_bitwise_repeatable(dev, B, T, H, IN):
    """The f32 full backward (``csrc/lstm_bwd_f32.cu``) at a width past the
    first design's shared-memory ceiling (H=2,400), at the training shape's
    width and at one row, on the transposed views ``LstmSeqCore`` passes:
    every output within the backward bound of its plain version, and a
    second call bitwise equal (no atomics)."""
    x, w, b, rk, h0, c0 = _lstm_seq_inputs(dev, B=B, T=T, H=H, IN=IN, seed=4)
    rk = rk * (256 / H) ** 0.5  # keep the pre-activations O(1) at every width
    h, c, z, hp, cp = ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)
    rng = np.random.default_rng(5)
    dh, dc = (torch.from_numpy(rng.standard_normal(tuple(h.shape)).astype(np.float32)).to(dev)
              for _ in range(2))
    res = (z, cp, c, hp, x, dh, dc, rk.T, w.T)
    before = _launches()
    got = ls.lstm_seq_bwd(*res)
    again = ls.lstm_seq_bwd(*res)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1], before[2] + 4)
    want = ls.lstm_seq_bwd_plain(*res)
    for name, g, a, wv in zip(("dx", "dh0", "dc0", "drk", "dw", "db"), got, again, want):
        assert g.shape == wv.shape and g.dtype == torch.float32, name
        _assert_bwd_close(g, wv, name)
        assert torch.equal(g, a), name



# the f32 forward (csrc/lstm_seq.cu lstm_fwd_kernel) at the port's shapes
# and past them: (B, T, H, IN, the plan it must take: groups of at most 8
# blocks, resident slice, rows a thread)
F32_FWD_CASES = {
    "training_shape": (200, 16, 256, 105, (True, True, 1)),
    "evaluation_shape": (12800, 16, 256, 106, (True, True, 4)),
    "ragged_hidden": (600, 3, 37, 5, (True, True, 1)),
    "four_rows_a_thread": (2000, 3, 256, 105, (True, True, 4)),
    "two_rows_a_thread": (400, 3, 256, 105, (True, True, 2)),
    "narrow_ragged_units": (1700, 4, 88, 101, (True, True, 4)),
    "streamed_slice": (300, 3, 512, 103, (True, False, 4)),
    "grid_group": (200, 3, 1024, 13, (False, False, 4)),
    "one_row": (1, 2, 8, 3, (True, True, 1)),
}


@pytest.mark.parametrize("case", sorted(F32_FWD_CASES))
def test_lstm_f32_forward_layouts_match_plain_bitwise_repeatable(dev, case):
    """Every mode of the f32 forward (inference, training, and on xz = x @ W
    + b the unfused inference and training forwards) in the layout each
    shape takes (asserted): outputs within 1e-5 of the plain versions (c and
    z within 1e-5 x max(1, max|plain|), ``chip_smoke.py``'s FWD_LIMIT), one
    launch counted a call, and a second call bitwise equal (every sum in a
    fixed order, no atomics)."""
    B, T, H, IN, layout = F32_FWD_CASES[case]
    x, w, b, rk, h0, c0 = _lstm_seq_inputs(dev, B=B, T=T, H=H, IN=IN, seed=6)
    rk = rk * (256 / H) ** 0.5  # keep the pre-activations O(1) at every width
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    p = ls.card_plan(B, IN, H, dev)
    assert (p["NB"] <= 8, p["resident"], p["rt"]) == layout, p
    assert p == ls.fwd_plan(B, IN, H, n_sm) and p["groups"] * p["NB"] <= n_sm, p
    if case in ("training_shape", "evaluation_shape"):  # a group on every 8 SMs
        assert p["groups"] == n_sm // 8, p
    xz = (x.reshape(T * B, IN) @ w + b).reshape(T, B, 4 * H)
    calls = {
        "FWD": (lambda: ls.lstm_seq_fwd(x, w, b, rk, h0, c0),
                lambda: ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)[:2]),
        "TRAIN_FWD": (lambda: ls.lstm_seq_train_fwd(x, w, b, rk, h0, c0),
                      lambda: ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)),
        "XZ_FWD": (lambda: ls.lstm_seq_xz_fwd(xz, rk, h0, c0),
                   lambda: ls.lstm_seq_xz_fwd_plain(xz, rk, h0, c0)),
        "XZ_TRAIN_FWD": (lambda: ls.lstm_seq_xz_train_fwd(xz, rk, h0, c0),
                         lambda: ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)),
    }
    for count, (kern, plain) in calls.items():
        before = getattr(ls, f"{count}_LAUNCHES")
        got, again = kern(), kern()
        torch.cuda.synchronize()
        assert getattr(ls, f"{count}_LAUNCHES") == before + 2, count
        want = plain()
        for name, g, a, r in zip(("h", "c", "z", "h_prev", "c_prev"), got, again, want):
            scale = 1.0 if name in ("h", "h_prev") else max(1.0, r.abs().max().item())
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * scale, msg=f"{count} {name}")
            assert torch.equal(g, a), f"{count} {name}: a second call differs"


# ---- the bf16 stream mode of the whole-sequence LSTM kernels
#
# Both sides round the same values at the same places and sum in f32 in
# another order, so a rounding may land on the other bf16 neighbour: forward
# h and c within 1e-2 x max(1, max|plain|) and 1e-3 relative Frobenius, the
# backward's outputs within 1e-2 relative Frobenius (``chip_smoke.py`` phase
# 20's bounds).


def _bf16_ins(ins):
    x, w, b, rk, h0, c0 = ins
    return x.bfloat16(), w, b, rk.bfloat16(), h0, c0


def _rel_fro(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _bf16_launches():
    return ls.BF16_FWD_LAUNCHES, ls.BF16_TRAIN_FWD_LAUNCHES, ls.BF16_BWD_LAUNCHES


@pytest.mark.parametrize("case", sorted(LSTM_SEQ_CASES))
def test_lstm_seq_bf16_kernels_match_plain(dev, case):
    kw = dict(LSTM_SEQ_CASES[case])
    if kw["B"] is None:
        kw["B"] = 16 * torch.cuda.get_device_properties(dev).multi_processor_count + 8
    ins = _bf16_ins(_lstm_seq_inputs(dev, **kw))
    before, before16 = _launches(), _bf16_launches()
    h, c = ls.lstm_seq_fwd(*ins)
    outs = ls.lstm_seq_train_fwd(*ins)
    torch.cuda.synchronize()
    ref = ls.lstm_seq_train_fwd_plain(*ins)
    for name, k, p in (("inference h", h, ref[0]), ("inference c", c, ref[1]),
                       *zip(("h", "c", "z", "h_prev", "c_prev"), outs, ref)):
        assert k.dtype == p.dtype, name
        scale = max(1.0, p.float().abs().max().item())
        assert (k.float() - p.float()).abs().max().item() <= 1e-2 * scale, name
        assert _rel_fro(k, p) <= 1e-3, name
    assert [o.dtype for o in outs] == [torch.float32] * 2 + [torch.bfloat16] * 2 + [torch.float32]
    x, w, _, rk, _, _ = ins
    h, c, z, hp, cp = ref
    rng = np.random.default_rng(1)
    dh = torch.from_numpy(rng.standard_normal(tuple(h.shape)).astype(np.float32)).to(dev)
    dc = torch.from_numpy(rng.standard_normal(tuple(c.shape)).astype(np.float32)).to(dev)
    res = (z, cp, c, hp, x, dh, dc, rk.T.contiguous(), w.T.contiguous())
    got = ls.lstm_seq_bwd(*res)
    torch.cuda.synchronize()
    want = ls.lstm_seq_bwd_plain(*res)
    for name, g, wv in zip(("dx", "dh0", "dc0", "drk", "dw", "db"), got, want):
        assert g.shape == wv.shape and g.dtype == wv.dtype, name
        assert _rel_fro(g, wv) <= 1e-2, name
    dw = got[4]
    assert got[3].dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert not torch.equal(dw, dw.bfloat16().float())  # dW is not rounded
    assert _launches() == before
    assert _bf16_launches() == (before16[0] + 1, before16[1] + 1, before16[2] + 2)
    with pytest.raises(ValueError, match="rk must be bfloat16"):
        ls.lstm_seq_fwd(*ins[:3], ins[3].float(), *ins[4:])
    with pytest.raises(ValueError, match="h_prev must be bfloat16"):
        ls.lstm_seq_bwd(z, cp, c, hp.float(), *res[4:])


def test_lstm_seq_bf16_gradients_on_cuda_match_cpu_plain(dev):
    """Every gradient of ``lstm_sequence(backend="pallas",
    compute_dtype=torch.bfloat16)``: the bf16 kernels on the card against the
    bf16 plain versions on the CPU, within 1e-2 relative Frobenius; the
    recurrent kernel's and x's gradients are bf16-valued, the kernel's is
    not."""
    B, T, IN, H = 10, 6, 14, 40
    rng = np.random.default_rng(3)
    arrays = {"x": rng.standard_normal((B, T, IN)), "h0": 0.5 * rng.standard_normal((B, H)),
              "c0": 0.5 * rng.standard_normal((B, H)),
              "kernel": 0.3 * rng.standard_normal((IN, 4 * H)),
              "recurrent_kernel": 0.2 * rng.standard_normal((H, 4 * H)),
              "bias": 0.3 * rng.standard_normal(4 * H)}

    def grads(device):
        t = {k: torch.from_numpy(v.astype(np.float32)).to(device).requires_grad_(True)
             for k, v in arrays.items()}
        params = {k: t[k] for k in ("kernel", "recurrent_kernel", "bias")}
        h, (hT, cT) = lstm_ops.lstm_sequence(params, t["x"], t["h0"], t["c0"], backend="pallas",
                                             compute_dtype=torch.bfloat16)
        ((h ** 2).sum() + (cT * hT).sum()).backward()
        return {k: t[k].grad for k in t}

    before = _bf16_launches()
    on_card = grads(dev)
    torch.cuda.synchronize()
    assert _bf16_launches() == (before[0], before[1] + 1, before[2] + 2)
    for k, w in grads("cpu").items():
        g = on_card[k].cpu()
        assert g.dtype == torch.float32 and _rel_fro(g, w) <= 1e-2, k
    representable = lambda g: torch.equal(g, g.bfloat16().float())
    assert representable(on_card["recurrent_kernel"]) and representable(on_card["x"])
    assert not representable(on_card["kernel"])


# ---- the other fusion rungs' kernels (csrc/lstm_seq.cu): the unfused
# forwards (xz in place of x and W), the dz-only walk and the drk walk
#
# f32 as the default rung's kernels; bf16: forward outputs within 1e-2 x
# max(1, max|plain|) and 1e-3 relative Frobenius, the walks' outputs within
# 1e-2 relative Frobenius (a dz on the other bf16 neighbour moves its row's
# earlier steps).

RUNG_COUNTS = ("XZ_FWD", "XZ_TRAIN_FWD", "WALK", "DRK")


def _rung_launches(bf16):
    return tuple(getattr(ls, f"{'BF16_' if bf16 else ''}{n}_LAUNCHES") for n in RUNG_COUNTS)


def _xz_inputs(dev, bf16, B, T, H, IN, seed=0):
    x, w, b, rk, h0, c0 = _lstm_seq_inputs(dev, B=B, T=T, H=H, IN=IN, seed=seed)
    xz = (x.reshape(T * B, IN) @ w + b).reshape(T, B, 4 * H)
    sd = torch.bfloat16 if bf16 else torch.float32
    return xz.to(sd), rk.to(sd), h0, c0


def _close(got, want, name, bf16, backward):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if not bf16:
        if backward:
            _assert_bwd_close(got, want, name)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=name)
    elif backward:
        assert _rel_fro(got, want) <= 1e-2, name
    else:
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale, name
        assert _rel_fro(got, want) <= 1e-3, name


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(LSTM_SEQ_CASES))
def test_lstm_seq_rung_kernels_match_plain(dev, case, bf16):
    kw = dict(LSTM_SEQ_CASES[case])
    if kw["B"] is None:
        kw["B"] = 16 * torch.cuda.get_device_properties(dev).multi_processor_count + 8
    xz, rk, h0, c0 = _xz_inputs(dev, bf16, **kw)
    before, default = _rung_launches(bf16), (_launches(), _bf16_launches())
    h, c = ls.lstm_seq_xz_fwd(xz, rk, h0, c0)
    outs = ls.lstm_seq_xz_train_fwd(xz, rk, h0, c0)
    torch.cuda.synchronize()
    ref = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    for name, k, p in (("inference h", h, ref[0]), ("inference c", c, ref[1]),
                       *zip(("h", "c", "z"), outs, ref)):
        _close(k, p, name, bf16, backward=False)
    assert outs[2].dtype == xz.dtype
    h, c, z = ref
    rng = np.random.default_rng(1)
    dh = torch.from_numpy(rng.standard_normal(tuple(h.shape)).astype(np.float32)).to(dev)
    dc = torch.from_numpy(rng.standard_normal(tuple(c.shape)).astype(np.float32)).to(dev)
    cp = torch.cat([c0[None], c[:-1]])
    hp = torch.cat([h0[None], h[:-1]]).to(z.dtype)
    rk_t = rk.T.contiguous()
    walk = ls.lstm_seq_walk(z, cp, c, dh, dc, rk_t)
    drk = ls.lstm_seq_walk_drk(z, cp, c, hp, dh, dc, rk_t)
    torch.cuda.synchronize()
    want = ls.lstm_seq_walk_drk_plain(z, cp, c, hp, dh, dc, rk_t)
    for label, got in (("walk", walk), ("drk walk", drk)):
        for name, g, wv in zip(("dz", "dh0", "dc0", "drk"), got, want):
            _close(g, wv, f"{label} {name}", bf16, backward=True)
    assert walk[0].dtype == z.dtype and drk[3].dtype == torch.float32
    assert _rung_launches(bf16) == tuple(n + d for n, d in zip(before, (1, 1, 1, 2)))
    assert (_launches(), _bf16_launches()) == default


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_lstm_seq_walk_at_hidden_2560(dev, bf16):
    """The widest H the JAX package's ``auto`` pins to the proj-only rung
    (7 rows: a ragged row tile): in f32 the full backward's walk of
    ``csrc/lstm_bwd_f32.cu``, in bf16 the tensor-core walk of
    ``csrc/lstm_seq_tc.cu``; neither has a shared-memory ceiling."""
    B, T, H = 7, 2, 2560
    xz, rk, h0, c0 = _xz_inputs(dev, bf16, B=B, T=T, H=H, IN=9)
    h, c, z = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    rng = np.random.default_rng(2)
    dh = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(dev)
    cp, rk_t = torch.cat([c0[None], c[:-1]]), rk.T.contiguous()
    walk = lambda: ls.lstm_seq_walk(z, cp, c, dh, torch.zeros_like(dh), rk_t)
    if bf16:
        out = []
        assert _tc_entries(lambda: out.append(walk())) == ["walk"]
        got = out[0]
    else:
        got = walk()
    torch.cuda.synchronize()
    want = ls.lstm_seq_walk_plain(z, cp, c, dh, torch.zeros_like(dh), rk_t)
    for name, g, wv in zip(("dz", "dh0", "dc0"), got, want):
        _close(g, wv, name, bf16, backward=True)


def test_lstm_seq_f32_walks_at_hidden_4900(dev):
    """Past the old 2-row walk's shared-memory ceiling (H ~ 4,800): the f32
    dz-only and drk walks keep their state in global memory and match their
    plain versions (a ragged row tile and H not a multiple of the 32-unit
    tiles); two calls give the same bits."""
    B, T, H = 3, 2, 4900
    xz, rk, h0, c0 = _xz_inputs(dev, False, B=B, T=T, H=H, IN=5)
    h, c, z = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    rng = np.random.default_rng(7)
    dh = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(dev)
    cp, hp = torch.cat([c0[None], c[:-1]]), torch.cat([h0[None], h[:-1]])
    res = (z, cp, c, hp, dh, torch.zeros_like(dh), rk.T)
    walk, drk = ls.lstm_seq_walk(*res[:3], *res[4:]), ls.lstm_seq_walk_drk(*res)
    again = ls.lstm_seq_walk_drk(*res)
    torch.cuda.synchronize()
    want = ls.lstm_seq_walk_drk_plain(*res)
    for label, got in (("walk", walk), ("drk walk", drk)):
        for name, g, wv in zip(("dz", "dh0", "dc0", "drk"), got, want):
            _close(g, wv, f"{label} {name}", False, backward=True)
    assert all(torch.equal(a, b) for a, b in zip(drk, again))


RUNGS = [(True, True, False), (True, False, False), (False, True, False), (False, False, False)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("fusion", RUNGS, ids=lambda f: "".join("TF"[not v] for v in f))
def test_lstm_seq_rung_gradients_on_cuda_match_cpu_plain(dev, fusion, bf16):
    """Every gradient of ``lstm_sequence(backend="pallas", fusion=...)``:
    the rung's kernels on the card against its plain versions on the CPU
    (f32 within the backward bound, bf16 within 1e-2 relative Frobenius);
    the launches are the rung's own, and nothing of the default rung's."""
    B, T, IN, H = 10, 6, 14, 40
    rng = np.random.default_rng(5)
    arrays = {"x": rng.standard_normal((B, T, IN)), "h0": 0.5 * rng.standard_normal((B, H)),
              "c0": 0.5 * rng.standard_normal((B, H)),
              "kernel": 0.3 * rng.standard_normal((IN, 4 * H)),
              "recurrent_kernel": 0.2 * rng.standard_normal((H, 4 * H)),
              "bias": 0.3 * rng.standard_normal(4 * H)}
    cd = torch.bfloat16 if bf16 else None

    def grads(device):
        t = {k: torch.from_numpy(v.astype(np.float32)).to(device).requires_grad_(True)
             for k, v in arrays.items()}
        params = {k: t[k] for k in ("kernel", "recurrent_kernel", "bias")}
        h, (hT, cT) = lstm_ops.lstm_sequence(params, t["x"], t["h0"], t["c0"], backend="pallas",
                                             compute_dtype=cd, fusion=fusion)
        ((h ** 2).sum() + (cT * hT).sum()).backward()
        return {k: t[k].grad for k in t}

    before, default = _rung_launches(bf16), (_launches(), _bf16_launches())
    on_card = grads(dev)
    torch.cuda.synchronize()
    proj, drk, _ = fusion
    expected = (0, 0 if proj else 1, 0 if drk else 1, 2 if drk else 0)
    assert _rung_launches(bf16) == tuple(n + d for n, d in zip(before, expected))
    train_fwd = 1 if proj else 0  # the proj rungs' training forward is the default rung's
    assert _launches() == (default[0][0], default[0][1] + (0 if bf16 else train_fwd),
                           default[0][2])
    assert _bf16_launches() == (default[1][0], default[1][1] + (train_fwd if bf16 else 0),
                                default[1][2])
    for k, w in grads("cpu").items():
        g = on_card[k].cpu()
        if bf16:
            assert g.dtype == torch.float32 and _rel_fro(g, w) <= 1e-2, k
        else:
            _assert_bwd_close(g, w, f"gradient {k}")
    if bf16:
        representable = lambda g: torch.equal(g, g.bfloat16().float())
        assert representable(on_card["recurrent_kernel"]) and representable(on_card["x"])
        assert representable(on_card["kernel"]) == (not proj)
        assert not representable(on_card["bias"])


def test_lstm_seq_rung_wrappers_raise_instead_of_falling_back(dev):
    xz, rk, h0, c0 = _xz_inputs(dev, False, B=4, T=2, H=16, IN=5)
    before = [_rung_launches(b) for b in (False, True)]
    with pytest.raises(ValueError, match="cpu"):
        ls.lstm_seq_xz_fwd(xz, rk.cpu(), h0, c0)
    with pytest.raises(ValueError, match="rk must be bfloat16"):
        ls.lstm_seq_xz_train_fwd(xz.bfloat16(), rk, h0, c0)
    with pytest.raises(ValueError, match="must be"):
        ls.lstm_seq_xz_fwd(xz, rk[:-1].contiguous(), h0, c0)
    h, c, z = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    cp, hp, rk_t = torch.cat([c0[None], c[:-1]]), torch.cat([h0[None], h[:-1]]), rk.T.contiguous()
    with pytest.raises(ValueError, match="h_prev must be bfloat16"):
        ls.lstm_seq_walk_drk(z.bfloat16(), cp, c, hp, h, c, rk_t.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        ls.lstm_seq_walk(z, cp, c, h, c, rk_t[:-1])
    assert [_rung_launches(b) for b in (False, True)] == before
    # the transposed view of Rk is taken (the f32 walk reads Rk as stored, no
    # copy), with the bits of a contiguous Rkᵀ
    view, copy = ls.lstm_seq_walk(z, cp, c, h, c, rk.T), ls.lstm_seq_walk(z, cp, c, h, c, rk_t)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(view, copy))
    assert _rung_launches(False)[2] == before[0][2] + 2


# ---- the bf16 route of the whole-sequence LSTM (csrc/lstm_seq_tc.cu)
#
# bf16 CUDA tensors reach the tensor-core entry points (the f32 library is
# not loaded for them), each wrapper call adding one to its count (two for
# the full backward and the drk walk, as before), whatever the device
# launches inside (T+1 for a forward, 2T+2 for the full backward).


def _tc_entries(fn):
    """The ``cvl_lstm_tc_*`` entry points ``fn()`` calls, in order; the f32
    library (``csrc/lstm_seq.cu``) must not be called."""
    import unittest.mock

    calls = []
    real = ls._tc_kernels()

    class Spy:
        def __getattr__(self, name):
            fn = getattr(real, name)

            def call(*a):
                calls.append(name.removeprefix("cvl_lstm_tc_"))
                return fn(*a)

            return call

    def f32_library():
        raise AssertionError("the f32 library was called for bf16 tensors")

    with unittest.mock.patch.object(ls, "_tc_kernels", Spy), \
            unittest.mock.patch.object(ls, "_kernels", f32_library):
        fn()
    return calls


BF16_COUNTS = ("FWD", "TRAIN_FWD", "BWD", "XZ_FWD", "XZ_TRAIN_FWD", "WALK", "DRK")


def _bf16_counts():
    return {n: getattr(ls, f"BF16_{n}_LAUNCHES") for n in BF16_COUNTS}


@pytest.mark.parametrize("case", sorted(LSTM_SEQ_CASES))
def test_lstm_seq_bf16_wrappers_reach_the_tensor_core_entry_points(dev, case):
    kw = dict(LSTM_SEQ_CASES[case])
    if kw["B"] is None:
        kw["B"] = 16 * torch.cuda.get_device_properties(dev).multi_processor_count + 8
    x, w, b, rk, h0, c0 = _bf16_ins(_lstm_seq_inputs(dev, **kw))
    h, c, z, hp, cp = ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)
    xz = (x.float() @ w.bfloat16().float() + b).bfloat16()
    dh, dc, rk_t = torch.ones_like(h), torch.zeros_like(c), rk.T.contiguous()
    cases = {
        "FWD": (lambda: ls.lstm_seq_fwd(x, w, b, rk, h0, c0), ["proj", "steps"], 1),
        "TRAIN_FWD": (lambda: ls.lstm_seq_train_fwd(x, w, b, rk, h0, c0), ["proj", "steps"], 1),
        "BWD": (lambda: ls.lstm_seq_bwd(z, cp, c, hp, x, dh, dc, rk_t, w.T.contiguous()),
                ["walk", "drk", "dw_db"], 2),
        "XZ_FWD": (lambda: ls.lstm_seq_xz_fwd(xz, rk, h0, c0), ["steps"], 1),
        "XZ_TRAIN_FWD": (lambda: ls.lstm_seq_xz_train_fwd(xz, rk, h0, c0), ["steps"], 1),
        "WALK": (lambda: ls.lstm_seq_walk(z, cp, c, dh, dc, rk_t), ["walk"], 1),
        "DRK": (lambda: ls.lstm_seq_walk_drk(z, cp, c, hp, dh, dc, rk_t), ["walk", "drk"], 2),
    }
    for name, (fn, entries, n) in cases.items():
        before = _bf16_counts()
        assert _tc_entries(fn) == entries, name
        torch.cuda.synchronize()
        after = _bf16_counts()
        assert after == {**before, name: before[name] + n}, name


def test_lstm_seq_bf16_route_has_no_width_ceiling(dev):
    """H=4,900, past the f32 walk's shared-memory ceiling (4,800), in bf16:
    the walk and the forward run and match their plain versions."""
    B, T, H = 3, 2, 4900
    xz, rk, h0, c0 = _xz_inputs(dev, True, B=B, T=T, H=H, IN=9)
    h, c, z = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    for name, k, p in zip(("h", "c", "z"), ls.lstm_seq_xz_train_fwd(xz, rk, h0, c0), (h, c, z)):
        _close(k, p, name, True, backward=False)
    dh = torch.ones_like(h)
    cp, rk_t = torch.cat([c0[None], c[:-1]]), rk.T.contiguous()
    got = ls.lstm_seq_walk(z, cp, c, dh, torch.zeros_like(dh), rk_t)
    want = ls.lstm_seq_walk_plain(z, cp, c, dh, torch.zeros_like(dh), rk_t)
    for name, g, wv in zip(("dz", "dh0", "dc0"), got, want):
        _close(g, wv, name, True, backward=True)


# ---- the whole-generation cl_vae kernel (csrc/generate_cl_vae.cu)
#
# f32 probabilities within 1e-5 and frames equal (same f32 products, other
# summation order; these fixed seeds have no near-tie); bf16 probabilities
# within 2e-3 of the plain bf16 version (bf16 rounding at the same places).

from classifying_vae_lstm_tpu_torch.models import cl_vae  # noqa: E402
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv  # noqa: E402


def _vae_problem(dev, B, nsteps, H, use_x_prev=True, D=12, L=3, K=3, seed=0, bf16=False):
    cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                        intermediate_class_dim=H or 8, n_classes=K, use_x_prev=use_x_prev,
                        bf16_compute=bf16)
    params = cl_vae.init(torch.Generator().manual_seed(seed), cfg)
    params["x_decoded_mean"]["bias"] -= 1.0  # sparse frames, as the trained models give
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(a).to(dev)
    arrays = (T((rng.random((B, D)) < 0.3).astype(np.float32)), nsteps,
              T(rng.standard_normal((B, nsteps, L)).astype(np.float32)),
              T(rng.random((B, nsteps, D)).astype(np.float32)),
              T(np.eye(K, dtype=np.float32)[np.arange(B) % K]))
    return params_from_numpy(params, dev), cfg, arrays


VAE_CASES = {  # the cluster kernel (generate_cluster_kernel)
    "one_song": dict(B=1, nsteps=20, H=40),
    "ragged_no_x_prev": dict(B=5, nsteps=16, H=40, use_x_prev=False),
    "two_column_passes": dict(B=6, nsteps=12, H=200, seed=1),  # H > the block's groups
    "vanilla_k1": dict(B=4, nsteps=10, H=24, K=1, use_x_prev=False, seed=2),
    # the jsball_vae width (the register path), and clusters of 2, 4 and 8
    # blocks (f32 at D=88: 282 KB of weights at H=256)
    "c1_d88_h88": dict(B=5, nsteps=12, H=88, D=88, L=4, K=13, seed=30),
    "c2_h256": dict(B=5, nsteps=12, H=256, D=88, L=4, K=13, seed=31),
    "c4_h512": dict(B=3, nsteps=8, H=512, D=88, L=4, K=13, seed=32),
    "c8_h1024": dict(B=3, nsteps=8, H=1024, D=88, L=4, K=13, seed=33),
    # without hidden layers (the z heads and the frame head over x_prev)
    "no_hidden": dict(B=5, nsteps=12, H=0, D=88, L=4, K=13, seed=34),
    "no_hidden_no_x_prev": dict(B=3, nsteps=10, H=0, use_x_prev=False, seed=35),
    "no_hidden_c2": dict(B=3, nsteps=8, H=0, D=300, L=4, K=13, seed=36),
    # more clusters of two blocks than one wave of the card holds
    "b300_waves": dict(B=300, nsteps=6, H=256, D=88, L=4, K=13, seed=37),
}
# blocks a cluster the plan takes (1 where not named)
VAE_BLOCKS = {"c2_h256": 2, "c4_h512": 4, "c8_h1024": 8, "no_hidden_c2": 2, "b300_waves": 2}


@pytest.mark.parametrize("case", sorted(VAE_CASES))
@pytest.mark.parametrize("zp", [False, True])
def test_vae_kernel_matches_plain_f32(dev, case, zp):
    """The cluster kernel: probabilities with u = 1 within 1e-5 of the plain
    version, frames equal, a second call bitwise equal, each call one launch
    of it."""
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, **VAE_CASES[case])
    assert cgv.kernel_for(cfg) == "generate_cl_vae_cluster"
    plan = cgv.launch_plan(cfg, seeds.shape[0], "f32", dev)
    assert plan["C"] == VAE_BLOCKS.get(case, 1), plan
    assert (plan["waves"] > 1) == (case == "b300_waves"), plan
    u1 = torch.ones_like(u)
    before = (cgv.LAUNCHES, cgv.CLUSTER_LAUNCHES)
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp,
                              return_probs=rp)
    pk, fk = run(cgv.generate_cl_vae_batch_cuda, u1, True), run(cgv.generate_cl_vae_batch_cuda,
                                                                 u, False)
    torch.cuda.synchronize()
    assert (cgv.LAUNCHES, cgv.CLUSTER_LAUNCHES) == (before[0] + 2, before[1] + 2)
    pp, fp = run(cgv.generate_cl_vae_batch_plain, u1, True), run(cgv.generate_cl_vae_batch_plain,
                                                                  u, False)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    torch.testing.assert_close(fk, fp, rtol=0, atol=0)
    assert torch.equal(pk, run(cgv.generate_cl_vae_batch_cuda, u1, True))


def test_vae_kernel_serving_buckets(dev):
    """The serving buckets (1, 4, 16, 64 songs x 32 ... 256 steps) at the
    jsball_vae width: within 1e-5 of the plain version, bitwise repeatable."""
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, B=64, nsteps=256, H=88, D=88,
                                                            L=4, K=13, seed=45)
    u1 = torch.ones_like(u)
    for b in (1, 4, 16, 64):
        for t in (32, 64, 128, 256):
            args = (seeds[:b].contiguous(), t, eps[:b, :t].contiguous(),
                    u1[:b, :t].contiguous(), ws[:b].contiguous())
            pk = cgv.generate_cl_vae_batch_cuda(params, cfg, *args, return_probs=True)
            pp = cgv.generate_cl_vae_batch_plain(params, cfg, *args, return_probs=True)
            torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5, msg=f"{b} x {t}")
            assert torch.equal(pk, cgv.generate_cl_vae_batch_cuda(params, cfg, *args,
                                                                  return_probs=True))


@pytest.mark.parametrize("H", [88, 512])
def test_vae_kernel_matches_plain_bf16(dev, H):
    """bf16 on the cluster kernel (one block at H=88, two at H=512):
    probabilities within 2e-3 of the plain bf16 version, bitwise
    repeatable."""
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, B=7, nsteps=16, H=H, D=88,
                                                            L=4, K=13, seed=3, bf16=True)
    assert cgv.kernel_for(cfg) == "generate_cl_vae_cluster"
    assert cgv.cluster_plan(cfg, 7)["C"] == (1 if H == 88 else 2)
    run = lambda f, **k: f(params, cfg, seeds, nsteps, eps, u, ws, return_probs=True, **k)
    pk, pp = run(cgv.generate_cl_vae_batch_cuda), run(cgv.generate_cl_vae_batch_plain)
    torch.testing.assert_close(pk, pp, rtol=0, atol=2e-3)
    assert torch.equal(pk, run(cgv.generate_cl_vae_batch_cuda))
    pf = run(cgv.generate_cl_vae_batch_cuda, mode="f32")
    assert (pk - pf).abs().max().item() > 1e-6  # bf16 really ran


VAE_INT8_CASES = {
    "h64": dict(B=7, nsteps=16, H=64, seed=3),
    "one_song": dict(B=1, nsteps=12, H=96, D=20, seed=8),
    # D and H not multiples of 4, a ragged song tile, no x_prev
    "ragged_no_x_prev": dict(B=5, nsteps=12, H=262, D=13, use_x_prev=False, seed=4),
    # more units a block than one product pass takes (two passes of n8
    # tiles)
    "many_units_a_block": dict(B=3, nsteps=4, H=13000, D=12, seed=5),
    # two song groups of the frame head (B > 16), more pitch tiles than
    # blocks (D=72, H=64: 8 blocks), the x_prev slices
    "song_groups": dict(B=40, nsteps=8, H=64, D=72, seed=6),
    # more songs than one launch takes: two launches a call, counted as one
    "two_launches": dict(B=70, nsteps=6, H=96, D=20, seed=7),
    # the JAX package's int8 band (D=1,024, L=16) with x_prev, past what
    # shared memory holds: the head's tiles streamed through the ring, in
    # one song group and in two
    "streamed_head": dict(B=1, nsteps=8, H=6144, D=1024, L=16, seed=9),
    "streamed_head_song_groups": dict(B=20, nsteps=8, H=5120, D=1024, L=16, seed=10),
    # the x rows of both cells streamed as well
    "streamed_all": dict(B=3, nsteps=8, H=7808, D=1024, L=16, seed=11),
    "streamed_all_song_groups": dict(B=20, nsteps=6, H=7808, D=1024, L=16, seed=12),
    # streamed, with more units a block than one product pass takes
    "streamed_many_units": dict(B=3, nsteps=4, H=13000, D=1024, seed=13),
}
# the residency (x-row slices, head tiles) each case must take on an H100
VAE_INT8_LAYOUTS = {"streamed_head": (True, False), "streamed_head_song_groups": (True, False),
                    "streamed_all": (False, False), "streamed_all_song_groups": (False, False),
                    "streamed_many_units": (False, False)}


@pytest.mark.parametrize("case", sorted(VAE_INT8_CASES))
@pytest.mark.parametrize("zp", [False, True])
def test_vae_int8_kernel_matches_plain(dev, case, zp):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, bf16=True,
                                                            **VAE_INT8_CASES[case])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cgv.coop_plan(cfg, min(seeds.shape[0], 64), n_sm)
    if case in ("many_units_a_block", "streamed_many_units"):
        assert plan["nu"] > 8 * cgv._COOP_MAX_NT
    if case in ("song_groups", "streamed_head_song_groups", "streamed_all_song_groups"):
        assert plan["hs"] == 2 and plan["P"] > 1
    assert plan["res"] == VAE_INT8_LAYOUTS.get(case, (True, True)), plan
    u1 = torch.ones_like(u)
    before = (cgv.INT8_LAUNCHES, cgv.LAUNCHES)
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp,
                              return_probs=rp, mode="int8")
    pk, fk = run(cgv.generate_cl_vae_batch_cuda, u1, True), run(cgv.generate_cl_vae_batch_cuda,
                                                                 u, False)
    torch.cuda.synchronize()
    assert (cgv.INT8_LAUNCHES, cgv.LAUNCHES) == (before[0] + 2, before[1])
    pp, fp = run(cgv.generate_cl_vae_batch_plain, u1, True), run(cgv.generate_cl_vae_batch_plain,
                                                                  u, False)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    frames_mostly_equal(fk, fp)
    # every sum in a fixed order or exact: a second call gives the same bits
    assert torch.equal(fk, run(cgv.generate_cl_vae_batch_cuda, u, False))


# the cooperative kernel in f32 and bf16 (generate_vae_coop_kernel): each
# layout (the residency of the x-row slices and of the head's tiles, asserted
# on an H100's grid), one and two song groups (B > 16), several launches
# (B > 64), more units a block than one product pass takes
VAE_COOP_CASES = {
    "f32_h512": dict(B=5, nsteps=12, H=512, D=88, L=4, K=13, seed=20),
    "f32_two_launches": dict(B=70, nsteps=6, H=512, D=88, L=4, K=13, seed=21),
    "bf16_h512_song_groups": dict(B=40, nsteps=8, H=512, D=88, L=4, K=13, seed=22, bf16=True),
    "bf16_seq_concat": dict(B=3, nsteps=8, H=1024, D=1024, L=16, K=13, use_x_prev=False,
                            seed=23, bf16=True),
    "bf16_h5120_streamed_head": dict(B=20, nsteps=6, H=5120, D=1024, L=16, K=13,
                                     use_x_prev=False, seed=24, bf16=True),
    "bf16_h5120_streamed_all": dict(B=20, nsteps=6, H=5120, D=1024, L=16, K=13, seed=25,
                                    bf16=True),
    "f32_h5120_streamed_all": dict(B=3, nsteps=4, H=5120, D=1024, L=16, K=13, seed=26),
    "bf16_many_units": dict(B=3, nsteps=4, H=13000, D=12, seed=27, bf16=True),
}
VAE_COOP_LAYOUTS = {"bf16_h5120_streamed_head": (True, False), "bf16_many_units": (True, False),
                    "bf16_h5120_streamed_all": (False, False),
                    "f32_h5120_streamed_all": (False, False)}


@pytest.mark.parametrize("case", sorted(VAE_COOP_CASES))
@pytest.mark.parametrize("zp", [False, True])
def test_vae_coop_kernel_matches_plain(dev, case, zp, monkeypatch):
    """Probabilities with u = 1 within 1e-5 of the plain version in f32 and
    within max 2e-2 / mean 2e-3 in bf16 (``chip_smoke.py`` phase 17's
    bounds), frames equal in >= 99.9% of entries (the z heads sum in another
    order: a near-tie may flip a frame, which then persists), a second call
    bitwise equal, and the launches counted as the cooperative kernel's.
    The cases the cluster kernel would take (H=512 at D=88) are sent to the
    cooperative kernel by a cluster kernel that holds nothing (``fits``)."""
    monkeypatch.setattr(cgv, "fits", lambda cfg, mode=None: False)
    kw = VAE_COOP_CASES[case]
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, **kw)
    mode = "bf16" if kw.get("bf16") else "f32"
    assert cgv.pick_mode(cfg) == mode and cgv.kernel_for(cfg) == "generate_cl_vae_coop"
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cgv.coop_plan(cfg, min(seeds.shape[0], 64), n_sm, mode)
    assert plan["res"] == VAE_COOP_LAYOUTS.get(case, (True, True)), plan
    assert (plan["hs"] == 2) == (seeds.shape[0] > 16)
    if case == "bf16_many_units":
        assert plan["nu"] > 8 * cgv._COOP_MAX_NT
    u1 = torch.ones_like(u)
    before = (cgv.COOP_LAUNCHES, cgv.LAUNCHES, cgv.CLUSTER_LAUNCHES)
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp,
                              return_probs=rp)
    pk, fk = run(cgv.generate_cl_vae_batch_cuda, u1, True), run(cgv.generate_cl_vae_batch_cuda,
                                                                 u, False)
    torch.cuda.synchronize()
    assert (cgv.COOP_LAUNCHES, cgv.LAUNCHES, cgv.CLUSTER_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2])
    pp, fp = run(cgv.generate_cl_vae_batch_plain, u1, True), run(cgv.generate_cl_vae_batch_plain,
                                                                  u, False)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    d = (pk - pp).abs()
    if mode == "f32":
        assert d.max().item() <= 1e-5, d.max().item()
    else:
        assert d.max().item() <= 2e-2 and d.mean().item() <= 2e-3, (d.max(), d.mean())
    assert 0 < fk.mean().item() < 1
    frames_mostly_equal(fk, fp)
    assert torch.equal(fk, run(cgv.generate_cl_vae_batch_cuda, u, False))


@pytest.mark.parametrize("use_x_prev", [False, True])
def test_vae_wide_kernel_matches_plain_bf16(dev, use_x_prev):
    """bf16 with hidden layers past the cooperative kernel's latent width
    (D=1,024, H=5,120, L=106): the wide kernel's bf16 mode, probabilities
    with u = 1 within max 2e-2 / mean 2e-3 of the plain version, frames
    equal in >= 99.9% of entries, each call counted as the wide kernel's."""
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(
        dev, B=5, nsteps=8, H=5120, D=1024, L=106, K=13, seed=12, use_x_prev=use_x_prev,
        bf16=True)
    assert cgv.pick_mode(cfg) == "bf16" and cgv.kernel_for(cfg) == "generate_cl_vae_wide"
    before = (cgv.LAUNCHES, cgv.WIDE_LAUNCHES)
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, return_probs=rp)
    u1 = torch.ones_like(u)
    pk, fk = run(cgv.generate_cl_vae_batch_cuda, u1, True), run(cgv.generate_cl_vae_batch_cuda,
                                                                 u, False)
    torch.cuda.synchronize()
    assert (cgv.LAUNCHES, cgv.WIDE_LAUNCHES) == (before[0] + 2, before[1] + 2)
    d = (pk - run(cgv.generate_cl_vae_batch_plain, u1, True)).abs()
    assert d.max().item() <= 2e-2 and d.mean().item() <= 2e-3, (d.max(), d.mean())
    frames_mostly_equal(fk, run(cgv.generate_cl_vae_batch_plain, u, False))
    # bf16 really ran: the f32 weights give other probabilities
    pf = cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True, mode="f32")
    assert (pk - pf).abs().max().item() > 1e-6


def test_vae_wrapper_raises_instead_of_falling_back(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, B=4, nsteps=4, H=16)
    before = cgv.LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps.cpu(), u, ws)
    with pytest.raises(ValueError, match="contiguous"):
        cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps,
                                       u.transpose(0, 1).contiguous().transpose(0, 1), ws)
    with pytest.raises(ValueError, match="unknown mode"):
        cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int4")
    # int8 runs its own kernel on CUDA tensors, and samples other frames than bf16
    before8 = cgv.INT8_LAUNCHES
    run = lambda mode: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws,
                                                      return_probs=True, mode=mode)
    p8, p16 = run("int8"), run("bf16")
    torch.cuda.synchronize()
    assert (cgv.INT8_LAUNCHES, cgv.LAUNCHES) == (before8 + 1, before + 1)
    assert (p8 - p16).abs().max().item() > 1e-6
    f8 = cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int8")
    assert set(torch.unique(f8).tolist()) <= {0.0, 1.0}
    before += 1
    # after a call that packed the parameters for the card, copies of them on
    # the CPU with the seeds on the card raise (the packed slabs are kept per
    # device)
    cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws)
    before += 1
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    with pytest.raises(ValueError, match="cpu"):
        cgv.generate_cl_vae_batch_cuda(to_cpu(params), cfg, seeds, nsteps, eps, u, ws)
    # a width the cluster kernel takes on 4 blocks, with weights of another
    # width: the weights' check raises before any launch
    wide = cl_vae.Config(original_dim=12, intermediate_dim=4096, latent_dim=3, n_classes=3,
                         use_x_prev=True)
    assert cgv.kernel_for(wide) == "generate_cl_vae_cluster"
    with pytest.raises(ValueError, match="must be"):
        cgv.generate_cl_vae_batch_cuda(params, wide, seeds, nsteps, eps, u, ws)
    assert cgv.LAUNCHES == before


# ---- the wide cl_vae generation kernel (generate_wide_kernel, f32)
#
# The same tolerances: frames equal and probabilities within 1e-5. The
# cases are configs kernel_for sends to it: without hidden layers, with
# x_prev, whose D x D frame-head rows do not fit 8 blocks of a cluster; and
# f32 with hidden layers at a latent width that neither the cluster kernel
# (2L past 4 x 32 lanes) nor the cooperative kernel (its z heads' columns in
# one block's shared memory) takes.

WIDE_CASES = {
    "no_hidden_d700": dict(B=5, nsteps=10, H=0, D=700, L=4, K=13, seed=5),
    "no_hidden_d1024_l16": dict(B=3, nsteps=8, H=0, D=1024, L=16, K=13, seed=6),
    "h64_l400": dict(B=5, nsteps=10, H=64, D=88, L=400, K=13, seed=4),
    # the frame head wider than the block's threads (up to 3 whole columns
    # a thread), the hidden layers split in K over 2 groups
    "d1100_h200_l400": dict(B=3, nsteps=6, H=200, D=1100, L=400, K=5, seed=9),
}
# no shared memory to spare: the per-song state in the global scratch
GLOBAL_STATE_CASES = {
    "state_in_global_memory": dict(B=5, nsteps=12, H=0, D=700, L=4, K=13, seed=8),
    "state_in_global_memory_hidden": dict(B=5, nsteps=12, H=40, L=400, seed=8),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES) + sorted(GLOBAL_STATE_CASES))
@pytest.mark.parametrize("zp", [False, True])
def test_vae_wide_kernel_matches_plain_f32(dev, case, zp, monkeypatch):
    if case in GLOBAL_STATE_CASES:
        monkeypatch.setattr(cgv, "_SMEM_LIMIT", 0)
        kw = GLOBAL_STATE_CASES[case]
    else:
        kw = WIDE_CASES[case]
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, **kw)
    assert cgv.kernel_for(cfg) == "generate_cl_vae_wide" and not cgv.fits(cfg)
    u1 = torch.ones_like(u)
    before = (cgv.LAUNCHES, cgv.WIDE_LAUNCHES)
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp,
                              return_probs=rp)
    pk, fk = (run(cgv.generate_cl_vae_batch_cuda, u1, True),
              run(cgv.generate_cl_vae_batch_cuda, u, False))
    torch.cuda.synchronize()
    assert (cgv.LAUNCHES, cgv.WIDE_LAUNCHES) == (before[0] + 2, before[1] + 2)
    pp, fp = (run(cgv.generate_cl_vae_batch_plain, u1, True),
              run(cgv.generate_cl_vae_batch_plain, u, False))
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    torch.testing.assert_close(fk, fp, rtol=0, atol=0)


# ---- the dense-stack cl_vae training kernels (csrc/vae_dense.cu; the bf16
# backward csrc/vae_dense_tc.cu)
#
# Forward outputs within 1e-5 (same f32 products, other summation order);
# backward outputs within max|a - b| <= 1e-4 * max|b| + 1e-6 (the weight
# gradients sum the B rows in another order).

from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd  # noqa: E402

# each case with the f32 layout ops/vae_dense.plan gives it (resident: the
# weights in every block's shared memory; streamed: through the ring)
VAE_DENSE_CASES = {
    "ragged_tile": dict(B=11, D=16, Cw=8, H=24, L=3, K=4, layout="resident", rows=4),  # B % 4
    "no_x_prev": dict(B=12, D=16, Cw=8, H=24, L=3, K=4, use_xp=False, layout="resident",
                      rows=4),
    # D, H > 256 threads: the weights no longer fit a block
    "two_column_passes": dict(B=9, D=300, Cw=40, H=280, L=5, K=13, layout="streamed", rows=8),
    "one_row": dict(B=1, D=12, Cw=6, H=10, L=2, K=2, layout="resident", rows=4),
    # the jsball_vae widths with 13 keys at phase 15's batch
    "training": dict(B=100, D=88, Cw=88, H=88, L=4, K=13, layout="resident", rows=4),
    # more rows than one streamed tile, widths that are no multiple of 32
    "streamed": dict(B=37, D=600, Cw=64, H=1400, L=6, K=5, layout="streamed", rows=8),
    # the streamed layout's smaller tiles, each with a ragged last tile: 4
    # rows a block at H=2,048; 2 at the f32 seq-concat width of the H=5,120
    # checkpoints; 1 at D=7,000, and at Cw=14,400 in a ring of two slots
    "streamed_four_rows": dict(B=9, D=1024, Cw=256, H=2048, L=16, K=13, layout="streamed",
                               rows=4),
    "streamed_two_rows": dict(B=5, D=1024, Cw=256, H=5120, L=16, K=13, layout="streamed",
                              rows=2),
    "streamed_one_row": dict(B=3, D=7000, Cw=64, H=96, L=4, K=5, layout="streamed", rows=1),
    "streamed_one_row_two_slots": dict(B=4, D=16, Cw=14400, H=16, L=1, K=2, use_xp=False,
                                       layout="streamed", rows=1),
    # every weight starting off 16 bytes (a view one float into its storage)
    "misaligned": dict(B=13, D=20, Cw=12, H=30, L=3, K=5, misalign=True, layout="resident",
                       rows=4),
}


def _vae_dense_inputs(dev, B, D, Cw, H, L, K, use_xp=True, seed=0, misalign=False,
                      layout=None, rows=None):
    """Binary frames, Gaussian noise, weights of std 1/sqrt(fan_in) (the
    scale of a trained or glorot-initialised model: pre-activations O(1));
    with ``misalign`` every weight a view that starts one float into its
    storage. ``layout`` and ``rows`` are the case's expected f32 layout and
    rows a block (not inputs)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)

    def m(i, o):
        w = f(i, o, scale=i ** -0.5)
        if not misalign:
            return w
        off = torch.empty(i * o + 1, device=dev)[1:].view(i, o)
        off.copy_(w)
        assert off.data_ptr() % 16 != 0
        return off
    bits = lambda: torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32)).to(dev)
    K2 = 2 * (K - 1)
    return (bits(), bits() if use_xp else None, f(B, K - 1), f(B, L), m(D, Cw),
            f(Cw, scale=0.2), m(Cw, K2), f(K2, scale=0.2), m(D, H), m(K, H), f(H, scale=0.2),
            m(H, 2 * L), f(2 * L, scale=0.2), m(K, H), m(D, H) if use_xp else None, m(L, H),
            f(H, scale=0.2), m(H, D), f(D, scale=0.2))


@pytest.mark.parametrize("case", sorted(VAE_DENSE_CASES))
def test_vae_dense_kernels_match_plain(dev, case):
    c = VAE_DENSE_CASES[case]
    p = vd.plan(c["B"], c["D"], c["Cw"], c["H"], c["L"], c["K"], c.get("use_xp", True))
    assert ("resident" if p.resident else "streamed", p.rows) == (c["layout"], c["rows"]), p
    ins = _vae_dense_inputs(dev, **c)
    before = (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)
    outs = vd.vae_dense_fwd(*ins)
    torch.cuda.synchronize()
    ref = vd.vae_dense_fwd_plain(*ins)
    for name, k, p in zip(("xhat", "wargs", "zargs", "w", "a1", "a2", "a3"), outs, ref):
        torch.testing.assert_close(k, p, rtol=0, atol=1e-5, msg=name)
    (x, xp, eps_w, eps_z, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
    xhat, wargs, zargs, w, a1, a2, a3 = ref
    rng = np.random.default_rng(1)
    cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(dev)
           for o in (xhat, wargs, zargs, w)]
    res = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, *cot,
           whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    got = vd.vae_dense_bwd(*res)
    torch.cuda.synchronize()
    want = vd.vae_dense_bwd_plain(*res)
    names = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz", "dbzz",
             "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")
    for name, g, wv in zip(names, got, want):
        if wv is None:
            assert g is None, name
            continue
        assert g.shape == wv.shape, name
        _assert_bwd_close(g, wv, name)
    # one launch a call in each direction (the backward's row pass and
    # weight gradients meet at a grid barrier inside its one launch)
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_vae_dense_gradients_on_cuda_match_cpu_plain(dev):
    """The loss and every parameter gradient of ``cl_vae.loss_and_metrics``
    on the ``pallas`` route: kernels on the card against the plain versions
    on the CPU, from the same weights, batch and noise."""
    D, H, L, K, B = 12, 20, 3, 4, 10
    cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                        intermediate_class_dim=10, n_classes=K, use_x_prev=True,
                        train_backend="pallas")
    raw = cl_vae.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    arrays = {"x": (rng.random((B, D)) < 0.3).astype(np.float32),
              "x_prev": (rng.random((B, D)) < 0.3).astype(np.float32),
              "y": (rng.random((B, D)) < 0.3).astype(np.float32),
              "w": np.eye(K, dtype=np.float32)[np.arange(B) % K],
              "eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
              "eps_z": rng.standard_normal((B, L)).astype(np.float32)}

    def grads(device):
        params = params_from_numpy({k: {n: v.numpy() for n, v in d.items()}
                                    for k, d in raw.items()}, device)
        leaves = [v.requires_grad_(True) for d in params.values() for v in d.values()]
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        loss, _ = cl_vae.loss_and_metrics(params, cfg, batch, None, 0.5, 0.7, 0.9)
        loss.backward()
        return [loss.detach()] + [v.grad for v in leaves]

    before = (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)
    on_card = grads(dev)
    torch.cuda.synchronize()
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    on_cpu = grads("cpu")
    assert len(on_card) == len(on_cpu) == 1 + 16  # the loss; 8 dense layers x 2
    for i, (g, wv) in enumerate(zip(on_card, on_cpu)):
        _assert_bwd_close(g.cpu(), wv, f"loss / gradient {i}")


@pytest.mark.parametrize("case", ["training", "streamed", "no_x_prev", "streamed_two_rows"])
def test_vae_dense_f32_bitwise_repeatable_and_timed_by_part(dev, case):
    """A second f32 call gives the same bits in both directions (every sum
    in a fixed order, no atomics), at a resident and at streamed layouts,
    and the kernels' own clock (``phase_ms``) times every part of one
    launch, counted as a launch, and reports its grid: the forward's row
    tiles, the backward's cooperative blocks (the row tiles or the
    weight-gradient tiles, whichever are more, at most what the card
    holds)."""
    ins = _vae_dense_inputs(dev, **VAE_DENSE_CASES[case], seed=3)
    outs, again = vd.vae_dense_fwd(*ins), vd.vae_dense_fwd(*ins)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    (x, xp, eps_w, eps_z, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
    xhat, wargs, zargs, w, a1, a2, a3 = outs
    rng = np.random.default_rng(4)
    cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(dev)
           for o in (xhat, wargs, zargs, w)]
    res = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, *cot,
           whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    got, again = vd.vae_dense_bwd(*res), vd.vae_dense_bwd(*res)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)
    before = (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)
    (fwd_parts, fwd_blocks), (bwd_parts, bwd_blocks) = (vd.phase_ms("fwd", *ins),
                                                         vd.phase_ms("bwd", *res))
    c = VAE_DENSE_CASES[case]
    p = vd.plan(c["B"], c["D"], c["Cw"], c["H"], c["L"], c["K"], c.get("use_xp", True))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(p.tiles, p.wg_tiles)
    assert fwd_blocks == p.tiles and min(want, n_sm) <= bwd_blocks <= want
    assert tuple(fwd_parts) == vd.FWD_PARTS and tuple(bwd_parts) == vd.BWD_PARTS
    assert sum(fwd_parts.values()) > 0 and sum(bwd_parts.values()) > 0
    assert all(v >= 0 for v in (*fwd_parts.values(), *bwd_parts.values()))
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)


def _bf16_inputs(ins):
    """The bf16 mode's operands: x, x_prev and the kernels in bf16."""
    ins = list(ins)
    for i in (0, 1, 4, 6, 8, 9, 11, 13, 14, 15, 17):
        ins[i] = None if ins[i] is None else ins[i].bfloat16()
    return ins


@pytest.mark.parametrize("case", sorted(VAE_DENSE_CASES))
def test_vae_dense_bf16_kernels_match_plain(dev, case):
    """The bf16 mode against the plain bf16 version: the same rounding
    points, f32 sums in another order, so a value near a bf16 rounding
    boundary may round the other way. Forward within 1e-2 x max(1,
    max|plain|) and 1e-3 relative Frobenius; backward within 1e-2 relative
    Frobenius; the weight gradients bf16, the bias gradients f32 and not
    rounded."""
    ins = _bf16_inputs(_vae_dense_inputs(dev, **VAE_DENSE_CASES[case]))
    before = (vd.BF16_FWD_LAUNCHES, vd.BF16_BWD_LAUNCHES)
    outs = vd.vae_dense_fwd(*ins)
    torch.cuda.synchronize()
    ref = vd.vae_dense_fwd_plain(*ins)
    rel = lambda a, b: ((a.float() - b.float()).norm() / (b.float().norm() + 1e-30)).item()
    for name, k, p in zip(("xhat", "wargs", "zargs", "w", "a1", "a2", "a3"), outs, ref):
        assert k.dtype == torch.float32, name
        scale = max(1.0, p.abs().max().item())
        assert (k - p).abs().max().item() <= 1e-2 * scale, name
        assert rel(k, p) <= 1e-3, name
    xhat, wargs, zargs, w, a1, a2, a3 = ref
    assert all(torch.equal(a, a.bfloat16().float()) for a in (a1, a2, a3))
    (x, xp, eps_w, eps_z, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
    rng = np.random.default_rng(1)
    cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(dev)
           for o in (xhat, wargs, zargs, w)]
    res = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, *cot,
           whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    got = vd.vae_dense_bwd(*res)
    torch.cuda.synchronize()
    want = vd.vae_dense_bwd_plain(*res)
    names = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz", "dbzz",
             "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")
    for name, g, wv in zip(names, got, want):
        if wv is None:
            assert g is None, name
            continue
        assert g.shape == wv.shape and g.dtype == wv.dtype, name
        assert g.dtype == (torch.float32 if name.startswith("db") else torch.bfloat16), name
        assert rel(g, wv) <= 1e-2, (name, rel(g, wv))
    assert (vd.BF16_FWD_LAUNCHES, vd.BF16_BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)


def test_vae_dense_bf16_gradients_on_cuda_match_cpu_plain(dev):
    """``cl_vae.loss_and_metrics`` on the ``pallas`` route with
    ``bf16_compute``: the loss and every parameter gradient, kernels on the
    card against the plain versions on the CPU, within 1e-2 relative
    Frobenius; every weight gradient bf16-representable."""
    D, H, L, K, B = 40, 48, 3, 4, 64
    cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                        intermediate_class_dim=24, n_classes=K, use_x_prev=True,
                        train_backend="pallas", bf16_compute=True)
    raw = cl_vae.init(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(3)
    arrays = {"x": (rng.random((B, D)) < 0.3).astype(np.float32),
              "x_prev": (rng.random((B, D)) < 0.3).astype(np.float32),
              "y": (rng.random((B, D)) < 0.3).astype(np.float32),
              "w": np.eye(K, dtype=np.float32)[np.arange(B) % K],
              "eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
              "eps_z": rng.standard_normal((B, L)).astype(np.float32)}

    def grads(device):
        params = params_from_numpy({k: {n: v.numpy() for n, v in d.items()}
                                    for k, d in raw.items()}, device)
        leaves = [(n, v.requires_grad_(True)) for d in params.values() for n, v in d.items()]
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        loss, _ = cl_vae.loss_and_metrics(params, cfg, batch, None, 0.5, 0.7, 0.9)
        loss.backward()
        return [("loss", loss.detach())] + [(n, v.grad) for n, v in leaves]

    before = (vd.BF16_FWD_LAUNCHES, vd.BF16_BWD_LAUNCHES)
    on_card = grads(dev)
    torch.cuda.synchronize()
    assert (vd.BF16_FWD_LAUNCHES, vd.BF16_BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    on_cpu = grads("cpu")
    for i, ((name, g), (_, wv)) in enumerate(zip(on_card, on_cpu)):
        g = g.cpu()
        err = ((g - wv).norm() / (wv.norm() + 1e-30)).item()
        assert err <= 1e-2, (i, name, err)
        if name == "kernel":
            assert torch.equal(g, g.bfloat16().float()), i


@pytest.mark.parametrize("B,use_xp", [(300, True), (100, False), (130, True)])
def test_vae_dense_bf16_backward_bitwise_repeatable(dev, B, use_xp):
    """The bf16 backward (``csrc/vae_dense_tc.cu``) at batches that take
    its row-split weight-gradient launch (B > 128) and that do not, with and
    without x_prev: within 1e-2 relative Frobenius of the bf16 plain
    version, the weight gradients bf16 and the bias gradients f32, and a
    second call bitwise equal (every sum in a fixed order)."""
    ins = _bf16_inputs(_vae_dense_inputs(dev, B=B, D=72, Cw=24, H=96, L=5, K=6, use_xp=use_xp,
                                         seed=B))
    xhat, wargs, zargs, w, a1, a2, a3 = vd.vae_dense_fwd_plain(*ins)
    (x, xp, eps_w, eps_z, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
    rng = np.random.default_rng(2)
    cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(dev)
           for o in (xhat, wargs, zargs, w)]
    res = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, *cot,
           whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    before = vd.BF16_BWD_LAUNCHES
    got = vd.vae_dense_bwd(*res)
    again = vd.vae_dense_bwd(*res)
    torch.cuda.synchronize()
    assert vd.BF16_BWD_LAUNCHES == before + 4
    want = vd.vae_dense_bwd_plain(*res)
    rel = lambda a, b: ((a.float() - b.float()).norm() / (b.float().norm() + 1e-30)).item()
    names = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz", "dbzz",
             "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")
    for name, g, a, wv in zip(names, got, again, want):
        if wv is None:
            assert g is None and a is None, name
            continue
        assert g.dtype == (torch.float32 if name.startswith("db") else torch.bfloat16), name
        assert rel(g, wv) <= 1e-2, (name, rel(g, wv))
        assert torch.equal(g, a), name


@pytest.mark.parametrize("B,use_xp", [(100, False), (130, True), (1, True)])
def test_vae_dense_bf16_forward_bitwise_repeatable(dev, B, use_xp):
    """The bf16 forward (``csrc/vae_dense_tc.cu``: two product launches and
    a row kernel) at one row, at a ragged batch and past two row tiles,
    with and without x_prev: within the bounds of
    ``test_vae_dense_bf16_kernels_match_plain``, one counted launch a call,
    and a second call bitwise equal (every sum in a fixed order)."""
    ins = _bf16_inputs(_vae_dense_inputs(dev, B=B, D=72, Cw=24, H=96, L=5, K=6, use_xp=use_xp,
                                         seed=B))
    before = vd.BF16_FWD_LAUNCHES
    got, again = vd.vae_dense_fwd(*ins), vd.vae_dense_fwd(*ins)
    torch.cuda.synchronize()
    assert vd.BF16_FWD_LAUNCHES == before + 2
    ref = vd.vae_dense_fwd_plain(*ins)
    rel = lambda a, b: ((a - b).norm() / (b.norm() + 1e-30)).item()
    for name, g, a, p in zip(("xhat", "wargs", "zargs", "w", "a1", "a2", "a3"), got, again, ref):
        assert (g - p).abs().max().item() <= 1e-2 * max(1.0, p.abs().max().item()), name
        assert rel(g, p) <= 1e-3, name
        assert torch.equal(g, a), name


def test_vae_dense_wrappers_raise_instead_of_falling_back(dev):
    ins = list(_vae_dense_inputs(dev, B=4, D=8, Cw=6, H=10, L=2, K=3))
    before = (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="cpu"):
        vd.vae_dense_fwd(*ins[:4], ins[4].cpu(), *ins[5:])
    with pytest.raises(ValueError, match="contiguous"):
        vd.vae_dense_fwd(*ins[:8], ins[8].T.contiguous().T, *ins[9:])
    with pytest.raises(ValueError, match="float32"):
        vd.vae_dense_fwd(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="together"):
        vd.vae_dense_fwd(ins[0], None, *ins[2:])
    wide = _vae_dense_inputs(dev, B=4, D=8, Cw=6, H=8192, L=2, K=3)
    with pytest.raises(ValueError, match="shared memory"):
        vd.vae_dense_fwd(*wide)
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == before


# ---- the redesigned two-cell forward (csrc/two_cell.cu) and f32 / bf16
# generation kernel (generate_kernel): widths past the old shared-memory
# limits, the serving buckets, weights resident and streamed, repeatable bits

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [136, 2400])
def test_two_cell_forward_without_width_limit(dev, H, bf16):
    """The forward at a width the 4-row-tile kernel could not take (its
    state in shared memory stopped near H = 2,200) and at a K split of
    whole chunks with a ragged rest, recurrent weights at an init's scale:
    against the plain version (f32 1e-5 x max(1, max|plain|): the
    pre-activations sum 2,400 products in another order;
    bf16 streams within one bf16 step at their largest entry, f32 outputs
    within 1e-2 x max(1, max|plain|)), one launch a call, the same bits
    from a second call."""
    ins = list(_two_cell_bf16_inputs(dev, B=20, T=3, H=H, L=2) if bf16 else
               _two_cell_inputs(dev, B=20, T=3, H=H, L=2))
    # the recurrent kernels and z heads scaled by sqrt(40 / H), as an init
    # scales them, so that the pre-activations stay O(1) at every width
    for i in (5, 8, 10):
        ins[i] = (ins[i].float() * (40 / H) ** 0.5).to(ins[i].dtype)
    before = (tc.FWD_LAUNCHES, tc.BF16_FWD_LAUNCHES)
    outs = tc.two_cell_fwd(*ins)
    again = tc.two_cell_fwd(*ins)
    torch.cuda.synchronize()
    assert (tc.FWD_LAUNCHES, tc.BF16_FWD_LAUNCHES) == (before[0] + 2 * (not bf16),
                                                       before[1] + 2 * bf16)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    ref = tc.two_cell_fwd_plain(*ins)
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    for name, k, p in zip(names, outs, ref):
        assert k.dtype == p.dtype, name
        err = (k.float() - p.float()).abs().max().item()
        if not bf16:
            assert err <= 1e-5 * max(1.0, p.abs().max().item()), (name, err)
        elif name in ("ze", "zd", "hpe", "he", "hpd"):
            assert err <= _bf16_step_at_max(p), (name, err)
        else:
            assert err <= 1e-2 * max(1.0, p.abs().max().item()), (name, err)


GEN_CASES = {
    # the serving buckets of jsball_vrnn4's shape (f32 weights resident)
    **{f"f32_b{B}": dict(B=B, Tseed=4, nsteps=8, H=256, D=88, L=8, K=10, seed=6)
       for B in (1, 4, 16, 64, 256)},
    # bf16: resident at H=512 and 1,024, streamed from L2 at 1,536 and 2,048
    **{f"bf16_b{B}_h{H}": dict(B=B, Tseed=3, nsteps=6, H=H, D=88, L=2, K=13, seed=7, bf16=True)
       for B in (1, 64) for H in (512, 1024, 1536, 2048)},
    "bf16_b256_h512": dict(B=256, Tseed=3, nsteps=6, H=512, D=88, L=2, K=13, seed=8, bf16=True),
    # more songs than one launch takes (two cooperative launches, one call)
    "f32_b300": dict(B=300, Tseed=2, nsteps=4, H=64, seed=9),
    # past 20 units a block on 132 SMs: blocks of two unit groups (gen_grid)
    **{f"{m}_b8_h{H}": dict(B=8, Tseed=3, nsteps=6, H=H, D=88, L=2, K=13, seed=10,
                            bf16=m == "bf16")
       for m in ("f32", "bf16") for H in (2688, 4096)},
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_kernel_buckets_and_widths(dev, case):
    """The f32 / bf16 kernel at the serving buckets and at widths whose
    slices stay resident or stream: probabilities with u = 1 against the
    plain version (f32 1e-5; bf16 max 2e-2, mean 2e-3, as chip_smoke holds
    it), one counted call each, and a second call bitwise equal."""
    kw = dict(GEN_CASES[case])
    bf16 = kw.get("bf16", False)
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, **kw)
    u1 = torch.ones_like(u)
    mode = "bf16" if bf16 else "f32"
    run = lambda f: f(params, cfg, seeds, nsteps, eps, u1, ws, return_probs=True, mode=mode)
    before = cg.LAUNCHES
    pk, again = run(cg.generate_cl_vrnn_batch_cuda), run(cg.generate_cl_vrnn_batch_cuda)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2
    assert torch.equal(pk, again)
    pp = run(cg.generate_cl_vrnn_batch_plain)
    d = (pk - pp).abs()
    if bf16:
        assert d.max().item() <= 2e-2 and d.mean().item() <= 2e-3, (d.max(), d.mean())
    else:
        assert d.max().item() <= 1e-5, d.max()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_generate_kernel_unit_groups_across_launches(dev, bf16, monkeypatch):
    """Blocks of two unit groups (H=2,688) where one launch takes only 16
    songs (the shared-memory limit lowered to the state of 16): 40 songs
    in three launches of one counted call, against the plain version with
    the bounds of :func:`test_generate_kernel_buckets_and_widths`."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nu, nv, _ = cg.gen_grid(2688, n_sm)
    assert nv > 1
    monkeypatch.setattr(cg, "_SMEM_LIMIT", cg.gen_smem(nu, 16, 2, 0, nv))
    assert cg.launch_songs(nu, nv, 2) == 16
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, B=40, Tseed=2, nsteps=4, H=2688,
                                                        D=88, L=2, K=13, seed=11, bf16=bf16)
    mode = "bf16" if bf16 else "f32"
    run = lambda f: f(params, cfg, seeds, nsteps, eps, torch.ones_like(u), ws,
                      return_probs=True, mode=mode)
    before = cg.LAUNCHES
    pk = run(cg.generate_cl_vrnn_batch_cuda)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 1
    d = (pk - run(cg.generate_cl_vrnn_batch_plain)).abs()
    if bf16:
        assert d.max().item() <= 2e-2 and d.mean().item() <= 2e-3, (d.max(), d.mean())
    else:
        assert d.max().item() <= 1e-5, d.max()


def test_device_prefetch_equals_synchronous_copies(dev):
    """The streamed batches (pinned memory, non-blocking copies on a side
    stream, the consumer waiting on an event a batch) equal synchronous
    ``.to(dev)`` copies, while the consuming stream works on each batch
    before the next is taken."""
    from classifying_vae_lstm_tpu_torch.data.loader import batch_iterator, device_prefetch

    rng = np.random.default_rng(0)
    data = {"x": rng.random((2000, 16, 88)).astype(np.float32),
            "w": np.eye(13, dtype=np.float32)[rng.integers(0, 13, 2000)]}
    got = []
    for b in device_prefetch(batch_iterator(data, 200, np.random.default_rng(1)), 2, dev):
        assert all(t.is_cuda for t in b.values())
        got.append({k: (v @ v.transpose(-1, -2) if v.ndim == 3 else v).sum().item()
                    for k, v in b.items()})
    want = [{k: (v @ v.transpose(-1, -2) if v.ndim == 3 else v).sum().item()
             for k, v in ((k, torch.from_numpy(a).to(dev)) for k, a in b.items())}
            for b in batch_iterator(data, 200, np.random.default_rng(1))]
    assert len(got) == len(want) == 10 and got == want


def test_key_consistency_kernel_matches_plain(dev):
    """``cli.key_consistency`` on the card: one generation launch a key
    with test songs; its kernel against the plain version on c5m's weights
    and one key's seeds (probabilities with u = 1 within 1e-5)."""
    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.cli import key_consistency as kc
    from classifying_vae_lstm_tpu_torch.data import PianoData

    args = kc.build_parser().parse_args(["-i", "artifacts/pm_configs/c5m.npz", "-n", "4", "-t",
                                         "32"])
    before = cg.LAUNCHES
    rep = kc.run(args)
    torch.cuda.synchronize()
    P = PianoData(args.train_file, batch_size=1, seq_length=args.seed_len, squeeze_x=False)
    assert cg.LAUNCHES - before == len(np.unique(P.test_song_keys)) == 13
    assert rep["n_songs"] == 52 and rep["margin"] > 0
    raw, cfg, margs = common.load_model(args.model_file, "cl_vrnn")
    params = params_from_numpy(raw, dev)
    seeds = torch.from_numpy(P.x_test[np.where(P.test_song_keys == 3)[0][:4]]).to(dev)
    ws = torch.eye(margs["n_classes"], device=dev)[[3] * 4]
    g = torch.Generator(device=dev).manual_seed(3)
    eps = torch.randn((4, 64, cfg.latent_dim), generator=g, device=dev)
    u1 = torch.ones((4, 64, cfg.original_dim), device=dev)
    run = lambda f: f(params, cfg, seeds, 32, eps, u1, ws, return_probs=True)
    d = (run(cg.generate_cl_vrnn_batch_cuda) - run(cg.generate_cl_vrnn_batch_plain)).abs()
    assert d.max().item() <= 1e-5, d.max()


# ---- the tools' step-decomposition probes (ops/exp_lstm.py, csrc/exp_lstm.cu)
# Tolerances: the chains (bf16 operands, f32 sums) within 1e-2 of each
# output block's largest entry, each block against the plain version started
# from the state the kernel carried out of the block before
# (``chain_plain_blockwise``: h is rounded to bf16 every step, so another
# summation order flips a rounding now and then, and over 64 steps at H=512
# two correct sum orders part by more than 1e-2, 16 steps by ~6e-3:
# tests/test_torch_exp_lstm.py test_two_correct_chains_part_by_about_a_percent),
# and one step a block within 1e-4 (one step of two sum orders parts by
# ~3e-7); the gates
# kernels (f32, another tanh and FMA contraction) and the f32 sums of the
# off-chain product and the mini walk within 1e-4 of each output's largest
# entry; the mini walk's bf16 dx within 1e-2 of each step's largest entry;
# the interleaved forward bitwise equal to the port's bf16 training forward
# (the same products and epilogue) and within 1e-3 relative Frobenius of the
# plain version (phase 20's bound for the bf16 streams).

def _exp_inputs(dev, B, H, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    # rk scaled to keep |h| of O(1) over every step of the chain
    return f(B, H), f(B, H), f(H, 4 * H, scale=50 / H ** 0.5).bfloat16(), \
        f(H, 4 * H, scale=50 / H ** 0.5).bfloat16()


def _close_per_block(got, want, bb, tol):
    for b in range(want.shape[0] // bb):
        g, w = got[b * bb:(b + 1) * bb], want[b * bb:(b + 1) * bb]
        assert torch.isfinite(g).all() and w.abs().max() > 1e-3
        err = (g - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (b, err, w.abs().max().item())


@pytest.mark.parametrize("B,H,bb", [(64, 128, 32), (1024, 512, 256), (96, 136, 48),
                                    (256, 256, 256)])
def test_exp_chain_kernels_match_plain(dev, B, H, bb):
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex

    h0, g0, rkA, rkB = _exp_inputs(dev, B, H)
    for name in ("chain_mm", "chain_mm_x2"):
        before = ex.counts()[name]
        got = getattr(ex, name)(h0, rkA, bb)
        torch.cuda.synchronize()
        assert ex.counts()[name] == before + 1
        _close_per_block(got, ex.chain_plain_blockwise(name, got, h0, rkA, bb=bb), bb, 1e-2)
    for name in ("chain_mm_x2_fullwidth", "chain_mm_encdec"):
        got = getattr(ex, name)(h0, g0, rkA, rkB, bb)
        want = ex.chain_plain_blockwise(name, got, h0, g0, rkA, rkB, bb=bb)
        for g, w in zip(got, want):
            _close_per_block(g, w, bb, 1e-2)


@pytest.mark.parametrize("B,H,bb", [(16384, 512, 256), (96, 136, 48)])
def test_exp_chain_kernels_hold_each_single_step(dev, B, H, bb):
    """The chains at T=1: each block is one step from the state the kernel
    carried out of the block before (64 steps at H=512), each held within
    1e-4 of its largest entry, so a bias a step cannot hide inside the
    blockwise comparison's 16 steps (two correct f32 sum orders part by ~3e-7
    a step: tests/test_torch_exp_lstm.py
    test_two_correct_chains_part_by_about_a_percent)."""
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex

    h0, g0, rkA, rkB = _exp_inputs(dev, B, H)
    for name in ("chain_mm", "chain_mm_x2", "chain_mm_x2_fullwidth", "chain_mm_encdec"):
        ins = (h0, rkA) if name in ("chain_mm", "chain_mm_x2") else (h0, g0, rkA, rkB)
        got = getattr(ex, name)(*ins, bb, 1)
        want = ex.chain_plain_blockwise(name, got, *ins, bb=bb, T=1)
        for g, w in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
            _close_per_block(g, w, bb, 1e-4)


@pytest.mark.parametrize("B,H,bb", [(64, 128, 32), (1024, 512, 256), (96, 136, 48)])
def test_exp_gates_and_offchain_kernels_match_plain(dev, B, H, bb):
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex

    rng = np.random.default_rng(1)
    z0 = torch.from_numpy(rng.standard_normal((B, 4 * H)).astype(np.float32)).to(dev)
    for name in ("gates_fwd", "gates_bwd"):
        _close_per_block(getattr(ex, name)(z0, bb), getattr(ex, f"{name}_plain")(z0, bb), bb,
                         1e-4)
    b16 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev).bfloat16()
    hp, dz, xp = b16(B, H), b16(B, 4 * H), b16(B, 128)
    for g, w in zip(ex.offchain_mm(hp, dz, xp, bb), ex.offchain_mm_plain(hp, dz, xp, bb)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("T,B,H", [(16, 200, 512), (5, 33, 20)])
def test_exp_interleave_matches_the_training_forward(dev, T, B, H):
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    rng = np.random.default_rng(2)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    xz, rk = f(T, B, 4 * H).bfloat16(), f(H, 4 * H, scale=0.05).bfloat16()
    h0, c0 = f(B, H, scale=0.1), f(B, H, scale=0.1)
    got = ex.lstm_interleave_train_fwd(xz, rk, h0, c0)
    base = ls.lstm_seq_xz_train_fwd(xz, rk, h0, c0)
    plain = ex.lstm_interleave_train_fwd_plain(xz, rk, h0, c0)
    for g, k, p in zip(got, base, plain):
        assert torch.equal(g, k)
        assert (g.float() - p.float()).norm() <= 1e-3 * p.float().norm()


@pytest.mark.parametrize("case", ["min_base", "min_dx_in", "min_dx_out", "min_dw", "min_db",
                                  "min_all"])
def test_exp_mini_walk_matches_plain_on_a_partial_tile(dev, case):
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex

    rng = np.random.default_rng(3)
    T, B, H, IN = 8, 40, 256, 128  # 40 rows: the last 16-row tile holds 8
    b16 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev).bfloat16()
    z, h, x = b16(T, B, 4 * H), b16(T, B, H), b16(T, B, IN)
    got, want = ex.mini_walk(case, z, h, x), ex.mini_walk_plain(case, z, h, x)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if w is None:
            continue
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        for gs, ws in (zip(g, w) if i == 0 else [(g, w)]):  # dx: each step apart
            tol = 1e-2 if i == 0 else 1e-4
            assert (gs - ws).abs().max().item() <= tol * ws.abs().max().item(), (case, i)


def test_exp_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex

    h0, g0, rk, _ = _exp_inputs(dev, 64, 128)
    with pytest.raises(ValueError, match="multiple of bb"):
        ex.chain_mm(h0, rk, 48)
    with pytest.raises(ValueError, match="bfloat16"):
        ex.chain_mm(h0, rk.float(), 32)
    with pytest.raises(ValueError, match="case"):
        ex.mini_walk("min_none", *(torch.zeros(2, 16, s, device=dev, dtype=torch.bfloat16)
                                   for s in (16, 4, 4)))
    with pytest.raises(ValueError, match="shared memory"):  # a tile past 227 KiB at H=1,024
        ex.mini_walk("min_base", *(torch.zeros(1, 16, s, device=dev, dtype=torch.bfloat16)
                                   for s in (4096, 1024, 4)))
