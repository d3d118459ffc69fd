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
    # two passes of the gate stages
    "ragged_no_x_prev": dict(B=5, Tseed=3, nsteps=12, H=262, D=13, use_x_prev=False, seed=4),
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
    """The widest H the JAX package's ``auto`` pins to the proj-only rung:
    in f32 the walk takes 2-row tiles there (7 rows: a ragged last tile); in
    bf16 it is the tensor-core walk of ``csrc/lstm_seq_tc.cu``, which has no
    row tile and no shared-memory ceiling."""
    B, T, H = 7, 2, 2560
    if not bf16:
        assert ls.walk_rows(H) == 2
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
    with pytest.raises(ValueError, match="contiguous"):
        ls.lstm_seq_walk(z, cp, c, h, c, rk.T)
    with pytest.raises(ValueError, match="h_prev must be bfloat16"):
        ls.lstm_seq_walk_drk(z.bfloat16(), cp, c, hp, h, c, rk_t.bfloat16())
    with pytest.raises(ValueError, match="shared memory"):
        ls.lstm_seq_walk(*(torch.zeros(1, 1, 4 * 4900, device=dev),) * 6)
    assert [_rung_launches(b) for b in (False, True)] == before


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


VAE_CASES = {
    "one_song": dict(B=1, nsteps=20, H=40),
    "ragged_no_x_prev": dict(B=5, nsteps=16, H=40, use_x_prev=False),
    "two_column_passes": dict(B=6, nsteps=12, H=200, seed=1),  # H > the block's threads
    "vanilla_k1": dict(B=4, nsteps=10, H=24, K=1, use_x_prev=False, seed=2),
}


@pytest.mark.parametrize("case", sorted(VAE_CASES))
@pytest.mark.parametrize("zp", [False, True])
def test_vae_kernel_matches_plain_f32(dev, case, zp):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, **VAE_CASES[case])
    u1 = torch.ones_like(u)
    before = cgv.LAUNCHES
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp,
                              return_probs=rp)
    pk, fk = run(cgv.generate_cl_vae_batch_cuda, u1, True), run(cgv.generate_cl_vae_batch_cuda,
                                                                 u, False)
    torch.cuda.synchronize()
    assert cgv.LAUNCHES == before + 2
    pp, fp = run(cgv.generate_cl_vae_batch_plain, u1, True), run(cgv.generate_cl_vae_batch_plain,
                                                                  u, False)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    torch.testing.assert_close(fk, fp, rtol=0, atol=0)


def test_vae_kernel_matches_plain_bf16(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, B=7, nsteps=16, H=64, seed=3,
                                                            bf16=True)
    run = lambda f, **k: f(params, cfg, seeds, nsteps, eps, u, ws, return_probs=True, **k)
    pk, pp = run(cgv.generate_cl_vae_batch_cuda), run(cgv.generate_cl_vae_batch_plain)
    torch.testing.assert_close(pk, pp, rtol=0, atol=2e-3)
    pf = run(cgv.generate_cl_vae_batch_cuda, mode="f32")
    assert (pk - pf).abs().max().item() > 1e-6  # bf16 really ran


VAE_INT8_CASES = {
    "h64": dict(B=7, nsteps=16, H=64, seed=3),
    # D and H not multiples of 4, a ragged song tile, no x_prev
    "ragged_no_x_prev": dict(B=5, nsteps=12, H=262, D=13, use_x_prev=False, seed=4),
    # per-song state past one block's shared memory: the global scratch
    "state_in_scratch": dict(B=3, nsteps=4, H=13000, D=12, seed=5),
}


@pytest.mark.parametrize("case", sorted(VAE_INT8_CASES))
@pytest.mark.parametrize("zp", [False, True])
def test_vae_int8_kernel_matches_plain(dev, case, zp):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, bf16=True,
                                                            **VAE_INT8_CASES[case])
    if case == "state_in_scratch":
        assert cgv._int8_smem_bytes(12, 13000, 3, True) > cgv._SMEM_LIMIT
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
    # a width the wide kernel takes, with weights of another width
    wide = cl_vae.Config(original_dim=12, intermediate_dim=4096, latent_dim=3, n_classes=3,
                         use_x_prev=True)
    with pytest.raises(ValueError, match="must be"):
        cgv.generate_cl_vae_batch_cuda(params, wide, seeds, nsteps, eps, u, ws)
    assert cgv.LAUNCHES == before


# ---- the wide cl_vae generation kernel (generate_wide_kernel)
#
# The same tolerances: f32 frames equal and probabilities within 1e-5; bf16
# probabilities within 2e-3 of the plain bf16 version.

WIDE_CASES = {
    "h256": dict(B=5, nsteps=12, H=256, D=88, L=4, K=13, seed=4),
    "no_hidden": dict(B=5, nsteps=12, H=0, D=88, L=4, K=13, seed=5),
    "no_hidden_no_x_prev": dict(B=3, nsteps=10, H=0, use_x_prev=False, seed=6),
    "h1100_k_split": dict(B=3, nsteps=6, H=1100, D=40, L=20, K=5, seed=7),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES) + ["state_in_global_memory"])
@pytest.mark.parametrize("zp", [False, True])
def test_vae_wide_kernel_matches_plain_f32(dev, case, zp, monkeypatch):
    if case == "state_in_global_memory":
        # no shared memory to spare: the narrow config takes the wide kernel,
        # its per-song state in the global scratch
        monkeypatch.setattr(cgv, "_SMEM_LIMIT", 0)
        kw = dict(B=5, nsteps=12, H=40, seed=8)
    else:
        kw = WIDE_CASES[case]
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, **kw)
    assert cgv.kernel_for(cfg) == "generate_cl_vae_wide"
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


def test_vae_wide_kernel_matches_plain_bf16(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, B=5, nsteps=12, H=512, D=88,
                                                            L=4, K=13, seed=9, bf16=True)
    assert cgv.kernel_for(cfg) == "generate_cl_vae_wide"
    run = lambda f, **k: f(params, cfg, seeds, nsteps, eps, u, ws, return_probs=True, **k)
    before = cgv.WIDE_LAUNCHES
    pk, pp = run(cgv.generate_cl_vae_batch_cuda), run(cgv.generate_cl_vae_batch_plain)
    torch.testing.assert_close(pk, pp, rtol=0, atol=2e-3)
    pf = run(cgv.generate_cl_vae_batch_cuda, mode="f32")
    assert (pk - pf).abs().max().item() > 1e-6  # bf16 really ran
    assert cgv.WIDE_LAUNCHES == before + 2


# ---- the dense-stack cl_vae training kernels (csrc/vae_dense.cu; the bf16
# backward csrc/vae_dense_tc.cu)
#
# Forward outputs within 1e-5 (same f32 products, other summation order);
# backward outputs within max|a - b| <= 1e-4 * max|b| + 1e-6 (the weight
# gradients sum the B rows in another order).

from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd  # noqa: E402

VAE_DENSE_CASES = {
    "ragged_tile": dict(B=11, D=16, Cw=8, H=24, L=3, K=4),  # B not a multiple of 4 rows
    "no_x_prev": dict(B=12, D=16, Cw=8, H=24, L=3, K=4, use_xp=False),
    "two_column_passes": dict(B=9, D=300, Cw=40, H=280, L=5, K=13),  # D, H > 256 threads
    "one_row": dict(B=1, D=12, Cw=6, H=10, L=2, K=2),
}


def _vae_dense_inputs(dev, B, D, Cw, H, L, K, use_xp=True, seed=0):
    """Binary frames, Gaussian noise, weights of std 1/sqrt(fan_in) (the
    scale of a trained or glorot-initialised model: pre-activations O(1))."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    m = lambda i, o: f(i, o, scale=i ** -0.5)
    bits = lambda: torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32)).to(dev)
    K2 = 2 * (K - 1)
    return (bits(), bits() if use_xp else None, f(B, K - 1), f(B, L), m(D, Cw),
            f(Cw, scale=0.2), m(Cw, K2), f(K2, scale=0.2), m(D, H), m(K, H), f(H, scale=0.2),
            m(H, 2 * L), f(2 * L, scale=0.2), m(K, H), m(D, H) if use_xp else None, m(L, H),
            f(H, scale=0.2), m(H, D), f(D, scale=0.2))


@pytest.mark.parametrize("case", sorted(VAE_DENSE_CASES))
def test_vae_dense_kernels_match_plain(dev, case):
    ins = _vae_dense_inputs(dev, **VAE_DENSE_CASES[case])
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
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)


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
    assert (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    on_cpu = grads("cpu")
    assert len(on_card) == len(on_cpu) == 1 + 16  # the loss; 8 dense layers x 2
    for i, (g, wv) in enumerate(zip(on_card, on_cpu)):
        _assert_bwd_close(g.cpu(), wv, f"loss / gradient {i}")


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
