"""The whole-generation CUDA kernel against its plain version, on the card.

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
at the same places, other summation order).
"""

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int8")
    assert cg.LAUNCHES == before


# ---- the two-cell training kernels (csrc/two_cell.cu)
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


# ---- the whole-sequence LSTM kernels (csrc/lstm_seq.cu)
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
    with pytest.raises(ValueError, match="shared memory"):
        ls.lstm_seq_bwd(*(torch.zeros(1, 1, 4 * 4096, device=dev),) * 9)
    assert _launches() == before


# ---- the whole-generation cl_vae kernel (csrc/generate_cl_vae.cu)
#
# f32 probabilities within 1e-5 and frames equal (same f32 products, other
# summation order; these fixed seeds have no near-tie); bf16 probabilities
# within 2e-3 of the plain bf16 version (bf16 rounding at the same places).

from classifying_vae_lstm_tpu_torch.models import cl_vae  # noqa: E402
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv  # noqa: E402


def _vae_problem(dev, B, nsteps, H, use_x_prev=True, D=12, L=3, K=3, seed=0, bf16=False):
    cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                        intermediate_class_dim=H, n_classes=K, use_x_prev=use_x_prev,
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


def test_vae_wrapper_raises_instead_of_falling_back(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _vae_problem(dev, B=4, nsteps=4, H=16)
    before = cgv.LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps.cpu(), u, ws)
    with pytest.raises(ValueError, match="contiguous"):
        cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps,
                                       u.transpose(0, 1).contiguous().transpose(0, 1), ws)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int8")
    wide = cl_vae.Config(original_dim=12, intermediate_dim=4096, latent_dim=3, n_classes=3,
                         use_x_prev=True)
    with pytest.raises(ValueError, match="shared memory"):
        cgv.generate_cl_vae_batch_cuda(params, wide, seeds, nsteps, eps, u, ws)
    assert cgv.LAUNCHES == before
