"""The port's weight-norm data-dependent init vs the JAX package's.

Both families' sequential walks on the same parameters and batch, the
port's noise-explicit core given the draws JAX makes inside
``data_based_init_*`` (``eps_w`` from the first half of ``split(key)``,
``eps_z`` from the second, rebuilt here with ``jax.random.normal``): every
leaf within rtol 1e-5 / atol 1e-6 (f32 products in another summation
order). The single-shot ``data_based_init`` likewise, and the
``torch.Generator`` wrappers draw eps_w then eps_z. ``--data_init`` in both
train CLIs inits on the first 100 training rows with a generator seeded
``--seed + 1``, before training, as the JAX CLIs do.
"""


import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.models import cl_vrnn as jvrnn
from classifying_vae_lstm_tpu.optim import data_init as jinit
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tvrnn
from classifying_vae_lstm_tpu_torch.optim import data_init as tinit
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_Cs.pickle"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _close(got, want):
    for name, layer in want.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(got[name][leaf].numpy(), np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name}/{leaf}")


def _batch(rng, shape, use_x_prev):
    b = {"x": (rng.random(shape) < 0.25).astype(np.float32)}
    if use_x_prev:
        b["x_prev"] = (rng.random(shape) < 0.25).astype(np.float32)
    return b


def _eps(key, shape_w, shape_z):
    kw, kz = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(kw, shape_w))),
            torch.from_numpy(np.array(jax.random.normal(kz, shape_z))))


@pytest.mark.parametrize("H,use_x_prev", [(16, True), (16, False), (0, True)],
                         ids=["hidden_x_prev", "hidden", "no_hidden_x_prev"])
def test_cl_vae_matches_jax(H, use_x_prev):
    B, D, L, K = 40, 12, 3, 4
    jcfg = jvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L, intermediate_class_dim=10,
                       n_classes=K, use_x_prev=use_x_prev)
    tcfg = tvae.Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    raw = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(0), jcfg))
    batch = _batch(np.random.default_rng(1), (B, D), use_x_prev)
    key = jax.random.PRNGKey(5)
    want = jinit.data_based_init_cl_vae(raw, jcfg, batch, key)
    eps_w, eps_z = _eps(key, (B, K - 1), (B, L))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tinit.data_based_init_cl_vae_noise(params_from_numpy(raw, "cpu"), tcfg, tb, eps_w,
                                             eps_z)
    _close(got, want)


@pytest.mark.parametrize("use_x_prev", [True, False], ids=["x_prev", "no_x_prev"])
def test_cl_vrnn_matches_jax(use_x_prev):
    B, T, D, H, L, K = 30, 5, 10, 8, 2, 3
    jcfg = jvrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                        n_classes=K, use_x_prev=use_x_prev)
    tcfg = tvrnn.Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    raw = jax.tree.map(np.asarray, jvrnn.init(jax.random.PRNGKey(0), jcfg))
    batch = _batch(np.random.default_rng(2), (B, T, D), use_x_prev)
    key = jax.random.PRNGKey(7)
    want = jinit.data_based_init_cl_vrnn(raw, jcfg, batch, key)
    eps_w, eps_z = _eps(key, (B, K - 1), (B, T, L))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tinit.data_based_init_cl_vrnn_noise(params_from_numpy(raw, "cpu"), tcfg, tb, eps_w,
                                              eps_z)
    _close(got, want)
    # the LSTM layers are untouched
    for name in ("encoder_h", "decoder_h"):
        for leaf, v in raw[name].items():
            np.testing.assert_array_equal(got[name][leaf].numpy(), v)


def test_single_shot_matches_jax():
    rng = np.random.default_rng(3)
    raw = {"a": {"kernel": rng.normal(size=(6, 4)).astype(np.float32),
                 "bias": rng.normal(size=4).astype(np.float32)},
           "b": {"kernel": rng.normal(size=(4, 2)).astype(np.float32),
                 "bias": np.zeros(2, np.float32)},
           "c": {"kernel": np.ones((2, 2), np.float32), "bias": np.zeros(2, np.float32)}}
    pre = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
           "b": rng.normal(size=(9, 2)).astype(np.float32)}
    want = jinit.data_based_init(raw, pre)
    got = tinit.data_based_init(params_from_numpy(raw, "cpu"),
                                {k: torch.from_numpy(v) for k, v in pre.items()})
    _close(got, want)
    np.testing.assert_array_equal(got["c"]["kernel"].numpy(), raw["c"]["kernel"])


@pytest.mark.parametrize("family", ["cl_vae", "cl_vrnn"])
def test_generator_wrappers_draw_eps_w_then_eps_z(family):
    if family == "cl_vae":
        cfg = tvae.Config(original_dim=8, intermediate_dim=6, latent_dim=2,
                          intermediate_class_dim=5, n_classes=3, use_x_prev=True)
        params = tvae.init(torch.Generator().manual_seed(0), cfg)
        x = (torch.rand((20, 8), generator=torch.Generator().manual_seed(1)) < 0.3).float()
        z_shape, wrap, core = (20, 2), tinit.data_based_init_cl_vae, \
            tinit.data_based_init_cl_vae_noise
    else:
        cfg = tvrnn.Config(original_dim=8, intermediate_dim=6, latent_dim=2, seq_length=4,
                           n_classes=3, use_x_prev=True)
        params = tvrnn.init(torch.Generator().manual_seed(0), cfg)
        x = (torch.rand((20, 4, 8), generator=torch.Generator().manual_seed(1)) < 0.3).float()
        z_shape, wrap, core = (20, 4, 2), tinit.data_based_init_cl_vrnn, \
            tinit.data_based_init_cl_vrnn_noise
    batch = {"x": x, "x_prev": x.flip(0)}
    got = wrap(params, cfg, batch, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    eps_w = torch.randn((20, 2), generator=g)
    want = core(params, cfg, batch, eps_w, torch.randn(z_shape, generator=g))
    for name, layer in want.items():
        for leaf, v in layer.items():
            torch.testing.assert_close(got[name][leaf], v, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
def test_data_init_flag_inits_on_the_first_100_rows(tmp_path, monkeypatch, family):
    cli = cl_vrnn_train if family == "cl_vrnn" else cl_vae_train
    extra = (["--intermediate_dim", "8", "--seq_length", "4", "--batch_size", "1000"]
             if family == "cl_vrnn" else ["--latent_dim", "2", "--batch_size", "500"])
    args = cli.build_parser().parse_args(
        ["r", "--device", "cpu", "--train_file", CORPUS, "--num_epochs", "1", "--patience", "0",
         "--model_dir", str(tmp_path), "--seed", "4", "--data_init", *extra])
    name = f"data_based_init_{family}"
    real, seen = getattr(cli, name), {}

    def spy(params, cfg, batch, generator):
        want = getattr(tinit, f"{name}_noise")
        B = batch["x"].shape[0]
        g = torch.Generator().manual_seed(5)
        eps_w = torch.randn((B, cfg.n_classes - 1), generator=g)
        eps_z = torch.randn((B,) + tuple(batch["x"].shape[1:-1]) + (cfg.latent_dim,),
                            generator=g)
        fresh = torch.Generator().manual_seed(5).get_state()
        seen.update(rows=B, seeded=torch.equal(generator.get_state(), fresh),
                    ref=want(params, cfg, batch, eps_w, eps_z))
        out = real(params, cfg, batch, generator)
        seen["out"] = out
        return out

    monkeypatch.setattr(cli, name, spy)
    cli.train(args)
    assert seen["rows"] == 100 and seen["seeded"]
    for layer, leaves in seen["ref"].items():
        for leaf, v in leaves.items():
            torch.testing.assert_close(seen["out"][layer][leaf], v, rtol=0, atol=0)
