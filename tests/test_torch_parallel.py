"""Data parallelism in the port (``classifying_vae_lstm_tpu_torch/parallel``)
against its single-device paths and against the JAX package's DP on its
8-device CPU mesh (``tests/conftest.py``).

Training runs one process a device: here gloo worlds of 2 and 4 ranks on
the CPU (``torch.multiprocessing.spawn``, a ``FileStore`` in ``tmp_path``;
the rank programs are in ``tests/torch_dp_ranks.py``), each rank pinned to
one intra-op thread. Tolerances, JAX ``tests/test_parallel.py``'s: losses
rtol 1e-5, parameters rtol 1e-4 / atol 1e-6 (the DP epoch differs from the
single-device one only in the order of the gradient mean). Generation,
evaluation and serving run in one process over a four-way CPU mesh and equal
the single-device calls exactly, and JAX's ``_dp`` functions fed the same
noise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.models import cl_vrnn as jvrnn
from classifying_vae_lstm_tpu.optim import init_optimizer as jinit_optimizer
from classifying_vae_lstm_tpu.parallel import make_mesh as jmake_mesh
from classifying_vae_lstm_tpu.sampling import generate as jgen
from classifying_vae_lstm_tpu.train import Trainer as JTrainer
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.evaluation import nll as tnll
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tvrnn
from classifying_vae_lstm_tpu_torch.parallel import (
    make_mesh,
    param_sharding_rules,
    replicate,
    shard_batch,
    shard_opt_state,
    shard_params,
    shard_training_state,
)
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.serving import GenerationEngine
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_Cs.pickle"
B, N = 8, 32  # batch and rows of the training epochs: 4 steps


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _spec(family, seed=0):
    """A job of torch_dp_ranks: a small config, Keras-initialised weights
    (the port's init, as NumPy: both packages take them) and seeded data of
    N rows."""
    rng = np.random.default_rng(seed)
    if family == "cl_vae":
        jcfg = jvae.Config(original_dim=12, intermediate_dim=16, latent_dim=2,
                           intermediate_class_dim=8, n_classes=4)
        x = (rng.random((N, 12)) < 0.25).astype(np.float32)
        tmod = tvae
    else:
        jcfg = jvrnn.Config(original_dim=12, intermediate_dim=8, latent_dim=2, seq_length=4,
                            n_classes=3, use_x_prev=True)
        x = (rng.random((N, 4, 12)) < 0.25).astype(np.float32)
        tmod = tvrnn
    raw = tmod.init(torch.Generator().manual_seed(seed), tmod.Config(**dataclasses.asdict(jcfg)))
    w = np.eye(jcfg.n_classes, dtype=np.float32)[np.arange(N) % jcfg.n_classes]
    data = {"x": x, "y": x, "w": w}
    if family == "cl_vrnn":
        data["x_prev"] = np.roll(x, 1, axis=1)
    return {"family": family, "cfg": dataclasses.asdict(jcfg), "B": B, "seed": 7,
            "raw": ranks.to_numpy(raw), "data": data, "step_check": True}, jcfg


def _jax_fed(spec, jcfg, key, eval_key):
    """JAX's DP epoch at n_data=4 on its 8-device CPU mesh, and the draws it
    makes (``Trainer`` ``dp_train_epoch`` / ``dp_eval_epoch``: the
    permutation and each batch's ``draw_apply_noise``), for the port's ranks
    to take instead of their own."""
    mod = jvae if spec["family"] == "cl_vae" else jvrnn
    loss_fn = functools.partial(
        lambda c, p, b, k, klw, cw, wklw: mod.loss_and_metrics(p, c, b, k, klw, cw, wklw), jcfg)
    opt, _ = jinit_optimizer("adam-wn")
    trainer = JTrainer(loss_fn, opt, batch_size=B, mesh=jmake_mesh(n_data=4, n_model=1),
                       noise_fn=lambda k: mod.draw_apply_noise(k, jcfg, B))
    params = jax.tree.map(jnp.asarray, spec["raw"])
    data = {k: jnp.asarray(v) for k, v in spec["data"].items()}
    one = jnp.float32(1.0)
    p, _, m = trainer.train_epoch(params, trainer.optimizer.init(params), data, key, one, one,
                                  one)
    vm = trainer.eval_epoch(p, data, eval_key, one, one, one)
    kperm, kstep = jax.random.split(key)
    np_noise = lambda keys: [jax.tree.map(np.asarray, mod.draw_apply_noise(k, jcfg, B))
                             for k in keys]
    spec["fed"] = {"perm": np.asarray(jax.random.permutation(kperm, N), dtype=np.int64),
                   "noise": np_noise(jax.random.split(kstep, N // B)),
                   "eval_noise": np_noise(jax.random.split(eval_key, N // B))}
    return (jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()},
            {k: float(v) for k, v in vm.items()})


def _epochs_close(got, want):
    params, m, vm = got
    for k in want[1]:
        np.testing.assert_allclose(m[k], want[1][k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(vm[k], want[2][k], rtol=1e-5, atol=1e-7, err_msg=f"val_{k}")
    ranks.tree_close(params, want[0], rtol=1e-4, atol=1e-6)


def test_mesh_shapes_and_sharding_rules():
    mesh = make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.axis_names == ("data", "model")
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="need 3x2 devices, have 4"):
        make_mesh(3, 2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()
    params = {"h": {"kernel": torch.ones(3, 4), "bias": torch.zeros(4)}}
    assert param_sharding_rules(params, _cpu_mesh(2)) == {
        "h": {"kernel": "replicated", "bias": "replicated"}}
    # n_model 2: the kernel column-sharded over each row's two devices
    assert param_sharding_rules(params, mesh) == {
        "h": {"kernel": (None, "model"), "bias": "replicated"}}
    placed = shard_params(params, mesh)
    kernel = placed[0]["h"]["kernel"]
    assert len(placed) == 4 and kernel.widths == [2, 2] and kernel.devices == [
        torch.device("cpu")] * 2 and placed[0]["h"]["bias"] is params["h"]["bias"]
    assert torch.equal(kernel.gather(), params["h"]["kernel"])
    state = shard_opt_state([torch.ones(2), torch.ones(3, 4), torch.ones(3, 3)], mesh)[0]
    assert [type(leaf).__name__ for leaf in state] == ["Tensor", "ColumnShards", "Tensor"]
    assert param_sharding_rules(params, mesh, shard_model_axis=False)["h"]["bias"] == "replicated"
    # a repeated device gets one replica, which its shards share
    reps = shard_params(params, _cpu_mesh(4))
    assert len(reps) == 4 and all(r["h"]["kernel"] is reps[0]["h"]["kernel"] for r in reps)
    assert replicate(params, _cpu_mesh(2))[1]["h"]["bias"] is params["h"]["bias"]
    data = {"x": torch.arange(12.0).view(6, 2), "y": torch.arange(6)}
    shards = shard_batch(_cpu_mesh(3), data)
    assert [s["y"].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="batch 6 not divisible by data axis 4"):
        shard_batch(_cpu_mesh(4), data)
    p, tr, va = shard_training_state(_cpu_mesh(2), params, data, data)
    assert len(p) == len(tr) == len(va) == 2 and tr[1]["y"].tolist() == [3, 4, 5]


def test_trainer_and_cli_dp_guards(tmp_path):
    """Every error of ``make_dp_mesh`` and of the Trainer's mesh path."""
    mk = lambda *argv: cl_vae_train.build_parser().parse_args(
        ["r", "--device", "cpu", "--model_dir", str(tmp_path), *argv])
    n = tcommon.dp_device_count(torch.device("cpu"))
    draw = tvae.draw_apply_noise
    assert tcommon.make_dp_mesh(mk(), None, draw) == (None, None)
    with pytest.raises(ValueError, match=f"--dp {n + 1}: only {n} devices available"):
        tcommon.make_dp_mesh(mk("--dp", str(n + 1)), None, draw)
    with pytest.raises(ValueError, match="--dp 2 must divide --batch_size 101"):
        tcommon.make_dp_mesh(mk("--dp", "2", "--batch_size", "101"), None, draw)
    with pytest.raises(ValueError, match="--dp does not combine with --streaming"):
        tcommon.make_dp_mesh(mk("--dp", "2", "--streaming"), None, draw)
    cfg = tvae.Config(original_dim=12, intermediate_dim=16, latent_dim=2,
                      intermediate_class_dim=8, n_classes=4)
    mesh, noise_fn = tcommon.make_dp_mesh(mk("--dp", "2"), cfg, draw)
    assert mesh.shape == {"data": 2, "model": 1} and mesh.data_devices[1].type == "cpu"
    assert noise_fn(torch.Generator().manual_seed(0))["eps_z"].shape == (100, 2)
    from classifying_vae_lstm_tpu_torch.train import Trainer

    with pytest.raises(ValueError, match="--dp 2 must divide batch_size 7"):
        Trainer(None, None, 7, mesh=mesh, noise_fn=noise_fn)
    with pytest.raises(ValueError, match="draw_apply_noise"):
        Trainer(None, None, 8, mesh=mesh)


def test_dp_epochs_in_a_gloo_world_of_4_match_single_device_and_jax(tmp_path):
    """A cl_vae and a cl_vrnn epoch (4 steps) and their validation passes in
    a gloo world of 4 ranks equal the port's single-device epoch (the same
    generator) and, fed the JAX package's draws, JAX's DP epoch at
    n_data=4; ``make_shard_map_train_step`` on each rank's quarter of a
    batch equals the single-device step on the whole batch. (A world of 2:
    :func:`test_train_cli_dp_2_on_the_cpu`.)"""
    specs, jax_epochs = {}, {}
    for i, family in enumerate(("cl_vae", "cl_vrnn")):
        spec, jcfg = _spec(family, seed=i)
        specs[family] = spec
        jax_epochs[family] = _jax_fed(spec, jcfg, jax.random.PRNGKey(11 + i),
                                      jax.random.PRNGKey(21 + i))
    got4 = ranks.run_world(4, specs, str(tmp_path))
    for family, spec in specs.items():
        want = ranks.single_epoch(spec)
        assert want[1]["loss"] < 1e3 and np.isfinite(want[1]["loss"])
        _epochs_close(got4[family]["epoch"], want)
        _epochs_close(got4[family]["fed"], jax_epochs[family])
        step_params, step_m, folded = got4[family]["step"]
        ref_params, ref_m = ranks.single_step(spec)
        np.testing.assert_allclose(step_m["loss"], ref_m["loss"], rtol=1e-5)
        ranks.tree_close(step_params, ref_params, rtol=1e-4, atol=1e-6)
        assert np.isfinite(folded["folded_loss"]) and len(set(folded["rank_sums"])) == 1


def _gen_setup(family, B=8, nsteps=6, seed=0):
    rng = np.random.default_rng(seed)
    if family == "cl_vrnn":
        jcfg = jvrnn.Config(original_dim=12, intermediate_dim=16, latent_dim=3, seq_length=4,
                            n_classes=3, use_x_prev=True)
        raw = jax.tree.map(np.asarray, jvrnn.init(jax.random.PRNGKey(seed), jcfg))
        seeds = (rng.random((B, 5, 12)) < 0.3).astype(np.float32)
        tcfg = tvrnn.Config(**dataclasses.asdict(jcfg))
    else:
        jcfg = jvae.Config(original_dim=12, intermediate_dim=16, latent_dim=3,
                           intermediate_class_dim=8, n_classes=3, use_x_prev=True)
        raw = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(seed), jcfg))
        seeds = (rng.random((B, 12)) < 0.3).astype(np.float32)
        tcfg = tvae.Config(**dataclasses.asdict(jcfg))
    ws = np.eye(3, dtype=np.float32)[np.arange(B) % 3]
    return jcfg, tcfg, raw, seeds, ws, nsteps


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
def test_dp_generation_matches_single_device_and_jax(family, monkeypatch):
    """``generate_*_batch_dp`` on a four-way CPU mesh equals the
    single-device sampler for the same generator (the noise drawn for all
    songs, split with them), with given and (cl_vae) inferred keys; fed the
    noise JAX's ``_dp`` function draws, it equals that function on JAX's
    mesh at n_data=4."""
    jcfg, tcfg, raw, seeds, ws, nsteps = _gen_setup(family)
    mesh = _cpu_mesh(4)
    tp, ts, tws = params_from_numpy(raw, "cpu"), torch.from_numpy(seeds), torch.from_numpy(ws)
    g = lambda: torch.Generator().manual_seed(5)
    if family == "cl_vrnn":
        dp = tgen.generate_cl_vrnn_batch_dp(tp, tcfg, ts, nsteps, g(), tws, mesh)
        one = tgen.generate_cl_vrnn_batch(tp, tcfg, ts, nsteps, g(), tws)
    else:
        dp = tgen.generate_cl_vae_batch_dp(tp, tcfg, ts, nsteps, g(), tws, mesh)
        one = tgen.generate_cl_vae_batch(tp, tcfg, ts, nsteps, g(), w_vals=tws)
        inferred = tgen.generate_cl_vae_batch_dp(replicate(tp, mesh), tcfg, ts, nsteps, g(),
                                                 None, mesh)
        assert torch.equal(inferred, tgen.generate_cl_vae_batch(tp, tcfg, ts, nsteps, g()))
    assert dp.shape == (8, nsteps, 12) and torch.equal(dp, one)
    dp_fn = tgen.generate_cl_vrnn_batch_dp if family == "cl_vrnn" else tgen.generate_cl_vae_batch_dp
    with pytest.raises(ValueError, match="batch 8 not divisible by data axis 3"):
        dp_fn(tp, tcfg, ts, nsteps, g(), tws, _cpu_mesh(3))
    # JAX's _dp sampler on its mesh, and the port's fed the same draws
    key = jax.random.PRNGKey(3)
    total = nsteps + (seeds.shape[1] if family == "cl_vrnn" else 0)
    eps, u = (np.array(a) for a in jgen.draw_generation_noise(key, 8, total, 3, 12))
    monkeypatch.setattr(tgen, "draw_generation_noise",
                        lambda *a, **k: (torch.from_numpy(eps), torch.from_numpy(u)))
    jmesh = jmake_mesh(n_data=4, n_model=1)
    if family == "cl_vrnn":
        want = jgen.generate_cl_vrnn_batch_dp(raw, jcfg, seeds, nsteps, key, ws, jmesh)
        got = tgen.generate_cl_vrnn_batch_dp(tp, tcfg, ts, nsteps, g(), tws, mesh)
    else:
        want = jgen.generate_cl_vae_batch_dp(raw, jcfg, seeds, nsteps, key, ws, jmesh)
        got = tgen.generate_cl_vae_batch_dp(tp, tcfg, ts, nsteps, g(), tws, mesh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
def test_dp_nll_matches_single_device_and_jax(family, monkeypatch):
    """``iw_nll_dataset_dp`` on a four-way CPU mesh: ``iw_nll_dataset``'s
    numbers for the same generator (the last batch padded and trimmed) and,
    fed JAX's per-batch draws, JAX's ``iw_nll_dataset_dp`` on its mesh at
    n_data=4. The model's outputs of a shard's rows are bitwise the
    single-device call's; the log-densities after them may differ in the
    last bit, since torch's vectorised ``exp`` / ``log`` on the CPU take a
    scalar path for the tail of a tensor, whose length the shard sets."""
    from classifying_vae_lstm_tpu.evaluation import nll as jnll

    jcfg, tcfg, raw, seeds, ws, _ = _gen_setup(family, B=22)
    x = seeds if family == "cl_vae" else seeds[:, :4]
    data = {"x": x, "y": x, "x_prev": np.roll(x, 1, axis=1 if family == "cl_vrnn" else 0)}
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tp, mesh = params_from_numpy(raw, "cpu"), _cpu_mesh(4)
    g = lambda: torch.Generator().manual_seed(9)
    dp = tnll.iw_nll_dataset_dp(tp, tcfg, tdata, g(), 5, 8, family, mesh)
    one = tnll.iw_nll_dataset(tp, tcfg, tdata, g(), 5, 8, family)
    assert dp.shape == (22,)
    torch.testing.assert_close(dp, one, rtol=1e-6, atol=0)
    # JAX: each batch's key split into its draws; fed to the port's estimator
    key, nb = jax.random.PRNGKey(4), 3
    want = jnll.iw_nll_dataset_dp(raw, jcfg, {k: jnp.asarray(v) for k, v in data.items()}, key,
                                  5, 8, family, jmake_mesh(n_data=4, n_model=1))
    draws = []  # per batch key: split(kb, S), then per sample ku, kz = split(k)
    z_shape = (8,) + (() if family == "cl_vae" else (4,)) + (3,)
    for kb in jax.random.split(key, nb):
        pairs = [jax.random.split(k) for k in jax.random.split(kb, 5)]
        draws.append(tuple(torch.from_numpy(np.stack([np.asarray(jax.random.normal(p[i], shp))
                                                       for p in pairs]))
                           for i, shp in ((0, (8, 2)), (1, z_shape))))
    monkeypatch.setattr(tnll, "_draw_batch_noise", lambda *a: draws.pop(0))
    got = tnll.iw_nll_dataset_dp(tp, tcfg, tdata, g(), 5, 8, family, mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_engine_with_a_mesh():
    """The serving engine over a four-way CPU mesh: a request whose bucket
    divides by the data axis (4 songs) splits over it, one that does not
    (1 song) runs single-device, both equal to an engine without a mesh fed
    the same seed; a data axis that divides no batch bucket raises."""
    jcfg, tcfg, raw, seeds, ws, nsteps = _gen_setup("cl_vrnn")
    calls = []
    dp_fn = tgen.generate_cl_vrnn_batch_dp

    def counted(*a, **k):
        calls.append(a[2].shape[0])
        return dp_fn(*a, **k)

    from classifying_vae_lstm_tpu_torch.serving import engine as tengine

    tengine.generate_cl_vrnn_batch_dp = counted
    try:
        with_mesh = GenerationEngine(raw, tcfg, seeds, device="cpu", seed=3, mesh=_cpu_mesh(4))
        plain = GenerationEngine(raw, tcfg, seeds, device="cpu", seed=3)
        for n in (4, 1, 3):
            np.testing.assert_array_equal(with_mesh.generate(n=n, nsteps=nsteps),
                                          plain.generate(n=n, nsteps=nsteps))
    finally:
        tengine.generate_cl_vrnn_batch_dp = dp_fn
    assert calls == [4, 4]  # 4 songs, and 3 padded to the bucket of 4; 1 alone
    assert with_mesh.device.type == "cpu" and len(with_mesh._replicas) == 4
    with pytest.raises(ValueError, match="dp=3 divides no batch bucket"):
        GenerationEngine(raw, tcfg, seeds, device="cpu", mesh=_cpu_mesh(3))
    jcfg, vcfg, vraw, vseeds, _, _ = _gen_setup("cl_vae")
    eng = GenerationEngine(vraw, vcfg, vseeds, device="cpu", seed=1, mesh=_cpu_mesh(2))
    ref = GenerationEngine(vraw, vcfg, vseeds, device="cpu", seed=1)
    np.testing.assert_array_equal(eng.generate(n=4, nsteps=8), ref.generate(n=4, nsteps=8))


@pytest.mark.parametrize("family", ["cl_vae", "cl_vrnn"])
def test_train_cli_dp_2_on_the_cpu(family, tmp_path, capfd):
    """``cl_*_train --dp 2 --device cpu`` end to end: two gloo ranks train 2
    epochs of the committed corpus and give the single-device run's losses
    and best parameters; rank 0 alone prints and writes the checkpoint
    triple, its args.json recording dp."""
    cli = cl_vae_train if family == "cl_vae" else cl_vrnn_train
    flags = ["--device", "cpu", "--train_file", CORPUS, "--batch_size", "1000",
             "--num_epochs", "2", "--patience", "0", "--latent_dim", "2",
             "--model_dir", str(tmp_path)]
    flags += (["--intermediate_dim", "16", "--intermediate_class_dim", "8"] if family == "cl_vae"
              else ["--intermediate_dim", "8", "--seq_length", "4", "--use_x_prev"])
    one_params, one_loss = cli.train(cli.build_parser().parse_args(["one", *flags]))
    capfd.readouterr()
    dp_params, dp_loss = cli.train(cli.build_parser().parse_args(["two", *flags, "--dp", "2"]))
    out = capfd.readouterr().out
    assert out.count("epoch 2/2") == 1 and "data-parallel training over 2 devices" in out
    for k, v in one_loss.items():
        np.testing.assert_allclose(dp_loss[k], v, rtol=1e-5, err_msg=k)
    ranks.tree_close(ranks.to_numpy(dp_params), ranks.to_numpy(one_params), rtol=1e-4,
                     atol=1e-6)
    import json

    assert json.load(open(tmp_path / "two.json"))["dp"] == 2
    assert all((tmp_path / f"two.{ext}").exists() for ext in ("json", "yaml", "npz"))
    assert not list(tmp_path.glob(".two.*"))  # the store and the result are gone
