"""Tensor parallelism in the port (``classifying_vae_lstm_tpu_torch/parallel``:
column shards over a mesh's ``model`` axis) against its replicated paths
and against the JAX package's TP on its 8-device CPU mesh
(``tests/conftest.py``).

The port keeps the model axis inside one process: a ``(1, n_model)`` mesh
of the CPU repeated stands in for n_model devices. The JAX package's draws
(each epoch's permutation and each step's ``draw_apply_noise``; the IW-NLL's
per-batch noise) are fed to the port where it is compared with JAX, within
JAX ``tests/test_parallel.py``'s own bounds (losses rtol 1e-4, parameters
rtol 1e-3 / atol 1e-5, NLLs rtol 1e-5 / atol 1e-6). Against the port's
replicated runs on the same generator the bound is tighter: losses rtol
1e-6, parameters rtol 1e-5 / atol 1e-6. Not bitwise: on the CPU torch sums
a column slice's rows in another order than the whole tensor's where the
slice's width is not a multiple of the vector width (AdamWN's per-column
norms, :func:`test_adamwn_column_norms_on_slices`). Generation takes the
weights gathered, so it is bitwise the replicated call.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from classifying_vae_lstm_tpu.evaluation import nll as jnll
from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.models import cl_vrnn as jvrnn
from classifying_vae_lstm_tpu.optim import init_optimizer as jinit_optimizer
from classifying_vae_lstm_tpu.parallel import make_mesh as jmake_mesh
from classifying_vae_lstm_tpu.parallel import param_sharding_rules as jrules
from classifying_vae_lstm_tpu.parallel import shard_params as jshard_params
from classifying_vae_lstm_tpu.parallel import shard_training_state as jshard_training_state
from classifying_vae_lstm_tpu.parallel.mesh import shard_opt_state as jshard_opt_state
from classifying_vae_lstm_tpu.train import Trainer as JTrainer
from classifying_vae_lstm_tpu_torch.cli.common import tree_to_cpu
from classifying_vae_lstm_tpu_torch.evaluation import nll as tnll
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tvrnn
from classifying_vae_lstm_tpu_torch.optim import init_optimizer
from classifying_vae_lstm_tpu_torch.optim.adamwn import _split_wn_grads
from classifying_vae_lstm_tpu_torch.parallel import (
    ColumnShards,
    columns,
    make_mesh,
    param_sharding_rules,
    shard_opt_state,
    shard_params,
)
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.train import Trainer, checkpoint as tckpt, fit
from classifying_vae_lstm_tpu_torch.train.loop import copy_params
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy, params_on_model_axis

JAX_LOSS = dict(rtol=1e-4)
JAX_PARAMS = dict(rtol=1e-3, atol=1e-5)
PORT_LOSS = dict(rtol=1e-6, atol=0)
PORT_PARAMS = dict(rtol=1e-5, atol=1e-6)
ONE = 1.0


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vae_setup(n=160, n_classes=4):
    """JAX ``tests/test_parallel.py``'s ``_setup``: its config, weights and
    data, as NumPy."""
    jcfg = jvae.Config(original_dim=16, intermediate_dim=16, latent_dim=2,
                       intermediate_class_dim=8, n_classes=n_classes)
    raw = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(0), jcfg))
    x = np.array((jax.random.uniform(jax.random.PRNGKey(1), (n, 16)) < 0.25)
                 .astype(jnp.float32))
    w = np.eye(n_classes, dtype=np.float32)[np.arange(n) % n_classes]
    return jcfg, raw, {"x": x, "y": x, "w": w}


def _vrnn_setup(n=32, seed=0, **kw):
    jcfg = jvrnn.Config(original_dim=12, intermediate_dim=16, latent_dim=2, seq_length=4,
                        n_classes=4, use_x_prev=True, **kw)
    raw = jax.tree.map(np.asarray, jvrnn.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 4, 12)) < 0.25).astype(np.float32)
    w = np.eye(4, dtype=np.float32)[np.arange(n) % 4]
    return jcfg, raw, {"x": x, "y": x, "w": w, "x_prev": np.roll(x, 1, axis=1)}


def _jmod(jcfg):
    return jvae if isinstance(jcfg, jvae.Config) else jvrnn


def _tmod(jcfg):
    return tvae if isinstance(jcfg, jvae.Config) else tvrnn


def _tcfg(jcfg):
    return _tmod(jcfg).Config(**dataclasses.asdict(jcfg))


def _jax_tp_epoch(jcfg, raw, data, key, B, n_data, n_model):
    """JAX's train_epoch on params and data placed on an ``n_data x n_model``
    mesh (``shard_training_state``), and the draws it makes."""
    mod = _jmod(jcfg)
    loss_fn = functools.partial(
        lambda c, p, b, k, klw, cw, wklw: mod.loss_and_metrics(p, c, b, k, klw, cw, wklw), jcfg)
    opt, _ = jinit_optimizer("adam-wn")
    trainer = JTrainer(loss_fn, opt, batch_size=B)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params, sh_data, _ = jshard_training_state(jmake_mesh(n_data=n_data, n_model=n_model),
                                               jax.tree.map(jnp.asarray, raw), jdata, jdata)
    one = jnp.float32(1.0)
    p, _, m = trainer.train_epoch(params, trainer.optimizer.init(params), sh_data, key, one,
                                  one, one)
    n = data["x"].shape[0]
    kperm, kstep = jax.random.split(key)
    fed = {"perm": np.asarray(jax.random.permutation(kperm, n), dtype=np.int64),
           "noise": [jax.tree.map(np.array, mod.draw_apply_noise(k, jcfg, B))
                     for k in jax.random.split(kstep, n // B)]}
    return jax.tree.map(np.asarray, p), float(m["loss"]), fed


def _port_epoch(jcfg, params, data, B, generator=None, fed=None, monkeypatch=None):
    """The port's single-process train epoch (then a validation pass) on
    ``params`` (replicated or column-sharded): its draws from ``generator``,
    or the permutation and noise of ``fed``. Returns (params on the CPU,
    train loss, validation loss, optimizer, params)."""
    mod, cfg = _tmod(jcfg), _tcfg(jcfg)
    queue = [] if fed is None else [{k: torch.from_numpy(v) for k, v in n.items()}
                                    for n in fed["noise"]]

    def loss_fn(p, b, g, kl_w, class_w, w_kl_w):
        b = {**b, **queue.pop(0)} if queue else b
        return mod.loss_and_metrics(p, cfg, b, g, kl_w, class_w, w_kl_w)

    trainer = Trainer(loss_fn, init_optimizer("adam-wn")[0], B)
    params = copy_params(params, requires_grad=True)
    opt = trainer.init_optimizer(params)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    if fed is not None:
        monkeypatch.setattr(torch, "randperm",
                            lambda n, generator=None, device=None: torch.from_numpy(fed["perm"]))
        generator = torch.Generator().manual_seed(0)
    m = trainer.train_epoch(params, opt, tdata, generator, ONE, ONE, ONE)
    if fed is not None:
        monkeypatch.undo()
        return tree_to_cpu(params), float(m["loss"]), None, opt, params
    vm = trainer.eval_epoch(params, tdata, generator, ONE, ONE, ONE)
    return tree_to_cpu(params), float(m["loss"]), float(vm["loss"]), opt, params


def _close(got, want, rtol, atol):
    ranks.tree_close(ranks.to_numpy(got), ranks.to_numpy(want), rtol=rtol, atol=atol)


def _tp(raw, n_model):
    return params_on_model_axis(raw, ["cpu"] * n_model)


def placement(tree):
    """Each leaf's placement read off a placed tree (a dict tree or a list),
    as JAX's ``PartitionSpec`` spells it."""
    if isinstance(tree, dict):
        return {k: placement(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [placement(v) for v in tree]
    if isinstance(tree, ColumnShards):
        return (None,) * (tree.ndim - 1) + ("model",)
    return "replicated"


@pytest.mark.parametrize("family", ["cl_vae", "cl_vrnn"])
def test_placement_matches_jax_on_a_4x2_mesh(family):
    """Every parameter's and every AdamWN state leaf's placement equals the
    ``PartitionSpec`` JAX gives it on a 4 x 2 mesh; a repeated row of
    devices holds one placed copy, its slices leaves on their devices."""
    jcfg, raw, _ = _vae_setup() if family == "cl_vae" else _vrnn_setup()
    jmesh, mesh = jmake_mesh(n_data=4, n_model=2), make_mesh(4, 2, devices=["cpu"] * 8)
    spec = lambda s: "replicated" if tuple(s.spec) == () else tuple(s.spec)
    want = jax.tree.map(spec, jrules(raw, jmesh))
    placed = shard_params(params_from_numpy(raw, "cpu"), mesh)
    assert param_sharding_rules(placed[0], mesh) == want == placement(placed[0])
    assert len(placed) == 4 and all(p is placed[0] for p in placed)
    sharded = [leaf for layer in placed[0].values() for leaf in layer.values()
               if isinstance(leaf, ColumnShards)]
    assert sharded and all(len(s.slices) == 2 and all(t.is_leaf for t in s.slices)
                           for s in sharded)
    kernel = placed[0]["h_w" if family == "cl_vae" else "encoder_h"]["kernel"]
    whole = raw["h_w" if family == "cl_vae" else "encoder_h"]["kernel"]
    np.testing.assert_array_equal(kernel.slices[1].numpy(), whole[:, whole.shape[1] // 2:])
    # the optimizer state: JAX's shard_opt_state of AdamWN's state, and the
    # port's of its state leaves (the .opt.npz layout) from a TP optimizer
    jopt, _ = jinit_optimizer("adam-wn")
    jstate = jshard_opt_state(jopt.init(jax.tree.map(jnp.asarray, raw)), jmesh)
    jleaves = jax.tree.leaves(jstate)
    tp = copy_params(_tp(raw, 2), requires_grad=True)
    opt = Trainer(None, init_optimizer("adam-wn")[0], 8).init_optimizer(tp)
    leaves = opt.state_leaves(tckpt.sorted_leaves(tp))
    assert [a.shape for a in leaves] == [a.shape for a in jleaves]
    assert placement(shard_opt_state(leaves, mesh)[0]) == [spec(a.sharding) for a in jleaves]
    assert param_sharding_rules(placed[0], mesh, shard_model_axis=False) == jax.tree.map(
        spec, jrules(raw, jmesh, shard_model_axis=False))


def test_adamwn_column_norms_on_slices():
    """What bounds the TP-against-replicated comparison: AdamWN's per-column
    reductions on a contiguous column slice equal the whole tensor's
    columns bit for bit where the slice's width is a multiple of 8 (and
    then the update is bitwise), and within an ulp-level bound otherwise."""
    g = torch.Generator().manual_seed(0)
    for (rows, cols), bitwise in (((16, 16), True), ((12, 64), True), ((100, 1024), True),
                                  ((88, 88), False), ((16, 48), False)):
        p, gr = torch.randn(rows, cols, generator=g), torch.randn(rows, cols, generator=g)
        sc = torch.rand(cols, generator=g) + 0.5
        whole = _split_wn_grads(p, gr, sc)
        h = cols // 2
        parts = [_split_wn_grads(p[:, a:a + h].contiguous(), gr[:, a:a + h].contiguous(),
                                 sc[a:a + h]) for a in (0, h)]
        for i in range(5):
            cat = torch.cat([parts[0][i], parts[1][i]], -1)
            torch.testing.assert_close(cat, whole[i], rtol=1e-6, atol=1e-6)
            if bitwise:
                assert torch.equal(cat, whole[i]), ((rows, cols), i)


def test_cl_vae_tp_epoch_matches_jax_and_single_device(monkeypatch):
    """JAX ``test_tensor_parallel_epoch_matches_single_device``'s problem: the
    port's TP epoch on a (1, 2) CPU mesh, fed JAX's draws, equals JAX's
    4 x 2 TP epoch; on its own draws it equals the port's single-device
    epoch (and its validation pass), its products split over the slices."""
    jcfg, raw, data = _vae_setup()
    p_jax, loss_jax, fed = _jax_tp_epoch(jcfg, raw, data, jax.random.PRNGKey(7), 40, 4, 2)
    tp = _tp(raw, 2)
    assert isinstance(tp["h_w"]["kernel"], ColumnShards)
    p_fed, loss_fed, _, _, _ = _port_epoch(jcfg, tp, data, 40, fed=fed, monkeypatch=monkeypatch)
    np.testing.assert_allclose(loss_fed, loss_jax, **JAX_LOSS)
    _close(p_fed, p_jax, **JAX_PARAMS)
    columns.SHARD_PRODUCTS = 0
    got = _port_epoch(jcfg, tp, data, 40, torch.Generator().manual_seed(7))
    assert columns.SHARD_PRODUCTS > 0
    want = _port_epoch(jcfg, params_from_numpy(raw, "cpu"), data, 40,
                       torch.Generator().manual_seed(7))
    np.testing.assert_allclose(got[1:3], want[1:3], **PORT_LOSS)
    _close(got[0], want[0], **PORT_PARAMS)


@pytest.mark.parametrize("route,n_model", [("xla", 2), ("xla", 4), ("pallas", 2),
                                           ("pallas", 4), ("pallas_off", 2)])
def test_cl_vrnn_tp_steps_match_single_device_and_jax(route, n_model, monkeypatch):
    """Four cl_vrnn steps (H=16, T=4) with the parameters column-sharded
    over 2 and 4 model devices: on ``xla`` every product runs slice by slice
    (the shard-product counter), on ``pallas`` the two-cell kernel
    (``pallas_off``: the whole-sequence LSTM kernels) take the weights
    gathered and only the heads' products are split. Equal to the port's
    single-device steps and, fed JAX's draws, to JAX's TP epoch on a
    (8 / n_model) x n_model mesh (its xla route: the routes compute one
    function)."""
    kw = {"lstm_backend": "xla" if route == "xla" else "pallas"}
    if route == "pallas_off":
        kw["two_cell"] = False
    jcfg, raw, data = _vrnn_setup(**kw)
    tp = _tp(raw, n_model)
    columns.SHARD_PRODUCTS = 0
    got = _port_epoch(jcfg, tp, data, 8, torch.Generator().manual_seed(3))
    # xla: every cell step's products (z's and h's) and the heads, per slice
    assert columns.SHARD_PRODUCTS >= (4 * 4 * 4 * n_model if route == "xla" else 4 * n_model)
    want = _port_epoch(jcfg, params_from_numpy(raw, "cpu"), data, 8,
                       torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got[1:3], want[1:3], **PORT_LOSS)
    _close(got[0], want[0], **PORT_PARAMS)
    jx = dataclasses.replace(jcfg, lstm_backend="xla", two_cell=None)
    p_jax, loss_jax, fed = _jax_tp_epoch(jx, raw, data, jax.random.PRNGKey(5), 8,
                                         8 // n_model, n_model)
    p_fed, loss_fed, _, _, _ = _port_epoch(jcfg, tp, data, 8, fed=fed, monkeypatch=monkeypatch)
    np.testing.assert_allclose(loss_fed, loss_jax, **JAX_LOSS)
    _close(p_fed, p_jax, **JAX_PARAMS)


def _jax_nll_draws(key, nb, S, B, K1, z_shape):
    """JAX ``iw_nll_dataset``'s per-batch draws: split(key, nb), then per
    batch split(kb, S) and per sample (ku, kz) = split(k)."""
    draws = []
    for kb in jax.random.split(key, nb):
        pairs = [jax.random.split(k) for k in jax.random.split(kb, S)]
        draws.append(tuple(torch.from_numpy(np.stack([np.asarray(jax.random.normal(p[i], shp))
                                                      for p in pairs]))
                           for i, shp in ((0, (B, K1)), (1, z_shape))))
    return draws


def test_tp_nll_matches_jax_and_replicated(monkeypatch):
    """JAX ``test_tensor_parallel_nll_matches_replicated``'s problem: the
    port's IW-NLL on TP parameters, fed JAX's draws, equals JAX's TP
    IW-NLL on a 4 x 2 mesh per window; on its own generator it equals the
    port's replicated IW-NLL, and a cl_vrnn's on the whole-sequence
    inference kernel's plain version (weights gathered) too."""
    jcfg, raw, _ = _vae_setup()
    x = np.array((jax.random.uniform(jax.random.PRNGKey(1), (32, 16)) < 0.25)
                 .astype(jnp.float32))
    key = jax.random.PRNGKey(9)
    want = jnll.iw_nll_dataset(jshard_params(jax.tree.map(jnp.asarray, raw),
                                             jmake_mesh(n_data=4, n_model=2)),
                               jcfg, {"x": jnp.asarray(x), "y": jnp.asarray(x)}, key,
                               n_samples=8, batch_size=16, family="cl_vae")
    tcfg, tdata, tp = _tcfg(jcfg), {"x": torch.from_numpy(x), "y": torch.from_numpy(x)}, _tp(
        raw, 2)
    g = lambda: torch.Generator().manual_seed(9)
    columns.SHARD_PRODUCTS = 0
    got = tnll.iw_nll_dataset(tp, tcfg, tdata, g(), 8, 16, "cl_vae")
    assert columns.SHARD_PRODUCTS > 0
    one = tnll.iw_nll_dataset(params_from_numpy(raw, "cpu"), tcfg, tdata, g(), 8, 16, "cl_vae")
    torch.testing.assert_close(got, one, rtol=1e-6, atol=0)
    draws = _jax_nll_draws(key, 2, 8, 16, 3, (16, 2))
    monkeypatch.setattr(tnll, "_draw_batch_noise", lambda *a: draws.pop(0))
    fed = tnll.iw_nll_dataset(tp, tcfg, tdata, g(), 8, 16, "cl_vae")
    np.testing.assert_allclose(fed.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    monkeypatch.undo()
    vcfg, vraw, vdata = _vrnn_setup(n=10, lstm_backend="pallas")
    vt = {k: torch.from_numpy(v) for k, v in vdata.items() if k != "w"}
    got = tnll.iw_nll_dataset(_tp(vraw, 2), _tcfg(vcfg), vt, g(), 4, 8, "cl_vrnn")
    one = tnll.iw_nll_dataset(params_from_numpy(vraw, "cpu"), _tcfg(vcfg), vt, g(), 4, 8,
                              "cl_vrnn")
    torch.testing.assert_close(got, one, rtol=1e-6, atol=0)


def test_dp_x_tp_in_a_gloo_world_of_2_matches_jax_2x2(tmp_path):
    """A cl_vae and a cl_vrnn epoch in a gloo world of 2 ranks, each holding
    its parameters column-sharded over 2 model devices (``Trainer.place``
    on a 2 x 2 mesh): fed JAX's draws, JAX's DP epoch on its 2 x 2 mesh; on
    its own draws, the port's single-device epoch."""
    specs, jax_epochs = {}, {}
    for family, jcfg, raw, data in (("cl_vae", *_vae_setup(n=32)), ("cl_vrnn", *_vrnn_setup())):
        spec = {"family": family, "cfg": dataclasses.asdict(jcfg), "B": 8, "seed": 7,
                "raw": raw, "data": data, "n_model": 2}
        key, eval_key = jax.random.PRNGKey(11), jax.random.PRNGKey(21)
        mod = _jmod(jcfg)
        loss_fn = functools.partial(
            lambda c, p, b, k, klw, cw, wklw: mod.loss_and_metrics(p, c, b, k, klw, cw, wklw),
            jcfg)
        opt, _ = jinit_optimizer("adam-wn")
        jmesh = jmake_mesh(n_data=2, n_model=2)
        trainer = JTrainer(loss_fn, opt, batch_size=8, mesh=jmesh,
                           noise_fn=lambda k, mod=mod, jcfg=jcfg: mod.draw_apply_noise(k, jcfg, 8))
        params = jshard_params(jax.tree.map(jnp.asarray, raw), jmesh)
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        one = jnp.float32(1.0)
        p, _, m = trainer.train_epoch(params, trainer.optimizer.init(params), jdata, key, one,
                                      one, one)
        vm = trainer.eval_epoch(p, jdata, eval_key, one, one, one)
        kperm, kstep = jax.random.split(key)
        draw = lambda keys, mod=mod, jcfg=jcfg: [
            jax.tree.map(np.asarray, mod.draw_apply_noise(k, jcfg, 8)) for k in keys]
        spec["fed"] = {"perm": np.asarray(jax.random.permutation(kperm, 32), dtype=np.int64),
                       "noise": draw(jax.random.split(kstep, 4)),
                       "eval_noise": draw(jax.random.split(eval_key, 4))}
        specs[family] = spec
        jax_epochs[family] = (jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()},
                              {k: float(v) for k, v in vm.items()})
    got = ranks.run_world(2, specs, str(tmp_path))
    for family, spec in specs.items():
        want = ranks.single_epoch(spec)
        params, m, vm = got[family]["epoch"]
        for k in want[1]:
            np.testing.assert_allclose(m[k], want[1][k], rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(vm[k], want[2][k], rtol=1e-5, atol=1e-7, err_msg=k)
        ranks.tree_close(params, want[0], **PORT_PARAMS)
        params, m, vm = got[family]["fed"]
        jp, jm, jvm = jax_epochs[family]
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], **JAX_LOSS, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(vm[k], jvm[k], **JAX_LOSS, atol=1e-7, err_msg=k)
        ranks.tree_close(params, jp, **JAX_PARAMS)
        assert got[family]["placed"] == ["cpu", "cpu"]


def test_tp_checkpoint_is_the_replicated_one_and_resumes(tmp_path):
    """``save_checkpoint`` of TP parameters and their AdamWN state writes the
    whole arrays: the files equal those of the same state replicated, bit
    for bit, and the replicated run's within the TP bound; a replicated
    run's ``.last`` files resume on a (1, 2) mesh and continue as the
    replicated resume does."""
    jcfg, raw, data = _vrnn_setup()
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    cfg = _tcfg(jcfg)
    loss_fn = lambda p, b, g, a, c, d: tvrnn.loss_and_metrics(p, cfg, b, g, a, c, d)
    trainer = Trainer(loss_fn, init_optimizer("adam-wn")[0], 8)
    _, _, _, tp_opt, tp_params = _port_epoch(jcfg, _tp(raw, 2), data, 8,
                                             torch.Generator().manual_seed(1))
    _, _, _, one_opt, one_params = _port_epoch(jcfg, params_from_numpy(raw, "cpu"), data, 8,
                                               torch.Generator().manual_seed(1))
    tp_leaves = tp_opt.state_leaves(tckpt.sorted_leaves(tp_params))
    tckpt.save_checkpoint(str(tmp_path / "tp.npz"), tp_params, tp_leaves, 1)
    # the same state, replicated: the TP state loaded into a replicated optimizer
    gathered = copy_params(tree_to_cpu(tp_params), requires_grad=True)
    rep_opt = trainer.init_optimizer(gathered)
    rep_opt.load_state_leaves(tckpt.sorted_leaves(gathered), tp_leaves)
    tckpt.save_checkpoint(str(tmp_path / "rep.npz"), gathered,
                          rep_opt.state_leaves(tckpt.sorted_leaves(gathered)), 1)
    tckpt.save_checkpoint(str(tmp_path / "one.npz"), one_params,
                          one_opt.state_leaves(tckpt.sorted_leaves(one_params)), 1)
    for name in ("npz", "opt.npz"):
        with np.load(tmp_path / f"tp.{name}") as a, np.load(tmp_path / f"rep.{name}") as b, \
                np.load(tmp_path / f"one.{name}") as c:
            assert sorted(a.files) == sorted(b.files) == sorted(c.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                np.testing.assert_allclose(a[k], c[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # resume: the replicated run's files onto a (1, 2) mesh and replicated
    leaves, epoch = tckpt.load_opt_state(str(tmp_path / "one.opt.npz"))
    saved = tckpt.load_checkpoint(str(tmp_path / "one.npz"))
    runs = {}
    for name, params in (("tp", _tp(saved, 2)), ("one", params_from_numpy(saved, "cpu"))):
        _, _, history, _ = fit(trainer, params, tdata, tdata, 3, torch.Generator().manual_seed(4),
                               patience=0, verbose=False, opt_state=leaves, initial_epoch=epoch,
                               checkpoint_path=str(tmp_path / f"{name}_r.npz"), save_last=True)
        runs[name] = history
    np.testing.assert_allclose(runs["tp"]["loss"], runs["one"]["loss"], **PORT_LOSS)
    with np.load(tmp_path / "tp_r.last.npz") as a, np.load(tmp_path / "one_r.last.npz") as b:
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], **PORT_PARAMS, err_msg=k)
    with np.load(tmp_path / "tp_r.last.opt.npz") as a:
        assert int(a["__epoch__"]) == 3 and int(a["leaf_0"]) == 12  # 4 steps an epoch


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
def test_tp_generation_equals_replicated(family):
    """Both samplers on TP parameters (weights gathered once a call) give
    the replicated call's frames bit for bit; so does the DP sampler over a
    2 x 2 mesh, each shard's row holding its column slices."""
    if family == "cl_vrnn":
        jcfg, raw, _ = _vrnn_setup()
        seeds = torch.from_numpy((np.random.default_rng(1).random((8, 5, 12)) < 0.3)
                                 .astype(np.float32))
    else:
        jcfg = jvae.Config(original_dim=12, intermediate_dim=16, latent_dim=4,
                           intermediate_class_dim=8, n_classes=4, use_x_prev=True)
        raw = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(2), jcfg))
        seeds = torch.from_numpy((np.random.default_rng(1).random((8, 12)) < 0.3)
                                 .astype(np.float32))
    cfg, ws = _tcfg(jcfg), torch.eye(4)[torch.arange(8) % 4]
    g = lambda: torch.Generator().manual_seed(6)
    one, tp = params_from_numpy(raw, "cpu"), _tp(raw, 2)
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    if family == "cl_vrnn":
        want = tgen.generate_cl_vrnn_batch(one, cfg, seeds, 6, g(), ws)
        got = tgen.generate_cl_vrnn_batch(tp, cfg, seeds, 6, g(), ws)
        dp = tgen.generate_cl_vrnn_batch_dp(shard_params(one, mesh), cfg, seeds, 6, g(), ws,
                                            mesh)
    else:
        want = tgen.generate_cl_vae_batch(one, cfg, seeds, 6, g())
        got = tgen.generate_cl_vae_batch(tp, cfg, seeds, 6, g())
        dp = tgen.generate_cl_vae_batch_dp(shard_params(one, mesh), cfg, seeds, 6, g(), None,
                                           mesh)
    assert want.shape == (8, 6, 12) and torch.equal(got, want) and torch.equal(dp, want)
