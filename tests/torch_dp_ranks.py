"""Rank programs of ``tests/test_torch_parallel.py``: each runs in one
process of a gloo world on the CPU (``torch.multiprocessing.spawn``), so
this module imports the port and never JAX (the spawned processes import
it by name). The test process calls :func:`single_epoch` for the reference
and :func:`run_world` for the ranks. A spec with ``n_model`` > 1 (from
``tests/test_torch_tensor_parallel.py``) runs each rank tensor-parallel:
its parameters column-sharded over its row of a ``world x n_model`` mesh
of the CPU."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from classifying_vae_lstm_tpu_torch.models import cl_vae, cl_vrnn
from classifying_vae_lstm_tpu_torch.optim import init_optimizer
from classifying_vae_lstm_tpu_torch.parallel import (
    ColumnShards,
    make_mesh,
    make_shard_map_train_step,
)
from classifying_vae_lstm_tpu_torch.train import Trainer
from classifying_vae_lstm_tpu_torch.train.loop import copy_params
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

MODELS = {"cl_vae": cl_vae, "cl_vrnn": cl_vrnn}
ONE = 1.0


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, ColumnShards):
        return tree.numpy()
    if not torch.is_tensor(tree):
        return np.array(tree)
    return tree.detach().cpu().numpy().copy()


def _trainer(spec, mesh=None, noise_fn=None):
    """(Trainer, cfg, model module, params requiring grad) of a job spec:
    the family, its config's fields, NumPy weights and batch size."""
    mod = MODELS[spec["family"]]
    cfg = mod.Config(**spec["cfg"])

    def loss_fn(p, b, g, kl_w, class_w, w_kl_w):
        return mod.loss_and_metrics(p, cfg, b, g, kl_w, class_w, w_kl_w)

    opt, _ = init_optimizer("adam-wn")
    trainer = Trainer(loss_fn, opt, spec["B"], mesh=mesh, noise_fn=noise_fn)
    params = copy_params(trainer.place(params_from_numpy(spec["raw"], "cpu")),
                         requires_grad=True)
    return trainer, cfg, mod, params


def _data(spec):
    return {k: torch.from_numpy(v) for k, v in spec["data"].items()}


def _epoch(trainer, params, data, generator):
    """A training epoch then a validation pass over the same data, as
    (trained params, train metrics, validation metrics) in NumPy."""
    opt = trainer.init_optimizer(params)
    m = trainer.train_epoch(params, opt, data, generator, ONE, ONE, ONE)
    vm = trainer.eval_epoch(params, data, generator, ONE, ONE, ONE)
    return (to_numpy(params), {k: float(v) for k, v in m.items()},
            {k: float(v) for k, v in vm.items()})


def single_epoch(spec):
    """The single-device epoch of ``spec``, its draws from a generator
    seeded ``spec["seed"]``."""
    trainer, _, _, params = _trainer(spec)
    return _epoch(trainer, params, _data(spec), torch.Generator().manual_seed(spec["seed"]))


def single_step(spec):
    """One single-device step on the first B rows with the noise of a
    generator seeded ``spec["seed"] + 1`` (the reference of
    :func:`_step_check`)."""
    trainer, cfg, mod, params = _trainer(spec)
    B = spec["B"]
    noise = mod.draw_apply_noise(torch.Generator().manual_seed(spec["seed"] + 1), cfg, B)
    batch = {**{k: v[:B] for k, v in _data(spec).items()}, **noise}
    opt = trainer.init_optimizer(params)
    m = trainer.train_step(params, opt, batch, None, ONE, ONE, ONE)
    return to_numpy(params), {k: float(v) for k, v in m.items()}


def _step_check(spec, mesh, rank, world):
    """``make_shard_map_train_step`` on this rank's rows of the batch of
    :func:`single_step`."""
    trainer, cfg, mod, params = _trainer(spec)
    B = spec["B"]
    noise = mod.draw_apply_noise(torch.Generator().manual_seed(spec["seed"] + 1), cfg, B)
    rows = slice(rank * B // world, (rank + 1) * B // world)
    batch = {**{k: v[:B][rows] for k, v in _data(spec).items()},
             **{k: v[rows] for k, v in noise.items()}}
    step = make_shard_map_train_step(trainer.loss_fn, trainer.init_optimizer(params), mesh)
    m = step(params, None, batch, None, ONE, ONE, ONE)
    first = to_numpy(params)
    # then a step whose noise each rank draws from its own stream (a shared
    # generator's draw folded with the rank): the ranks' parameters stay equal
    folded = step(params, None, {k: v for k, v in batch.items() if k not in noise},
                  torch.Generator().manual_seed(5), ONE, ONE, ONE)
    sums = [torch.zeros(1, dtype=torch.float64) for _ in range(world)]
    dist.all_gather(sums, sum(p.double().sum() for p in _leaves(params)).reshape(1))
    return (first, {k: float(v) for k, v in m.items()},
            {"folded_loss": float(folded["loss"]), "rank_sums": [float(s) for s in sums]})


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree.detach()]


def _fed_epoch(spec, mesh):
    """The DP epoch with the permutation and the per-batch noise given
    (``spec["fed"]``: the JAX package's draws), not drawn."""
    fed = spec["fed"]
    queue = [{k: torch.from_numpy(v) for k, v in n.items()}
             for n in fed["noise"] + fed["eval_noise"]]
    trainer, _, _, params = _trainer(spec, mesh, lambda g: queue.pop(0))
    randperm = torch.randperm
    torch.randperm = lambda n, generator=None, device=None: torch.from_numpy(fed["perm"])
    try:
        return _epoch(trainer, params, _data(spec), torch.Generator().manual_seed(0))
    finally:
        torch.randperm = randperm


def _rank_job(rank, world, spec):
    n_model = spec.get("n_model", 1)
    mesh = make_mesh(world, n_model, devices=["cpu"] * (world * n_model))
    mod = MODELS[spec["family"]]
    cfg = mod.Config(**spec["cfg"])
    trainer, _, _, params = _trainer(spec, mesh, lambda g: mod.draw_apply_noise(g, cfg,
                                                                                spec["B"]))
    out = {"epoch": _epoch(trainer, params, _data(spec),
                           torch.Generator().manual_seed(spec["seed"]))}
    if n_model > 1:  # the devices of a kernel's slices
        layer = "h_w" if spec["family"] == "cl_vae" else "encoder_h"
        out["placed"] = [str(d) for d in params[layer]["kernel"].devices]
    if "fed" in spec:
        out["fed"] = _fed_epoch(spec, mesh)
    if spec.get("step_check"):
        out["step"] = _step_check(spec, mesh, rank, world)
    return out


def _main(rank, world, store, out, job):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    try:
        res = {name: _rank_job(rank, world, spec) for name, spec in job.items()}
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def run_world(world: int, job: dict, tmp: str) -> dict:
    """Every spec of ``job`` in a gloo world of ``world`` ranks on the CPU;
    rank 0's results."""
    store, out = os.path.join(tmp, f"store{world}"), os.path.join(tmp, f"out{world}.pt")
    mp.spawn(_main, args=(world, store, out, job), nprocs=world, join=True)
    return torch.load(out, weights_only=False)


def tree_close(a, b, rtol, atol, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            tree_close(a[k], b[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=path)
