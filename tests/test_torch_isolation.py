"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no quiet fall-back to the CPU."""

import ast
import pathlib

import pytest
import torch

PORT = pathlib.Path(__file__).resolve().parent.parent / "classifying_vae_lstm_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    tools = PORT.parent / "tools"
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"] + [
        tools / f"{name}.py" for name in ("torch_converged_parity", "torch_exp_h512_ablation",
                                          "torch_exp_lstm_interleave",
                                          "torch_repro_full_bwd_fault")]
    assert len(files) >= 25 and all(f.exists() for f in files)
    # the data-parallel package too
    assert {"__init__.py", "mesh.py", "shard_map_step.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    bad = [(str(f.relative_to(PORT.parent)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "classifying_vae_lstm_tpu")]
    assert not bad, bad


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    import numpy as np

    from classifying_vae_lstm_tpu_torch import resolve_device
    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.serving import GenerationEngine

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        GenerationEngine({}, cl_vrnn.Config(), np.zeros((1, 16, 88), np.float32))
    assert resolve_device("cpu").type == "cpu"


def test_unported_paths_raise_naming_the_roadmap():
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, cl_vrnn_sample, serve

    # --dp is ported: serve builds an engine over a two-way CPU mesh, and a
    # --dp past the devices there are raises the JAX package's message
    for model in ("artifacts/jsball_vrnn4.npz", "artifacts/jsball_vae.npz"):
        args = serve.build_parser().parse_args(["-i", model, "--device", "cpu", "--dp", "2"])
        engine = serve.build_engine(args)[0]
        assert engine.mesh.shape == {"data": 2, "model": 1} and engine.device.type == "cpu"
    args = serve.build_parser().parse_args(["-i", model, "--device", "cpu", "--dp", "100000"])
    with pytest.raises(ValueError, match="--dp 100000: only .* devices available"):
        serve.build_engine(args)
    assert serve.build_parser().parse_args(["-i", "m.npz"]).device == "cuda"
    for cli in (cl_vae_sample, cl_vrnn_sample):
        assert cli.build_parser().parse_args(["r"]).device == "cuda"

    # training: --dp needs its devices (the card by default); every
    # fusion rung of the whole-sequence LSTM kernels runs (the proj-only rung
    # that JAX auto pins at H >= 1,579 gives, without a gradient, the default
    # rung's output: every proj rung shares its forward)
    import dataclasses

    from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_train, common
    from classifying_vae_lstm_tpu_torch.models import cl_vrnn

    cfg = cl_vrnn.Config(original_dim=6, intermediate_dim=8, latent_dim=2, seq_length=3,
                         n_classes=3, lstm_backend="pallas", two_cell=True)
    params = cl_vrnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((2, 3, 6))
    proj_only = dataclasses.replace(cfg, bf16_compute=True, two_cell=False,
                                    fusion=(True, False, False))
    torch.testing.assert_close(
        cl_vrnn.apply(params, proj_only, x, torch.Generator().manual_seed(1))["X_decoded_mean"],
        cl_vrnn.apply(params, dataclasses.replace(proj_only, fusion=None), x,
                      torch.Generator().manual_seed(1))["X_decoded_mean"], rtol=0, atol=0)
    for two_cell in (False, True):
        out = cl_vrnn.apply(params, dataclasses.replace(cfg, bf16_compute=True,
                                                        two_cell=two_cell), x,
                            torch.Generator().manual_seed(1))
        assert torch.isfinite(out["X_decoded_mean"]).all()
    # --dp on the default device: the card, which this machine may lack
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cl_vrnn_train.train(cl_vrnn_train.build_parser().parse_args(["r", "--dp", "2"]))
    with pytest.raises(ValueError, match="--dp 2 must divide --batch_size 201"):
        common.check_dp(cl_vrnn_train.build_parser().parse_args(
            ["r", "--dp", "2", "--batch_size", "201", "--device", "cpu"]))
    assert cl_vrnn_train.build_parser().parse_args(["r"]).device == "cuda"
