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
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) >= 25
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
    from classifying_vae_lstm_tpu_torch.data import PianoData

    for model in ("artifacts/jsball_vrnn4.npz", "artifacts/jsball_vae.npz"):
        args = serve.build_parser().parse_args(["-i", model, "--device", "cpu", "--dp", "2"])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve.build_engine(args)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PianoData("data/input")
    assert serve.build_parser().parse_args(["-i", "m.npz"]).device == "cuda"
    for cli in (cl_vae_sample, cl_vrnn_sample):
        assert cli.build_parser().parse_args(["r"]).device == "cuda"

    # training: the bf16 modes of the two-cell and whole-sequence LSTM
    # kernels, and the train flags whose modules are not ported
    import dataclasses

    from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_train, common
    from classifying_vae_lstm_tpu_torch.models import cl_vrnn

    cfg = cl_vrnn.Config(original_dim=6, intermediate_dim=8, latent_dim=2, seq_length=3,
                         n_classes=3, lstm_backend="pallas", two_cell=True)
    params = cl_vrnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((2, 3, 6))
    for bad in (dataclasses.replace(cfg, bf16_compute=True),
                dataclasses.replace(cfg, bf16_compute=True, two_cell=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cl_vrnn.apply(params, bad, x, torch.Generator().manual_seed(1))
    for flag in common.UNPORTED_FLAGS:
        extra = {"dp": ["--dp", "2"], "trace_dir": ["--trace_dir", "t"]}.get(flag, [f"--{flag}"])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cl_vrnn_train.train(cl_vrnn_train.build_parser().parse_args(["r", *extra]))
    assert cl_vrnn_train.build_parser().parse_args(["r"]).device == "cuda"
