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
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    bad = [(str(f.relative_to(PORT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "classifying_vae_lstm_tpu")]
    assert not bad, bad
    chip_smoke = PORT.parent / "chip_smoke.py"
    assert not [m for m in _imports(chip_smoke) if m.split(".")[0] in ("jax", "jaxlib")]


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
    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.data import PianoData

    for extra in (["--family", "cl_vae"], ["--dp", "2"]):
        args = serve.build_parser().parse_args(
            ["-i", "artifacts/jsball_vrnn4.npz", "--device", "cpu", *extra])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve.build_engine(args)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PianoData("data/input")
    assert serve.build_parser().parse_args(["-i", "m.npz"]).device == "cuda"
