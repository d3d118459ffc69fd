"""The port's public surface against the JAX package's.

Every name a JAX sub-package exports (its ``__all__``) is in the port's
sub-package's ``__all__`` and resolves there; every public function and
class of a JAX module resolves in the port's module of the same name, but
for the exemptions listed below, each with its reason.
"""

import importlib
import inspect
import pathlib

import pytest

JAX = "classifying_vae_lstm_tpu"
PORT = "classifying_vae_lstm_tpu_torch"
SUBPACKAGES = ("data", "evaluation", "models", "nn", "ops", "optim", "parallel", "runtime",
               "sampling", "serving", "train", "utils")

# JAX names with no counterpart in the port, and why. None of them is in a
# sub-package's __all__.
EXEMPT = {
    # orbax checkpoints are a JAX library's format; the port reads and writes
    # the .npz / .opt.npz contract both packages share
    "train.checkpoint": {"save_checkpoint_orbax", "load_checkpoint_orbax"},
    # optax state NamedTuples: the port's optimizers are torch.optim.Optimizers
    # that keep their state in the optimizer (state_leaves / load_state_leaves)
    "optim.adamwn": {"AdamWNState", "SGDWNState", "KerasAdamState"},
    "optim.keras_optimizers": {"KerasSGDState", "KerasAdadeltaState", "KerasAdamaxState",
                               "KerasNadamState"},
    # JAX's persistent compilation cache; the port's kernels are built once by nvcc
    "cli.common": {"enable_compile_cache"},
}
# the Pallas modules: their kernels are the port's ops/cuda_*.py, lstm_seq.py,
# two_cell.py and vae_dense.py over csrc/
PALLAS_MODULES = {"ops.pallas_generate", "ops.pallas_generate_vae", "ops.pallas_lstm",
                  "ops.pallas_two_cell", "ops.pallas_vae"}


def _modules():
    root = pathlib.Path(__file__).resolve().parents[1] / JAX
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        if rel.name != "__init__":
            yield ".".join(rel.parts)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_subpackage_export_resolves_in_the_port(sub):
    jax_all = importlib.import_module(f"{JAX}.{sub}").__all__
    port = importlib.import_module(f"{PORT}.{sub}")
    assert not [n for n in jax_all if n not in port.__all__], sub
    assert all(hasattr(port, n) for n in port.__all__), sub


@pytest.mark.parametrize("mod", [m for m in _modules() if m not in PALLAS_MODULES])
def test_every_public_function_has_a_counterpart(mod):
    jmod = importlib.import_module(f"{JAX}.{mod}")
    tmod = importlib.import_module(f"{PORT}.{mod}")
    public = {n for n, v in vars(jmod).items()
              if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == jmod.__name__}
    exempt = EXEMPT.get(mod, set())
    assert exempt <= public, f"{mod}: stale exemptions {exempt - public}"
    missing = sorted(n for n in public - exempt if not hasattr(tmod, n))
    assert not missing, f"{mod}: {missing}"
