"""The port's public names against the JAX package's: each subpackage's
``__all__`` holds the JAX one's, and each JAX module's public functions and
classes are in its twin module, less a named list of deliberate omissions."""

import importlib
import inspect
import pkgutil

import pytest

import transformergrooveinfilling_tpu as jax_package

SUBPACKAGES = ("audio", "data", "eval", "hvo", "models", "ops", "parallel", "train", "utils")

# names the port does not carry, each with its reason
OMISSIONS = {
    # TPU layout choices: VMEM residency of the FFN's weights and the layer
    # kernel's row tile; the Hopper kernels choose their own tiles
    "ops.fused_ffn": {"fits_resident"},
    "ops.fused_layer": {"pick_layer_tile"},
    # flax submodules; the port has them as functions whose weights map to
    # the same flax names (ops/dropout.py::dropout, models/transformer.py::
    # _drop_add_layer_norm over an nn.LayerNorm)
    "models.transformer": {"Dropout", "DropAddLayerNorm"},
}
# JAX module → the port's twin where the name differs, and renamed names
TWINS = {"ops.mso_pallas": "ops.band_energies"}
RENAMED = {"ops.mso_pallas": {"band_energies_reference": "band_energies_plain"}}


def _port(name: str):
    return importlib.import_module(f"transformergrooveinfilling_tpu_torch.{name}")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_all_holds_the_jax_one(sub):
    jax_all = set(importlib.import_module(f"transformergrooveinfilling_tpu.{sub}").__all__)
    port = _port(sub)
    assert jax_all <= set(port.__all__), sorted(jax_all - set(port.__all__))
    assert all(hasattr(port, name) for name in port.__all__)


def _modules(sub: str):
    package = importlib.import_module(f"transformergrooveinfilling_tpu.{sub}")
    return sorted(m.name for m in pkgutil.walk_packages(package.__path__, package.__name__ + "."))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_module_public_names_have_twins(sub):
    """Every public function and class a JAX module of ``sub`` defines is in
    the port's module of the same path (``TWINS`` where it is renamed), under
    its own name or its ``RENAMED`` one, but the ``OMISSIONS``."""
    prefix = jax_package.__name__ + "."
    for name in _modules(sub):
        rel = name[len(prefix):]
        module = importlib.import_module(name)
        twin = _port(TWINS.get(rel, rel))
        public = {n for n, obj in vars(module).items()
                  if not n.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
                  and obj.__module__ == name}
        renamed = RENAMED.get(rel, {})
        missing = {n for n in public - OMISSIONS.get(rel, set())
                   if not hasattr(twin, renamed.get(n, n))}
        assert not missing, (rel, sorted(missing))


def test_the_omissions_are_still_jax_names():
    """A listed omission or rename the JAX package no longer has goes from the
    lists."""
    for rel, names in {**OMISSIONS, **{k: set(v) for k, v in RENAMED.items()}}.items():
        module = importlib.import_module(f"transformergrooveinfilling_tpu.{rel}")
        assert all(hasattr(module, n) for n in names), rel
