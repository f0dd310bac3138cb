"""The port's completeness and public surface against the JAX package.

Reads the JAX package's tree with `os` and `ast` only (nothing of it is
imported), per subpackage:

  * every `.py` module of `idccrn_vae_tpu/<sub>/` has a module at the
    same relative path in `idccrn_vae_torch/`, or stands in NOT_PORTED
    with its reason;
  * every name a JAX subpackage's `__init__.py` imports or assigns is an
    attribute of the port's subpackage, and not a module, or stands in
    NOT_EXPORTED with its reason.

A module or an export added to the JAX package that the port misses
fails here. The two tables are themselves checked: each entry must
still name something the JAX package has and the port lacks.
"""

import ast
import importlib
import inspect
import os

import pytest

import torch_port_util  # noqa: F401  (thread cap of the port tests)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "idccrn_vae_tpu")
PORT_PKG = os.path.join(REPO, "idccrn_vae_torch")

NOT_PORTED = {
    "cli/convert_torch.py": (
        "converts a reference PyTorch checkpoint into JAX variables; the "
        "port's modules carry the reference's state_dict names, so its "
        "CLIs read a reference .pt directly "
        "(cli/common.py _load_reference_state_dict)"),
    "models/torch_import.py": (
        "maps reference state_dict names onto JAX variable trees; the "
        "port's parameter modules are those state_dicts "
        "(models/modules.py), and JAX variables come in through "
        "models/from_jax.py"),
}

_INIT = ("the port initialises these parameters in the nn.Module "
         "constructors of models/modules.py (fan-in uniform bounds, "
         "gamma_ri ~ N(0, 1)); a functional init returning a parameter "
         "tree has no caller in a module-based package")
_SHARDING = ("a jax.sharding object (Mesh, NamedSharding); the port's "
             "data parallelism is a torch.distributed process group, one "
             "rank per card (parallel/distributed.py, parallel/mesh.py "
             "auto_world and shard_batch)")
_MODULE = ("in the JAX package this export shadows the submodule of the "
           "same name; in the port the name stays the submodule (ops/stft.py"
           ", ops/lstm.py), which the port's code and tests import as "
           "`from idccrn_vae_torch.ops import stft`; the function is the "
           "submodule's attribute of the same name")
NOT_EXPORTED = {
    "ops": dict({name: _INIT for name in (
        "init_complex_conv2d", "init_complex_conv_transpose2d",
        "init_complex_dense", "init_lstm", "init_complex_lstm",
        "init_cbn_params", "init_cbn_stats")},
        stft=_MODULE, lstm=_MODULE),
    "parallel": {"make_mesh": _SHARDING, "data_sharding": _SHARDING},
}


def _subpackages():
    return sorted(d for d in os.listdir(JAX_PKG)
                  if os.path.isfile(os.path.join(JAX_PKG, d, "__init__.py")))


def _modules(sub: str):
    """Relative paths of the .py files under idccrn_vae_tpu/<sub>."""
    out = []
    for root, _, files in os.walk(os.path.join(JAX_PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_PKG))
    return sorted(out)


def _exports(sub: str):
    """Names bound at the top level of idccrn_vae_tpu/<sub>/__init__.py
    by imports and assignments (dunder names aside)."""
    with open(os.path.join(JAX_PKG, sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("__")]


SUBPACKAGES = _subpackages()


def test_the_jax_package_has_the_subpackages_this_test_expects():
    assert {"cli", "data", "eval", "losses", "models", "ops", "parallel",
            "train", "utils"} <= set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_module_has_a_port_module(sub):
    missing = [rel for rel in _modules(sub)
               if not os.path.isfile(os.path.join(PORT_PKG, rel))
               and rel not in NOT_PORTED]
    assert not missing, (
        f"JAX modules without a port counterpart: {missing}; port them "
        f"or list them in NOT_PORTED with the reason")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_on_the_port(sub):
    port = importlib.import_module(f"idccrn_vae_torch.{sub}")
    skip = NOT_EXPORTED.get(sub, {})
    missing = [n for n in _exports(sub) if n not in skip and
               (not hasattr(port, n) or inspect.ismodule(getattr(port, n)))]
    assert not missing, (
        f"idccrn_vae_tpu.{sub} exports {missing}, idccrn_vae_torch.{sub} "
        f"does not; export the port's counterpart under that name or list "
        f"it in NOT_EXPORTED with the reason")


@pytest.mark.parametrize("rel", sorted(NOT_PORTED))
def test_each_unported_module_exists_in_jax_and_not_in_the_port(rel):
    assert os.path.isfile(os.path.join(JAX_PKG, rel))
    assert not os.path.exists(os.path.join(PORT_PKG, rel))
    assert NOT_PORTED[rel]


@pytest.mark.parametrize("sub", sorted(NOT_EXPORTED))
def test_each_unexported_name_is_a_jax_export_the_port_lacks(sub):
    port = importlib.import_module(f"idccrn_vae_torch.{sub}")
    exports = set(_exports(sub))
    for name, reason in NOT_EXPORTED[sub].items():
        assert name in exports, f"{sub}.{name} is no longer a JAX export"
        if reason is _MODULE:
            module = getattr(port, name)
            assert inspect.ismodule(module) and callable(
                getattr(module, name))
        else:
            assert not hasattr(port, name), \
                f"the port now exports {sub}.{name}"
        assert reason
