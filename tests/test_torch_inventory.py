"""The port has a twin of every public function and class of the JAX package.

Walks every module of `genomicbreedingmodels_tpu` and, for each public
function or class defined there, finds the same name in the port's module
of the same path (`genomicbreedingmodels_tpu_torch.<same path>`). The twin
takes the JAX parameters, in the same order, of the same kind and with the
same defaults (a default that is a function or a dtype compares by name);
apart from `device`, it may add only parameters that have a default, so
every call of the JAX signature is a call of the port's. The exceptions are
named below, each with its reason.
"""

import importlib
import inspect
import pkgutil

import pytest
import torch

import genomicbreedingmodels_tpu as gj

_JAX = gj.__name__
_PORT = "genomicbreedingmodels_tpu_torch"

# JAX modules without a module twin: their Pallas kernels are ported as
# hand-written CUDA kernels (K1-K3) under the port's kernels/ and csrc/,
# named here by the port's wrapper module and functions.
KERNEL_MODULES = {
    "ops.pallas_kernels": ("kernels.gram_tri", ("gram_tri_int8", "gram_tri_float")),
    "ops.pallas_gibbs": ("kernels.gibbs_group", ("grouped_block_update",)),
}

# Twins under another name.
RENAMED = {
    ("utils.logging", "jax_profile"): "torch_profile",  # the profiler is torch's
}

# JAX parameters the twin leaves out, with the reason; the rest are checked.
_NB = "nb= picks the JAX package's XLA panel schedule; K1 and K2 tile for themselves"
DROPPED = {
    ("ops.grm", "gram_panel"): ("nb", _NB),
    ("ops.grm", "gram_dosage"): ("nb", _NB),
    ("ops.grm", "gram_dosage_snp_major"): ("nb", _NB),
    ("ops.grm", "gram_dosage_lower"): ("nb", _NB),
}

# Twins whose parameters differ from the JAX signature, with the reason.
SIGNATURE_EXCEPTIONS = {
    ("models.mlp", "mlp_apply"): "the port holds the parameters in an nn.Module (`net`) and applies "
                                 "dropout in training mode, not through functional params and "
                                 "dropout_rate",
    ("parallel.mesh", "marker_sharding"): "JAX returns a NamedSharding for device_put; the port "
                                          "returns the rank's slice of a p_pad-wide panel",
    ("parallel.mesh", "replicated"): "JAX returns a replicated NamedSharding; the port returns the "
                                     "tensor t as every rank holds it",
}


def _jax_modules():
    names = [_JAX] + [m.name for m in pkgutil.walk_packages(gj.__path__, _JAX + ".")]
    return [n for n in names if n != _JAX + ".__main__"]


def _rel(name: str) -> str:
    return name[len(_JAX) + 1:]


def _public(module):
    """(name, object) of the public functions and classes defined in `module`."""
    return [(k, v) for k, v in sorted(vars(module).items())
            if not k.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == module.__name__]


def _norm(default):
    """A default as the two packages can share it: functions and dtypes by
    name, containers element by element."""
    if isinstance(default, (tuple, list)):
        return type(default)(_norm(d) for d in default)
    if isinstance(default, dict):
        return {k: _norm(v) for k, v in default.items()}
    if inspect.isfunction(default) or inspect.isclass(default):  # jnp.int32 is a class
        return default.__name__
    if isinstance(default, torch.dtype):
        return str(default).rsplit(".", 1)[-1]
    return default


def _params(obj):
    return [p for p in inspect.signature(obj).parameters.values() if p.name != "device"]


JAX_MODULES = _jax_modules()


def test_walk_covers_the_packages():
    assert len(JAX_MODULES) >= 30
    assert set(KERNEL_MODULES) <= {_rel(m) for m in JAX_MODULES}
    listed = set(SIGNATURE_EXCEPTIONS) | set(RENAMED) | set(DROPPED)
    found = {(_rel(m), k) for m in JAX_MODULES if _rel(m) not in KERNEL_MODULES
             for k, _ in _public(importlib.import_module(m))}
    assert listed <= found, listed - found  # no stale exception


@pytest.mark.parametrize("module", JAX_MODULES, ids=lambda m: _rel(m) or "__init__")
def test_every_public_name_has_a_twin(module):
    rel = _rel(module)
    if rel in KERNEL_MODULES:
        path, names = KERNEL_MODULES[rel]
        port = importlib.import_module(f"{_PORT}.{path}")
        assert all(callable(getattr(port, n, None)) for n in names)
        return
    port = importlib.import_module(module.replace(_JAX, _PORT, 1))
    if module == _JAX:  # the package's exported names
        missing = [n for n in gj.__all__ if not hasattr(port, RENAMED.get(("", n), n))]
        assert not missing, missing
    for name, obj in _public(importlib.import_module(module)):
        twin = getattr(port, RENAMED.get((rel, name), name), None)
        assert twin is not None, f"{rel}.{name} has no twin in the port"
        assert inspect.isclass(twin) == inspect.isclass(obj), f"{rel}.{name}"
        if (rel, name) in SIGNATURE_EXCEPTIONS:
            continue
        dropped = DROPPED.get((rel, name), ("",))[0]
        pj, pt = [p for p in _params(obj) if p.name != dropped], _params(twin)
        assert len(pt) >= len(pj), f"{rel}.{name}: the port drops parameters"
        for a, b in zip(pj, pt):
            assert (a.name, a.kind) == (b.name, b.kind), f"{rel}.{name}: {a} against {b}"
            assert _norm(a.default) == _norm(b.default), f"{rel}.{name}: {a} against {b}"
        extra = [p.name for p in pt[len(pj):] if p.default is inspect.Parameter.empty
                 and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        assert not extra, f"{rel}.{name}: the port adds required parameters {extra}"
