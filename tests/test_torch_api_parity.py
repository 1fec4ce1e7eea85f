"""The port's public API against the JAX package's: every public function
and class a JAX module defines has its counterpart in the port, under the
same name, with every JAX parameter in the same position, of the same
kind and with an equal default.  The port may add parameters that have
defaults (``device``), make a required JAX parameter optional, and give a
torch dtype where JAX gives the jnp one.  Every other difference is an
entry of ALLOWED, with its reason.

Then the calls that this check found different, held to the JAX
package's results on the CPU: ``build_bvh``'s "auto" method,
``RenderMetrics.phase``'s ``result``, ``native.available`` and the
package's exports (the candidate builds' ``exact`` / ``ray_cert`` and
``build_clusters``' order and budgets are in test_torch_cluster.py)."""

import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.utils.procedural import dragon_standin

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = "sycl_ray_tracing_tpu"
PORT_PKG = "sycl_ray_tracing_tpu_torch"

# key -> (reason, the port's counterpart or None).  A key is
# "module:name" for a name the port does not define, "module:name(param)"
# for a parameter it does not take; modules relative to the package.
ALLOWED = {
    "ops.pallas.listtrace:fits_in_vmem": (
        "the TPU kernel's VMEM budget; the port's kernels take the same "
        "cluster limit as a constant", "MAX_CLUSTERS"),
    "ops.intersect:name_traversal": (
        "only names HLO ops for the TPU profiler; the port has no HLO",
        None),
    "parallel.render:render_sharded_jit": (
        "jax.jit around render_sharded; the port runs render_sharded "
        "eagerly", "render_sharded"),
    "parallel.mesh:make_mesh(devices)": (
        "a torch process owns one card, so there is no device list to "
        "pass", None),
    "utils.metrics:hlo_op_times": (
        "reads XLA op times from a JAX profiler trace; the port reads "
        "torch.profiler's CUDA activity", "device_op_totals"),
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
_MISSING = object()


def _jax_modules():
    """Every module of the JAX package, by its path relative to the
    package ("" for the package itself)."""
    root = REPO / JAX_PKG
    mods = []
    for f in sorted(root.rglob("*.py")):
        parts = list(f.relative_to(root).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _full(pkg, rel):
    return f"{pkg}.{rel}" if rel else pkg


def _port_rel(rel):
    """The port keeps every module path, with ops.pallas as ops.kernels."""
    return "ops.kernels" + rel[len("ops.pallas"):] \
        if rel.split(".")[:2] == ["ops", "pallas"] else rel


def _same_default(a, b) -> bool:
    if isinstance(b, torch.dtype):
        try:
            return np.dtype(a).name == str(b).removeprefix("torch.")
        except TypeError:
            return False
    return type(a) is type(b) and a == b


def _param_diffs(jsig, psig):
    """(parameter, what differs) for each JAX parameter the port does not
    take as JAX does, and each parameter only the port requires."""
    jps = list(jsig.parameters.values())
    pps = list(psig.parameters.values())
    where = {p.name: i for i, p in enumerate(pps)}
    out = []
    for i, j in enumerate(jps):
        if j.name not in where:
            out.append((j.name, "missing"))
            continue
        k = where[j.name]
        p = pps[k]
        if j.kind in _POSITIONAL:
            if k != i or p.kind not in _POSITIONAL:
                out.append((j.name, f"at {k} ({p.kind.name}) where JAX has "
                                    f"it at {i} ({j.kind.name})"))
        elif j.kind in _VAR:
            if p.kind != j.kind:
                out.append((j.name, f"{p.kind.name} where JAX has "
                                    f"{j.kind.name}"))
        elif p.kind not in (inspect.Parameter.KEYWORD_ONLY,
                            inspect.Parameter.POSITIONAL_OR_KEYWORD):
            out.append((j.name, f"{p.kind.name} where JAX takes a keyword"))
        if j.default is not j.empty and not _same_default(j.default,
                                                          p.default):
            out.append((j.name, f"default {p.default!r} where JAX has "
                                f"{j.default!r}"))
    jnames = {j.name for j in jps}
    for p in pps:
        if p.name not in jnames and p.default is p.empty \
                and p.kind not in _VAR:
            out.append((p.name, "required in the port only"))
    return out


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _callable_diffs(key, jobj, pobj):
    js, ps = _signature(jobj), _signature(pobj)
    if js is None or ps is None:
        return {} if (js is None) == (ps is None) else {
            key: "one signature cannot be read"}
    return {f"{key}({name})": msg for name, msg in _param_diffs(js, ps)}


def _unwrap(attr):
    return attr.__func__ if isinstance(attr, (staticmethod, classmethod)) \
        else attr


def _class_diffs(key, jcls, pcls):
    """The constructor, then each public method and property that the
    JAX class defines (fields with defaults are the constructor's)."""
    out = _callable_diffs(key, jcls, pcls)
    for name, attr in vars(jcls).items():
        if name.startswith("_"):
            continue
        attr = _unwrap(attr)
        if not (inspect.isfunction(attr) or isinstance(attr, property)):
            continue
        pattr = inspect.getattr_static(pcls, name, _MISSING)
        if pattr is _MISSING:
            out[f"{key}.{name}"] = "missing"
        elif isinstance(attr, property):
            if not isinstance(pattr, property):
                out[f"{key}.{name}"] = "not a property"
        else:
            out.update(_callable_diffs(f"{key}.{name}", attr,
                                       _unwrap(pattr)))
    return out


def api_diffs(rel):
    """Every difference of one JAX module's public API from its port
    counterpart's: {key: what differs}."""
    jmod = importlib.import_module(_full(JAX_PKG, rel))
    pmod = importlib.import_module(_full(PORT_PKG, _port_rel(rel)))
    out = {}
    if hasattr(jmod, "__all__"):
        if getattr(pmod, "__all__", None) != jmod.__all__:
            out[f"{rel}:__all__"] = (f"{getattr(pmod, '__all__', None)} "
                                     f"where JAX has {jmod.__all__}")
        for name in jmod.__all__:
            if not hasattr(pmod, name):
                out[f"{rel}:{name}"] = "in JAX's __all__, missing"
    for name, jobj in vars(jmod).items():
        if name.startswith("_") or getattr(jobj, "__module__", None) \
                != jmod.__name__:
            continue
        if not (inspect.isfunction(jobj) or inspect.isclass(jobj)):
            continue
        key = f"{rel}:{name}"
        pobj = getattr(pmod, name, _MISSING)
        if pobj is _MISSING:
            out[key] = "missing"
        elif inspect.isclass(jobj):
            out.update(_class_diffs(key, jobj, pobj) if inspect.isclass(pobj)
                       else {key: "not a class"})
        else:
            out.update(_callable_diffs(key, jobj, pobj))
    return out, pmod


JAX_MODULES = _jax_modules()


def test_every_jax_module_is_checked():
    assert len(JAX_MODULES) >= 30 and "" in JAX_MODULES
    assert {k.split(":")[0] for k in ALLOWED} <= set(JAX_MODULES)


@pytest.mark.parametrize("rel", JAX_MODULES,
                         ids=[_full(JAX_PKG, r) for r in JAX_MODULES])
def test_public_api_matches_jax(rel):
    """This module's public names and signatures equal the JAX module's,
    up to ALLOWED; every ALLOWED entry of it is still a difference, and
    its counterpart exists in the port."""
    diffs, pmod = api_diffs(rel)
    allowed = {k: v for k, v in ALLOWED.items()
               if k.split(":")[0] == rel}
    unexpected = {k: v for k, v in diffs.items() if k not in allowed}
    assert not unexpected, unexpected
    stale = sorted(set(allowed) - set(diffs))
    assert not stale, f"ALLOWED entries that no longer differ: {stale}"
    for key, (reason, counterpart) in allowed.items():
        assert reason
        if counterpart is not None:
            assert hasattr(pmod, counterpart), (key, counterpart)


def test_parity_check_sees_each_kind_of_difference():
    """The checker itself: a missing parameter, a moved one, another
    default, a parameter only the port requires, and the two that are
    allowed (an added optional parameter, a jnp dtype as a torch one)."""
    import jax.numpy as jnp

    def jax_f(a, b=1, *, c="x", dtype=jnp.float32):
        pass

    def same(a, b=1, *, c="x", dtype=torch.float32, device="cuda"):
        pass

    def moved(b=1, a=None, *, c="x", dtype=torch.float32):
        pass

    def other(a, b=2, *, dtype=torch.int32, e):
        pass

    assert _param_diffs(inspect.signature(jax_f), inspect.signature(same)) \
        == []
    assert [n for n, _ in _param_diffs(inspect.signature(jax_f),
                                       inspect.signature(moved))] \
        == ["a", "b"]
    assert [n for n, _ in _param_diffs(inspect.signature(jax_f),
                                       inspect.signature(other))] \
        == ["b", "c", "dtype", "e"]


# ---- the calls the check found different, against the JAX package ----

def test_build_bvh_auto_builds_as_sah():
    """The default method is "auto", which builds the native SAH tables
    (the port never falls back to Morton; the JAX package's "auto" does
    where its library is not built, so it is not compared here)."""
    from sycl_ray_tracing_tpu.ops import bvh as JB
    from sycl_ray_tracing_tpu_torch.ops import bvh as PB

    tris = dragon_standin(1_500)
    for fn in (PB.build_bvh, PB.build_bvh_arrays, JB.build_bvh):
        assert inspect.signature(fn).parameters["method"].default == "auto"
    sah = PB.build_bvh_arrays(tris, 4, "sah")
    auto = PB.build_bvh_arrays(tris, 4, "auto")
    assert sah.keys() == auto.keys()
    for name in sah:
        np.testing.assert_array_equal(auto[name], sah[name], err_msg=name)
    bvh = PB.build_bvh(tris, device="cpu")
    np.testing.assert_array_equal(bvh.nodes_box.numpy(), sah["nodes_box"])
    np.testing.assert_array_equal(bvh.tri_order.numpy(), sah["tri_order"])
    with pytest.raises(ValueError, match="bad build method"):
        PB.build_bvh_arrays(tris, 4, "median")


def test_phase_takes_result():
    from sycl_ray_tracing_tpu.utils.metrics import RenderMetrics as JM
    from sycl_ray_tracing_tpu_torch.utils.metrics import RenderMetrics as PM

    for metrics in (JM(), PM()):
        with metrics.phase("x", result=1):
            pass
        with metrics.phase("x"):
            pass
        assert list(metrics.timers) == ["x"] and metrics.timers["x"] >= 0.0


def test_native_available(monkeypatch):
    """True where the library builds and loads; False, without raising,
    where loading fails, while load itself still raises."""
    from sycl_ray_tracing_tpu_torch import native

    assert native.available() is True

    def broken():
        raise RuntimeError("build of libsrt_native failed")

    monkeypatch.setattr(native, "load", broken)
    assert native.available() is False
    with pytest.raises(RuntimeError):
        native.sah_build(dragon_standin(100))


def test_package_exports():
    import sycl_ray_tracing_tpu as J
    import sycl_ray_tracing_tpu_torch as P
    from sycl_ray_tracing_tpu_torch import (
        Camera,
        Materials,
        RenderConfig,
        Scene,
    )
    from sycl_ray_tracing_tpu_torch.models import camera, scene
    from sycl_ray_tracing_tpu_torch.utils import config

    assert P.__all__ == J.__all__
    assert (Scene, Materials, Camera, RenderConfig) == (
        scene.Scene, scene.Materials, camera.Camera, config.RenderConfig)
    assert P.__version__ == J.__version__
