"""The port's public surface against the JAX package's, walked.

Every module of `hierarchical_block_sparse_lib_tpu` (found by
`pkgutil.walk_packages`) must have its counterpart at the same relative
path in `hierarchical_block_sparse_lib_tpu_torch`, and there:

- each public name the JAX module defines or exports (its `__all__`, and
  the functions, classes and constants assigned at its top level);
- each public method, property and class attribute of a JAX class;
- the dataclass fields and `NamedTuple` `_fields` of a JAX class, in order;
- each parameter name of a public function or method, in the same
  relative order (the port may add parameters), with an equal default
  where the JAX default is a plain int, float, str, bool or None;
- each UPPERCASE module constant.

A difference the port states on purpose sits in `ALLOWED`, keyed by
(module, name[, parameter or member]), with its reason.  An entry whose
difference is gone (the JAX package lacks the name, or the port now has
it) fails `test_allow_list_has_no_stale_entry`, so the list cannot hide a
later repair.  One case per JAX module, so a failure names its module.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import pkgutil

import pytest

import hierarchical_block_sparse_lib_tpu as jax_pkg
import hierarchical_block_sparse_lib_tpu_torch as port_pkg

_KERNEL_WRAPPERS = {
    "kernels.pallas_gemm": ("gather_gemm_accumulate",),
    "kernels.pallas_gemm_fine": ("fine_spgemm",),
    "kernels.pallas_gemm_groups": ("groups_spgemm",),
    "kernels.pallas_gemm_rows": ("rows_spgemm",),
    "kernels.pallas_gemm_stream": ("gather_gemm_accumulate_stream",),
    "kernels.pallas_norms": ("block_frob_squared", "norms_and_keep"),
}

_INTERPRET = (
    "Pallas interpret mode: a CUDA tensor launches the Hopper kernel, a CPU "
    "tensor takes the plain version; there is no interpreter to select"
)
_MOSAIC_HOOK = (
    "a Mosaic lowering hook of the TPU kernel (ROADMAP.md, Queue 2: "
    "'Do not carry over')"
)
_VMEM_GATE = (
    "a TPU VMEM/SMEM residency gate (ROADMAP.md, 'Stated differences'): the "
    "Hopper kernel keeps no panel resident, so row caps and nbc bound nothing"
)
_ROWS_GATE = _VMEM_GATE + (
    "; the JAX rule is kept whole as `reference_rows_rule`, which the router "
    "asks for its aligned decision"
)
_GATES = {
    "kernels.pallas_gemm_fine": (("b_row_max", "c_row_max", "nbc"), _VMEM_GATE),
    "kernels.pallas_gemm_rows": (("b_row_max", "c_row_max", "nbc"), _ROWS_GATE),
    "kernels.pallas_gemm_groups": (
        ("a_grp_max", "slab_max", "c_grp_max", "nbc"), _VMEM_GATE,
    ),
}

ALLOWED: dict[tuple, str] = {
    ("kernels.mxu", "*"): (
        "not a kernel: the TPU's multi-pass MXU dot; each Hopper kernel "
        "implements the precision tiers itself (ROADMAP.md, Queue 2)"
    ),
    **{
        (mod, fn, "interpret"): _INTERPRET
        for mod, fns in _KERNEL_WRAPPERS.items()
        for fn in fns
    },
    ("kernels.pallas_gemm_fine", "fine_spgemm", "ablate"): _MOSAIC_HOOK,
    ("kernels.pallas_gemm_rows", "rows_spgemm", "wide"): _MOSAIC_HOOK,
    ("kernels.pallas_gemm_groups", "groups_spgemm", "wide"): _MOSAIC_HOOK,
    ("kernels.pallas_norms", "block_frob_squared", "chunk"): (
        "the TPU grid's tiling of the capacity axis; the CUDA kernel picks "
        "its own launch shape"
    ),
    ("kernels.pallas_norms", "norms_and_keep", "chunk"): (
        "the TPU grid's tiling of the capacity axis; the CUDA kernel picks "
        "its own launch shape"
    ),
    **{
        (mod, "supported", param): reason
        for mod, (params, reason) in _GATES.items()
        for param in params
    },
    ("utils.profiling", "Counters", "_t0"): (
        "a private field: the start time of the open `timed` section, which "
        "the port keeps in a local of `timed`"
    ),
    **{
        (mod, "purify_scan", "unroll"): (
            "lax.scan unrolling, an XLA compile setting; the port's scan is "
            "a host loop of device calls, so there is nothing to unroll"
        )
        for mod in ("models", "models.purification")
    },
    ("parallel.route", "FrozenRoutePlan", "send"): (
        "an addition, not a missing member: the send tensors of the route, "
        "built once when the plan is frozen"
    ),
    ("parallel.route2", "FrozenRoute2Plan", "send"): (
        "an addition, not a missing member: the send tensors of the route, "
        "built once when the plan is frozen"
    ),
}


def _modules(pkg) -> dict:
    """{relative dotted name ('' for the package): module}."""
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[info.name[len(pkg.__name__) + 1:]] = importlib.import_module(info.name)
    return out


JAX_MODULES = _modules(jax_pkg)
PORT_MODULES = _modules(port_pkg)


def _top_level_names(mod) -> list:
    """Names a module binds by def, class or assignment at its top level
    (inside top-level `if`/`try` too), in source order."""
    try:
        tree = ast.parse(inspect.getsource(mod))
    except (OSError, TypeError):
        return []
    names = []

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.append(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.append(n.id)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)
                visit(node.finalbody)

    visit(tree.body)
    return names


def _public_names(mod) -> list:
    names = list(getattr(mod, "__all__", ()))
    names += [n for n in _top_level_names(mod) if n not in names]
    return [n for n in names if not n.startswith("_") and hasattr(mod, n)]


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


_PLAIN = (int, float, str, bool, type(None))


def _compare_signature(key, jax_obj, port_obj, problems):
    js, ps = _signature(jax_obj), _signature(port_obj)
    if js is None:
        return
    if ps is None:
        problems[key] = "the port's counterpart has no signature"
        return
    port_names = list(ps.parameters)
    last = -1
    for name, jp in js.parameters.items():
        if name.startswith("_"):
            continue
        if name not in ps.parameters:
            problems[key + (name,)] = f"parameter {name!r} is missing"
            continue
        at = port_names.index(name)
        if at < last:
            problems[key + (name,)] = f"parameter {name!r} is out of order"
        last = max(last, at)
        jd, pd = jp.default, ps.parameters[name].default
        if jd is not inspect.Parameter.empty and isinstance(jd, _PLAIN):
            if type(jd) is not type(pd) or jd != pd:
                problems[key + (name,)] = (
                    f"default of {name!r}: JAX {jd!r}, port {pd!r}"
                )


def _own_members(cls) -> dict:
    """Public members a class and its bases in the JAX package define."""
    out = {}
    for c in reversed(cls.__mro__):
        if not c.__module__.startswith(jax_pkg.__name__):
            continue
        for name, value in vars(c).items():
            if not name.startswith("_"):
                out[name] = value
    return out


def _fields(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    if isinstance(getattr(cls, "_fields", None), tuple):
        return list(cls._fields)
    return None


def _compare_class(mod, name, jcls, pcls, problems):
    if not isinstance(pcls, type):
        problems[(mod, name)] = "a class in the JAX package, not one in the port"
        return
    # The constructor first, so that a field's own message below wins.
    _compare_signature((mod, name), jcls, pcls, problems)
    jf, pf = _fields(jcls), _fields(pcls)
    if jf is not None:
        if pf is None:
            problems[(mod, name)] = "the port's class has no fields"
        else:
            for f in jf:
                if f not in pf:
                    problems[(mod, name, f)] = f"field {f!r} is missing"
            for f in pf:
                if f not in jf:
                    problems[(mod, name, f)] = f"field {f!r} is the port's addition"
            shared = [f for f in pf if f in jf]
            if shared != [f for f in jf if f in pf]:
                problems[(mod, name)] = f"fields out of order: {jf} vs {pf}"
    fields = set(jf or ())
    for member, value in _own_members(jcls).items():
        if member in fields:
            continue
        if not hasattr(pcls, member):
            problems[(mod, f"{name}.{member}")] = "member is missing"
            continue
        if inspect.isfunction(value):
            _compare_signature((mod, f"{name}.{member}"), value,
                               inspect.getattr_static(pcls, member), problems)
        elif isinstance(value, (staticmethod, classmethod)):
            # Bound on both sides, so a classmethod's `cls` drops out of both.
            _compare_signature((mod, f"{name}.{member}"), getattr(jcls, member),
                               getattr(pcls, member), problems)


def surface_problems(mod: str) -> dict:
    """{key: what differs} for one JAX module (relative dotted name)."""
    jmod = JAX_MODULES[mod]
    if mod not in PORT_MODULES:
        return {(mod, "*"): "the module has no counterpart in the port"}
    pmod = PORT_MODULES[mod]
    problems = {}
    for name in _public_names(jmod):
        jobj = getattr(jmod, name)
        if inspect.ismodule(jobj):
            continue
        if not hasattr(pmod, name):
            problems[(mod, name)] = "name is missing"
            continue
        pobj = getattr(pmod, name)
        if isinstance(jobj, type):
            _compare_class(mod, name, jobj, pobj, problems)
        elif callable(jobj):
            if not callable(pobj):
                problems[(mod, name)] = "callable in the JAX package only"
            else:
                _compare_signature((mod, name), jobj, pobj, problems)
    return problems


@pytest.mark.parametrize("mod", sorted(JAX_MODULES))
def test_module_surface_matches_jax(mod):
    problems = {k: v for k, v in surface_problems(mod).items() if k not in ALLOWED}
    assert not problems, "\n".join(f"{k}: {v}" for k, v in problems.items())


def test_allow_list_has_no_stale_entry():
    found = {}
    for mod in JAX_MODULES:
        found.update(surface_problems(mod))
    stale = [k for k in ALLOWED if k not in found]
    assert not stale, f"allow-list entries with no difference left: {stale}"
    assert all(isinstance(r, str) and len(r) > 20 for r in ALLOWED.values())
