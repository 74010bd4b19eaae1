"""Signature parity of the port with the JAX package, read with ``inspect``
(no JAX computation runs). The callables: every name of the JAX package's
top-level ``__all__``, of the ``__all__`` of each reference-name namespace
(``test_torch_namespaces.NAMESPACES``), and the public functions and
classes that every JAX module with a port counterpart defines
(``MODULES``: ``utils``, ``loader``, ``engine``, the ``ops`` modules, the
pipeline, the I/O, quality and command-line modules, ``parallel``'s
modules, ...); for a class, its constructor and its public methods. Two rules,
each a case of one parametrised test per callable:

- ``names``: every JAX parameter name is a parameter of the port's
  counterpart;
- ``optional``: no call the JAX package accepts leaves a required port
  parameter unset -- a parameter optional in JAX is optional in the port,
  and a parameter only the port has is optional.

A callable passes a rule it breaks only through ``SUBSTITUTIONS``, one line
of reason an entry, and an entry that no longer matches anything fails."""

import importlib
import inspect

import pytest

from test_torch_namespaces import NAMESPACES

MODULES = ["utils", "utils.device", "utils.keys", "utils.logging", "loader", "engine",
           "factorization", "blocksparse", "pmd_array", "dataset", "parallel.mesh",
           "parallel.multihost", "parallel.sharded", "ops.tiling", "ops.linalg", "ops.noise",
           "ops.pooling", "ops.roughness", "pipeline", "aot", "checkpoint", "volumetric",
           "metrics", "sim", "diagnostics", "serialization", "compat", "io.tiff", "io.native",
           "decomposition", "evaluation", "pmd_loader", "preprocessing_utils", "cli",
           "diagnostic_plots"]

PRNG = "a JAX PRNG key is a seeded torch.Generator in the port"
SKETCHES = "JAX's per-block PRNG keys are the per-block sketches themselves, drawn by the caller"
MESH = "the port's collectives take the caller's DeviceMesh; there is no process-wide mesh"
LOADER_MESH = "the port binds the mesh when the loader is built (PMDLoader(mesh=...))"
NOT_PORTED = "Do not port (ROADMAP.md): "

# (JAX callable, JAX parameter): (the port's parameters in its place, reason)
# (JAX callable, None): (None, reason) -- the callable is not ported
# (JAX callable, None): (port parameters, reason) -- required parameters only the port has
SUBSTITUTIONS = {
    ("engine.threshold_heuristic", "key"): (("generator",), PRNG),
    ("compat.single_block_md", "key"): (("generator",), PRNG),
    ("compat.single_residual_block_md", "key"): (("generator",), PRNG),
    ("compat.windowed_pmd", "key"): (("generator",), PRNG),
    ("compat.rank_simulation", "key1"): (("generator1",), PRNG),
    ("compat.rank_simulation", "key2"): (("generator2",), PRNG),
    ("compat.decomposition_no_normalize_approx", "key"): (("generator",), PRNG),
    ("compat.truncated_random_svd_ref", "key"): (("generator",), PRNG),
    ("pmd_loader.truncated_random_svd", "key"): (("generator",), PRNG),
    ("ops.linalg.truncated_random_svd", "key"): (("generator",), PRNG),
    ("ops.linalg.batched_truncated_random_svd", "keys"): (("sketch", "generator"),
                                                          "JAX's per-matrix keys are one sketch "
                                                          "or a torch.Generator in the port"),
    ("utils.keys.split_keys", "key"): (("generator",), PRNG),
    ("engine.single_block_md_batched", "keys"): (("sketches",), SKETCHES),
    ("engine.single_residual_block_md_batched", "keys"): (("sketches",), SKETCHES),
    ("engine.window0_chunk_step", "keys"): (("sketches",), SKETCHES),
    ("engine.window0_coset_stage", "keys"): (("sketches",), SKETCHES),
    ("engine.windowed_pmd_batched", "key"): (("sketches",), SKETCHES),
    ("parallel.sharded.sharded_block_decomposition", "keys"): (("sketches",), SKETCHES),
    ("parallel.sharded.sharded_window0_chunk_step", "keys"): (("sketches",), SKETCHES),
    ("parallel.sharded.sharded_windowed_pmd", "keys_all"): (("sketches",), SKETCHES),
    ("engine.window_keys", None): (None, NOT_PORTED + "PRNG key derivation; the pipeline draws "
                                   "each window's sketches from its stage's generator"),
    ("loader.PMDLoader.v_projection", "mesh"): ((), LOADER_MESH),
    ("loader.PMDLoader.start_v_prefetch", "mesh"): ((), LOADER_MESH),
    ("parallel.multihost.replicate_frame_sharded", "v"): (("mesh", "local", "t"),
                                                          MESH + "; the rank's own columns and "
                                                          "the movie's length in place of a "
                                                          "sharded global array"),
    ("parallel.multihost.agree_int_min", None): (("mesh",), MESH),
    ("engine.WindowedPMDResult.__init__", None): (("windows_run", "fallback"),
                                                  "the engine's result also counts the windows run "
                                                  "before the early stop (pmd.pipeline_windows) "
                                                  "and the blocks the fallback re-ran "
                                                  "(blocks.fallback)"),
    ("ops.linalg.jacobi_eigh", "sweeps"): ((), NOT_PORTED + "jacobi_eigh as XLA code; ops.jacobi_eigh "
                                          "is K4, which runs the JAX package's sweep count for k"),
    ("utils.device.ambient_device", None): (None, NOT_PORTED + "JAX's thread-local default device; "
                                            "every port entry point takes device="),
    ("utils.device.ambient_device_or_first", None): (None, NOT_PORTED + "JAX's thread-local default "
                                                     "device; every port entry point takes device="),
    ("loader.nominal_hbm_bytes", None): (None, NOT_PORTED + "utils/device.py's nominal-HBM fallback; "
                                         "the card reports its memory"),
    ("aot.BlockProgramWarmer.__init__", None): (None, NOT_PORTED + "aot.py's warms; no warm shortened a cold "
                                       "call on the card"),
    ("aot.StageWarmer.__init__", None): (None, NOT_PORTED + "aot.py's warms; no warm shortened a cold call on "
                                "the card"),
    ("aot.plan_block_stage", None): (None, NOT_PORTED + "it plans the block stage's warm programs, "
                                     "and the port warms none"),
    ("aot.clear_warm_registry", None): (None, NOT_PORTED + "the registry of warm programs, and the "
                                        "port warms none"),
    ("aot.snapshot_jax_program_configs", None): (None, NOT_PORTED + "it carries JAX's precision "
                                                 "config onto a warm thread"),
    ("aot.replay_jax_program_configs", None): (None, NOT_PORTED + "it carries JAX's precision "
                                               "config onto a warm thread"),
}


def _short(obj) -> str:
    return f"{obj.__module__.removeprefix('localmd_tpu.')}.{obj.__qualname__}"


def _module_callables(name):
    """(name, object) of what the JAX module ``name`` exports: its
    ``__all__`` when it has one, else the public functions and classes it
    defines itself."""
    mod = importlib.import_module(f"localmd_tpu.{name}" if name else "localmd_tpu")
    if hasattr(mod, "__all__"):
        names = list(mod.__all__)
    else:
        names = [n for n, o in vars(mod).items()
                 if not n.startswith("_") and callable(o) and not inspect.ismodule(o)
                 and getattr(o, "__module__", None) == mod.__name__]
    for n in names:
        obj = getattr(mod, n)
        if callable(obj) and not inspect.ismodule(obj):
            yield n, obj


def _methods(cls):
    """Public methods of a JAX class, its own and those it inherits from
    the package's classes."""
    seen = []
    for base in cls.__mro__:
        if not base.__module__.startswith("localmd_tpu"):
            continue
        for n, raw in vars(base).items():
            if n.startswith("_") or n in seen:
                continue
            if isinstance(raw, (staticmethod, classmethod)) or inspect.isfunction(raw):
                seen.append(n)
    return seen


def _collect():
    """{case id: (JAX callable, port callable or None)}. The id is the JAX
    callable's module and qualified name; a class's constructor is
    ``Class.__init__``."""
    sources = [("", n, o) for n, o in _module_callables("")]
    for name in NAMESPACES + MODULES:
        sources += [(name, n, o) for n, o in _module_callables(name)]
    cases = {}

    def add(cid, jax_obj, port_obj):
        # a classmethod binds anew on every lookup: compare what it wraps
        if cid in cases and getattr(cases[cid][1], "__func__", cases[cid][1]) is not getattr(
                port_obj, "__func__", port_obj):
            raise AssertionError(f"{cid} has two port counterparts")
        cases[cid] = (jax_obj, port_obj)

    for mod_name, n, jax_obj in sources:
        port_mod = importlib.import_module(f"localmd_tpu_torch.{mod_name}" if mod_name
                                           else "localmd_tpu_torch")
        port_obj = getattr(port_mod, n, None)
        cid = _short(jax_obj)
        if not inspect.isclass(jax_obj):
            add(cid, jax_obj, port_obj)
            continue
        add(cid + ".__init__", jax_obj, port_obj)
        if port_obj is None:
            continue
        for m in _methods(jax_obj):
            add(f"{cid}.{m}", getattr(jax_obj, m), getattr(port_obj, m, None))
    return cases


CASES = _collect()


def _params(fn):
    """name -> Parameter of ``fn``'s signature, without ``self``."""
    params = dict(inspect.signature(fn).parameters)
    params.pop("self", None)
    return params


def _variadic(p) -> bool:
    return p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)


def _optional(p) -> bool:
    return p.default is not p.empty or _variadic(p)


def _named(params):
    return {n: p for n, p in params.items() if not _variadic(p) and p.kind != p.POSITIONAL_ONLY}


@pytest.mark.parametrize("rule", ["names", "optional"])
@pytest.mark.parametrize("cid", sorted(CASES))
def test_port_accepts_every_jax_call(cid, rule):
    jax_fn, port_fn = CASES[cid]
    if port_fn is None:
        entry = SUBSTITUTIONS.get((cid, None))
        assert entry is not None and entry[0] is None, f"{cid} has no counterpart in the port"
        return
    jax_params, port_params = _params(jax_fn), _params(port_fn)
    port_named = _named(port_params)
    problems = []
    # port parameters standing in for JAX parameters, and whether each may be omitted
    substitutes = {}
    for n, p in jax_params.items():
        if _variadic(p):
            if rule == "names" and not any(q.kind == p.kind for q in port_params.values()):
                problems.append(f"*{n}: the port takes no {p.kind.description} arguments")
            continue
        if n in port_named:
            if rule == "optional" and _optional(p) and not _optional(port_named[n]):
                problems.append(f"{n}: optional in JAX, required in the port")
            continue
        entry = SUBSTITUTIONS.get((cid, n))
        if entry is None:
            problems.append(f"{n}: a JAX parameter the port does not accept")
            continue
        for q in entry[0]:
            substitutes.setdefault(q, _optional(p))
            substitutes[q] = substitutes[q] or _optional(p)
            if q not in port_named:
                problems.append(f"{n}: its substitute {q} is not a port parameter")
            elif rule == "optional" and _optional(p) and not _optional(port_named[q]):
                problems.append(f"{n}: optional in JAX, its substitute {q} required in the port")
    if rule == "optional":
        extra = SUBSTITUTIONS.get((cid, None), (None, ""))[0] or ()
        for q, p in port_params.items():
            if q in jax_params or _optional(p) or q in substitutes or q in extra:
                continue
            problems.append(f"{q}: required in the port, absent from JAX")
    assert not problems, f"{cid}: " + "; ".join(problems)


@pytest.mark.parametrize("key", sorted(SUBSTITUTIONS, key=lambda k: (k[0], k[1] or "")),
                         ids=lambda k: f"{k[0]}:{k[1]}")
def test_every_substitution_matches_and_has_a_reason(key):
    cid, jax_param = key
    port_params, reason = SUBSTITUTIONS[key]
    assert isinstance(reason, str) and reason.strip() and "\n" not in reason
    assert cid in CASES, f"{cid} is no longer a callable the test covers"
    jax_fn, port_fn = CASES[cid]
    if port_params is None:
        assert jax_param is None and port_fn is None, f"{cid} is ported now"
        return
    assert port_fn is not None, f"{cid} is not ported"
    jax_names, port_named = _params(jax_fn), _named(_params(port_fn))
    if jax_param is None:
        for q in port_params:
            assert q in port_named and not _optional(port_named[q]) and q not in jax_names, (
                f"{cid}: {q} is no longer a required parameter only the port has")
        return
    assert jax_param in jax_names, f"{cid}: JAX has no parameter {jax_param}"
    assert jax_param not in port_named, f"{cid}: the port accepts {jax_param} now"
    for q in port_params:
        assert q in port_named, f"{cid}: the port has no parameter {q}"


def test_the_cases_cover_the_named_callables():
    """The collection reaches what the comparison must hold: the entry
    points and the callables whose parameters the port lacked."""
    for cid in ("pipeline.localmd_decomposition", "factorization.compute_lowrank_factorized_svd",
                "loader.PMDLoader.__init__", "loader.PMDLoader.temporal_crop",
                "engine.threshold_heuristic", "utils.device.transient_budget_bytes",
                "utils.device.device_free_bytes", "utils.device.block_batch_budget",
                "loader.standardize_and_filter", "blocksparse.BlockSparseMatrix.__init__",
                "parallel.multihost.replicate_frame_sharded",
                "ops.tiling.BlockGrid.device_constants", "ops.tiling.BlockGrid.coset_info",
                "ops.linalg.sketch_override"):
        assert cid in CASES and CASES[cid][1] is not None, cid
