"""Orbax checkpoint backend for Sampler state (opt-in).

The default snapshot format is an atomically-written pickle
(sampler.save_state, matching the reference's dill snapshots,
reference pocomc/sampler.py:1023-1060). This module adds an
orbax-backed alternative — JAX's own checkpoint library — which stores
arrays as a real tensorstore checkpoint (mmap-able, incremental,
inspectable) instead of one opaque blob:

    sampler.save_state("run.orbax")     # directory checkpoint
    sampler.load_state("run.orbax")

orbax is an optional dependency (``pip install pocomc-tpu[orbax]``);
only '.orbax' paths need it.

Sampler state is a pytree of numpy arrays mixed with python scalars,
strings, big RNG integers and Nones; orbax's StandardCheckpointer
rejects the non-array leaves. The state is therefore split path-wise:
array leaves go to a flat StandardSave tree, everything JSON-able goes
to a JsonSave sidecar holding the full structure with array markers.
Python's json keeps arbitrary-precision ints, so the PCG64 128-bit RNG
state round-trips exactly.
"""

from __future__ import annotations

import numpy as np

_ARRAY_MARK = "__pocomc_array__"


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "'.orbax' checkpoint paths need the optional orbax package "
            "(pip install pocomc-tpu[orbax]); any other path uses the "
            "built-in pickle format.") from e
    return ocp


def _is_array(x) -> bool:
    if isinstance(x, np.ndarray):
        return True
    # jax arrays / anything exposing the protocol, but NOT scalars
    return hasattr(x, "__array__") and hasattr(x, "ndim") \
        and not np.isscalar(x)


def _split(node, path, arrays):
    """Return the JSON skeleton of `node`; array leaves are pulled into
    the flat `arrays` dict and replaced by a marker with their key."""
    if isinstance(node, dict):
        return {str(k): _split(v, f"{path}.{k}", arrays)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        out = [_split(v, f"{path}[{i}]", arrays)
               for i, v in enumerate(node)]
        return {"__tuple__": out} if isinstance(node, tuple) else out
    if _is_array(node):
        arrays[path] = np.asarray(node)
        return {_ARRAY_MARK: path}
    if isinstance(node, (np.integer,)):
        return int(node)
    if isinstance(node, (np.floating,)):
        return float(node)
    if isinstance(node, (np.bool_,)):
        return bool(node)
    return node  # str / int / float / bool / None


def _join(node, arrays):
    if isinstance(node, dict):
        if _ARRAY_MARK in node:
            return np.asarray(arrays[node[_ARRAY_MARK]])
        if "__tuple__" in node:
            return tuple(_join(v, arrays) for v in node["__tuple__"])
        return {k: _join(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_join(v, arrays) for v in node]
    return node


def save_orbax(state: dict, path) -> None:
    ocp = _ocp()
    from pathlib import Path

    arrays: dict[str, np.ndarray] = {}
    meta = _split(state, "$", arrays)
    path = Path(path).absolute()
    with ocp.Checkpointer(
            ocp.CompositeCheckpointHandler()) as ckptr:
        ckptr.save(
            path,
            args=ocp.args.Composite(
                arrays=ocp.args.StandardSave(arrays),
                meta=ocp.args.JsonSave(meta)),
            force=True)


def load_orbax(path) -> dict:
    ocp = _ocp()
    from pathlib import Path

    path = Path(path).absolute()
    with ocp.Checkpointer(
            ocp.CompositeCheckpointHandler()) as ckptr:
        out = ckptr.restore(
            path,
            args=ocp.args.Composite(
                arrays=ocp.args.StandardRestore(),
                meta=ocp.args.JsonRestore()))
    return _join(out["meta"], out["arrays"])


def is_orbax_path(path) -> bool:
    """Path convention: '.orbax' suffix or an existing orbax directory."""
    from pathlib import Path
    p = Path(path)
    return p.suffix == ".orbax" or (p.is_dir() and (p / "meta").exists())
