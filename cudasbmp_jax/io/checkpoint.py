"""Checkpoint / resume for planner state.

The reference has none (SURVEY.md §5) — its closest analog is the full-state
CSV dump at the end of plan (KGMT.cu:299-311), which is in fact a complete
checkpoint minus RNG. Because our planner state is one pytree (KGMTState,
including the RNG key and iteration counter), snapshot/restore is exact: a
resumed solve continues bit-identically from where it stopped.

Format: ``np.savez`` of the flattened pytree (orbax would also work; savez
keeps checkpoints dependency-free and human-inspectable).
"""

from __future__ import annotations

import os

import jax
import numpy as np

from cudasbmp_jax.planners.kgmt import KGMTState, PathlessState

_KEY_FIELD = "key"
_TYPE_FIELD = "__state_type__"
# registry of checkpointable state pytrees (r5: the pathless driver's state
# checkpoints/resumes exactly like the tree state)
_STATE_TYPES = {"KGMTState": KGMTState, "PathlessState": PathlessState}


def save_checkpoint(state, path: str | os.PathLike) -> None:
    """Atomic write: savez to a temp file, then os.replace — a process
    killed mid-write (fault injection, preemption) never leaves a torn file
    under the final name, so 'newest checkpoint' is always intact.
    ``state`` is any registered planner-state NamedTuple (KGMTState or
    PathlessState); the type rides in the file for load dispatch."""
    data = {_TYPE_FIELD: np.asarray(type(state).__name__)}
    for name, val in state._asdict().items():
        if name == _KEY_FIELD:
            # typed PRNG keys serialize via their raw uint32 key data
            data[name] = np.asarray(jax.random.key_data(val))
        else:
            data[name] = np.asarray(val)
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"  # savez appends it; make the rename target explicit
    tmp = path + ".tmp.npz"
    np.savez(tmp, **data)
    os.replace(tmp, path)


def load_checkpoint(path: str | os.PathLike):
    with np.load(path) as z:
        # pre-r5 checkpoints carry no type marker and are tree-state
        cls_name = (str(z[_TYPE_FIELD]) if _TYPE_FIELD in z.files
                    else "KGMTState")
        cls = _STATE_TYPES[cls_name]
        fields = {}
        for name in cls._fields:
            if name == _KEY_FIELD:
                fields[name] = jax.random.wrap_key_data(z[name])
            else:
                fields[name] = jax.numpy.asarray(z[name])
    return cls(**fields)
