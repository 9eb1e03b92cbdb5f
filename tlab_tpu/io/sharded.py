"""Per-shard field I/O for sharded arrays.

JAX-native equivalent of the reference's MPI-IO subarray machinery
(src/base/io_fields.f90 IO_Create_Subarray_XOZ + collective
read/write): each device's shard is streamed to its own file together
with a JSON manifest recording the global shape and the index slab of
every shard, so a restart can be reassembled (on any process count) or
re-distributed shard-by-shard without materializing the full field on
the host at once.

Layout: <path>.manifest.json + <path>.shard<k>.npy, one per addressable
shard, each an independent C-contiguous slab.
"""
from __future__ import annotations

import json
import os

import numpy as np
import jax


def _slices_to_json(idx, shape):
    out = []
    for sl, n in zip(idx, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = n if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def write_sharded(path: str, arr: jax.Array, params: dict | None = None
                  ) -> None:
    """Write each addressable shard as its own .npy slab + manifest."""
    shards = arr.addressable_shards
    manifest = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                "n_shards": len(shards), "params": params or {},
                "shards": []}
    for k, sh in enumerate(shards):
        data = np.asarray(sh.data)
        np.save(f"{path}.shard{k}.npy", data)
        manifest["shards"].append(
            {"file": os.path.basename(f"{path}.shard{k}.npy"),
             "index": _slices_to_json(sh.index, arr.shape),
             "device": str(sh.device)})
    with open(f"{path}.manifest.json", "w") as fh:
        json.dump(manifest, fh, indent=1)


def read_sharded(path: str) -> tuple[np.ndarray, dict]:
    """Reassemble the global array from the shard slabs."""
    with open(f"{path}.manifest.json") as fh:
        man = json.load(fh)
    out = np.empty(tuple(man["shape"]), dtype=np.dtype(man["dtype"]))
    base = os.path.dirname(path)
    for rec in man["shards"]:
        idx = tuple(slice(a, b) for a, b in rec["index"])
        out[idx] = np.load(os.path.join(base, rec["file"]))
    return out, man["params"]


def read_sharded_to(path: str, sharding) -> jax.Array:
    """Load shard slabs directly onto their devices (device_put per slab;
    no full-host copy when the sharding matches the manifest layout)."""
    with open(f"{path}.manifest.json") as fh:
        man = json.load(fh)
    shape = tuple(man["shape"])
    base = os.path.dirname(path)
    slabs = {}
    for rec in man["shards"]:
        idx = tuple(slice(a, b) for a, b in rec["index"])
        slabs[tuple(rec["index"][i][0] for i in range(len(shape)))] = \
            (idx, np.load(os.path.join(base, rec["file"])))

    def cb(index):
        key = tuple(0 if sl.start is None else int(sl.start) for sl in index)
        if key in slabs:
            return slabs[key][1]
        # fallback: assemble from overlapping slabs
        full, _ = read_sharded(path)
        return full[index]

    return jax.make_array_from_callback(shape, sharding, cb)


def write_state_sharded(prefix: str, itime: int, state, rtime: float,
                        visc: float) -> None:
    """Sharded restart write: flow.<it>.{1,2,3} + scal.<it>.<i> prefixes
    (reference file-per-variable naming, io_fields.f90:534)."""
    params = {"rtime": float(rtime), "visc": float(visc),
              "itime": int(itime)}
    for tag, comp in (("1", state.u), ("2", state.v), ("3", state.w)):
        write_sharded(f"{prefix}flow.{itime}.{tag}", comp, params)
    for i in range(state.s.shape[0]):
        write_sharded(f"{prefix}scal.{itime}.{i + 1}", state.s[i], params)
