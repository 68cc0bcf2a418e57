"""Several processes, one device each: the process group, the
``(data, model)`` rank grid with its placement rules, the collectives of
the data-parallel step, and the host-to-device prefetcher.

The names are those of ``tacotron_tpu/parallel/__init__.py``.  They load on
first use, so the model and the train step can import
:mod:`.collectives` without importing the prefetcher (which imports the
train step).
"""

import importlib

_EXPORTS = {
    "DevicePrefetcher": ".prefetch",
    "DataShard": ".collectives",
    "MeshPlan": ".mesh",
    "batch_sharding": ".mesh",
    "distributed_initialize": (".distributed", "initialize"),
    "make_mesh": ".mesh",
    "rank_grid": ".mesh",
    "replicated_sharding": ".mesh",
    "runtime_info": ".distributed",
    "shard_batch": ".mesh",
    "shard_params": ".mesh",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    where = _EXPORTS.get(name)
    if where is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = where if isinstance(where, tuple) else (where, name)
    return getattr(importlib.import_module(module, __name__), attr)
