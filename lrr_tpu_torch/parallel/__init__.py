"""Multi-rank distribution over torch.distributed (lrr_tpu/parallel).

Lazy re-exports (PEP 562), as lrr_tpu's: launcher code imports
`lrr_tpu_torch.parallel.distributed` alone to call
`maybe_initialize_distributed()` first, without the modules the other two
pull in.
"""

_EXPORTS = {
    "distributed_normal_equations": "lrr_tpu_torch.parallel.sharding",
    "make_mesh": "lrr_tpu_torch.parallel.sharding",
    "shard_candidates": "lrr_tpu_torch.parallel.sharding",
    "halo_exchange": "lrr_tpu_torch.parallel.spatial",
    "score_halo": "lrr_tpu_torch.parallel.spatial",
    "sharded_feature_score": "lrr_tpu_torch.parallel.spatial",
    "global_mesh": "lrr_tpu_torch.parallel.distributed",
    "global_to_host_local": "lrr_tpu_torch.parallel.distributed",
    "host_local_to_global": "lrr_tpu_torch.parallel.distributed",
    "maybe_initialize_distributed": "lrr_tpu_torch.parallel.distributed",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
