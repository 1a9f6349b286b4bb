"""Core support-core machinery of the port: packets, free-list metadata,
HMQ scheduling, the plain scheduled step, lane stash and paged KV.

The names resolve lazily (PEP 562): the allocator service imports the
core's modules, and paged KV imports the service, so importing the
package must not pull in paged KV first.
"""
__all__ = [
    "FreeListState", "FreelistInvariantError", "init_freelist", "num_free",
    "validate_freelist",
    "max_safe_lanes", "queue_occupancy", "round_robin_rank", "schedule",
    "LaneStashState", "autotune_stash", "below_watermark", "init_stash",
    "stash_clear", "stash_pop", "stash_push", "stash_push_batch",
    "validate_stash_params",
    "FREE_ALL", "NO_BLOCK", "NO_LANE", "OP_FREE", "OP_MALLOC", "OP_NOP",
    "RequestQueue", "ResponseQueue", "empty_queue", "make_queue",
    "KV_CLASS", "STATE_CLASS", "KV_TENANT", "STATE_TENANT", "SCRATCH_TENANT",
    "DecodeStats", "PagedKVConfig", "PagedKVState",
    "admit_prefill", "admit_prefill_many", "decode_append",
    "empty_decode_stats", "gather_kv", "init_paged_kv", "kv_pages_in_use",
    "live_pages", "num_alloc_classes", "paged_service",
    "release_lanes", "release_packets",
    "stash_depth_histogram", "validate_paged_kv",
    "StepStats",
]


def __getattr__(name):
    if name in __all__:
        from importlib import import_module
        for module in ("packets", "freelist", "hmq", "lane_stash",
                       "support_core", "paged_kv"):
            mod = import_module(f".{module}", __name__)
            if hasattr(mod, name):
                return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
