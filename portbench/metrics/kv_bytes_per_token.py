"""Allocator layer (alloc/service.py, core/paged_kv.py, core/hmq.py): the
K/V bytes the lanes hold for each token they hold, summed over every
decode step of the run: each KV tenant's pages mapped for the active
lanes times its page's bytes, over the tokens those lanes hold (the
program's process-wide counters, which outlive the engine).  Nothing
where the program keeps no such counters."""


def read(run):
    try:
        from repro_torch.tracing import COUNTERS
    except ImportError:
        return None
    c = COUNTERS.read()
    held = [v for k, v in c.items() if k.endswith(".held_bytes")]
    tokens = c.get("kv.held_tokens", 0)
    if not held or not tokens:
        return None
    return sum(held) / tokens
