"""Allocator layer (alloc/service.py, core/paged_kv.py, core/hmq.py):
support-core kernel launches in the window per 1000 output tokens (the
kernel's own launch counter)."""
from portbench import reading


def read(run):
    return reading.commits_per_1k_tokens(run)
