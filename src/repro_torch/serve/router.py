"""Request router for multi-engine sharded serving (a copy of
:mod:`repro.serve.router`, DESIGN.md §10).

The multi-engine deployment runs N
:class:`~repro_torch.serve.engine.ServingEngine` shards as disjoint tenant
sets on ONE shared :class:`~repro_torch.alloc.AllocService`; this module
decides which shard a new
request lands on.  Routing is deliberately host-side and stateless apart
from the round-robin cursor: the router sees only scalar shard loads, never
device arrays, so it costs nothing on the step path.

Policies
--------
* ``round_robin`` — requests cycle through the shards in submission order.
  Deterministic and load-agnostic; the differential-test default (the N=1
  equivalence proof needs routing to be a pure function of arrival order).
* ``least_loaded`` — each request goes to the shard with the smallest
  current load (waiting + running requests, tie-broken by shard index so
  equal loads stay deterministic).  The sensible production default under
  skewed request lengths.
"""
from __future__ import annotations

from typing import Sequence

#: Valid values for the ``router`` argument / ``--router`` launcher flag.
ROUTER_POLICIES = ("round_robin", "least_loaded")


class Router:
    """Assigns each submitted request to an engine shard."""

    def __init__(self, policy: str = "round_robin"):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; expected "
                             f"one of {ROUTER_POLICIES}")
        self.policy = policy
        self._cursor = 0

    def route(self, loads: Sequence[int]) -> int:
        """Pick a shard for the next request.

        ``loads`` is the per-shard load vector (one entry per shard;
        ``waiting + running`` request counts is the canonical measure, see
        :func:`shard_load`).  Round-robin ignores the values but uses the
        length.
        """
        if not len(loads):
            raise ValueError("route() needs at least one shard")
        if self.policy == "round_robin":
            shard = self._cursor % len(loads)
            self._cursor += 1
            return shard
        # Tie-break on the shard index so equal loads always resolve to the
        # LOWEST-numbered shard: replaying the same arrival trace must route
        # identically run to run (the differential tests depend on it), and
        # a bare min() over a dict/generator would not promise stability.
        return min(range(len(loads)), key=lambda i: (loads[i], i))


def shard_load(sched) -> int:
    """Canonical load measure of one shard: requests it still has to finish
    (waiting queue + running lanes)."""
    return len(sched.waiting) + len(sched.running)
