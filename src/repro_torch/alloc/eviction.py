"""Eviction policies for the prefix cache (a copy of
:mod:`repro.alloc.eviction`, with the policy named explicitly).

The KV prefix cache (DESIGN.md §11) retains pages past request completion
and must pick victims when its page budget fills.  Victim selection is a
seam exactly like the allocator policy: a small
protocol, a menu of classic designs, and a registry keyed by name --
mirroring the simulator-menu idiom of ZODB's ``simul.py`` (one class per
cache discipline, swapped by flag, all driven by the same event stream).
The port reads no environment variable: the caller names the policy, and
the JAX package's default (``lru``) is the default here.

Policies order *entries* (one cached page each) by an opaque hashable key;
the cache owns all page/budget accounting.  Three disciplines:

  lru — single recency list (``OrderedDict``); victim = least recent.
  2q  — Johnson & Shasha: newcomers enter the A1in FIFO and are evicted
        from it unless re-referenced, which promotes them to the Am LRU —
        one-shot scans can't flush the hot set.
  arc — Megiddo & Modha: two resident lists (T1 recency / T2 frequency)
        plus ghost lists (B1/B2) of recently evicted keys; the adaptive
        target ``p`` steals capacity toward whichever list's ghosts are
        being re-referenced.

All three see the same ``on_insert`` / ``on_hit`` / ``on_remove`` /
``victim`` event stream, so identical logical traces replay through any of
them and give comparable counts.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Protocol, runtime_checkable

__all__ = [
    "EVICTION_POLICIES", "EvictionPolicy", "LRUEviction", "TwoQEviction",
    "ARCEviction", "get_eviction", "register_eviction",
]

EVICTION_POLICIES = ("lru", "2q", "arc")


@runtime_checkable
class EvictionPolicy(Protocol):
    """Victim-selection discipline over cached-entry keys.

    The cache calls ``on_insert`` when an entry becomes resident,
    ``on_hit`` when a probe reuses it, ``on_remove`` when the cache drops
    it for a reason other than this policy's choice (cascade invalidation),
    and ``victim`` to pick + forget the next entry to evict.  Keys are
    opaque hashables (the serving cache uses page/block ids).
    """

    name: str

    def on_insert(self, key: Hashable) -> None: ...
    def on_hit(self, key: Hashable) -> None: ...
    def on_remove(self, key: Hashable) -> None: ...
    def victim(self) -> Hashable | None: ...

    def __len__(self) -> int: ...


class LRUEviction:
    """Plain LRU: one recency list, evict from the cold end."""

    name = "lru"

    def __init__(self) -> None:
        self._lru: OrderedDict[Hashable, None] = OrderedDict()

    def on_insert(self, key: Hashable) -> None:
        self._lru[key] = None
        self._lru.move_to_end(key)

    def on_hit(self, key: Hashable) -> None:
        if key in self._lru:
            self._lru.move_to_end(key)

    def on_remove(self, key: Hashable) -> None:
        self._lru.pop(key, None)

    def victim(self) -> Hashable | None:
        if not self._lru:
            return None
        key, _ = self._lru.popitem(last=False)
        return key

    def __len__(self) -> int:
        return len(self._lru)


class TwoQEviction:
    """2Q: A1in FIFO for newcomers, Am LRU for the proven-hot set.

    A hit on an A1in resident promotes it to Am; a fresh insert whose key
    sits in the A1out ghost list (recently evicted from A1in) goes straight
    to Am.  Victims drain A1in first while it exceeds ``in_frac`` of the
    resident population, shielding Am from one-shot scans.
    """

    name = "2q"

    def __init__(self, in_frac: float = 0.25, ghost_cap: int = 256) -> None:
        self.in_frac = in_frac
        self.ghost_cap = ghost_cap
        self._a1in: OrderedDict[Hashable, None] = OrderedDict()
        self._am: OrderedDict[Hashable, None] = OrderedDict()
        self._a1out: OrderedDict[Hashable, None] = OrderedDict()

    def on_insert(self, key: Hashable) -> None:
        if key in self._a1out:
            del self._a1out[key]
            self._am[key] = None
            self._am.move_to_end(key)
        else:
            self._a1in[key] = None
            self._a1in.move_to_end(key)

    def on_hit(self, key: Hashable) -> None:
        if key in self._a1in:
            del self._a1in[key]
            self._am[key] = None
        if key in self._am:
            self._am.move_to_end(key)

    def on_remove(self, key: Hashable) -> None:
        self._a1in.pop(key, None)
        self._am.pop(key, None)

    def victim(self) -> Hashable | None:
        total = len(self._a1in) + len(self._am)
        if total == 0:
            return None
        threshold = max(1, int(total * self.in_frac))
        if self._a1in and (len(self._a1in) >= threshold or not self._am):
            key, _ = self._a1in.popitem(last=False)
            self._a1out[key] = None
            while len(self._a1out) > self.ghost_cap:
                self._a1out.popitem(last=False)
            return key
        key, _ = self._am.popitem(last=False)
        return key

    def __len__(self) -> int:
        return len(self._a1in) + len(self._am)


class ARCEviction:
    """ARC: adaptive T1 (recency) / T2 (frequency) split with ghost lists.

    ``p`` is the target size of T1.  A re-insert whose key is remembered in
    ghost B1 grows ``p`` (recency was being under-served); a B2 ghost hit
    shrinks it.  Victims come from T1 while it exceeds ``p``, else from T2;
    evicted keys are remembered in the matching ghost list.
    """

    name = "arc"

    def __init__(self, ghost_cap: int = 256) -> None:
        self.ghost_cap = ghost_cap
        self.p = 0.0
        self._t1: OrderedDict[Hashable, None] = OrderedDict()
        self._t2: OrderedDict[Hashable, None] = OrderedDict()
        self._b1: OrderedDict[Hashable, None] = OrderedDict()
        self._b2: OrderedDict[Hashable, None] = OrderedDict()

    def _trim_ghost(self, ghost: OrderedDict) -> None:
        while len(ghost) > self.ghost_cap:
            ghost.popitem(last=False)

    def on_insert(self, key: Hashable) -> None:
        cap = max(1.0, float(len(self._t1) + len(self._t2) + 1))
        if key in self._b1:
            delta = max(1.0, len(self._b2) / max(1, len(self._b1)))
            self.p = min(cap, self.p + delta)
            del self._b1[key]
            self._t2[key] = None
            self._t2.move_to_end(key)
        elif key in self._b2:
            delta = max(1.0, len(self._b1) / max(1, len(self._b2)))
            self.p = max(0.0, self.p - delta)
            del self._b2[key]
            self._t2[key] = None
            self._t2.move_to_end(key)
        else:
            self._t1[key] = None
            self._t1.move_to_end(key)

    def on_hit(self, key: Hashable) -> None:
        if key in self._t1:
            del self._t1[key]
            self._t2[key] = None
        if key in self._t2:
            self._t2.move_to_end(key)

    def on_remove(self, key: Hashable) -> None:
        self._t1.pop(key, None)
        self._t2.pop(key, None)

    def victim(self) -> Hashable | None:
        if not self._t1 and not self._t2:
            return None
        if self._t1 and (len(self._t1) > self.p or not self._t2):
            key, _ = self._t1.popitem(last=False)
            self._b1[key] = None
            self._trim_ghost(self._b1)
            return key
        key, _ = self._t2.popitem(last=False)
        self._b2[key] = None
        self._trim_ghost(self._b2)
        return key

    def __len__(self) -> int:
        return len(self._t1) + len(self._t2)


_EVICTION: dict[str, type] = {
    "lru": LRUEviction,
    "2q": TwoQEviction,
    "arc": ARCEviction,
}


def get_eviction(name: str = "lru") -> EvictionPolicy:
    """Instantiate an eviction policy by name.  Each call returns a fresh
    instance: policies hold per-cache state."""
    try:
        return _EVICTION[name]()
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {name!r}; registered: "
            f"{tuple(_EVICTION)}") from None


def register_eviction(name: str, cls: type) -> None:
    """Register a custom eviction policy class under ``name``."""
    _EVICTION[name] = cls
