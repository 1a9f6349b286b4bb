"""Sliding-window page recycling (``decode_append(window=...)``) in the
port against the JAX package, on the CPU, with no model.

Both packages step in lockstep from the same admissions and the same
numpy K/V: after every step the block tables (with their ``NO_BLOCK``
holes), seq_lens, stash rows, every field of the allocator state and the
step's stats are identical; in ``defer_refill`` mode so are the
:class:`PendingDecodeOps` (``below``, ``flush_mask``, ``flush_blocks``).
The stash is off (every recycle a flush) or on (a lane topped up to a
full stash, so that a recycle overflows, as in the JAX package's
``tests/test_lane_stash.py``).  Also held to JAX's: ``gather_kv_window``,
``compact_kv`` over a table with holes, and the reference's kept fault of
a prompt longer than ``window + 2 * page_size`` (only the newest dead
page is recycled each step, so older dead pages stay mapped until the
lane's release).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.paged_kv as jpkv  # noqa: E402
from repro.core.lane_stash import stash_push as j_stash_push  # noqa: E402
import repro_torch.core.paged_kv as pkv  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.lane_stash import stash_push  # noqa: E402
from repro_torch.core.packets import NO_BLOCK  # noqa: E402

WINDOW = 8
BASE = dict(num_kv_layers=2, kv_heads=1, head_dim=4, page_size=4,
            num_pages=64, max_lanes=3, max_pages_per_lane=12)


def configs(**kw):
    base = dict(BASE, **kw)
    return (jpkv.PagedKVConfig(dtype=jnp.float32, **base),
            pkv.PagedKVConfig(dtype=torch.float32, **base))


@functools.lru_cache(maxsize=None)
def j_decode_append(jcfg, window, defer):
    """The JAX package's ``decode_append``, compiled once per config."""
    return jax.jit(lambda st, k, v: jpkv.decode_append(
        jcfg, st, k, v, window=window, defer_refill=defer))


class Pair:
    """The two packages' paged states, stepped in lockstep."""

    def __init__(self, stash=0, **kw):
        knobs = dict(stash_size=stash, stash_watermark=1,
                     stash_refill=1) if stash else {}
        self.jcfg, self.cfg = configs(**knobs, **kw)
        self.jt = jpkv.paged_tenants(self.jcfg)
        self.tt = pkv.paged_tenants(self.cfg, "cpu")
        self.j = jpkv.init_paged_kv(self.jcfg)
        self.t = pkv.init_paged_kv(self.cfg, self.tt)
        self.rng = np.random.RandomState(0)
        self.flushes = 0

    def admit(self, lane: int, length: int):
        c = self.cfg
        k = self.rng.randn(c.num_kv_layers, length, c.kv_heads,
                           c.head_dim).astype(np.float32)
        self.j, _ = jpkv.admit_prefill(self.jcfg, self.j, jnp.int32(lane),
                                       jnp.asarray(k), jnp.asarray(k),
                                       jnp.int32(length))
        self.t, _ = pkv.admit_prefill(self.cfg, self.t, lane,
                                      torch.from_numpy(k),
                                      torch.from_numpy(k), length, self.tt)
        self.check("admit")

    def fill_stash(self, lane: int):
        """Top the lane's stash up with one centrally granted page, in
        both packages alike."""
        L = self.cfg.max_lanes
        want = np.arange(L) == lane
        jb = self.jt.service.new_burst()
        jtk = jb.malloc(self.jt.kv, jnp.arange(L, dtype=jnp.int32), 1,
                        where=jnp.asarray(want))
        jalloc, jres = self.jt.service.commit(self.j.alloc, jb,
                                              max_blocks_per_req=1)
        jstash, _ = j_stash_push(self.j.stash, jres.blocks_for(jtk)[:, 0],
                                 jnp.asarray(want))
        self.j = self.j._replace(alloc=jalloc, stash=jstash)
        tb = self.tt.service.new_burst()
        ttk = tb.malloc(self.tt.kv, torch.arange(L, dtype=torch.int32), 1,
                        where=torch.from_numpy(want))
        talloc, tres = self.tt.service.commit(self.t.alloc, tb,
                                              max_blocks_per_req=1)
        tstash, _ = stash_push(self.t.stash, tres.blocks_for(ttk)[:, 0],
                               torch.from_numpy(want))
        self.t = self.t._replace(alloc=talloc, stash=tstash)
        self.check("fill")

    def step(self, window=WINDOW, defer=False):
        c = self.cfg
        nk = self.rng.randn(c.max_lanes, c.num_kv_layers, c.kv_heads,
                            c.head_dim).astype(np.float32)
        jout = j_decode_append(self.jcfg, window, defer)(
            self.j, jnp.asarray(nk), jnp.asarray(nk))
        tout = pkv.decode_append(self.cfg, self.t, torch.from_numpy(nk),
                                 torch.from_numpy(nk), self.tt,
                                 defer_refill=defer, window=window)
        self.j, self.t = jout[0], tout[0]
        js, ts = jout[1], tout[1]
        for f in ("failed", "refill_failed", "stash_hits", "stash_misses",
                  "bursts", "stash_depth_hist", "queue_live",
                  "queue_capacity"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        for a, b in zip((*ts.core, *ts.tenant), (*js.core, *js.tenant)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if defer:
            for f in ("below", "flush_mask", "flush_blocks"):
                np.testing.assert_array_equal(
                    getattr(tout[2], f).numpy(),
                    np.asarray(getattr(jout[2], f)), err_msg=f)
            self.flushes += int(tout[2].flush_mask.sum())
        else:
            self.flushes += int(ts.tenant.blocks_freed[self.tt.kv.size_class])
        self.check("step")
        return tout

    def release(self, lanes):
        mask = np.isin(np.arange(self.cfg.max_lanes), lanes)
        self.j, _ = jpkv.release_lanes(self.jcfg, self.j, jnp.asarray(mask))
        self.t, _ = pkv.release_lanes(self.cfg, self.t,
                                      torch.from_numpy(mask), self.tt)
        self.check("release")

    def check(self, ctx: str, payload: bool = True):
        t, j = self.t, self.j
        for f in FreeListState._fields:
            np.testing.assert_array_equal(getattr(t.alloc, f).numpy(),
                                          np.asarray(getattr(j.alloc, f)),
                                          err_msg=f"{ctx}: alloc.{f}")
        for f in ("block_tables", "seq_lens", "active", "scratch_slot"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f"{ctx}: {f}")
        np.testing.assert_array_equal(t.stash.pages.numpy(),
                                      np.asarray(j.stash.pages))
        np.testing.assert_array_equal(t.stash.depth.numpy(),
                                      np.asarray(j.stash.depth))
        if payload:
            tbl = t.block_tables.numpy()
            live = np.unique(tbl[tbl >= 0])
            for name in ("k_pages", "v_pages"):
                np.testing.assert_array_equal(
                    getattr(t, name).numpy()[live],
                    np.asarray(getattr(j, name))[live], err_msg=name)


@pytest.mark.parametrize("stash", [0, 2])
@pytest.mark.parametrize("defer", [False, True])
def test_decode_append_recycles_like_jax(stash, defer):
    """Three lanes of 3, 6 and 9 tokens decode 24 steps under a window of
    8: every step identical in both packages, pages recycled on every
    lane, flushes on the burst (or pending) in both stash modes."""
    pair = Pair(stash=stash)
    for lane, n in enumerate((3, 6, 9)):
        pair.admit(lane, n)
    if stash:
        pair.fill_stash(2)
    holes = 0
    for _ in range(24):
        pair.step(defer=defer)
        tbl = pair.t.block_tables.numpy()
        lens = pair.t.seq_lens.numpy()
        for lane in range(3):
            mapped = np.flatnonzero(tbl[lane] >= 0)
            # the window's pages, and no more than one page past them
            assert len(mapped) <= -(-WINDOW // 4) + 1
            holes += int((tbl[lane, :mapped.min()] == NO_BLOCK).sum()) \
                if lens[lane] > WINDOW + 4 else 0
        if not defer:
            pkv.validate_paged_kv(pair.cfg, pair.t, pair.tt)
    assert holes > 0
    assert pair.flushes > 0
    pair.release([0, 1, 2])
    assert int(pkv.live_pages(pair.t, pair.tt)) == 0


def test_recycled_pages_go_to_the_stash_first():
    """With room in the stash a recycled page is stashed, and the central
    free count does not move."""
    pair = Pair(stash=2, max_lanes=1)
    pair.admit(0, 4)
    frees = int(pair.t.alloc.free_count[0])
    for _ in range(24):
        pair.step()
        pkv.validate_paged_kv(pair.cfg, pair.t, pair.tt)
    assert int(pair.t.alloc.free_count[0]) == frees
    assert pair.flushes == 0


def test_long_prompt_keeps_older_dead_pages():
    """A 20-token prompt under a window of 8 and pages of 4: the first
    decode step recycles page 2, the newest dead one; pages 0 and 1 are
    dead too but stay mapped, in both packages, for every later step, and
    return only with the lane's release."""
    pair = Pair(max_lanes=1)
    pair.admit(0, 20)
    first = pair.t.block_tables.numpy()[0, :2].copy()
    pair.step()
    tbl = pair.t.block_tables.numpy()[0]
    assert tbl[2] == NO_BLOCK and (tbl[:2] == first).all()
    for _ in range(12):
        pair.step()
        tbl = pair.t.block_tables.numpy()[0]
        assert (tbl[:2] == first).all()
        dead = (int(pair.t.seq_lens[0]) - WINDOW) // 4    # pages below
        assert (tbl[2:dead] == NO_BLOCK).all() and (tbl[dead:] >= 0).any()
    pkv.validate_paged_kv(pair.cfg, pair.t, pair.tt)
    pair.release([0])
    assert int(pkv.live_pages(pair.t, pair.tt)) == 0


@pytest.mark.parametrize("window", [8, 12, 64])
def test_gather_kv_window_matches_jax(window):
    """After a run with holes: every lane's windowed slots, positions and
    valid mask, both layers, identical (a window wider than the table
    clamps to it)."""
    pair = Pair()
    for lane, n in enumerate((3, 11, 17)):
        pair.admit(lane, n)
    for _ in range(9):
        pair.step()
    pair.release([1])
    for layer in range(pair.cfg.num_kv_layers):
        want = jpkv.gather_kv_window(pair.jcfg, pair.j, layer, window)
        got = pkv.gather_kv_window(pair.cfg, pair.t, layer, window)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    valid = got[3].numpy()
    assert valid[0].any() and not valid[1].any()


@pytest.mark.parametrize("max_moves", [None, 2])
def test_compact_kv_over_recycled_holes_matches_jax(max_moves):
    """Compaction of tables with recycled holes (one lane released to free
    low pages): the same moves and the same state in both packages, and
    the holes stay holes."""
    pair = Pair(num_pages=24)
    for lane, n in enumerate((5, 14, 9)):
        pair.admit(lane, n)
    for _ in range(10):
        pair.step()
    pair.release([0])
    holes = pair.t.block_tables.numpy() == NO_BLOCK
    jstate, j_moved = jpkv.compact_kv(pair.jcfg, pair.j, max_moves=max_moves)
    tstate, moved = pkv.compact_kv(pair.cfg, pair.t, pair.tt,
                                   max_moves=max_moves)
    assert moved == j_moved
    assert moved > 0 if max_moves is None else moved <= max_moves
    pair.j, pair.t = jstate, tstate
    pair.check("compact")
    assert ((pair.t.block_tables.numpy() == NO_BLOCK) == holes).all()
    pkv.validate_paged_kv(pair.cfg, pair.t, pair.tt)
    for _ in range(6):                       # decoding goes on alike
        pair.step()
