"""The host side of the split paged-decode kernel on the CPU: the split
planner (shapes only) and the plain split-and-merge arithmetic
(``paged_attention_split``) against the JAX package's paged attention.

Inputs come from numpy with a seed; f32, rtol = atol = 2e-5 (the JAX
kernel tests' f32 tolerance: the chunks sum in another order).
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.ops import \
    paged_decode_attention_op as j_paged  # noqa: E402
from repro.models.decode import \
    paged_decode_attention as j_paged_decode  # noqa: E402
from repro_torch.kernels._build import ptxas_report  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    MIN_CHUNK, plan_splits)
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_split  # noqa: E402

TOL = 2e-5
FULL = 1 << 30
H100_SMS = 132
PAGED_SWEEP = [(3, 2, 4, 32, 8, 5), (2, 1, 8, 64, 16, 4), (2, 4, 1, 128, 8, 6),
               (1, 2, 2, 16, 4, 3)]
# (B, KV, G, P, ps): the serving layouts, then the JAX sweeps' layouts
PLAN_SHAPES = [(4, 1, 4, 129, 16), (4, 32, 1, 33, 8)] + [
    (B, KV, G, P, ps) for B, KV, G, _, ps, P in PAGED_SWEEP]


def live_count(seq, window, S, self_mode):
    """The kernel's live positions of one lane: cached [lo, hi], then in
    the self mode the position seq_len."""
    lo = max(0, seq - window + 1)
    hi = min(seq - 1 if self_mode else seq, S - 1)
    return max(0, hi - lo + 1) + (1 if self_mode and window > 0 else 0)


@pytest.mark.parametrize("window", [FULL, 512, 19, 1])
@pytest.mark.parametrize("B,KV,G,P,ps", PLAN_SHAPES)
def test_plan_covers_every_live_range(window, B, KV, G, P, ps):
    """Chunks [s * chunk, (s + 1) * chunk), s < n_splits, cover each
    lane's live indices exactly once for every seq_len, the self position
    in the last non-empty chunk; no chunk lies wholly past the longest
    span, and each has at least MIN_CHUNK positions."""
    n_splits, chunk = plan_splits(B, KV, G, P, ps, window, H100_SMS)
    S = P * ps
    span = min(window, S) + 1
    assert chunk >= MIN_CHUNK and n_splits * chunk >= span
    assert (n_splits - 1) * chunk < span
    for self_mode in (False, True):
        for seq in range(0, S + 1):
            n = live_count(seq, window, S, self_mode)
            assert n <= span
            # the kernel's chunk bounds: t_lo = s * chunk, t_hi = min(n,
            # t_lo + chunk); the non-empty ones must tile [0, n)
            bounds = [(s * chunk, min(n, (s + 1) * chunk))
                      for s in range(n_splits) if s * chunk < n]
            starts = [lo for lo, _ in bounds]
            ends = [hi for _, hi in bounds]
            assert starts == ([0] + ends[:-1] if bounds else [])
            assert (ends[-1] if bounds else 0) == n
            if self_mode and n:
                last = max(s for s in range(n_splits) if s * chunk < n)
                assert last * chunk <= n - 1 < (last + 1) * chunk


@pytest.mark.parametrize("B,KV,G,P,ps,window", [
    (4, 1, 4, 129, 16, 19), (4, 1, 4, 129, 16, 1), (1, 1, 1, 1, 16, FULL),
    (2, 2, 2, 31, 1, FULL), (4, 32, 1, 33, 8, 31)])
def test_plan_one_split_when_span_fits_a_chunk(B, KV, G, P, ps, window):
    assert min(window, P * ps) + 1 <= MIN_CHUNK
    assert plan_splits(B, KV, G, P, ps, window, H100_SMS) == (1, MIN_CHUNK)


def test_plan_reads_shapes_only():
    """The planner takes ints, never seq_lens (a device tensor whose read
    would sync the decode step), and gives the serving splits."""
    params = inspect.signature(plan_splits).parameters
    assert list(params) == ["B", "KV", "G", "P", "ps", "window", "sm_count"]
    assert plan_splits(4, 1, 4, 129, 16, FULL, H100_SMS) == (33, 63)
    assert plan_splits(4, 1, 4, 129, 16, 512, H100_SMS) == (17, 32)
    assert plan_splits(4, 32, 1, 33, 8, FULL, H100_SMS) == (1, 265)


def paged_inputs(rng, B, KV, G, hd, ps, P):
    npages = B * P + 2
    return (rng.randn(B, KV * G, hd).astype(np.float32),
            rng.randn(npages, ps, KV, hd).astype(np.float32),
            rng.randn(npages, ps, KV, hd).astype(np.float32),
            rng.permutation(npages)[:B * P].reshape(B, P).astype(np.int32),
            rng.randint(1, P * ps - 1, size=B).astype(np.int32))


def chunks_for(ps, live):
    """1, a page, 3 pages + 1 and at least the whole live range."""
    return [1, ps, 3 * ps + 1, live + 1]


@pytest.mark.parametrize("chunk_i", range(4))
@pytest.mark.parametrize("window", [FULL, 19])
@pytest.mark.parametrize("B,KV,G,hd,ps,P", PAGED_SWEEP)
def test_split_matches_jax_ref(rng, B, KV, G, hd, ps, P, window, chunk_i):
    """The JAX op's contract (the token already in the cache)."""
    arrays = paged_inputs(rng, B, KV, G, hd, ps, P)
    chunk = chunks_for(ps, P * ps)[chunk_i]
    want = j_paged(*map(jnp.asarray, arrays), window=window, impl="ref")
    got = paged_attention_split(*map(torch.as_tensor, arrays), window, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def self_mode_case(rng):
    """Lane 0 mid-page, lane 1 at a page boundary, lane 2 inactive, lane
    3 with only the self column (its chunks past the first are empty),
    over one layer of a port-shaped pool [N + 1, L, ps, KV, hd]."""
    B, L, KV, G, hd, ps, P = 4, 2, 2, 2, 32, 4, 6
    n = 20
    pool_k = rng.randn(n + 1, L, ps, KV, hd).astype(np.float32)
    pool_v = rng.randn(n + 1, L, ps, KV, hd).astype(np.float32)
    tables = np.full((B, P), -1, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :4] = [1, 7, 3, 12]
    tables[2, :2] = [4, 6]
    return dict(q=rng.randn(B, KV * G, hd).astype(np.float32),
                pool_k=pool_k, pool_v=pool_v, tables=tables,
                seq=np.asarray([10, 16, 7, 0], np.int32),
                active=np.asarray([True, True, False, True]),
                k_new=rng.randn(B, KV, hd).astype(np.float32),
                v_new=rng.randn(B, KV, hd).astype(np.float32))


@pytest.mark.parametrize("chunk_i", range(4))
@pytest.mark.parametrize("window", [FULL, 5, 1])
def test_split_self_mode_matches_jax_decode(rng, window, chunk_i):
    """The serving decode's convention against the JAX decode's
    ``paged_decode_attention`` on the gathered pages: inactive lanes give
    zeros, empty chunks add nothing."""
    c = self_mode_case(rng)
    layer = 1
    ps, P = c["pool_k"].shape[2], c["tables"].shape[1]
    chunk = chunks_for(ps, P * ps + 1)[chunk_i]
    got = paged_attention_split(
        torch.from_numpy(c["q"]), torch.from_numpy(c["pool_k"])[:, layer],
        torch.from_numpy(c["pool_v"])[:, layer],
        torch.from_numpy(c["tables"]), torch.from_numpy(c["seq"]), window,
        chunk, k_self=torch.from_numpy(c["k_new"]),
        v_self=torch.from_numpy(c["v_new"]),
        active=torch.from_numpy(c["active"])).numpy()
    safe = np.where(c["tables"] < 0, 0, c["tables"])
    B = len(c["seq"])
    kg = c["pool_k"][safe, layer].reshape(B, P * ps, *c["pool_k"].shape[3:])
    vg = c["pool_v"][safe, layer].reshape(B, P * ps, *c["pool_v"].shape[3:])
    want = j_paged_decode(*map(jnp.asarray, (
        c["q"], kg, vg, c["k_new"], c["v_new"], c["seq"], c["active"])),
        window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert not got[2].any()


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tc16flash_mma_kernelILi256EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc16flash_mma_kernelILi256EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 214 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 64 bytes smem, 384 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    assert ptxas_report(PTXAS_LOG) == [
        dict(name="_ZN2tc16flash_mma_kernelILi256EEEvv", registers=214,
             spill_stores=0, spill_loads=0, smem=0),
        dict(name="_Z6kernelv", registers=255, spill_stores=12,
             spill_loads=16, smem=64)]
    assert ptxas_report("") == []
