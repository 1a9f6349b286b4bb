"""The port's two attention ops on the CPU (their plain versions) against
the JAX package's, and each CUDA kernel against its plain version on the
card (``cuda`` marker; skips on a host without one).

Inputs come from numpy with a seed.  f32 everywhere on the CPU: rtol =
atol = 2e-5, the JAX kernel tests' f32 tolerance (sums taken in another
order).  On the card: 2e-5 in f32, 2e-2 (paged) / 3e-2 (flash) in bf16,
the JAX tests' tolerances.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention_op as j_flash  # noqa: E402
from repro.kernels.paged_attention.ops import \
    paged_decode_attention_op as j_paged  # noqa: E402
from repro.models.attention import naive_attention as j_naive  # noqa: E402
from repro.models.decode import \
    paged_decode_attention as j_paged_decode  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_KERNEL, flash_attention_op)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    PAGED_KERNEL, paged_decode_attention_op, plan_splits)
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_split  # noqa: E402

TOL = 2e-5
FULL = 1 << 30
# the sweeps of tests/test_kernels.py, run here in f32
PAGED_SWEEP = [(3, 2, 4, 32, 8, 5), (2, 1, 8, 64, 16, 4), (2, 4, 1, 128, 8, 6),
               (1, 2, 2, 16, 4, 3)]
FLASH_SWEEP = [(32, 32, 4, 2, 32, True, FULL), (64, 64, 4, 1, 64, True, 24),
               (32, 32, 2, 2, 32, False, FULL), (64, 64, 8, 2, 128, True, FULL)]


def paged_inputs(rng, B, KV, G, hd, ps, P, dtype=np.float32):
    npages = B * P + 2
    return (rng.randn(B, KV * G, hd).astype(dtype),
            rng.randn(npages, ps, KV, hd).astype(dtype),
            rng.randn(npages, ps, KV, hd).astype(dtype),
            rng.permutation(npages)[:B * P].reshape(B, P).astype(np.int32),
            rng.randint(1, P * ps - 1, size=B).astype(np.int32))


def t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("B,KV,G,hd,ps,P", PAGED_SWEEP)
@pytest.mark.parametrize("window", [FULL, 19])
def test_paged_op_matches_jax_ref(rng, B, KV, G, hd, ps, P, window):
    arrays = paged_inputs(rng, B, KV, G, hd, ps, P)
    want = j_paged(*map(jnp.asarray, arrays), window=window, impl="ref")
    got = paged_decode_attention_op(*t(*arrays), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_paged_op_matches_pallas_interpret(rng):
    arrays = paged_inputs(rng, 2, 2, 2, 16, 4, 3)
    want = j_paged(*map(jnp.asarray, arrays), window=7, impl="kernel",
                   interpret=True)
    got = paged_decode_attention_op(*t(*arrays), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_paged_op_no_block_slot_and_shared_tables(rng):
    """tests/test_prefix_alias.py's case: position ``seq_len`` of lane 0
    falls in a NO_BLOCK slot, which is read as page 0 (validity is by
    position only), and an aliased page reads bit-identically to a private
    copy of it."""
    B, KV, G, hd, ps = 2, 2, 2, 32, 8
    q = rng.randn(B, KV * G, hd).astype(np.float32)
    kp = rng.randn(12, ps, KV, hd).astype(np.float32)
    vp = rng.randn(12, ps, KV, hd).astype(np.float32)
    seq = np.asarray([3 * ps, 3 * ps - 2], np.int32)
    shared = np.asarray([[0, 1, 2, -1], [0, 1, 3, -1]], np.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[10:12], vp2[10:12] = kp[0:2], vp[0:2]
    private = np.asarray([[0, 1, 2, -1], [10, 11, 3, -1]], np.int32)
    got_shared = paged_decode_attention_op(*t(q, kp, vp, shared, seq))
    got_private = paged_decode_attention_op(*t(q, kp2, vp2, private, seq))
    assert torch.equal(got_shared, got_private)
    want = j_paged(*map(jnp.asarray, (q, kp, vp, shared, seq)), impl="ref")
    np.testing.assert_allclose(got_shared.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def self_mode_case(rng, window):
    """Four lanes over a pool laid out like the port's ([N + 1, L, ps, KV,
    hd], read through one layer's view): lane 0 mid-page, lane 1 at a page
    boundary (its next page not granted yet), lane 2 inactive, lane 3
    empty (only the self column)."""
    B, L, KV, G, hd, ps, P = 4, 2, 2, 2, 32, 4, 6
    n = 20
    pool_k = rng.randn(n + 1, L, ps, KV, hd).astype(np.float32)
    pool_v = rng.randn(n + 1, L, ps, KV, hd).astype(np.float32)
    seq = np.asarray([10, 16, 7, 0], np.int32)
    tables = np.full((B, P), -1, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :4] = [1, 7, 3, 12]
    tables[2, :2] = [4, 6]
    active = np.asarray([True, True, False, True])
    q = rng.randn(B, KV * G, hd).astype(np.float32)
    k_new = rng.randn(B, KV, hd).astype(np.float32)
    v_new = rng.randn(B, KV, hd).astype(np.float32)
    return pool_k, pool_v, tables, seq, active, q, k_new, v_new


@pytest.mark.parametrize("window", [FULL, 5, 1])
def test_paged_self_mode_matches_jax_decode(rng, window):
    """The self mode's plain version on one layer of a port-shaped pool
    against the JAX decode's ``paged_decode_attention`` on the gathered
    pages, and against the JAX op once each token's K/V is written at
    ``seq_len`` (a fresh page at the boundary)."""
    pool_k, pool_v, tables, seq, active, q, k_new, v_new = \
        self_mode_case(rng, window)
    layer = 1
    got = paged_decode_attention_op(
        *t(q), torch.from_numpy(pool_k)[:, layer],
        torch.from_numpy(pool_v)[:, layer], *t(tables, seq), window,
        k_self=torch.from_numpy(k_new), v_self=torch.from_numpy(v_new),
        active=torch.from_numpy(active)).numpy()
    ps, P = pool_k.shape[2], tables.shape[1]
    safe = np.where(tables < 0, 0, tables)
    kg = pool_k[safe, layer].reshape(len(seq), P * ps, *pool_k.shape[3:])
    vg = pool_v[safe, layer].reshape(len(seq), P * ps, *pool_v.shape[3:])
    want = j_paged_decode(*map(jnp.asarray, (q, kg, vg, k_new, v_new, seq,
                                             active)), window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert not got[2].any()                       # inactive lane
    # the same lanes with the token written into the cache: the JAX op
    kl, vl = pool_k[:, layer].copy(), pool_v[:, layer].copy()
    tbl = tables.copy()
    tbl[1, 4] = 19                                 # lane 1's boundary page
    for b in range(len(seq)):
        page = tbl[b, seq[b] // ps] if tbl[b, seq[b] // ps] >= 0 else 0
        if b == 3:
            page = tbl[3, 0] = 18
        kl[page, seq[b] % ps], vl[page, seq[b] % ps] = k_new[b], v_new[b]
    op = np.asarray(j_paged(*map(jnp.asarray, (q, kl, vl, tbl, seq)),
                            window=window, impl="ref"))
    live = active
    np.testing.assert_allclose(got[live], op[live], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("Tq,Tk,H,KV,hd,causal,window", FLASH_SWEEP)
def test_flash_op_matches_jax_ref(rng, Tq, Tk, H, KV, hd, causal, window):
    B = 2
    q = rng.randn(B, Tq, H, hd).astype(np.float32)
    k = rng.randn(B, Tk, KV, hd).astype(np.float32)
    v = rng.randn(B, Tk, KV, hd).astype(np.float32)
    want = j_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                   window=window, impl="ref")
    got = flash_attention_op(*t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_flash_op_matches_pallas_interpret(rng):
    q = rng.randn(1, 16, 2, 16).astype(np.float32)
    k = rng.randn(1, 16, 1, 16).astype(np.float32)
    v = rng.randn(1, 16, 1, 16).astype(np.float32)
    want = j_flash(*map(jnp.asarray, (q, k, v)), causal=True, window=6,
                   block_q=8, block_k=8, impl="kernel", interpret=True)
    got = flash_attention_op(*t(q, k, v), causal=True, window=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, 9)])
def test_flash_op_ragged_tq_matches_jax_naive(rng, causal, window):
    """Tq = 37, no multiple of any tile: the port's op takes it (the JAX
    kernel asserts), against JAX's naive attention."""
    q = rng.randn(2, 37, 4, 32).astype(np.float32)
    k = rng.randn(2, 37, 2, 32).astype(np.float32)
    v = rng.randn(2, 37, 2, 32).astype(np.float32)
    want = j_naive(*map(jnp.asarray, (q, k, v)), causal=causal,
                   window=window)
    got = flash_attention_op(*t(q, k, v), causal=causal,
                             window=FULL if window is None else window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_cpu_tensors_launch_nothing(rng):
    PAGED_KERNEL.launches = FLASH_KERNEL.launches = 0
    paged_decode_attention_op(*t(*paged_inputs(rng, 1, 1, 2, 16, 4, 2)))
    x = torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32))
    flash_attention_op(x, x[:, :, :1].contiguous(), x[:, :, :1].contiguous())
    assert PAGED_KERNEL.launches == FLASH_KERNEL.launches == 0
    assert PAGED_KERNEL.lib is None and FLASH_KERNEL.lib is None


@pytest.mark.cuda
def test_attention_kernels_match_plain_on_card():
    """Both kernels against their plain versions on the card over the JAX
    sweeps in f32 and bf16, then the redesigned kernels' edges: bf16 flash
    around a 64-row tile with windows of 1, 100 and 512, hd 64-256, G 1-8
    and queries scaled by 8; paged lanes over no, one and every split of
    the context, against both plain versions; two identical launches
    bit-identical (``chip_smoke.py`` runs the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(3)
    for dt, tol in ((torch.float32, TOL), (torch.bfloat16, 2e-2)):
        for shape in PAGED_SWEEP:
            for window in (FULL, 19):
                arrays = paged_inputs(rng, *shape)
                cpu = [torch.as_tensor(a) for a in arrays]
                cpu[:3] = [a.to(dt) for a in cpu[:3]]
                got = paged_decode_attention_op(*[a.cuda() for a in cpu],
                                                window)
                want = paged_decode_attention_op(*cpu, window)
                torch.testing.assert_close(got.cpu().float(), want.float(),
                                           rtol=tol, atol=tol)
        tol = TOL if dt == torch.float32 else 3e-2
        for Tq, Tk, H, KV, hd, causal, window in FLASH_SWEEP:
            q, k, v = (torch.as_tensor(rng.randn(2, T, n, hd)).to(dt)
                       for T, n in ((Tq, H), (Tk, KV), (Tk, KV)))
            got = flash_attention_op(q.cuda(), k.cuda(), v.cuda(),
                                     causal=causal, window=window)
            want = flash_attention_op(q, k, v, causal=causal, window=window)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=tol, atol=tol)
    bf = torch.bfloat16
    for T in (1, 63, 65, 200, 2048):
        for window in (1, 100, 512):
            for hd in (64, 128, 256):
                for G in (1, 4, 8):
                    q = (torch.as_tensor(rng.randn(1, T, 2 * G, hd)) * 8
                         ).to(bf)
                    k, v = (torch.as_tensor(rng.randn(1, T, 2, hd)).to(bf)
                            for _ in range(2))
                    got = flash_attention_op(q.cuda(), k.cuda(), v.cuda(),
                                             window=window)
                    assert torch.equal(got, flash_attention_op(
                        q.cuda(), k.cuda(), v.cuda(), window=window))
                    want = flash_attention_op(q, k, v, window=window)
                    torch.testing.assert_close(got.cpu().float(),
                                               want.float(), rtol=3e-2,
                                               atol=3e-2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, tol in ((torch.float32, TOL), (bf, 2e-2)):
        for KV, G, hd, ps, P in ((1, 4, 256, 16, 129), (32, 1, 128, 8, 33)):
            for window in (FULL, 512):
                _, chunk = plan_splits(4, KV, G, P, ps, window, sms)
                seq = np.asarray([5, chunk - 1, min(P * ps - 1, window + 40),
                                  9], np.int32)
                n = 4 * P + 2
                cpu = [torch.as_tensor(rng.randn(4, KV * G, hd)).to(dt),
                       torch.as_tensor(rng.randn(n, ps, KV, hd)).to(dt),
                       torch.as_tensor(rng.randn(n, ps, KV, hd)).to(dt),
                       torch.as_tensor(rng.permutation(n)[:4 * P]
                                       .reshape(4, P).astype(np.int32)),
                       torch.as_tensor(seq)]
                kw = dict(k_self=torch.as_tensor(rng.randn(4, KV, hd)).to(dt),
                          v_self=torch.as_tensor(rng.randn(4, KV, hd)).to(dt),
                          active=torch.tensor([True, True, True, False]))
                for mode in ({}, kw):
                    dev_kw = {k: x.cuda() for k, x in mode.items()}
                    got = paged_decode_attention_op(
                        *[a.cuda() for a in cpu], window, **dev_kw)
                    assert torch.equal(got, paged_decode_attention_op(
                        *[a.cuda() for a in cpu], window, **dev_kw))
                    for want in (paged_decode_attention_op(*cpu, window,
                                                           **mode),
                                 paged_attention_split(*cpu, window, chunk,
                                                       **mode)):
                        torch.testing.assert_close(got.cpu().float(),
                                                   want.float(), rtol=tol,
                                                   atol=tol)
