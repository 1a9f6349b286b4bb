"""The hybrid family's ``ServingEngine`` in the port, on the CPU, against
the JAX package's, in f32 with the JAX parameters carried across by
``params_from_numpy``, at ``smoke_config("zamba2-1.2b")`` (the shared
block once) and at 4 layers with ``attn_every`` 2 (twice, two KV
layers).

Both engines admit two prompts (9 and 6 tokens, ``RandomState(1)``) in
one burst, step 6 times, release lane 0, admit a third prompt into it,
step 3 more times and release both lanes.  After every operation the
tokens must be equal and the allocator state bit-identical in all three
tenants (``kv_pages``, ``state_slots``, ``scratch``), with the tables,
``seq_lens``, state and scratch slots and stashes; the recurrent state
within rtol = atol = 1e-4 (f32, sums in another order).

The double fold of the last prompt token, a fault of the reference that
the port keeps, is shown in both packages: the first generated token is
the argmax of ``forward(prompt + [prompt[-1]])``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve.engine import AdmissionItem as JItem  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import AdmissionItem, ServingEngine  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-4)
DEPTHS = {"smoke": {}, "reduced": dict(num_layers=4, attn_every=2)}
PAGED = dict(seq_len=48, lanes=2, page_size=4)


@pytest.fixture(scope="module", params=list(DEPTHS))
def model(request):
    jcfg = dataclasses.replace(j_smoke_config(ARCH), **DEPTHS[request.param])
    cfg = dataclasses.replace(smoke_config(ARCH), **DEPTHS[request.param])
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return request.param, jcfg, cfg, jparams, tparams


def _paged_diff(tp, jp) -> list[str]:
    out = [f for f in FreeListState._fields
           if not np.array_equal(getattr(tp.alloc, f).numpy(),
                                 np.asarray(getattr(jp.alloc, f)))]
    for f in ("block_tables", "seq_lens", "active", "state_slot",
              "scratch_slot"):
        if not np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))):
            out.append(f)
    for f in ("pages", "depth"):
        if not np.array_equal(getattr(tp.stash, f).numpy(),
                              np.asarray(getattr(jp.stash, f))):
            out.append(f"stash.{f}")
    return out


def _engines(jcfg, cfg, jparams, tparams):
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **PAGED)
    tkv = make_paged_config(cfg, dtype=torch.float32, **PAGED)
    for f in ("num_kv_layers", "num_pages", "max_pages_per_lane",
              "state_slots", "scratch_slots", "stash_size",
              "stash_watermark", "stash_refill"):
        assert getattr(tkv, f) == getattr(jkv, f), f
    return (JEngine(jcfg, jkv, jparams, dtype=jnp.float32,
                    alloc_backend="jnp"),
            ServingEngine(cfg, tkv, tparams, device="cpu"))


@pytest.fixture(scope="module")
def served(model):
    """Both engines: two prompts (9 and 6 tokens) admitted in one burst, 6
    steps, lane 0 released, a new 9-token prompt admitted into it, 3 more
    steps, both lanes released.  Records tokens and state differences
    after every operation."""
    depth, jcfg, cfg, jparams, tparams = model
    jeng, teng = _engines(jcfg, cfg, jparams, tparams)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 6, 9)]
    log = []                              # (operation, tokens or None, diff)

    def record(what, tokens=None):
        log.append((what, tokens, _paged_diff(teng.state.paged,
                                              jeng.state.paged)))

    assert jeng.admit_many([JItem(0, prompts[0]), JItem(1, prompts[1])]) \
        == teng.admit_many([AdmissionItem(0, prompts[0]),
                            AdmissionItem(1, prompts[1])]) == []
    assert jeng.admitted_tokens == teng.admitted_tokens == {}
    record("admit")
    seq0 = teng.state.paged.seq_lens.tolist()
    for s in range(6):
        record(f"step {s}", (np.asarray(jeng.step()), teng.step()))
        if s == 0:
            seq1 = teng.state.paged.seq_lens.tolist()
    for e in (jeng, teng):
        e.release([0])
    record("release 0")
    assert jeng.admit(0, prompts[2]) and teng.admit(0, prompts[2])
    record("admit 2")
    for s in range(3):
        record(f"step {6 + s}", (np.asarray(jeng.step()), teng.step()))
    rec = (teng.state.rec, jeng.state.rec)
    for e in (jeng, teng):
        e.release([0, 1])
    record("release all")
    return dict(jeng=jeng, teng=teng, log=log, prompts=prompts, rec=rec,
                seq=(seq0, seq1), cfg=(jcfg, cfg), params=(jparams, tparams))


def test_engine_tokens_equal_jax(served):
    steps = [(w, t) for w, t, _ in served["log"] if t is not None]
    assert len(steps) == 9
    for what, (j, t) in steps:
        np.testing.assert_array_equal(t, j, err_msg=what)


def test_engine_state_bit_identical_in_every_tenant(served):
    """FreeListState (every class), tables, seq_lens, state and scratch
    slots and stash after every operation; the tenant reports equal."""
    for what, _, diff in served["log"]:
        assert not diff, f"after {what}: {diff} differ from JAX"
    jeng, teng = served["jeng"], served["teng"]
    assert [t.name for t in teng.tenants.handles] == \
        ["kv_pages", "state_slots", "scratch"]
    assert teng.tenant_report() == jeng.tenant_report()
    rep = teng.tenant_report()
    assert rep["state_slots"]["size_class"] == 1
    assert rep["scratch"]["size_class"] == 2
    assert all(d["used"] == 0 for d in rep.values())
    assert rep["state_slots"]["alloc_count"] == 3 == \
        rep["state_slots"]["free_count"]
    for f in ("admitted", "completed", "decode_steps", "alloc_failures",
              "hmq_admit_bursts", "hmq_release_bursts", "decode_bursts",
              "stash_hits", "stash_misses", "burst_slots_live",
              "burst_slots_capacity", "tenants"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_engine_recurrent_state_matches_jax(served):
    trec, jrec = served["rec"]
    assert trec.ssm.dtype == torch.float32
    np.testing.assert_allclose(trec.ssm.numpy(), np.asarray(jrec.ssm), **TOL)
    np.testing.assert_allclose(trec.conv.numpy(), np.asarray(jrec.conv),
                               **TOL)


def test_double_fold_of_last_prompt_token_in_both_packages(served):
    """The reference seeds decode with the last prompt token AFTER the
    prefill folded it: the first generated token is the argmax of
    ``forward(prompt + [prompt[-1]])``, and the first step writes a
    ``len(prompt) + 1``-th K/V.  The port keeps the fault for parity."""
    jcfg, cfg = served["cfg"]
    jparams, tparams = served["params"]
    (_, (jtok, ttok), _) = next(e for e in served["log"]
                                if e[0] == "step 0")
    for lane in (0, 1):
        p = served["prompts"][lane]
        twice = np.concatenate([p, p[-1:]])[None]
        j_twice = int(np.asarray(j_forward(jparams, jcfg, jnp.asarray(twice),
                                           remat=False))[0, -1].argmax())
        t_twice = int(forward(tparams, torch.as_tensor(twice))[0, -1]
                      .argmax())
        assert int(jtok[lane]) == j_twice
        assert int(ttok[lane]) == t_twice == j_twice
    seq0, seq1 = served["seq"]
    assert seq0 == [9, 6] and seq1 == [10, 7]
