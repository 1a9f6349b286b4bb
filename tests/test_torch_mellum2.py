"""mellum2-12b-a2.5b, the port's first arch with no JAX twin, against its
plain reference (``portbench/reference/mellum2-12b-a2.5b.py``) on the
CPU at one period of its layers (three windowed, one global), a window
of 32 tokens, 4-token pages and 16 experts top-4 (its E/K of 8 kept at
4 here: 16 / 4), in float32, so that the program and the reference agree
to rounding.

* YaRN: the published values' ramp (``low`` 18, ``high`` 35) and the
  frequencies at both ends; the port's rotation is the reference's.
* Grouped experts: the dropless path equals the capacity path at
  ``cf = E / K`` and the reference's ``experts``; it computes only the
  rows routed.
* The split cache: prefill and paged decode through the two pools give
  the reference's logits over prompts longer than the window plus two
  pages; the window tenant maps at most ``ceil(W / ps) + 2`` pages a lane,
  recycles, serves the tokens one pool serves, and every page of both
  tenants is back after release.
"""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_only import J_ARCH_IDS, SHARED_ARCH_IDS  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PORT_ONLY_ARCH_IDS,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.core.paged_kv import NO_BLOCK  # noqa: E402
from repro_torch.models import (init_params, make_paged_config,  # noqa: E402
                                splits_window)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import FULL_WINDOW  # noqa: E402
from repro_torch.models.layers import (YaRN, apply_rope,  # noqa: E402
                                       rope_frequencies, yarn_bounds)
from repro_torch.models.transformer import (forward, layer_windows,  # noqa: E402
                                            layer_yarns)
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402
from repro_torch.tracing import COUNTERS  # noqa: E402

ARCH = "mellum2-12b-a2.5b"
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from portbench.reference.decoder import experts  # noqa: E402
W, PS = 32, 4
#: f32 on both sides: the logits agree to rounding (max error relative to
#: max |logit|, the bound the gemma3 decode test uses)
REL_TOL = 2e-4


def _reference():
    path = ROOT / "portbench" / "reference" / f"{ARCH}.py"
    spec = importlib.util.spec_from_file_location("mellum2_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_config():
    return dataclasses.replace(smoke_config(ARCH), num_layers=4, window=W,
                               num_heads=8, num_kv_heads=2, num_experts=16,
                               experts_per_token=4, moe_capacity_factor=4.0)


def model_dict(cfg) -> dict:
    """The reference's view of ``cfg`` (a configuration file's keys)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            } | {"num_layers": cfg.num_layers,
                 "head_dim": cfg.resolved_head_dim}


def weights(params):
    """The reference's weight callbacks over the port's parameters."""
    sd = {k: v.detach() for k, v in params.state_dict().items()}

    def layer(i):
        pre = f"layers.{i}."
        return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    return (lambda: sd["embed"], layer,
            lambda: {"unembed": sd["unembed"],
                     "final_norm": sd["final_norm"]})


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    return cfg, init_params(cfg, seed=3, dtype=torch.float32, device="cpu")


def test_port_only_archs():
    """mellum2 is the port's one arch the JAX package lacks; every parity
    test iterates the other ten."""
    assert set(ARCH_IDS) - set(J_ARCH_IDS) == set(PORT_ONLY_ARCH_IDS) \
        == {ARCH}
    assert len(SHARED_ARCH_IDS) == 10 and ARCH not in SHARED_ARCH_IDS


def test_config_is_the_published_one():
    """The registered arch and the benchmark's configuration file (the
    catalog's config.json keys) agree, layer pattern included."""
    cfg = get_config(ARCH)
    pub = json.loads((ROOT / "portbench" / "configs" / f"{ARCH}.json")
                     .read_text())
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.window,
            cfg.num_experts, cfg.experts_per_token) == (
        pub["num_hidden_layers"], pub["hidden_size"],
        pub["num_attention_heads"], pub["num_key_value_heads"],
        pub["head_dim"], pub["moe_intermediate_size"], pub["vocab_size"],
        pub["sliding_window"], pub["num_experts"], pub["num_experts_per_tok"])
    full = [w == FULL_WINDOW for w in layer_windows(cfg)]
    assert full == [t == "full_attention" for t in pub["layer_types"]]
    yarn = pub["rope_parameters"]["full_attention"]
    assert layer_yarns(cfg) == [YaRN(yarn["factor"],
                                     yarn["original_max_position_embeddings"],
                                     yarn["beta_fast"], yarn["beta_slow"],
                                     yarn["attention_factor"]) if f else None
                                for f in full]
    assert cfg.rope_theta == yarn["rope_theta"] \
        == pub["rope_parameters"]["sliding_attention"]["rope_theta"]
    assert moe.dropless(moe.spec_of(cfg))
    assert abs(cfg.param_count() - 12.15e9) < 0.01e9
    for key in ("num_layers", "d_model", "num_experts", "window",
                "yarn_factor", "yarn_attention_factor"):
        assert pub[key] == getattr(cfg, key), key


def test_yarn_frequencies_at_published_values():
    cfg = get_config(ARCH)
    yarn = layer_yarns(cfg)[3]
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    assert yarn_bounds(hd, theta, yarn) == (18.0, 35.0)
    assert yarn.attention_factor == pytest.approx(0.1 * math.log(16) + 1,
                                                  abs=1e-15)
    plain = rope_frequencies(hd, theta, "cpu")
    got = rope_frequencies(hd, theta, "cpu", yarn)
    i = torch.arange(hd // 2)
    want = theta ** (-2.0 * i.double() / hd)
    torch.testing.assert_close(got[:18].double(), want[:18], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(got[36:].double(), want[36:] / 16, rtol=1e-6,
                               atol=0)
    assert torch.equal(got[:18], plain[:18])
    assert ((got[18:36] <= plain[18:36]) & (got[18:36] >= plain[18:36] / 16)
            ).all()
    # the port's rotation is the reference's, on both kinds of layer
    ref = _reference()
    x = torch.randn(7, 4, hd, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(100, 107)
    m = model_dict(cfg)
    for li in (0, 3):
        inv, scale = ref.frequencies(m, ref.is_full(m, li), "cpu")
        torch.testing.assert_close(
            apply_rope(x, pos, theta, layer_yarns(cfg)[li]),
            ref.rope(x, pos, inv, scale), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b"])
def test_grouped_experts_equal_capacity_path(arch):
    """At ``cf = E / K`` the grouped path, the capacity buffer and the
    reference's dropless ``experts`` give one result; the grouped path
    computes the routed rows alone, the buffer ``E / K`` times as many;
    a ``real_rows`` scope counts as routed only the tokens it marks."""
    cfg = tiny_config() if arch == ARCH else smoke_config(arch)
    spec = moe.spec_of(cfg)
    spec = spec._replace(capacity_factor=spec.num_experts
                         / spec.experts_per_token)
    assert moe.dropless(spec)
    params = init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    layer = params.layers[0].moe
    x = torch.randn(3, 11, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    N, K = 33, spec.experts_per_token
    c0 = dict(COUNTERS.host)
    grouped = moe.moe_apply(layer, spec, x)            # the CPU's choice
    c1 = dict(COUNTERS.host)
    capacity = moe._moe_apply(layer, spec, x)
    c2 = dict(COUNTERS.host)
    torch.testing.assert_close(grouped, capacity, rtol=1e-5, atol=1e-5)
    lw = {"moe.router": layer.router, "moe.w_in": layer.w_in,
          "moe.w_out": layer.w_out}
    ref = experts(x.reshape(N, -1), lw, K, None).reshape(x.shape)
    torch.testing.assert_close(grouped, ref, rtol=1e-5, atol=1e-5)

    def delta(a, b, name):
        return b.get(name, 0) - a.get(name, 0)
    assert delta(c0, c1, "moe.rows_routed") == N * K \
        == delta(c0, c1, "moe.rows_computed")
    C = moe.expert_capacity(spec, N)
    assert delta(c1, c2, "moe.rows_computed") == spec.num_experts * C >= N * K
    # inside real_rows only the marked tokens' rows count as routed (on
    # the device, once at the scope's end); the computed rows all count
    real = torch.zeros((3, 11), dtype=torch.bool)
    real[:, :5] = True
    r0 = COUNTERS.read()
    with moe.real_rows(real):
        moe.moe_apply(layer, spec, x)
        moe.moe_apply(layer, spec, x[:2])             # not the scope's rows
    r1 = COUNTERS.read()
    assert delta(r0, r1, "moe.rows_routed") == 15 * K + 22 * K
    assert delta(r0, r1, "moe.rows_computed") == N * K + 22 * K


def test_paged_config_splits_only_mellum2():
    cfg = get_config(ARCH)
    kv = make_paged_config(cfg, 17408, 96, page_size=16)
    assert splits_window(cfg) and not splits_window(get_config("gemma3-1b"))
    assert not splits_window(smoke_config(ARCH))      # no global layer
    # the config asks for the split, whatever its name
    gemma = get_config("gemma3-1b")
    assert splits_window(dataclasses.replace(gemma, kv_split_window=True))
    assert not splits_window(dataclasses.replace(cfg, kv_split_window=False))
    assert splits_window(dataclasses.replace(cfg, name="renamed"))
    assert kv.num_kv_layers == 7 and len(kv.window_layers) == 21
    assert kv.full_layers == (3, 7, 11, 15, 19, 23, 27)
    assert kv.window_span == 65 and kv.max_pages_per_lane == 1089
    assert kv.num_pages >= 96 * 1089 and kv.num_pages % 512 == 0
    assert kv.window_pages >= 96 * 66 and kv.window_pages < kv.num_pages
    one = one_pool(kv)
    assert one.num_kv_layers == 28 and one.kv_layers == 28


def _decode_logits(eng, lane_tokens):
    """One eager decode step with each lane's token set: its logits."""
    tokens = eng.state.tokens.clone()
    for lane, t in lane_tokens.items():
        tokens[lane] = int(t)
    eng.state = eng.state._replace(tokens=tokens)
    eng.state, logits, _ = eng._decode(eng.params, eng.state)
    return logits


def test_engine_matches_reference(tiny):
    """Prompts of 45, 61 and 50 tokens (past the window of 32 plus two
    pages), admitted into the split cache, then 14 teacher-forced decode
    steps through its two pools: every logit row the reference's, the
    prefill's first token too."""
    cfg, params = tiny
    kv = make_paged_config(cfg, seq_len=96, lanes=3, page_size=PS,
                           dtype=torch.float32)
    assert kv.split_window == W
    eng = ServingEngine(cfg, kv, params, device="cpu")
    rng = np.random.RandomState(4)
    lens, steps = (45, 61, 50), 14
    seqs = [rng.randint(0, cfg.vocab_size, n + steps).astype(np.int32)
            for n in lens]
    for lane, (n, s) in enumerate(zip(lens, seqs)):
        assert eng.admit(lane, s[:n])
    got = [[] for _ in lens]
    for t in range(steps):
        logits = _decode_logits(eng, {lane: s[n + t] for lane, (n, s)
                                      in enumerate(zip(lens, seqs))})
        for lane in range(len(lens)):
            got[lane].append(logits[lane])
    ref = _reference()
    m = model_dict(cfg)
    want = ref.served_logits(m, *weights(params),
                             [s for s in seqs], [n for n in lens], "cpu")
    for lane, n in enumerate(lens):
        g, w = torch.stack(got[lane]), want[lane][:steps]
        err = float((g - w).abs().max() / w.abs().max())
        assert err < REL_TOL, (lane, err)
    # the prefill: the model's forward at the last prompt position
    for lane, (n, s) in enumerate(zip(lens, seqs)):
        fw = forward(params, torch.from_numpy(s[:n])[None])[0, -1]
        w = ref.served_logits(m, *weights(params), [s[:n]], [n - 1],
                              "cpu")[0][0]
        assert float((fw - w).abs().max() / w.abs().max()) < REL_TOL
    # no dead page stays mapped in the window tenant
    tbl = eng.state.paged.win.block_tables.numpy()
    seq = eng.state.paged.seq_lens.numpy()
    for lane in range(len(lens)):
        mapped = np.flatnonzero(tbl[lane] != NO_BLOCK)
        assert mapped.min() == (seq[lane] - W) // PS, (lane, mapped)
        assert len(mapped) <= -(-W // PS) + 1


def one_pool(kv):
    """The split cache's config as one pool of every layer (the global
    layers' sizing, as an unsplit ``local_global`` cache is sized)."""
    return dataclasses.replace(kv, num_kv_layers=kv.kv_layers,
                               split_window=0, window_layers=(),
                               window_pages=0)


def _serve(cfg, params, split, reqs, lanes=3, quantum=2):
    """Serve ``reqs`` (fresh copies) on one engine, on the split cache or
    on one pool; the deployment, its outputs and the most window pages a
    lane mapped after any step."""
    kv = make_paged_config(cfg, seq_len=128, lanes=lanes, page_size=PS,
                           dtype=torch.float32)
    if not split:
        kv = one_pool(kv)
    scfg = make_scheduler_config(cfg, kv, max_prompt_len=96)
    me = MultiEngine(cfg, kv, params, n_engines=1, sched_cfg=scfg,
                     quantum=quantum, preemption=False, device="cpu")
    eng = me.engines[0]
    most = [0]
    inner = eng.step

    def step():
        out = inner()
        if eng.state.paged.win is not None:
            mapped = (eng.state.paged.win.block_tables != NO_BLOCK).sum(1)
            most[0] = max(most[0], int(mapped.max()))
        return out
    eng.step = step
    me.serve([Request(rid=r.rid, tokens=r.tokens.copy(),
                      max_new_tokens=r.max_new_tokens) for r in reqs],
             max_new_tokens=None, validate=True)
    return me, {r.rid: list(r.output) for r in me.finished}, most[0]


def _all_pages_back(me) -> bool:
    a = me.alloc
    return bool((a.free_top == a.capacity).all()
                and (a.owner[a.owner != -1].numel() == 0)
                and (a.refcount == 0).all())


def test_window_tenant_bounds_recycles_and_returns_every_page(tiny):
    """Five requests on three lanes through the window commits, with the
    I1-I6 checks after every window: the window tenant never maps more
    than ``ceil(W / ps) + 2`` pages a lane, recycles, and serves the
    tokens the one-pool cache serves; afterwards every page of both
    tenants is on its free stack, unowned.  The counters add up."""
    cfg, params = tiny
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(70, 12), (45, 30), (12, 40),
                                        (90, 9), (33, 6)])]
    c0 = COUNTERS.read()
    me, out, most = _serve(cfg, params, True, reqs)
    c1 = COUNTERS.read()
    assert -(-W // PS) <= most <= -(-W // PS) + 2
    assert _all_pages_back(me)
    assert me.engines[0].tenants.window is not None
    assert sorted(len(v) for v in out.values()) == [6, 9, 12, 30, 40]

    def d(name):
        return c1.get(name, 0) - c0.get(name, 0)
    assert d("kv_window_pages.recycled") > 0
    assert d("kv_window_pages.admitted_pages") \
        <= 5 * (-(-W // PS) + 1)
    assert d("kv_pages.admitted_pages") == sum(-(-len(r.tokens) // PS)
                                               for r in reqs)
    # routed: every prompt token, and each served token past the first
    # (one decode step of an active lane), at each MoE layer; the idle
    # lanes' decode rows are computed, not routed
    K, L = cfg.experts_per_token, cfg.num_layers
    real = sum(len(r.tokens) + r.max_new_tokens - 1 for r in reqs)
    assert d("moe.rows_routed") == K * L * real < d("moe.rows_computed")
    # bytes per token held: the global layer's every page, the windowed
    # layers' window only: below what one pool would hold
    per_token = (d("kv_pages.held_bytes") + d("kv_window_pages.held_bytes")) \
        / d("kv.held_tokens")
    one_pool = 2 * 4 * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    assert one_pool / 4 < per_token < one_pool
    _, one, _ = _serve(cfg, params, False, reqs)
    assert out == one


def test_benchmark_harness_serves_a_tiny_mellum2():
    """The benchmark's own path at a tiny size on the CPU: weights drawn by
    ``portbench/weights.py`` under the program's parameter names (loaded
    strictly), a backlog through the split cache, and the served tokens
    checked against the plain reference: no gap, no page astray, no
    rejection; the run's expert products computed more rows than the
    real tokens routed (idle lanes), and the new per-layer metrics read
    the counters."""
    import time
    from portbench import check, core
    model = {"name": ARCH, "arch": ARCH, "dtype": "float32",
             "num_layers": 4, "d_model": 64, "num_heads": 8,
             "num_kv_heads": 2, "head_dim": 16, "d_ff": 32,
             "vocab_size": 256, "rope_theta": 500000.0,
             "attn_pattern": "local_global", "local_per_global": 3,
             "window": 16, "num_experts": 16, "experts_per_token": 4,
             "moe_capacity_factor": 4.0, "yarn_factor": 16.0,
             "yarn_original_max_position": 64, "yarn_beta_fast": 32.0,
             "yarn_beta_slow": 1.0, "yarn_attention_factor": 1.277}
    mix = {"loop": "backlog", "requests": 3,
           "warmup": {"requests": 4, "per_call": 2},
           "prompt": {"dist": "uniform", "lo": 20, "hi": 60},
           "output": {"dist": "uniform", "lo": 10, "hi": 30},
           "engine": {"engines": 1, "lanes": 4, "page_size": 4,
                      "seq_len": 96, "max_prompt_len": 64, "quantum": 4},
           "check": {"requests": 7, "logit_gap_limit": 1e-3,
                     "logit_gap_mean_limit": 1e-3}}
    c0 = COUNTERS.read()
    run, checks = core.run_cell("tiny", model, mix, 2 ** 33 + 7, 60, False,
                                "cpu", time.perf_counter())
    assert check.correct(checks), checks
    assert checks["logit_gap"]["value"] == 0.0 and run.checked_tokens > 100
    c1 = COUNTERS.read()

    def d(name):
        return c1.get(name, 0) - c0.get(name, 0)
    assert d("kv_window_pages.recycled") > 0
    # the backlog's last steps leave lanes idle: computed, not routed
    assert 0 < d("moe.rows_routed") < d("moe.rows_computed")
    # the readers read the process's counts (other tests' too, here)
    assert 0 < core.reader_of("expert_row_use").read(run) <= 1.0
    assert 0 < core.reader_of("kv_bytes_per_token").read(run)


def test_card_keeps_the_capacity_buffer_for_a_few_rows():
    """On the card the grouped path takes over where the capacity buffer
    would hold more than ``GROUPED_MIN_ROWS`` rows (mixtral's 32-lane
    decode keeps the buffer, its prefills and mellum2's decode group); the
    CPU always groups a dropless spec; a gradient or a spec that drops
    keeps the buffer everywhere (read on ``meta`` tensors in the card's
    place: the choice reads only shapes and dtypes)."""
    def engages(arch, tokens, device="cuda", cf=None, grad=False,
                dtype=torch.bfloat16):
        spec = moe.spec_of(get_config(arch))
        spec = spec._replace(capacity_factor=cf or spec.num_experts
                             / spec.experts_per_token)
        layer = moe.MoE(spec, dtype, torch.device("meta"), None)
        x = torch.empty((1, tokens, spec.d_model), dtype=dtype,
                        device="meta", requires_grad=grad)
        fake = type("X", (), {"device": torch.device(device),
                              "dtype": x.dtype, "shape": x.shape,
                              "requires_grad": grad})()
        return moe._grouped_engages(layer, spec, fake)
    assert not engages("mixtral-8x7b", 32)
    assert engages("mixtral-8x7b", 1020)
    assert engages(ARCH, 96) and engages(ARCH, 64)
    assert engages(ARCH, 4, device="cpu")
    assert not engages(ARCH, 96, dtype=torch.float32)
    assert not engages(ARCH, 96, grad=True)
    assert not engages("mixtral-8x7b", 1020, cf=1.25)
