"""The harness's arithmetic on known inputs: the union of device
intervals and the idle gaps by host span, the window's rate and tails
over every due request, and each kernel's work from its shapes."""
import math
import types

import pytest

from portbench import core, reading, trace
from portbench import traffic as tr
from portbench.work import flash_attention, model as model_work, \
    paged_attention, support_core

MIXTRAL = {"num_layers": 16, "d_model": 4096, "num_heads": 32,
           "num_kv_heads": 8, "head_dim": 128, "d_ff": 14336,
           "vocab_size": 32000, "window": None, "num_experts": 8,
           "experts_per_token": 2}
DEEPSEEK = {"num_layers": 30, "d_model": 4096, "num_heads": 32,
            "num_kv_heads": 32, "head_dim": 128, "d_ff": 11008,
            "vocab_size": 102400, "window": None, "num_experts": 0}


def test_union_of_intervals():
    busy, merged = trace.union_seconds([(0, 10), (5, 20), (30, 40),
                                        (40, 45), (50, 51)])
    assert busy == pytest.approx(36e-9)
    assert merged == [[0, 20], [30, 45], [50, 51]]


def test_idle_gaps_by_host_span():
    # host: one call from 1.0 s to 2.0 s with a decode step 1.2-1.5 s
    w = core.Window(t0=1.0, t1=2.0, steps=[(1.2, 1.5)])
    ev = [("void paged_attention_kernel<bf16>(int)", 1_300_000_000,
           1_400_000_000),
          ("flash_mma_kernel", 1_600_000_000, 1_700_000_000)]
    s = trace.summarise(ev, 1.0, 3.0, 0, [w])
    assert s["busy_s"] == pytest.approx(0.2)
    assert s["window_s"] == pytest.approx(2.0)
    gaps = dict(s["idle_gaps"])
    assert gaps[trace.STEP] == pytest.approx(0.1 + 0.1)
    assert gaps[trace.REST] == pytest.approx(0.2 + 0.1 + 0.3)
    assert gaps[trace.LOOP] == pytest.approx(1.0)
    assert sum(gaps.values()) == pytest.approx(1.8)
    assert s["kernel_s"]["paged_attention"] == pytest.approx(0.1)
    assert s["kernel_s"]["flash_attention"] == pytest.approx(0.1)
    assert s["device_ops"][0][0] == "paged_attention_kernel"


def _run(**kw):
    run = core.Run(cell="c", model=DEEPSEEK, mix={"loop": "open"}, seed=0,
                   seconds=10, device="cuda",
                   device_name="NVIDIA H100 80GB HBM3")
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _req(due, first, done, n, state="finished"):
    item = tr.Item(0, due, None, n, "window")
    return core.Req(item, types.SimpleNamespace(output=[0] * n, state=state),
                    due, first=first, done=done)


def test_window_rate_and_tails_over_every_due_request():
    reqs = [_req(0.0, 0.1 * (i + 1), 0.1 * (i + 1) + 1.0, 11)
            for i in range(9)]
    reqs.append(_req(0.0, None, None, 0, state="waiting"))   # failed
    run = _run(reqs=reqs, w_begin=0.0, w_end=4.0, window_tokens=400,
               t_drained=20.0, setup_s=3.0)
    e = core.end_to_end(run)
    assert e["output_tokens_per_s"] == pytest.approx(100.0)
    # the failed request lies above every served one
    assert e["ttft_p90_ms"] == pytest.approx(900.0)
    assert e["tpot_p90_ms"] == pytest.approx(100.0)
    assert core.attempted_failed(run) == (10, 1)
    reqs[-1] = _req(0.0, 0.05, 0.2, 11)
    e = core.end_to_end(_run(reqs=reqs, w_begin=0, w_end=4.0,
                             window_tokens=1, t_drained=20.0, setup_s=3.0))
    assert e["ttft_p90_ms"] == pytest.approx(800.0)


def test_paged_work_counts_live_keys():
    flops, nbytes = paged_attention.work(MIXTRAL, live_keys=1000,
                                         lane_steps=10)
    assert flops == 4 * 32 * 128 * 1000 * 16
    assert nbytes == (2 * 8 * 128 * 1000 + 2 * 32 * 128 * 10) * 2 * 16


def test_flash_work_within_the_window():
    assert flash_attention.attended_pairs(4, None) == 10
    assert flash_attention.attended_pairs(6, 4) == 10 + 2 * 4
    assert flash_attention.attended_pairs(5000, 4096) == \
        4096 * 4097 // 2 + 904 * 4096
    flops, nbytes = flash_attention.work(DEEPSEEK, [100, 200])
    pairs = 100 * 101 // 2 + 200 * 201 // 2
    assert flops == 4 * 32 * 128 * pairs * 30
    assert nbytes == (2 * 32 + 2 * 32) * 128 * 300 * 2 * 30


def test_support_core_and_model_work():
    ops, nbytes = support_core.work(launches=2, classes=2, pages=512,
                                    slots=16)
    assert nbytes == 4 * (2 * 2 * (3 * 2 * 512 + 12) + 6 * 16)
    assert ops == 12 * 2 * 512 * 2 + 4 * 16
    # mixtral: two experts of three d x ff matrices a token
    assert model_work.linear_params(MIXTRAL) == \
        4096 * 48 * 128 + 4096 * 4096 + 2 * 3 * 4096 * 14336 + 4096 * 8
    dec = model_work.decode_flops(DEEPSEEK, live_keys=600, lane_steps=1)
    assert dec == 2 * model_work.linear_params(DEEPSEEK) * 30 \
        + 2 * 4096 * 102400 + 4 * 32 * 128 * 600 * 30


def test_rooflines_and_mfu_from_a_record():
    w = core.Window(t0=0.0, t1=1.0, step_us=[500000.0], prompts=[1000],
                    lane_steps=40, live_keys=40 * 600)
    run = _run(windows=[w], first_window=0, last_window=1, w_begin=0.0,
               w_end=1.0, window_tokens=40, classes=2, pages=5632)
    run.trace = {"first": 0, "last": 1, "busy_s": 0.25, "window_s": 1.0,
                 "launches": {"support_core": 10}, "slots": 100,
                 "kernel_s": {"paged_attention": 0.01,
                              "flash_attention": 0.02,
                              "support_core": 0.0001}}
    fl, nb = paged_attention.work(DEEPSEEK, 40 * 600, 40)
    assert reading.roofline(run, "paged_attention") == \
        pytest.approx(100 * nb / 3.35e12 / 0.01)
    fl, nb = flash_attention.work(DEEPSEEK, [1000])
    assert reading.roofline(run, "flash_attention") == \
        pytest.approx(100 * max(fl / 989e12, nb / 3.35e12) / 0.02)
    assert 0 < reading.roofline(run, "support_core") < 100
    assert reading.idle_share(run) == pytest.approx(0.75)
    decode = model_work.decode_flops(DEEPSEEK, 40 * 600, 40)
    assert reading.step_mfu(run) == pytest.approx(100 * decode / 0.5
                                                  / 989e12)
    assert reading.decode_step_ms(run) == pytest.approx(500.0)
    assert reading.window_rest_ms(run) == pytest.approx(500.0)
    assert reading.commits_per_1k_tokens(run) is None     # no launches
    run.launches = {"support_core": 4}
    assert reading.commits_per_1k_tokens(run) == pytest.approx(100.0)
    cpu = _run(device="cpu", device_name="cpu", windows=[w], w_end=1.0,
               last_window=1)
    assert reading.mfu(cpu) is None and math.isfinite(reading.mfu(run))
