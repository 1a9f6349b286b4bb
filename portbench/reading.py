"""What the per-layer readers (``metrics/<metric>.py``) share: the window's
calls, the traced span's kernel work against the chip's peaks, and the
model FLOPs of what was served.  Each returns ``None`` where the run has
nothing to read (no trace, no call of the kernel, a chip without peaks).
"""
from __future__ import annotations

from typing import Optional

from .core import end_to_end
from .peaks import peaks_of
from .work import flash_attention, model as model_work, paged_attention, \
    support_core


def _peaks(run) -> Optional[dict]:
    return peaks_of(run.device_name) if run.device == "cuda" else None


def roofline(run, kernel: str) -> Optional[float]:
    """Percent: the least time of the kernel's launches in the traced span
    (the larger of its operations over the peak rate and its bytes over
    the peak bandwidth, summed launch by launch from their shapes) over
    the device time the profiler gave that kernel's names."""
    pk = _peaks(run)
    t = run.trace
    if pk is None or t is None or not t.get("kernel_s", {}).get(kernel):
        return None
    calls = run.window_calls(traced=True)
    bw = pk["hbm_bytes_per_s"]
    if kernel == "paged_attention":
        least = 0.0
        for w in calls:
            flops, nbytes = paged_attention.work(run.model, w.live_keys,
                                                 w.lane_steps)
            least += max(flops / pk["bf16_flops"], nbytes / bw)
    elif kernel == "flash_attention":
        least = 0.0
        for w in calls:
            for n in w.prompts:
                flops, nbytes = flash_attention.work(run.model, [n])
                least += max(flops / pk["bf16_flops"], nbytes / bw)
    elif kernel == "support_core":
        ops, nbytes = support_core.work(t["launches"]["support_core"],
                                        run.classes, run.pages, t["slots"])
        least = max(ops / pk["f32_flops"], nbytes / bw)
    else:
        raise ValueError(f"no work model for kernel {kernel!r}")
    return 100.0 * least / t["kernel_s"][kernel]


def decode_flops(calls: list, model: dict) -> float:
    return sum(model_work.decode_flops(model, w.live_keys, w.lane_steps)
               for w in calls)


def prefill_flops(calls: list, model: dict) -> float:
    return sum(model_work.prefill_flops(model, w.prompts) for w in calls
               if w.prompts)


def mfu(run) -> Optional[float]:
    """Percent: model FLOPs of every prefill and decode token of the
    window over the window's seconds at the bf16 peak."""
    pk = _peaks(run)
    if pk is None:
        return None
    calls = run.window_calls()
    flops = decode_flops(calls, run.model) + prefill_flops(calls, run.model)
    return 100.0 * flops / (run.window_s * pk["bf16_flops"])


def step_mfu(run) -> Optional[float]:
    """Percent: model FLOPs of the decode steps over the steps' wall
    seconds (``step_window``'s own timing) at the bf16 peak."""
    pk = _peaks(run)
    calls = run.window_calls()
    step_s = sum(sum(w.step_us) for w in calls) / 1e6
    if pk is None or not step_s:
        return None
    return 100.0 * decode_flops(calls, run.model) / (step_s * pk["bf16_flops"])


def rest_seconds(w) -> float:
    """A call's wall time outside its decode steps."""
    return (w.t1 - w.t0) - sum(w.step_us) / 1e6


def prefill_mfu(run) -> Optional[float]:
    """Percent: model FLOPs of the admitted prompts over the windows' wall
    time outside their decode steps, where the prefills run, at the bf16
    peak."""
    pk = _peaks(run)
    calls = run.window_calls()
    rest = sum(rest_seconds(w) for w in calls if w.prompts)
    if pk is None or not rest:
        return None
    return 100.0 * prefill_flops(calls, run.model) / (rest * pk["bf16_flops"])


def decode_step_ms(run) -> Optional[float]:
    steps = [u for w in run.window_calls() for u in w.step_us]
    return sum(steps) / len(steps) / 1e3 if steps else None


def window_rest_ms(run) -> Optional[float]:
    calls = run.window_calls()
    if not calls:
        return None
    return 1e3 * sum(rest_seconds(w) for w in calls) / len(calls)


def commits_per_1k_tokens(run) -> Optional[float]:
    """Support-core launches of the window per 1000 output tokens (0
    launches: the plain path, nothing to read)."""
    n = run.launches.get("support_core", 0)
    if not n or not run.window_tokens:
        return None
    return 1000.0 * n / run.window_tokens


def tail_ms(run, name: str) -> Optional[float]:
    """An open loop's tail (``ttft_p90_ms`` or ``tpot_p90_ms``) as the
    harness core reads it, for a cell that reports it per layer."""
    return end_to_end(run).get(name)


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or "busy_s" not in t:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
