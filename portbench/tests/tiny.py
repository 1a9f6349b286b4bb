"""Tiny cells for the CPU tests: the two configurations' code paths at a
size a test run holds (float32, so the program and the reference agree
to rounding), and mixes of a few seconds."""
import time

from portbench import core


def model(kind: str = "dense") -> dict:
    m = {"name": "deepseek-7b", "arch": "deepseek-7b", "dtype": "float32",
         "num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256,
         "rope_theta": 10000.0, "attn_pattern": "full", "window": None,
         "num_experts": 0, "experts_per_token": 0}
    if kind == "moe":
        m.update(name="mixtral-8x7b", arch="mixtral-8x7b", num_kv_heads=2,
                 num_experts=4,
                 experts_per_token=2, moe_capacity_factor=2.0,
                 rope_theta=1e6)
    return m


def mix(loop: str = "open", limit: float = 1e-3) -> dict:
    eng = {"engines": 1, "lanes": 4, "page_size": 8, "seq_len": 96,
           "max_prompt_len": 48, "quantum": 4}
    if loop == "open":
        return {"loop": "open", "arrival": {"process": "poisson",
                                            "rate": 10.0},
                "warmup_s": 0.2,
                "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                           "lo": 8, "hi": 48},
                "output": {"dist": "lognormal", "median": 8, "sigma": 1.0,
                           "lo": 4, "hi": 16},
                "engine": eng, "drain_s": 10,
                "check": {"requests": 3, "logit_gap_limit": limit,
                          "logit_gap_mean_limit": limit}}
    return {"loop": "backlog", "requests": 2,
            "warmup": {"requests": 4, "output": {"dist": "uniform",
                                                 "lo": 4, "hi": 20}},
            "prompt": {"dist": "uniform", "lo": 20, "hi": 40},
            "output": {"dist": "uniform", "lo": 10, "hi": 20},
            "engine": eng, "check": {"requests": 2, "logit_gap_limit": limit,
                      "logit_gap_mean_limit": limit}}


def run(kind="dense", loop="open", seed=2 ** 33 + 5, seconds=0.6,
        fault=None, control=False, requests=None, mix_=None):
    """One run of a tiny cell; ``requests`` sets the sample (a backlog
    that ends before its close and a sample of every request make the
    outcome independent of the host's timing); ``mix_`` replaces the
    mix."""
    m = mix(loop) if mix_ is None else mix_
    if requests is not None:
        m["check"]["requests"] = requests
    return core.run_cell("tiny", model(kind), m, seed, seconds,
                         False, "cpu", time.perf_counter(), fault=fault,
                         control=control)
