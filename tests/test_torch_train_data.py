"""The port's data pipeline (a numpy copy of the JAX package's) against the
JAX one, on the CPU: every family's batch byte-identical for the same
``(seed, step, host)`` (vlm ``patches``, audio ``frames``), the pipeline
resuming from a step, and the JAX package's own pipeline tests.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.data.pipeline import DataPipeline as JDataPipeline  # noqa: E402
from repro.data.pipeline import TokenSource as JTokenSource  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from _port_only import SHARED_ARCH_IDS  # noqa: E402
from repro_torch.data import DataPipeline, TokenSource  # noqa: E402


@pytest.mark.parametrize("arch", SHARED_ARCH_IDS)
@pytest.mark.parametrize("step,host", [(0, 0), (5, 1)])
def test_batches_byte_identical_to_jax(arch, step, host):
    src, jsrc = TokenSource(smoke_config(arch), 3), \
        JTokenSource(j_smoke_config(arch), 3)
    got = src.batch(step, host, batch_size=4, seq_len=24)
    want = jsrc.batch(step, host, batch_size=4, seq_len=24)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_full_width_gemma3_batch_byte_identical_to_jax():
    """The published config's vocabulary (262144), the shape phase 6b of
    the card's smoke run trains on, one row."""
    from repro.configs import get_config as j_get_config
    got = TokenSource(get_config("gemma3-1b")).batch(2, 0, 1, 1024)
    want = JTokenSource(j_get_config("gemma3-1b")).batch(2, 0, 1, 1024)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)


@pytest.mark.parametrize("arch", ["deepseek-7b", "whisper-medium"])
def test_pipeline_resume_from_step_matches_jax(arch):
    """A pipeline started at step 3 gives the fourth batch of one started
    at 0, in both packages, byte for byte."""
    src = TokenSource(smoke_config(arch), seed=1)
    p0 = DataPipeline(src, global_batch=4, seq_len=16, start_step=0)
    first = [next(p0) for _ in range(5)]
    p0.close()
    p3 = DataPipeline(src, global_batch=4, seq_len=16, start_step=3)
    b3 = next(p3)
    p3.close()
    jp = JDataPipeline(JTokenSource(j_smoke_config(arch), seed=1),
                       global_batch=4, seq_len=16, start_step=3)
    jb3 = next(jp)
    jp.close()
    assert b3["_step"] == jb3["_step"] == 3
    for k in ("tokens", "labels"):
        assert b3[k].tobytes() == first[3][k].tobytes() == jb3[k].tobytes()


def test_deterministic_replay():
    src = TokenSource(smoke_config("deepseek-7b"), seed=3)
    a = src.batch(step=5, host=0, batch_size=4, seq_len=16)
    b = src.batch(step=5, host=0, batch_size=4, seq_len=16)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_hosts_get_different_data():
    src = TokenSource(smoke_config("deepseek-7b"), seed=3)
    a = src.batch(step=5, host=0, batch_size=4, seq_len=16)
    b = src.batch(step=5, host=1, batch_size=4, seq_len=16)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_labels_are_shifted_tokens():
    b = TokenSource(smoke_config("deepseek-7b")).batch(0, 0, 2, 8)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_host_shards_split_the_global_batch():
    """Two hosts of a global batch of 4 each synthesize 2 rows of their
    own stream."""
    src = TokenSource(smoke_config("deepseek-7b"), seed=2)
    shards = []
    for host in (0, 1):
        p = DataPipeline(src, global_batch=4, seq_len=8, num_hosts=2,
                         host_index=host)
        shards.append(next(p))
        p.close()
    for host, b in enumerate(shards):
        assert b["tokens"].shape == (2, 8)
        np.testing.assert_array_equal(b["tokens"],
                                      src.batch(0, host, 2, 8)["tokens"])
