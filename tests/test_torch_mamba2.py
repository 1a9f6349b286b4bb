"""The port's chunked linear attention and Mamba2 block on the CPU against
the JAX package's (``repro.models.linear_attention``, ``repro.models
.mamba2``), in f32.

Inputs come from a numpy seed.  The linear attention runs with Mamba2's
flags (one decay per head, ``strict=False``, ``shifted=False``) and with
RWKV6's (a decay per channel, ``strict=True``, ``shifted=True``, a bonus),
with and without an initial state, at lengths that do and do not fill the
last chunk.  The Mamba2 block's parameters are the JAX initializer's, with
the ones it zeroes (``A_log``, ``dt_bias``, ``conv_b``, ``norm_scale``)
redrawn so that every term is exercised.

Tolerance: rtol = atol = 2e-5 on every float output -- both sides compute
in f32 and differ only in the order of their sums.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import linear_attention as jla  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.models import linear_attention as tla  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)

#: (strict, shifted, per-channel decay, bonus): Mamba2's and RWKV6's
FLAGS = {"mamba2": (False, False, False, False),
         "rwkv6": (True, True, True, True)}


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL,
                               err_msg=what)


def _la_inputs(flags, T, seed, B=2, H=3, dk=8, dv=5, init=True):
    strict, shifted, per_channel, bonus = flags
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ld = -np.abs(f(B, T, H, dk if per_channel else 1)) * 0.7
    ld[0, :3] = -20.0                   # below LOG_DECAY_MIN: clamped
    return dict(q=f(B, T, H, dk), k=f(B, T, H, dk), v=f(B, T, H, dv),
                log_decay=ld, strict=strict, shifted=shifted,
                bonus=f(H, dk) if bonus else None,
                initial_state=f(B, H, dk, dv) if init else None)


def _call(fn, inputs, to):
    return fn(**{k: (to(v) if isinstance(v, np.ndarray) else v)
                 for k, v in inputs.items()})


# the JAX functions jitted (one compile per shape, not one per primitive)
J_CHUNKED = jax.jit(jla.chunked_linear_attention,
                    static_argnames=("strict", "shifted", "chunk"))
J_REF = jax.jit(jla.linear_attention_ref, static_argnames=("strict",
                                                           "shifted"))
J_STEP = jax.jit(jla.linear_attention_decode_step,
                 static_argnames=("strict",))
J_FORWARD = jax.jit(jm2.mamba2_forward_with_state, static_argnums=1)
J_DECODE = jax.jit(jm2.mamba2_decode_step, static_argnums=1)


@pytest.mark.parametrize("init", [True, False], ids=["state", "zero"])
@pytest.mark.parametrize("T", [16, 37, 5])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_chunked_linear_attention_matches_jax(flags, T, init):
    inputs = _la_inputs(FLAGS[flags], T, seed=T, init=init)
    ty, ts = _call(tla.chunked_linear_attention, inputs, torch.from_numpy)
    jy, js = _call(J_CHUNKED, inputs, jnp.asarray)
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy, "y")
    _close(ts, js, "final state")
    # the per-token scan oracle, in both packages
    ry, rs = _call(tla.linear_attention_ref, inputs, torch.from_numpy)
    jry, jrs = _call(J_REF, inputs, jnp.asarray)
    _close(ry, jry, "ref y")
    _close(rs, jrs, "ref state")
    if not FLAGS[flags][1]:
        # without the shift the scan and the chunked form agree
        np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_linear_attention_decode_step_matches_jax(flags):
    strict, _, per_channel, bonus = FLAGS[flags]
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    B, H, dk, dv = 3, 2, 8, 6
    inputs = dict(state=f(B, H, dk, dv), q=f(B, H, dk), k=f(B, H, dk),
                  v=f(B, H, dv),
                  log_decay=-np.abs(f(B, H, dk if per_channel else 1)) * 3,
                  strict=strict, bonus=f(H, dk) if bonus else None)
    ts, ty = _call(tla.linear_attention_decode_step, inputs, torch.from_numpy)
    js, jy = _call(J_STEP, inputs, jnp.asarray)
    _close(ts, js, "state")
    _close(ty, jy, "y")


SPEC = dict(d_model=32, n_state=16, head_dim=8)


@pytest.fixture(scope="module")
def block():
    """The JAX block's parameters (f32), and the same in a port module."""
    spec = jm2.make_spec(**SPEC)
    jp = jm2.init_mamba2(jax.random.PRNGKey(0), spec, jnp.float32)
    rng = np.random.RandomState(1)
    redraw = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.1, "norm_scale": 0.2,
              "D": 1.0}
    jp = {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * redraw[k])
              if k in redraw else v) for k, v in jp.items()}
    tspec = tm2.make_spec(**SPEC)
    tp = tm2.Mamba2(tspec, torch.float32, torch.device("cpu"), None)
    for k, v in jp.items():
        getattr(tp, k).data = torch.from_numpy(np.array(v))
    return spec, jp, tspec, tp


@pytest.mark.parametrize("T", [2, 21])
def test_mamba2_forward_with_state_matches_jax(block, T):
    """Output, final SSD state and conv tail (T = 2 pads the tail with a
    zero row, T = 21 spans two chunks), from zero and from a given state."""
    spec, jp, tspec, tp = block
    rng = np.random.RandomState(T)
    x = rng.randn(2, T, SPEC["d_model"]).astype(np.float32)
    s0 = rng.randn(2, spec.heads, spec.n_state,
                   spec.head_dim).astype(np.float32)
    for init in (None, s0):
        jy, js, jc = J_FORWARD(
            jp, spec, jnp.asarray(x),
            None if init is None else jnp.asarray(init))
        ty, ts, tc = tm2.mamba2_forward_with_state(
            tp, tspec, torch.from_numpy(x),
            None if init is None else torch.from_numpy(init))
        _close(ty, jy, "y")
        _close(ts, js, "ssm state")
        _close(tc, jc, "conv tail")


def test_mamba2_decode_step_matches_jax_and_continues_the_forward(block):
    """Three decode steps from the state a 9-token forward leaves, in both
    packages; and the port's steps equal its own forward over 12 tokens."""
    spec, jp, tspec, tp = block
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, SPEC["d_model"]).astype(np.float32)
    _, js, jc = J_FORWARD(jp, spec, jnp.asarray(x[:, :9]))
    _, ts, tc = tm2.mamba2_forward_with_state(tp, tspec,
                                              torch.from_numpy(x[:, :9]))
    jst = jm2.Mamba2DecodeState(conv=jc, ssm=js)
    tst = tm2.Mamba2DecodeState(conv=tc, ssm=ts)
    ys = []
    for t in range(9, 12):
        jy, jst = J_DECODE(jp, spec, jnp.asarray(x[:, t]), jst)
        ty, tst = tm2.mamba2_decode_step(tp, tspec, torch.from_numpy(x[:, t]),
                                         tst)
        _close(ty, jy, f"y at {t}")
        _close(tst.ssm, jst.ssm, f"ssm at {t}")
        _close(tst.conv, jst.conv, f"conv at {t}")
        ys.append(ty)
    full, _, _ = tm2.mamba2_forward_with_state(tp, tspec, torch.from_numpy(x))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               full[:, 9:].numpy(), rtol=1e-4, atol=1e-4)


def test_mamba2_precision_in_bf16(block):
    """In a bf16 model the SSD state stays f32 and the conv tail and output
    are bf16, as in the JAX block."""
    spec, jp, tspec, tp = block
    tb = tm2.Mamba2(tspec, torch.bfloat16, torch.device("cpu"), None)
    for k in jp:
        src = getattr(tp, k).data
        getattr(tb, k).data = src if k in tm2.F32_PARAMS \
            else src.to(torch.bfloat16)
    x = torch.randn(1, 5, SPEC["d_model"], generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    y, ssm, conv = tm2.mamba2_forward_with_state(tb, tspec, x)
    assert (y.dtype, ssm.dtype, conv.dtype) == (torch.bfloat16, torch.float32,
                                                torch.bfloat16)
    y1, st = tm2.mamba2_decode_step(
        tb, tspec, x[:, -1], tm2.Mamba2DecodeState(conv=conv, ssm=ssm))
    assert (y1.dtype, st.ssm.dtype, st.conv.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    assert torch.isfinite(y1.float()).all()
