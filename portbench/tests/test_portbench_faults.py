"""The harness, driven on the CPU with the timed path broken underneath,
must come out not correct: once for each fault a serving cell can have
(a decode step that returns its state unchanged; half the lanes left
out of a step; a token altered where the decode step or the prefill
produces it), and correct when nothing is broken.  The look for a chip
is the command's (``run.py``); everything after it runs here."""
import pytest

from portbench import check
from portbench.tests import tiny


def _wrap_decode(me, change):
    for eng in me.engines:
        inner = eng._decode

        def dec(params, state, inner=inner):
            new, *rest = inner(params, state)
            return (change(state, new), *rest)
        eng._decode = dec


def state_unchanged(me):
    _wrap_decode(me, lambda old, new: old)


def half_lanes(me):
    def change(old, new):
        toks = new.tokens.clone()
        half = toks.shape[0] // 2
        toks[half:] = old.tokens[half:]
        return new._replace(tokens=toks)
    _wrap_decode(me, change)


def decode_token_altered(me):
    V = me.cfg.vocab_size
    _wrap_decode(me, lambda old, new: new._replace(
        tokens=(new.tokens + 1) % V))


def prefill_token_altered(me):
    for eng in me.engines:
        inner = eng._prefill

        def pre(params, batch, inner=inner):
            res = inner(params, batch)
            return res._replace(last_logits=res.last_logits.roll(1, -1))
        eng._prefill = pre


@pytest.mark.parametrize("fault", [state_unchanged, half_lanes,
                                   decode_token_altered,
                                   prefill_token_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    # a backlog on every lane, finished before its close, all checked
    _, checks = tiny.run(loop="backlog", seconds=60, fault=fault,
                         requests=100)
    assert not check.correct(checks), checks


def test_sound_open_loop_is_correct():
    run, checks = tiny.run()
    assert check.correct(checks), checks
    assert checks["logit_gap"]["value"] == 0.0
    assert run.checked_tokens > 0
