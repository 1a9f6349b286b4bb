"""Checkpoints of the port: the JAX package's five checkpoint tests,
ported, and restores across the two packages in both directions, on the
CPU.  The port writes the JAX format (``.npy`` leaves named by the md5 of
their key, a JSON index with sha256 hashes); a bf16 leaf is npy ``'<V2'``
over its 16-bit words with index dtype ``"bfloat16"``, as JAX's
``np.save`` of an ``ml_dtypes`` array writes it.  Values round-trip bit for
bit.

The JAX package cannot restore a checkpoint with bf16 leaves, its own
included (``np.load`` gives ``'<V2'`` words and ``astype(bfloat16)``
has no cast); the port reads those words directly.  Port -> JAX is
therefore held in f32, and in bf16 as identical files.
"""
import json
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _train_parity import configs, seeded_tree  # noqa: E402
from repro.distributed.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.distributed.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.distributed.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                                _flatten, latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from repro_torch.models import (abstract_params,  # noqa: E402
                                params_from_numpy, port_layout)
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.trainer import train_state_tree  # noqa: E402


def _state(dtype=torch.float32, arch="gemma3-1b"):
    """(model, AdamW state) from the JAX init, with a few moments set."""
    jcfg, cfg = configs(arch)
    model = params_from_numpy(seeded_tree(jcfg), cfg, dtype=dtype,
                              device="cpu")
    opt = AdamW().init(model)
    gen = torch.Generator().manual_seed(0)
    for t in (*opt.m.values(), *opt.v.values()):
        t.copy_(torch.rand(t.shape, generator=gen))
    return model, opt._replace(step=torch.tensor(5, dtype=torch.int32))


@pytest.fixture
def tree():
    return train_state_tree(*_state())


def _words(x) -> np.ndarray:
    """A leaf's bytes as an array (bf16 as 16-bit words)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _same(a, b) -> None:
    fa, fb = _flatten(a), _flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert np.array_equal(_words(fa[k]), _words(fb[k])), k


def test_roundtrip(tree, tmp_path):
    save_checkpoint(tmp_path, tree, 7)
    assert latest_step(tmp_path) == 7
    restored, step = restore_checkpoint(tmp_path, tree)
    assert step == 7
    _same(restored, tree)


def test_integrity_detection(tree, tmp_path):
    path = save_checkpoint(tmp_path, tree, 1)
    idx = json.loads((path / "index_p0.json").read_text())
    victim = next(iter(idx["arrays"].values()))["file"]
    arr = np.load(path / victim)
    arr_corrupt = arr.copy()
    arr_corrupt.flat[0] += 1
    np.save(path / victim, arr_corrupt)
    with pytest.raises(IOError, match="integrity"):
        restore_checkpoint(tmp_path, tree)


def test_dtype_resharding_restore(tree, tmp_path):
    """Restore into a different-dtype template (a bf16 restart)."""
    save_checkpoint(tmp_path, tree, 2)
    template = jax.tree.map(
        lambda x: torch.zeros(x.shape, dtype=torch.bfloat16, device="meta")
        if x.dtype == torch.float32 else x, tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    restored, _ = restore_checkpoint(tmp_path, template)
    for key, leaf in _flatten(restored).items():
        assert leaf.dtype in (torch.bfloat16, torch.int32), key
    assert torch.equal(_flatten(restored)["0/embed"],
                       _flatten(tree)["0/embed"].to(torch.bfloat16))


def test_async_and_gc(tree, tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(tree, s)
    ck.wait()
    steps = sorted(int(p.name.split("_")[1])
                   for p in Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]


def test_atomic_commit_no_partial(tmp_path):
    """A .tmp dir never counts as a checkpoint."""
    (Path(tmp_path) / "step_00000009.tmp").mkdir(parents=True)
    assert latest_step(tmp_path) is None


def test_async_save_holds_the_tree_before_it_returns(tmp_path):
    """The optimizer writes in place: what :meth:`save` returned on is
    what lands on disk, whatever the tensors hold afterwards."""
    model, opt = _state()
    tree = train_state_tree(model, opt, "cpu")
    want = {k: v.clone() for k, v in _flatten(tree).items()}
    ck = AsyncCheckpointer(tmp_path)
    ck.save(tree, 1)
    for leaf in _flatten(tree).values():
        leaf.add_(1)
    ck.wait()
    restored, _ = restore_checkpoint(tmp_path, tree)
    for k, v in _flatten(restored).items():
        assert torch.equal(v, want[k]), k


def _jax_state(dtype):
    jcfg, _ = configs("gemma3-1b")
    f32 = seeded_tree(jcfg)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), f32)
    st = JAdamW().init(params)
    rng = np.random.RandomState(0)
    st = st._replace(step=jnp.int32(5), m=jax.tree.map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32)), st.m))
    return f32, (params, st)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_save_port_restore(dtype, tmp_path):
    """The JAX package saves (params, AdamWState); the port restores into
    its own template: every key, and every value bit for bit (bf16 leaves
    through their 16-bit words)."""
    f32, jtree = _jax_state(dtype)
    j_save(tmp_path, jtree, 4, process_index=0)
    _, cfg = configs("gemma3-1b")
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = params_from_numpy(f32, cfg, dtype=tdtype, device="cpu")
    template = train_state_tree(model, AdamW().init(model), "meta")
    restored, step = restore_checkpoint(tmp_path, template)
    assert step == 4
    got, want = _flatten(restored), _flatten(jax.tree.map(np.asarray, jtree))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(_words(g), w.reshape(-1).view(np.uint8)), k
        else:
            assert np.array_equal(g.numpy(), w), k


def test_port_save_jax_restore(tmp_path):
    """The port saves in f32; the JAX package restores it into its own
    template: the same keys, shapes, dtypes and hashes in the index, and
    the same values."""
    f32, jtree = _jax_state(jnp.float32)
    j_save(tmp_path / "jax", jtree, 3, process_index=0)
    _, cfg = configs("gemma3-1b")
    model = params_from_numpy(f32, cfg, device="cpu")
    st = AdamW().init(model)
    st = st._replace(step=torch.tensor(5, dtype=torch.int32),
                     m={n: torch.from_numpy(np.array(a)) for n, a in
                        _port_m(cfg, jtree[1].m).items()})
    save_checkpoint(tmp_path / "port", train_state_tree(model, st), 3)
    read = [json.loads((tmp_path / d / "step_00000003" / "index_p0.json")
                       .read_text()) for d in ("port", "jax")]
    assert read[0] == read[1]
    restored, step = j_restore(tmp_path / "port", jtree, process_index=0)
    assert step == 3
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _port_m(cfg, m):
    return port_layout(jax.tree.map(np.asarray, m),
                       dict(abstract_params(cfg).named_parameters()))


def test_bf16_checkpoint_files_identical_and_only_the_port_restores(
        tmp_path):
    """A bf16 state saved by each package: the same index and the same
    bytes in every file.  The JAX package's restore of either fails (its
    ``astype`` from ``'<V2'``: a fault of the reference, kept); the port
    restores both."""
    f32, jtree = _jax_state(jnp.bfloat16)
    j_save(tmp_path / "jax", jtree, 2, process_index=0)
    _, cfg = configs("gemma3-1b")
    model = params_from_numpy(f32, cfg, dtype=torch.bfloat16, device="cpu")
    st = AdamW().init(model)
    st = st._replace(step=torch.tensor(5, dtype=torch.int32),
                     m={n: torch.from_numpy(np.array(a)) for n, a in
                        _port_m(cfg, jtree[1].m).items()})
    port_tree = train_state_tree(model, st)
    save_checkpoint(tmp_path / "port", port_tree, 2)
    dirs = [tmp_path / d / "step_00000002" for d in ("port", "jax")]
    idx = [json.loads((d / "index_p0.json").read_text()) for d in dirs]
    assert idx[0] == idx[1]
    assert idx[0]["arrays"]["0/embed"]["dtype"] == "bfloat16"
    for meta in idx[0]["arrays"].values():
        assert (dirs[0] / meta["file"]).read_bytes() == \
            (dirs[1] / meta["file"]).read_bytes()
    for d in ("port", "jax"):
        with pytest.raises(ValueError, match="cast"):
            j_restore(tmp_path / d, jtree, process_index=0)
        restored, _ = restore_checkpoint(tmp_path / d, port_tree)
        _same(restored, port_tree)
    shutil.rmtree(tmp_path / "jax")
