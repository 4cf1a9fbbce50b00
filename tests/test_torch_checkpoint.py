"""The port's data pipeline, checkpoints and train CLI, against the JAX
package's, on CPU.

``SyntheticLM`` batches bitwise equal to JAX's; the cases of
``tests/test_data_checkpoint.py`` for the port's modules; checkpoints
that each package restores from the other, bitwise; the seed-layout
migration (``fuse_params`` / ``unfuse_params`` / ``fuse_state``)
against JAX's; preemption and resume (``tests/test_system.py``'s case,
limit 1e-6 as there); and ``launch/train.py`` stopped by SIGTERM and
resumed from its checkpoint.
"""
import os
import signal
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.core.types import ModelConfig as JModelConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import tree as tree_lib
from repro_torch.core.types import ModelConfig
from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       SyntheticLM)
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as tsl


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed,step,n_hosts,host", [
    (0, 0, 1, 0), (7, 12345, 1, 0), (3, 5, 2, 1), (11, 2, 4, 3)])
def test_batches_bitwise_equal_jax(seed, step, n_hosts, host):
    kw = dict(vocab=151936, seq_len=40, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    want = JSyntheticLM(JDataConfig(**kw)).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


# -------- tests/test_data_checkpoint.py's cases, for the port ----------


def test_batch_is_pure_function_of_step():
    cfg = DataConfig(vocab=256, seq_len=32, global_batch=4)
    ds1, ds2 = SyntheticLM(cfg), SyntheticLM(cfg)
    for step in (0, 7, 12345):
        b1, b2 = ds1.batch(step), ds2.batch(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds1.batch(1)["tokens"],
                              ds1.batch(2)["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab=256, seq_len=32, global_batch=2)).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (2, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_disjoint():
    h0 = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=8,
                                n_hosts=2, host_id=0))
    h1 = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=8,
                                n_hosts=2, host_id=1))
    assert h0.local_batch == h1.local_batch == 4
    assert not np.array_equal(h0.batch(3)["tokens"], h1.batch(3)["tokens"])


def test_resume_exactly():
    ds = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=2))
    np.testing.assert_array_equal(next(ds.iter_from(5))["tokens"],
                                  ds.batch(5)["tokens"])


def test_prefetch_iterator():
    ds = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=2))
    it = PrefetchIterator(ds.iter_from(0), depth=2)
    got = [next(it) for _ in range(3)]
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], ds.batch(i)["tokens"])
    it.close()


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32)},
            "scalar": torch.tensor(3.5)}


def test_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(str(tmp_path), 3, tree, extra={"data_step": 3})
    restored, extra = ckpt.restore(str(tmp_path), 3, tree, device="cpu")
    assert extra["data_step"] == 3
    for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    tree = _tree(1)
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ac.save_async(s, tree)
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]


def test_corruption_detected(tmp_path):
    tree = _tree(2)
    d = ckpt.save(str(tmp_path), 1, tree)
    with open(os.path.join(d, "shard_00000.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00\x00\x00")
    with pytest.raises((IOError, ValueError, zipfile.BadZipFile)):
        ckpt.restore(str(tmp_path), 1, tree, device="cpu")


def test_atomicity_tmp_never_latest(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(3))
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1


# ------------------- across the two packages ---------------------------


def _tiny(jax_side):
    kw = dict(name="tiny", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab=64, act="silu",
              norm="rms")
    return JModelConfig(**kw) if jax_side else ModelConfig(**kw)


def _tiny_data():
    return SyntheticLM(DataConfig(vocab=64, seq_len=32, global_batch=8,
                                  seed=7))


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _trained_states(steps=2):
    """A JAX and a port TrainState of the tiny model, each after
    ``steps`` steps of its own package (from the same weights)."""
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), _tiny(True),
                            dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    jt = jstep.TrainConfig(warmup_steps=2, total_steps=20, remat=False)
    tt = tsl.TrainConfig(warmup_steps=2, total_steps=20, remat=False)
    jst = jstep.init_state(params, jt)
    tst = tsl.init_state(from_jax_params(tree, _tiny(False), device="cpu"),
                         tt)
    jfn = jax.jit(jstep.make_train_step(_tiny(True), jt))
    tfn = tsl.make_train_step(_tiny(False), tt)
    ds = _tiny_data()
    for i in range(steps):
        jst, _ = jfn(jst, jax.tree_util.tree_map(jnp.asarray, ds.batch(i)))
        tst, _ = tfn(tst, _torch_batch(ds.batch(i)))
    return jst, tst


def test_checkpoints_cross_restore_bitwise(tmp_path):
    """A TrainState saved by JAX restores into the port's (every key of
    ``.params/...``, ``.opt/.step``, ``.opt/.mu/...``, ``.opt/.nu/...``)
    and one saved by the port into JAX's, both bitwise; the two
    manifests list the same keys."""
    jst, tst = _trained_states()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, 2, jst, extra={"data_step": 2})
    ckpt.save(tdir, 2, tst, extra={"data_step": 2})
    keys = [p for p, _ in tree_lib.leaves_with_paths(tst)]
    assert ".opt/.step" in keys and ".params/embed" in keys
    assert ".params/stages/0/stacked/0/attn/wqkv" in keys
    assert ".opt/.mu/embed" in keys and ".opt/.nu/final_norm/g" in keys
    jpaths, _, _ = jckpt._flatten_with_paths(jst)
    assert keys == jpaths
    # JAX -> port
    got, extra = ckpt.restore(jdir, 2, tst, device="cpu")
    assert extra == {"data_step": 2}
    assert got.opt.step.dtype == torch.int32 and got.opt.step.dim() == 0
    for a, b in zip(tree_lib.leaves(got), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # port -> JAX
    back, extra = jckpt.restore(tdir, 2, jst)
    assert extra == {"data_step": 2}
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_lib.leaves(tst)):
        assert a.dtype == np.dtype(str(b.dtype).split(".")[-1])
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fuse_and_unfuse_match_jax():
    """The seed-layout migration on a decoder (deepseek-smoke) and an
    encoder-decoder (whisper-smoke, its cross ``wkv``): ``unfuse_params``
    and ``fuse_params`` give JAX's trees leaf for leaf, round trip
    exactly, and ``fuse_state`` migrates params and both moments; the
    split leaves are copies (each may be made to require a gradient)."""
    for arch in ("deepseek-7b", "whisper-base"):
        jcfg, cfg = jget_reduced(arch), get_reduced(arch)
        params, _ = jlm.init_lm(jax.random.PRNGKey(1), jcfg,
                                dtype=jnp.float32)
        tree = jax.tree_util.tree_map(np.asarray, params)
        tp = from_jax_params(tree, cfg, device="cpu")
        jseed = jlm.unfuse_params(jcfg, params)
        seed = lm.unfuse_params(cfg, tp)
        assert [p for p, _ in tree_lib.leaves_with_paths(seed)] == \
            jckpt._flatten_with_paths(jseed)[0]
        for a, b in zip(tree_lib.leaves(seed),
                        jax.tree_util.tree_leaves(jseed)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a._base is None
        fused = lm.fuse_params(cfg, seed)
        for a, b in zip(tree_lib.leaves(fused), tree_lib.leaves(tp)):
            assert torch.equal(a, b)
        # idempotent: a fused tree passes through leaf for leaf
        assert all(a is b for a, b in zip(
            tree_lib.leaves(lm.fuse_params(cfg, fused)),
            tree_lib.leaves(fused)))
    jcfg, cfg = _tiny(True), _tiny(False)
    jst, tst = _trained_states(1)
    jseed_state = jst._replace(
        params=jlm.unfuse_params(jcfg, jst.params),
        opt=jst.opt._replace(mu=jlm.unfuse_params(jcfg, jst.opt.mu),
                             nu=jlm.unfuse_params(jcfg, jst.opt.nu)))
    seed_state = tst._replace(
        params=lm.unfuse_params(cfg, tst.params),
        opt=tst.opt._replace(mu=lm.unfuse_params(cfg, tst.opt.mu),
                             nu=lm.unfuse_params(cfg, tst.opt.nu)))
    jf, tf = jstep.fuse_state(jseed_state, jcfg), tsl.fuse_state(
        seed_state, cfg)
    assert [p for p, _ in tree_lib.leaves_with_paths(tf)] == \
        jckpt._flatten_with_paths(jf)[0]
    for a, b in zip(tree_lib.leaves(tf), tree_lib.leaves(tst)):
        assert torch.equal(a, b)


def test_preemption_resume_exact(tmp_path):
    """test_system.py's case: 10 straight steps against 6 steps, a
    checkpoint, a restore and 4 more: parameters within 1e-6."""
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), _tiny(True),
                            dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tsl.TrainConfig(warmup_steps=2, total_steps=20, remat=False)
    step = tsl.make_train_step(_tiny(False), tcfg)
    ds = _tiny_data()

    def start():
        return tsl.init_state(from_jax_params(tree, _tiny(False),
                                              device="cpu"), tcfg)
    state = start()
    for i in range(10):
        state, _ = step(state, _torch_batch(ds.batch(i)))
    ref = state
    state = start()
    for i in range(6):
        state, _ = step(state, _torch_batch(ds.batch(i)))
    ckpt.save(str(tmp_path), 6, state, extra={"data_step": 6})
    restored, extra = ckpt.restore(str(tmp_path), 6, state, device="cpu")
    for i in range(extra["data_step"], 10):
        restored, _ = step(restored, _torch_batch(ds.batch(i)))
    diffs = [float((a - b).abs().max()) for a, b in zip(
        tree_lib.leaves(ref.params), tree_lib.leaves(restored.params))]
    assert max(diffs) < 1e-6, max(diffs)


def test_train_cli_sigterm_and_resume(tmp_path, monkeypatch, capsys):
    """``launch/train.py --smoke --device cpu``: a run stopped by SIGTERM
    during its fifth step saves step 5 synchronously (beside the async
    save of step 4) and exits; run again, it resumes from step 5's
    checkpoint and data step and ends with the parameters of a straight
    run."""
    argv = ["--arch", "qwen2-vl-2b", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "16", "--device", "cpu", "--ckpt-every", "4"]
    straight = train_cli.main(argv)
    ckdir = str(tmp_path / "ck")
    orig = tsl.make_train_step

    def preempting(cfg, tcfg):
        fn, calls = orig(cfg, tcfg), [0]

        def step(state, batch):
            calls[0] += 1
            if calls[0] == 5:
                os.kill(os.getpid(), signal.SIGTERM)
            return fn(state, batch)
        return step
    monkeypatch.setattr(train_cli.tsl, "make_train_step", preempting)
    with pytest.raises(SystemExit) as stop:
        train_cli.main(argv + ["--ckpt-dir", ckdir])
    assert stop.value.code == 0
    assert ckpt.all_steps(ckdir) == [4, 5]
    assert ckpt.latest_step(ckdir) == 5
    monkeypatch.setattr(train_cli.tsl, "make_train_step", orig)
    resumed = train_cli.main(argv + ["--ckpt-dir", ckdir])
    out = capsys.readouterr().out
    assert "SIGTERM: sync checkpoint + exit" in out
    assert "resumed from step 5" in out and "step 7: loss=" in out
    assert ckpt.latest_step(ckdir) == 8
    for a, b in zip(tree_lib.leaves(straight), tree_lib.leaves(resumed)):
        assert torch.equal(a, b)
    assert int(resumed.opt.step) == 8


def test_train_cli_refuses_mesh_and_compression():
    """A mesh other than ``none`` or ``host`` is refused, and so is
    ``--compress-pods`` without a mesh (it reduces over the ``pod``
    axis): nothing runs quietly on one device instead. The mesh itself
    runs in ``tests/test_torch_mesh_worlds.py``."""
    base = ["--smoke", "--steps", "1", "--device", "cpu"]
    with pytest.raises(SystemExit):
        train_cli.main(base + ["--mesh", "production"])
    with pytest.raises(ValueError, match="--mesh host"):
        train_cli.main(base + ["--compress-pods"])


def test_adamw_init_is_fp32_on_the_params_device():
    p = {"w": torch.zeros(3, 2, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    st = adamw.init(p)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert all(t.dtype == torch.float32 for t in tree_lib.leaves(st.mu))
    assert [p_ for p_, _ in tree_lib.leaves_with_paths(st)] == [
        ".step", ".mu/b/0", ".mu/w", ".nu/b/0", ".nu/w"]
    jst = jadamw.init({"w": jnp.zeros((3, 2), jnp.bfloat16),
                       "b": [jnp.ones(2)]})
    assert jckpt._flatten_with_paths(jst)[0] == [
        p_ for p_, _ in tree_lib.leaves_with_paths(st)]
