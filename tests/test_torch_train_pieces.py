"""The modules around the port's training step, on the CPU: checkpoints,
fault tolerance, the data pipeline, gradient compression and the launcher.

Mirrors of ``tests/test_checkpoint.py`` (all but the reshard test, which
waits for the distributed port), ``tests/test_fault_tolerance.py:22,33,51,76``
(watchdog and trainer; the heartbeat waits for the distributed port) and
``tests/test_data_and_compress.py:17-79``, plus direct comparisons with the
JAX package: batches byte-identical, quantization and error feedback equal.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.optim import grad_compress as jax_gc

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import llama3_8b
from repro_torch.core import tree as tree_lib
from repro_torch.data.pipeline import DataConfig, MemmapLM, SyntheticLM, make_pipeline
from repro_torch.distributed.fault_tolerance import (
    StateWriteFailure,
    StepFailure,
    StragglerWatchdog,
    failure_injector,
)
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import train_step as ts
from repro_torch.training.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- checkpoint -----------------------------------------------------------------


def tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "a_dm": torch.randn((8, 16), generator=gen),
            "nested": (torch.arange(6, dtype=torch.int32), {"b_r": torch.ones((3,))}),
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


def assert_tree_equal(a, b):
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = tree()
    ck.save(str(tmp_path), 5, t, meta={"data_step": 5})
    restored, meta, step = ck.restore(str(tmp_path), t)
    assert step == 5 and meta["data_step"] == 5
    assert_tree_equal(t, restored)


def test_latest_and_gc(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, t, keep_last=3)
    assert ck.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 3


def test_partial_write_is_invisible(tmp_path):
    t = tree()
    ck.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_00000002.tmp-deadbeef")
    assert ck.latest_step(str(tmp_path)) == 1
    _, _, step = ck.restore(str(tmp_path), t)
    assert step == 1


def test_corrupt_manifest_ignored(tmp_path):
    ck.save(str(tmp_path), 1, tree())
    os.makedirs(tmp_path / "step_00000009")
    assert ck.latest_step(str(tmp_path)) == 1


def test_async_save(tmp_path):
    t = tree()
    ck.save(str(tmp_path), 3, t, async_write=True)
    deadline = time.time() + 10
    while ck.latest_step(str(tmp_path)) != 3 and time.time() < deadline:
        time.sleep(0.05)
    assert ck.latest_step(str(tmp_path)) == 3
    restored, _, _ = ck.restore(str(tmp_path), t)
    assert_tree_equal(t, restored)


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """The host copy is taken before ``save`` returns, so an in-place update
    right after (what the train step does) does not reach the checkpoint."""
    t = tree()
    want = t["params"]["a_dm"].clone()
    ck.save(str(tmp_path), 1, t, async_write=True)
    t["params"]["a_dm"].add_(1.0)
    deadline = time.time() + 10
    while ck.latest_step(str(tmp_path)) != 1 and time.time() < deadline:
        time.sleep(0.05)
    restored, _, _ = ck.restore(str(tmp_path), t)
    assert torch.equal(restored["params"]["a_dm"], want)


def test_bfloat16_moments_roundtrip_exactly(tmp_path):
    """numpy has no bfloat16: bf16 AdamW moments are stored by their raw
    16-bit pattern and come back bit for bit."""
    params = {"wq": torch.randn(5, 7), "ln1": torch.randn(7)}
    opt = adamw.init(params, AdamWConfig(moment_dtype="bfloat16"))
    grads = tree_lib.map_tree(torch.randn_like, params)
    _, opt, _ = adamw.update(AdamWConfig(moment_dtype="bfloat16"), params, grads, opt)
    state = {"params": params, "opt": opt}
    ck.save(str(tmp_path), 2, state)
    restored, _, _ = ck.restore(str(tmp_path), state)
    assert restored["opt"].mu["wq"].dtype == torch.bfloat16
    assert isinstance(restored["opt"], adamw.OptState)
    assert_tree_equal(state, restored)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "nope"), tree())


# -- fault tolerance --------------------------------------------------------------


def test_watchdog_flags_stragglers():
    w = StragglerWatchdog(deadline_factor=2.0, warmup_steps=2)
    for i in range(5):
        assert not w.observe(i, 1.0)
    assert w.observe(5, 5.0)
    assert w.straggler_count == 1
    assert abs(w.ema - 1.0) < 1e-6
    assert not w.observe(6, 1.1)


def test_watchdog_hook_called():
    events = []
    w = StragglerWatchdog(deadline_factor=2.0, warmup_steps=1, on_straggler=events.append)
    w.observe(0, 1.0)
    w.observe(1, 1.0)
    w.observe(2, 10.0)
    assert len(events) == 1 and events[0].step == 2


def _smoke_trainer(tmp_path, total, **kw):
    cfg = llama3_8b.SMOKE
    tcfg = ts.TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    state = ts.init_train_state(kw.pop("seed", 0), cfg, tcfg, device="cpu")
    pipe = make_pipeline(DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab))
    kw.setdefault("ckpt_dir", str(tmp_path))
    return Trainer(ts.make_train_step(cfg, tcfg), state, pipe,
                   TrainerConfig(total_steps=total, log_every=1000, **kw),
                   put_batch=lambda b: ts.to_device(b, "cpu"))


def test_trainer_recovers_from_injected_failures(tmp_path, caplog):
    tr = _smoke_trainer(tmp_path, 12, ckpt_every=4, ckpt_async=False)
    with caplog.at_level("WARNING", logger="repro_torch.trainer"):
        tr.run(inject_failure=failure_injector({5, 9}))
    assert tr.step == 12 and tr.retries == 2
    assert sum("failed" in r.getMessage() for r in caplog.records) == 2
    # A fresh trainer resumes from the persisted checkpoint, with its state.
    tr2 = _smoke_trainer(tmp_path, 12, seed=1)
    assert tr2.try_resume()
    assert tr2.step == 12
    assert_tree_equal(tr.state["params"], tr2.state["params"])


def test_trainer_gives_up_after_max_retries(tmp_path):
    tr = _smoke_trainer(tmp_path, 3, max_retries=2)

    def always_fail(step):
        raise StepFailure("permanent")

    with pytest.raises(StepFailure):
        tr.run(inject_failure=always_fail)
    assert tr.retries == 3


def _update_that_fails_once_at(step, monkeypatch):
    """Patch the train step's AdamW update so that its ``step``-th call
    (1-based) writes the state in full and then raises: the worst case of a
    failure inside the update. Returns the list of calls made."""
    real, calls = adamw.update, []

    def update(*args, **kw):
        calls.append(len(calls) + 1)
        out = real(*args, **kw)
        if len(calls) == step:
            raise RuntimeError("injected failure after the in-place update")
        return out

    monkeypatch.setattr(adamw, "update", update)
    return calls


def test_trainer_does_not_replay_a_partial_update_without_checkpoint(tmp_path, monkeypatch):
    """With no checkpoint to restore, a failure inside the in-place update
    propagates: replaying the step would apply the moments twice while the
    optimizer's step count stays behind."""
    tr = _smoke_trainer(tmp_path, 3, ckpt_dir=None)
    calls = _update_that_fails_once_at(2, monkeypatch)
    with pytest.raises(StateWriteFailure) as info:
        tr.run()
    assert isinstance(info.value.__cause__, RuntimeError)
    assert calls == [1, 2] and tr.step == 1 and tr.retries == 1
    assert int(tr.state["opt"].step) == 1


def test_trainer_replays_a_partial_update_from_checkpoint(tmp_path, monkeypatch):
    """With a checkpoint, the same failure restores it and replays: the run
    ends where a run without the failure ends, leaf for leaf."""
    clean = _smoke_trainer(tmp_path / "clean", 4, ckpt_every=1, ckpt_async=False)
    clean.run()
    tr = _smoke_trainer(tmp_path / "faulty", 4, ckpt_every=1, ckpt_async=False)
    calls = _update_that_fails_once_at(3, monkeypatch)
    tr.run()
    assert tr.step == 4 and tr.retries == 1 and len(calls) == 5
    assert int(tr.state["opt"].step) == 4
    assert_tree_equal(clean.state, tr.state)


def test_train_step_leaves_params_servable(tmp_path):
    """The train step gives the parameters a gradient only inside the call,
    and serving runs without autograd even on parameters that require grad:
    its KV pools and logits carry no graph."""
    from repro_torch.serving import LLMEngine, Request, SamplingParams

    tr = _smoke_trainer(tmp_path, 1, ckpt_dir=None)
    tr.run()
    params = tr.state["params"]
    assert not any(p.requires_grad for p in tree_lib.leaves(params))
    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
    eng = LLMEngine(llama3_8b.SMOKE, params, num_pages=16, max_batch=1,
                    prompt_buckets=(16,), device="cpu")
    req = Request(uid=0, prompt=np.arange(1, 13), sampling=SamplingParams(max_tokens=2))
    rec = eng.backend.try_admit(req)
    first = eng.backend.flush([rec])[rec["row"]]
    eng.backend.release(rec["row"])
    eng.add_request(req)
    eng.step()                          # prefill and one decode sync
    nxt = eng.backend.last_logits
    assert first.grad_fn is None and nxt is not None and nxt.grad_fn is None
    assert not any(t.requires_grad for t in tree_lib.leaves(eng.backend.caches))
    eng.close()


# -- data ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(seq_len=32, global_batch=8, seed=1, vocab=100),
                                dict(seq_len=16, global_batch=2, vocab=50, num_codebooks=4),
                                dict(seq_len=24, global_batch=4, vocab=128256, ngram_vocab=32)])
def test_batches_byte_identical_to_jax_pipeline(kw):
    mine, theirs = SyntheticLM(DataConfig(**kw)), jax_pipeline.SyntheticLM(
        jax_pipeline.DataConfig(**kw))
    for step in (0, 3, 17):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()


def test_batches_deterministic():
    cfg = DataConfig(seq_len=32, global_batch=8, seed=1, vocab=100)
    p1, p2 = SyntheticLM(cfg), SyntheticLM(cfg)
    for step in (0, 3, 17):
        np.testing.assert_array_equal(p1.batch_at(step)["tokens"], p2.batch_at(step)["tokens"])
    assert not np.array_equal(p1.batch_at(0)["tokens"], p1.batch_at(1)["tokens"])


def test_targets_are_shifted_tokens():
    b = SyntheticLM(DataConfig(seq_len=32, global_batch=4, vocab=100)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_sharding_partitions_batch():
    cfg = DataConfig(seq_len=16, global_batch=8, seed=2, vocab=50)
    batches = [SyntheticLM(cfg, shard=i, num_shards=4).batch_at(5)["tokens"] for i in range(4)]
    assert all(b.shape[0] == 2 for b in batches)
    assert not np.array_equal(batches[0], batches[1])


def test_memmap_pipeline(tmp_path):
    data = np.arange(10_000, dtype=np.int32) % 777
    path = tmp_path / "tokens.bin"
    data.tofile(path)
    cfg = DataConfig(seq_len=64, global_batch=4, vocab=777, path=str(path))
    p = make_pipeline(cfg)
    assert isinstance(p, MemmapLM)
    b1 = p.batch_at(0)
    np.testing.assert_array_equal(b1["tokens"], p.batch_at(0)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    theirs = jax_pipeline.make_pipeline(jax_pipeline.DataConfig(
        seq_len=64, global_batch=4, vocab=777, path=str(path))).batch_at(3)
    assert p.batch_at(3)["tokens"].tobytes() == theirs["tokens"].tobytes()


# -- gradient compression ------------------------------------------------------------


@pytest.mark.parametrize("n,scale,seed", [(10, 1e-4, 0), (2048, 1.0, 1), (5000, 1e3, 2),
                                          (4097, 3.7, 3)])
def test_quantize_matches_jax_and_error_bound(n, scale, seed):
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32) * scale
    mine = gc.quantize(torch.from_numpy(x))
    theirs = jax_gc.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(mine.q.numpy(), np.asarray(theirs.q))
    np.testing.assert_array_equal(mine.scale.numpy(), np.asarray(theirs.scale))
    back = gc.dequantize(mine, x.shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_gc.dequantize(theirs, x.shape)))
    assert float(np.abs(back.numpy() - x).max()) <= np.abs(x).max() / 127.0 + 1e-6


def test_error_feedback_accumulates():
    grads = {"w": torch.full((100,), 1e-6)}
    ef = gc.init_error_feedback(grads)
    total = torch.zeros((100,))
    for _ in range(400):
        deq, ef = gc.compress_with_feedback(grads, ef)
        total = total + deq["w"]
    assert abs(float(total.mean()) / (400 * 1e-6) - 1.0) < 0.05


def test_error_feedback_matches_jax():
    rng = np.random.default_rng(7)
    g = {"a": rng.normal(size=(3000,)).astype(np.float32),
         "b": [rng.normal(size=(5, 9)).astype(np.float32) * 1e-3]}
    mine = gc.init_error_feedback(tree_lib.map_tree(torch.from_numpy, g))
    theirs = jax_gc.init_error_feedback({"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]})
    for step in range(3):
        gt = tree_lib.map_tree(lambda x: torch.from_numpy(x * (step + 1)), g)
        gj = {"a": jnp.asarray(g["a"] * (step + 1)), "b": [jnp.asarray(g["b"][0] * (step + 1))]}
        dt, mine = gc.compress_with_feedback(gt, mine)
        dj, theirs = jax_gc.compress_with_feedback(gj, theirs)
        np.testing.assert_array_equal(dt["a"].numpy(), np.asarray(dj["a"]))
        np.testing.assert_array_equal(dt["b"][0].numpy(), np.asarray(dj["b"][0]))
        np.testing.assert_array_equal(mine.residual["a"].numpy(),
                                      np.asarray(theirs.residual["a"]))


# -- the launcher ---------------------------------------------------------------------


def test_train_launcher_checkpoints_and_resumes_on_cpu(tmp_path, capsys, caplog):
    from repro_torch.launch import train

    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--seq-len", "32",
            "--global-batch", "4", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    first = train.main(argv + ["--steps", "3"])
    assert np.isfinite(first["loss"]) and ck.latest_step(str(tmp_path)) == 3
    assert "device=cpu steps=3 retries=0" in capsys.readouterr().out
    with caplog.at_level("INFO", logger="repro_torch.trainer"):
        second = train.main(argv + ["--steps", "5"])
    assert any("resumed from checkpoint step=3" in r.getMessage() for r in caplog.records)
    assert "device=cpu steps=5 retries=0" in capsys.readouterr().out
    assert ck.latest_step(str(tmp_path)) == 5 and np.isfinite(second["loss"])
