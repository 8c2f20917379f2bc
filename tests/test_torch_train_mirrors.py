"""Mirrors of ``tests/test_system.py:21,62,81,93,104`` for the port's
training step, optimizer and loss, on the CPU: loss decreases on learnable
data, int8 compression with error feedback still trains, the AdamW
schedule and clipping, no weight decay on norm gains (with the JAX
package's decay mask leaf for leaf), and the cross-entropy oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jax_llama

from repro_torch.configs import llama3_8b
from repro_torch.core import tree as tree_lib
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.models import layers, transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import train_step as ts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_decreases_on_learnable_data():
    cfg = llama3_8b.SMOKE
    tcfg = ts.TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40),
                          microbatches=2)
    state = ts.init_train_state(0, cfg, tcfg, device="cpu")
    step = ts.make_train_step(cfg, tcfg)
    pipe = make_pipeline(DataConfig(seq_len=64, global_batch=8, vocab=cfg.vocab,
                                    ngram_vocab=32))
    losses = []
    for i in range(40):
        state, m = step(state, ts.to_device(pipe.batch_at(i), "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert all(np.isfinite(losses))


def test_grad_compression_trains():
    cfg = llama3_8b.SMOKE
    tcfg = ts.TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30),
                          grad_compression="int8_ef")
    state = ts.init_train_state(0, cfg, tcfg, device="cpu")
    assert "ef" in state
    step = ts.make_train_step(cfg, tcfg)
    pipe = make_pipeline(DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab,
                                    ngram_vocab=16))
    losses = []
    for i in range(25):
        state, m = step(state, ts.to_device(pipe.batch_at(i), "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_adamw_schedule_and_clip():
    acfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, grad_clip=1.0)
    assert float(adamw.schedule(acfg, 0)) == 0.0
    assert float(adamw.schedule(acfg, 10)) == pytest.approx(1.0)
    assert float(adamw.schedule(acfg, 100)) == pytest.approx(0.1)
    params = {"wq": torch.ones((4, 4))}
    grads = {"wq": torch.full((4, 4), 100.0)}
    _, _, metrics = adamw.update(acfg, params, grads, adamw.init(params))
    assert float(metrics["grad_norm"]) == pytest.approx(400.0)


def test_no_weight_decay_on_norms():
    acfg = AdamWConfig(lr=1e-2, weight_decay=1.0, warmup_steps=0, total_steps=10)
    params = {"ln1": torch.ones((4,)), "layers": [{"ln2": torch.ones((4,)),
                                                   "wq": torch.ones((4, 4))}],
              "ln_f": torch.ones((4,)), "embed": torch.ones((4, 4)), "head": torch.ones((4, 4))}
    grads = tree_lib.map_tree(torch.zeros_like, params)
    new, _, _ = adamw.update(acfg, params, grads, adamw.init(params))
    # zero grad + decay: weights shrink, norm gains do not
    for key in ("ln1", "ln_f"):
        assert float((new[key] - 1.0).abs().max()) < 1e-6
    assert float((new["layers"][0]["ln2"] - 1.0).abs().max()) < 1e-6
    for w in (new["layers"][0]["wq"], new["embed"], new["head"]):
        assert float(w.max()) < 1.0


def test_decay_mask_matches_jax_leaf_for_leaf():
    """The port's key names get the JAX assignment: ``embed``, ``head`` and
    the matmul weights decay; the norm gains do not."""
    from repro.models import transformer as jax_tf
    from repro.optim import adamw as jax_adamw

    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    jpaths, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jax_decay = {}
    for path, _ in jpaths:
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        jax_decay[(keys[0], keys[-1])] = jax_adamw._decayable(path)
    names = {"table_vd": "embed", "w_dm": "head", "wq_dm": "wq", "wk_dm": "wk",
             "wv_dm": "wv", "wi_gate_dm": "w_gate", "wi_up_dm": "w_up"}
    params = transformer.init_model(llama3_8b.SMOKE, device="cpu", param_dtype=torch.float32)
    for path, _ in tree_lib.leaves_with_paths(params):
        key = path[-1]
        if key in ("ln1", "ln2", "ln_f"):
            want = jax_decay[(key if key == "ln_f" else "layers", "scale_r")]
        elif key in ("wo", "w_down"):
            want = jax_decay[("layers", "wo_md")]
        else:
            jkey = {v: k for k, v in names.items()}[key]
            want = jax_decay[(path[0] if path[0] != "layers" else "layers", jkey)]
        assert adamw._decayable(path) == want, path


def test_cross_entropy_oracle():
    logits = torch.tensor([[[2.0, 0.0, -1.0], [0.0, 3.0, 0.0]]])
    targets = torch.tensor([[0, 1]])
    loss, metrics = layers.softmax_cross_entropy(logits, targets)
    expect = -np.log(np.exp(2) / (np.exp(2) + 1 + np.exp(-1)))
    expect = (expect + -np.log(np.exp(3) / (np.exp(3) + 2))) / 2
    assert float(loss) == pytest.approx(expect, rel=1e-5)
    assert float(metrics["accuracy"]) == 1.0


def test_cross_entropy_matches_jax_with_mask_and_z_loss():
    from repro.models import layers as jax_layers

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)
    lj, mj = jax_layers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                              jnp.asarray(mask), z_loss=1e-2)
    lt, mt = layers.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                          torch.from_numpy(mask), z_loss=1e-2)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    for key in ("loss", "accuracy", "tokens"):
        assert float(mt[key]) == pytest.approx(float(mj[key]), rel=1e-6)
