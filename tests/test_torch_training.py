"""The training slice of the PyTorch port against the JAX package, on the CPU.

``repro.training.train_step`` (the JAX package's own CPU route, jitted) and
the port's ``make_train_step`` start from the same ``llama3_8b.SMOKE``
weights (carried across by ``from_jax_params(..., param_dtype=float32)``)
and take the same batches (``data.pipeline``, byte-identical in both
packages). Bars, float32 end to end in both:

* every metric of 3 steps within 1e-5 relative: the two differ only in the
  order of float32 sums (about 1e-7 relative per operation over two
  layers). With ``int8_ef`` the gradient norm is taken after compression,
  and an entry that lies within that float32 noise of a rounding boundary
  of the int8 grid takes the neighbouring level (one level is the block's
  max over 127); such a flip moves the norm by up to ~1e-4 relative, so
  ``grad_norm`` is held to 1e-4 there and the rest to 1e-5;
* step-1 gradients per leaf: max |dg| <= 1e-5 max |g|;
* parameters after 3 steps: AdamW's step direction m_hat / sqrt(v_hat) has
  magnitude at most R_t = sqrt(sum_i w_i^2 / u_i) (Cauchy-Schwarz; w_i and
  u_i the bias-corrected EMA weights of the two moments), so a gradient
  entry near zero whose sign differs between the two runs can move a
  parameter by at most 2 lr_t R_t at step t. The bar is the sum of that
  over the steps, plus 1e-5; and at most 1e-3 of all entries may differ by
  more than 1e-5 (1e-2 with ``int8_ef``: an entry on the boundary between
  the int8 levels 0 and +-1 gets an AdamW step of 0 in one run and +-lr in
  the other).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jax_llama
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_pipeline as jax_make_pipeline
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.training import train_step as jax_ts

from repro_torch.configs import llama3_8b
from repro_torch.core import tree as tree_lib
from repro_torch.models import transformer
from repro_torch.optim import adamw, grad_compress
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import train_step as ts

REL_TOL = 1e-5
LR, WARMUP, TOTAL = 1e-3, 2, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adam_ratio_bound(t, b1, b2) -> float:
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(wi * wi / ui for wi, ui in zip(w, u)))


def _port_params(tree):
    return transformer.from_jax_params(jax.tree.map(np.asarray, tree), llama3_8b.SMOKE,
                                       device="cpu", param_dtype=torch.float32)


@pytest.mark.parametrize("microbatches,compression",
                         [(1, "none"), (2, "none"), (1, "int8_ef")],
                         ids=["plain", "microbatches2", "int8_ef"])
def test_train_steps_match_jax(microbatches, compression):
    cfg_j, cfg = jax_llama.SMOKE, llama3_8b.SMOKE
    jt = jax_ts.TrainConfig(optimizer=JaxAdamW(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                            microbatches=microbatches, grad_compression=compression)
    tt = ts.TrainConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                        microbatches=microbatches, grad_compression=compression)
    jstate = jax_ts.init_train_state(jax.random.PRNGKey(0), cfg_j, jt)
    params = _port_params(jstate["params"])
    state = {"params": params, "opt": adamw.init(params, tt.optimizer)}
    if compression == "int8_ef":
        state["ef"] = grad_compress.init_error_feedback(params)
    pipe = jax_make_pipeline(JaxDataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab))

    # Step-1 gradients, leaf by leaf (int8_ef compresses after this point,
    # so its raw gradients are the "plain" case's).
    if compression == "none":
        b0 = pipe.batch_at(0)
        gj, _, _ = jax.jit(lambda p, b: jax_ts._accumulate_grads(p, cfg_j, b, jt, lambda t: t))(
            jstate["params"], {k: jnp.asarray(v) for k, v in b0.items()})
        gt, _, _ = ts._accumulate_grads(state["params"], cfg, ts.to_device(b0, "cpu"), tt)
        for (path, got), want in zip(tree_lib.leaves_with_paths(gt),
                                     tree_lib.leaves(_port_params(gj))):
            assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max()), path

    jstep = jax.jit(jax_ts.make_train_step(cfg_j, jt))
    tstep = ts.make_train_step(cfg, tt)
    lrs = []
    for i in range(3):
        batch = pipe.batch_at(i)
        jstate, mj = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, mt = tstep(state, ts.to_device(batch, "cpu"))
        assert set(mt) == set(mj)
        for key in mj:
            want, got = float(mj[key]), float(mt[key])
            tol = 1e-4 if (compression == "int8_ef" and key == "grad_norm") else REL_TOL
            assert abs(got - want) <= tol * max(abs(want), 1e-12), (i, key, got, want)
        lrs.append(float(mj["lr"]))

    b1, b2 = tt.optimizer.betas
    bar = 2 * sum(lr * _adam_ratio_bound(t, b1, b2) for t, lr in enumerate(lrs, 1)) + 1e-5
    diffs = torch.cat([(got.detach() - want).abs().reshape(-1) for got, want in
                       zip(tree_lib.leaves(state["params"]),
                           tree_lib.leaves(_port_params(jstate["params"])))])
    assert float(diffs.max()) <= bar
    share = 1e-2 if compression == "int8_ef" else 1e-3
    assert float((diffs > 1e-5).float().mean()) <= share


def test_forward_logits_match_jax():
    """``transformer.forward`` (train mode, remat on) against the JAX one."""
    from repro.models import transformer as jax_tf

    jparams = jax_tf.init_model(jax.random.PRNGKey(1), jax_llama.SMOKE)
    params = _port_params(jparams)
    tokens = np.random.default_rng(0).integers(0, llama3_8b.SMOKE.vocab, (2, 40), np.int32)
    lj, aux_j = jax_tf.forward(jparams, jax_llama.SMOKE, jnp.asarray(tokens))
    lt, aux_t = transformer.forward(params, llama3_8b.SMOKE, torch.from_numpy(tokens))
    assert lt.dtype == torch.float32 and lt.shape == (2, 40, llama3_8b.SMOKE.vocab)
    assert float(np.abs(np.asarray(lj) - lt.detach().numpy()).max()) < 1e-4
    assert set(aux_t) == set(aux_j) and all(float(v) == 0.0 for v in aux_t.values())
