"""Training of the SSM and hybrid stacks in the PyTorch port, on the CPU.

* AdamW's decay mask: one ``adamw.update`` with zero gradients and weight
  decay 0.1 from the JAX package's ``init_train_state`` parameters, for the
  seven SMOKE configs the port takes, against the JAX update leaf by leaf
  (1e-6 relative: both compute ``p - lr * wd * p`` in float32, one rounding
  apart). The SSM vectors ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b``
  (``*_r`` in the JAX package) take no decay; every MoE leaf (router,
  expert stacks, shared expert) decays, as there.
* ``ssd.SSDIntraChunk``'s written-out backward against ``torch.autograd``
  of ``ssd_intra_chunk_plain`` in float64, over one group and over groups of
  heads, with acum spanning 100 inside a chunk so that above the diagonal
  exp would overflow float32: no NaN, and every gradient within 2e-5 of
  its max (float32 products in another order).
* The gradient of ``ssd_chunked_cuda`` (the Function, on the plain version
  here) against ``jax.grad`` of ``repro.models.ssm.ssd_chunked``, with a
  ragged last chunk and an initial state, within 2e-5 of each gradient's
  max.
* ``transformer.forward`` of the SMOKE stacks against the JAX one (3 train
  steps against the JAX train step are in ``tests/test_torch_training.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jax_gemma2
from repro.configs import gemma3_1b as jax_gemma3
from repro.configs import hymba_1_5b as jax_hymba
from repro.configs import llama3_8b as jax_llama
from repro.configs import mamba2_1_3b as jax_mamba
from repro.configs import mixtral_8x7b as jax_mixtral
from repro.configs import moonshot_v1_16b_a3b as jax_moonshot
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.optim import adamw as jax_adamw
from repro.training import train_step as jax_ts

from repro_torch.configs import (gemma2_2b, gemma3_1b, hymba_1_5b, llama3_8b, mamba2_1_3b,
                                 mixtral_8x7b, moonshot_v1_16b_a3b)
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models import transformer
from repro_torch.optim import adamw

GRAD_TOL = 2e-5

ARCHS = {"llama3-8b": (jax_llama.SMOKE, llama3_8b.SMOKE),
         "gemma2-2b": (jax_gemma2.SMOKE, gemma2_2b.SMOKE),
         "gemma3-1b": (jax_gemma3.SMOKE, gemma3_1b.SMOKE),
         "mamba2-1.3b": (jax_mamba.SMOKE, mamba2_1_3b.SMOKE),
         "hymba-1.5b": (jax_hymba.SMOKE, hymba_1_5b.SMOKE),
         "moonshot-v1-16b-a3b": (jax_moonshot.SMOKE, moonshot_v1_16b_a3b.SMOKE),
         "mixtral-8x7b": (jax_mixtral.SMOKE, mixtral_8x7b.SMOKE)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small ops gain nothing from intra-op threads, which contend with the
    other pytest-xdist workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(tree, cfg):
    return transformer.from_jax_params(jax.tree.map(np.asarray, tree), cfg,
                                       device="cpu", param_dtype=torch.float32)


def _rel_err(got, want) -> float:
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_weight_decay_mask_matches_jax(arch):
    """Zero gradients leave only the decay: a leaf that decays in one
    package and not in the other moves by lr * wd * |p| = 1e-3 |p|."""
    cfg_j, cfg = ARCHS[arch]
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jt = jax_ts.TrainConfig(optimizer=jax_adamw.AdamWConfig(**ocfg))
    jstate = jax_ts.init_train_state(jax.random.PRNGKey(0), cfg_j, jt)
    jparams = jstate["params"]
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    want, _, _ = jax.jit(lambda p, g, o: jax_adamw.update(jt.optimizer, p, g, o))(
        jparams, zeros, jax_adamw.init(jparams, jt.optimizer))
    params = _port_params(jparams, cfg)
    before = tree_lib.map_tree(lambda p: p.clone(), params)
    ocfg_t = adamw.AdamWConfig(**ocfg)
    grads = tree_lib.map_tree(torch.zeros_like, params)
    got, _, _ = adamw.update(ocfg_t, params, grads, adamw.init(params, ocfg_t))
    moved = set()
    for (path, g), w, p0 in zip(tree_lib.leaves_with_paths(got),
                                tree_lib.leaves(_port_params(want, cfg)),
                                tree_lib.leaves(before)):
        assert _rel_err(g, w) <= 1e-6, path
        if not torch.equal(g, p0):
            moved.add(path[-1])
    assert {"embed", "wq", "win", "wout"} & moved      # some leaves do decay
    assert not {"a_log", "dt_bias", "d_skip", "conv_b", "norm", "ln1", "ln_f"} & moved
    if cfg.moe is not None:
        assert {"router", "w_gate", "w_up", "w_down"} <= moved


def _seq_inputs(rng, b, nc, q, h, p, g, n, span):
    """xdt (B,nc,q,H,P), B / C per group (B,nc,q,G,N) and acum falling from
    about 0 to -span inside each chunk, in float64."""
    x = rng.standard_normal((b, nc, q, h, p))
    bq, cq = rng.standard_normal((2, b, nc, q, g, n))
    steps = rng.exponential(1.0, (b, nc, q, h))
    acum = -np.cumsum(steps, 2) / steps.sum(2, keepdims=True) * span
    return [torch.from_numpy(t) for t in (x, bq, cq, acum)]


@pytest.mark.parametrize("h,g", [(4, 1), (6, 2), (3, 3)], ids=["g1", "g2", "per_head"])
def test_written_out_backward_matches_autograd_of_plain(h, g):
    """The Function's backward against autograd of the plain version, in
    float64, from seeded float32-representable inputs; acum spans 100 over a
    chunk, so above the diagonal exp(acum_i - acum_j) reaches e^100, past
    float32's range: a mask applied after the exp, as a product, would give
    0 * inf = NaN gradients."""
    rng = np.random.default_rng(0)
    b, nc, q, p, n = 2, 3, 24, 8, 16
    ins = [t.float() for t in _seq_inputs(rng, b, nc, q, h, p, g, n, span=100.0)]
    dy = torch.from_numpy(rng.standard_normal((b, nc, q, h, p))).float()
    ds = torch.from_numpy(rng.standard_normal((b, nc, h, p, n))).float()

    got = [t.clone().requires_grad_(True) for t in ins]
    y, s = ssd_kernel.SSDIntraChunk.apply(*got)
    torch.autograd.backward((y, s), (dy, ds))

    ref = [t.double().requires_grad_(True) for t in ins]
    perm = (0, 1, 3, 2, 4)
    y_r, s_r = ssd_kernel.ssd_intra_chunk_plain(ref[0].permute(perm), ref[1].permute(perm),
                                                ref[2].permute(perm), ref[3].permute(0, 1, 3, 2))
    torch.autograd.backward((y_r.permute(perm), s_r.transpose(-1, -2)),
                            (dy.double(), ds.double()))
    assert _rel_err(y, y_r.permute(perm)) <= GRAD_TOL
    for name, a, r in zip(("xdt", "bq", "cq", "acum"), got, ref):
        assert a.grad.dtype == torch.float32 and a.grad.shape == a.shape, name
        assert torch.isfinite(a.grad).all(), name
        assert _rel_err(a.grad.double(), r.grad) <= GRAD_TOL, name


@pytest.mark.parametrize("l,chunk,g", [(70, 32, 1), (45, 16, 2)])
def test_ssd_chunked_cuda_grad_matches_jax(l, chunk, g):
    """``ssd_chunked_cuda`` (the Function over the plain version on the CPU,
    then the PyTorch recurrence) against ``jax.grad`` of the JAX package's
    ``ssd_chunked``: L not a multiple of the chunk, an initial state h0, a
    loss that reads y and the final state."""
    rng = np.random.default_rng(2)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm, cm = rng.standard_normal((2, b, l, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    wh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = (x, dt, a, bm, cm, h0)

    def jloss(x, dt, a, bm, cm, h0):
        y, ht = jax_ssm.ssd_chunked(x, dt, a, bm, cm, chunk, h0=h0)
        return jnp.sum(y * wy) + jnp.sum(ht * wh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*(jnp.asarray(t) for t in args))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in args]
    y, ht = ssd_kernel.ssd_chunked_cuda(*ts[:5], chunk, h0=ts[5])
    ((y * torch.from_numpy(wy)).sum() + (ht * torch.from_numpy(wh)).sum()).backward()
    for name, t, w in zip(("x", "dt", "a", "b", "c", "h0"), ts, want):
        w = torch.from_numpy(np.array(w))
        assert torch.isfinite(t.grad).all(), name
        assert _rel_err(t.grad, w) <= GRAD_TOL, name


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_forward_logits_match_jax(arch):
    """``transformer.forward`` (train mode, remat on) of the SMOKE stacks
    against the JAX one at 80 tokens: two chunks of 32 and a ragged tail,
    past hymba's window of 64."""
    cfg_j, cfg = ARCHS[arch]
    jparams = jax_tf.init_model(jax.random.PRNGKey(1), cfg_j)
    params = _port_params(jparams, cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 80), np.int32)
    lj, _ = jax_tf.forward(jparams, cfg_j, jnp.asarray(tokens))
    lt, aux = transformer.forward(params, cfg, torch.from_numpy(tokens))
    assert lt.shape == (2, 80, cfg.vocab)
    assert float(np.abs(np.asarray(lj) - lt.detach().numpy()).max()) < 1e-4
    assert all(float(v) == 0.0 for v in aux.values())
