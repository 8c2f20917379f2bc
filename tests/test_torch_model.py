"""The port's llama stack against the JAX package on ``llama3_8b.SMOKE``:
prefill logits and 8 paged decode steps, with the JAX weights carried
across by ``from_jax_params``.

Tolerance 1e-4 on float32 logits: SMOKE computes in float32 end to end in
both packages, so the only differences are the order of float32 sums
(einsum vs XLA dot, online vs exact softmax), about 1e-6 relative per
operation over two layers; logits are O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jax_llama
from repro.models import transformer as jax_tf

from repro_torch.configs import llama3_8b
from repro_torch.models import layers, transformer

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    tree = jax.tree.map(np.asarray, jparams)
    params = transformer.from_jax_params(tree, llama3_8b.SMOKE, device="cpu")
    return jparams, params


def _scatter(pools, caches, lengths, table, ps):
    """Write each row's prefilled K/V positions into its pages."""
    for pool, c in zip(pools, caches):
        for b, n in enumerate(lengths):
            for pos in range(n):
                pid = table[b, pos // ps]
                pool["k_pages"][:, pid, pos % ps] = c["k"][b, :, pos]
                pool["v_pages"][:, pid, pos % ps] = c["v"][b, :, pos]


def test_prefill_and_paged_decode_match_jax(models):
    jparams, params = models
    cfg_j, cfg = jax_llama.SMOKE, llama3_8b.SMOKE
    rng = np.random.default_rng(0)
    lens = [20, 13]
    bucket, ps, steps = 24, 8, 8
    tokens = np.zeros((2, bucket), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab, size=(n,))
    last = np.array(lens, np.int32) - 1

    lj, cj = jax_tf.prefill(jparams, cfg_j, jnp.asarray(tokens), cache_len=64,
                            last_positions=jnp.asarray(last))
    lt, ct = transformer.prefill(params, cfg, torch.from_numpy(tokens).long(),
                                 cache_len=bucket, last_positions=torch.from_numpy(last).long())
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg.vocab)
    assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < LOGIT_TOL

    max_pages = -(-(bucket + steps) // ps)
    table = np.arange(1, 1 + 2 * max_pages, dtype=np.int32).reshape(2, max_pages)
    pools = transformer.init_paged_caches(cfg, 1 + 2 * max_pages, ps, "cpu")
    _scatter(pools, ct, lens, table, ps)
    lengths = np.array(lens, np.int32)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(steps):
        lengths = lengths + 1
        lj, cj = jax_tf.decode_step(jparams, cfg_j, jnp.asarray(tok), cj,
                                    jnp.asarray(lengths))
        lt, pools = transformer.decode_step(
            params, cfg, torch.from_numpy(tok).long(), pools,
            torch.from_numpy(lengths), page_table=torch.from_numpy(table))
        assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < LOGIT_TOL
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        assert np.array_equal(tok, lt.argmax(dim=-1).numpy())


def test_extend_prefill_matches_full_prefill(models):
    """A tail prefilled against its prefix in pages gives the logits of the
    whole prompt prefilled at once."""
    _, params = models
    cfg = llama3_8b.SMOKE
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, cfg.vocab, size=(29,))
    full, _ = transformer.prefill(params, cfg, torch.from_numpy(prompt)[None], cache_len=29)
    ps, n_prefix = 8, 16
    _, cp = transformer.prefill(params, cfg, torch.from_numpy(prompt[:n_prefix])[None],
                                cache_len=n_prefix)
    pools = transformer.init_paged_caches(cfg, 4, ps, "cpu")
    table = np.array([[1, 2]], np.int32)
    _scatter(pools, cp, [n_prefix], table, ps)
    tail = torch.from_numpy(prompt[n_prefix:])[None]
    ext, _ = transformer.prefill(params, cfg, tail, cache_len=tail.shape[1],
                                 prefix_caches=pools, page_table=torch.from_numpy(table),
                                 prefix_len=torch.tensor([n_prefix], dtype=torch.int32))
    assert float((ext - full).abs().max()) < LOGIT_TOL


def test_layers_match_jax():
    from repro.models import layers as jax_layers

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    pos = np.array([[0, 5, 100, 7, 9, 131071, 3, 4]] * 2, np.int32)
    want = jax_layers.apply_rotary(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    got = layers.apply_rotary(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    assert float(np.abs(np.asarray(want) - got.numpy()).max()) < 1e-4
    scale = rng.standard_normal(16).astype(np.float32)
    want = jax_layers.rmsnorm({"scale_r": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x))
    assert float(np.abs(np.asarray(want) - got.numpy()).max()) < 1e-5


def test_init_model_shapes_and_scales():
    cfg = llama3_8b.SMOKE
    p = transformer.init_model(cfg, seed=3, device="cpu")
    assert p["embed"].shape == (cfg.vocab, cfg.d_model)
    assert p["head"].dtype == torch.float32
    assert len(p["layers"]) == cfg.n_layers
    lp = p["layers"][0]
    assert lp["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert lp["w_down"].shape == (cfg.d_ff, cfg.d_model)
    assert float(lp["ln1"].abs().max()) == 0.0
    assert abs(float(lp["w_gate"].std()) - cfg.d_model ** -0.5) < 0.02
    q = transformer.init_model(cfg, seed=3, device="cpu")
    assert torch.equal(p["layers"][1]["wv"], q["layers"][1]["wv"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # default device is the card
            transformer.init_model(cfg, seed=0)
