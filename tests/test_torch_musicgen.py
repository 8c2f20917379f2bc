"""The port's multi-codebook model, musicgen-medium, against the JAX package
on the CPU.

SMOKE (2 layers, 4 codebooks over a vocabulary of 256, float32), JAX
``init_model`` weights carried across by ``from_jax_params``, seeded numpy
codes:

* the configs field for field, and the full config's parameter count;
* ``from_jax_params`` consumes every element of every JAX leaf once, and
  ``init_model`` draws the (K, V, D) table as the JAX package does;
* ``forward`` logits (B, S, K, V), and ``prefill`` of two rows of unequal
  length then 4 ``decode_step``s over dense caches, within 2e-5 of the JAX
  package's;
* the sampler at (B, K, V): greedy rows take each codebook's argmax,
  identical codebooks draw distinct tokens, a row's draws do not depend on
  its neighbours, and the (B, V) sampler keeps its bits;
* the engine: ``"auto"`` resolves to dense, ``"paged"`` raises; its greedy
  (K,) ids equal the JAX ``LLMEngine``'s at ``steps_per_sync`` 1 and 8;
* 3 train steps' metrics and step-1 gradients against the JAX train step
  at ``test_torch_training``'s 1e-5, and AdamW's decay of the table;
* both launchers on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import musicgen_medium as jax_musicgen
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_pipeline as jax_make_pipeline
from repro.models import transformer as jax_tf
from repro.optim import adamw as jax_adamw
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.training import train_step as jax_ts

from repro_torch.configs import musicgen_medium, registry
from repro_torch.core import tree as tree_lib
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving import LLMEngine, Request, SamplingParams
from repro_torch.serving import sampling
from repro_torch.training import train_step as ts

TOL = 2e-5
REL_TOL = 1e-5          # tests/test_torch_training.py
CFG_J, CFG = jax_musicgen.SMOKE, musicgen_medium.SMOKE
K = CFG.num_codebooks
LR, WARMUP, TOTAL = 1e-3, 2, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    tree = jax.jit(jax_tf.init_model, static_argnums=1)(jax.random.PRNGKey(0), CFG_J)
    tree = jax.tree.map(np.asarray, tree)
    return (jax.tree.map(jnp.asarray, tree),
            transformer.from_jax_params(tree, CFG, device="cpu"))


def _codes(batch, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab, size=(batch, seq, K)).astype(np.int32)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_are_the_jax_packages_field_for_field(which):
    mine, theirs = (_fields(getattr(m, which)) for m in (musicgen_medium, jax_musicgen))
    pattern = mine.pop("layer_pattern")
    assert [_fields(s) for s in pattern] == [_fields(s) for s in theirs.pop("layer_pattern")]
    assert mine == {k: theirs[k] for k in mine}
    assert registry.get_config("musicgen-medium") is musicgen_medium.CONFIG
    assert registry.get_smoke_config("musicgen-medium") is musicgen_medium.SMOKE


def test_full_width():
    """48 layers, 24 query heads over 24 KV heads (group 1) at head_dim 64,
    4 codebooks: 1,824,669,696 parameters by ``param_count()`` (3.65 GB in
    bf16), which leaves out the final norm's d_model gains; the port's
    SMOKE tree holds as many as the JAX package's."""
    cfg = musicgen_medium.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab, cfg.num_codebooks) == (48, 1536, 24, 24, 64, 6144, 2048, 4)
    assert jax_musicgen.CONFIG.param_count() == 1_824_669_696
    params = transformer.init_model(CFG, seed=0, device="cpu")
    shapes = jax.eval_shape(lambda k: jax_tf.init_model(k, CFG_J), jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tree_lib.leaves(params)) == want == CFG_J.param_count() + 64


def test_from_jax_params_consumes_every_leaf():
    """Every element of every JAX leaf lands once in the port's tree: each
    leaf of a JAX tree of SMOKE's structure is filled with its own run of
    integers, and the port's leaves together hold each integer once."""
    shapes = jax.eval_shape(lambda k: jax_tf.init_model(k, CFG_J), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)
    start, filled = 0, []
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        filled.append(np.arange(start, start + n, dtype=np.float32).reshape(leaf.shape))
        start += n
    assert start < 2**24           # exact in float32
    params = transformer.from_jax_params(jax.tree.unflatten(treedef, filled), CFG,
                                         device="cpu", param_dtype=torch.float32)
    got = torch.cat([p.reshape(-1) for p in tree_lib.leaves(params)]).double()
    assert torch.equal(torch.sort(got).values, torch.arange(start, dtype=torch.float64))
    assert tuple(params["embed"].shape) == (K, CFG.vocab, CFG.d_model)


def test_init_model_draws_the_codebook_table():
    """A float32 (K, V, D) table of standard deviation d_model^-0.5, as the
    JAX ``init_model`` draws it, also where the compute dtype is bf16 (the
    table is the heads too)."""
    cfg = dataclasses.replace(CFG, vocab=2048, compute_dtype="bfloat16")
    table = transformer.init_model(cfg, seed=3, device="cpu")["embed"]
    want = jax_tf.init_model(jax.random.PRNGKey(3), cfg)["embed"]["table_kvd"]
    assert table.dtype == torch.float32 and table.shape == want.shape
    assert float(table.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.01)
    assert float(np.std(np.asarray(want))) == pytest.approx(cfg.d_model**-0.5, rel=0.01)


def test_forward_logits_match_jax(models):
    jparams, params = models
    tokens = _codes(2, 24)
    want = np.asarray(jax.jit(lambda p, t: jax_tf.forward(p, CFG_J, t)[0])(
        jparams, jnp.asarray(tokens)))
    got, _ = transformer.forward(params, CFG, torch.from_numpy(tokens).long())
    assert want.shape == tuple(got.shape) == (2, 24, K, CFG.vocab)
    assert float(np.abs(got.detach().numpy() - want).max()) < TOL


def test_each_codebook_moves_the_logits(models):
    """The control of the parity tests: a change in one codebook's codes
    moves every codebook's logits by far more than the bar."""
    _, params = models
    tokens = _codes(1, 8)
    other = tokens.copy()
    other[..., 2] = (other[..., 2] + 1) % CFG.vocab
    a, b = (transformer.forward(params, CFG, torch.from_numpy(t).long(), remat=False)[0]
            for t in (tokens, other))
    assert all(float((a[..., k, :] - b[..., k, :]).abs().max()) > 100 * TOL for k in range(K))


def test_prefill_and_decode_logits_match_jax(models):
    """Prefill of two rows, one right-padded (``last_positions``), then 4
    greedy decode steps over dense caches: every (B, K, V) logit within 2e-5
    of the JAX package's, the same greedy (B, K) ids."""
    jparams, params = models
    lens, bucket, cache_len = [20, 13], 20, 32
    tokens = np.zeros((2, bucket, K), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = _codes(1, n, seed=5 + b)[0]
    last = np.array(lens, np.int32) - 1
    lj, cj = jax.jit(lambda p, t, lp: jax_tf.prefill(
        p, CFG_J, t, cache_len=cache_len, last_positions=lp))(
        jparams, jnp.asarray(tokens), jnp.asarray(last))
    lt, ct = transformer.prefill(params, CFG, torch.from_numpy(tokens).long(),
                                 cache_len=cache_len, last_positions=torch.from_numpy(last).long())
    assert tuple(lt.shape) == (2, K, CFG.vocab)
    assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < TOL
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, CFG_J, t, c, n))
    lengths = np.array(lens, np.int32)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(4):
        lengths = lengths + 1
        lj, cj = jdecode(jparams, jnp.asarray(tok), cj, jnp.asarray(lengths))
        lt, ct = transformer.decode_step(params, CFG, torch.from_numpy(tok).long(), ct,
                                         torch.from_numpy(lengths))
        assert tuple(lt.shape) == (2, K, CFG.vocab)
        assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < TOL
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        assert np.array_equal(tok, lt.argmax(-1).numpy())


# -- the sampler ---------------------------------------------------------------

def _params(b, temperature, top_k=0, top_p=1.0, seed=1, pos=0):
    return (torch.full((b,), temperature), torch.full((b,), top_k, dtype=torch.int64),
            torch.full((b,), top_p), torch.full((b,), seed, dtype=torch.int64),
            torch.full((b,), pos, dtype=torch.int64))


def test_greedy_codebooks_take_their_argmax():
    logits = torch.from_numpy(np.random.default_rng(5).normal(size=(3, K, 48)).astype(np.float32))
    out = sampling.sample_batch(logits, *_params(3, 0.0))
    assert tuple(out.shape) == (3, K)
    assert torch.equal(out, logits.argmax(-1))


def test_identical_codebooks_draw_distinct_tokens():
    """Identical logits in every codebook: each codebook draws from its own
    stream, not K copies of one sample (``tests/test_sampling.py``)."""
    row = np.random.default_rng(5).normal(size=(48,)).astype(np.float32)
    same = torch.from_numpy(np.broadcast_to(row, (1, K, 48)).copy())
    draws = [tuple(sampling.sample_batch(same, *_params(1, 1.5, pos=pos))[0].tolist())
             for pos in range(50)]
    assert sum(len(set(d)) > 1 for d in draws) > 40


def test_a_rows_draws_do_not_depend_on_its_neighbours():
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.normal(size=(4, K, 64)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.7, 1.3])
    top_k = torch.tensor([0, 250, 5, 0])
    top_p = torch.tensor([1.0, 1.0, 0.9, 1.0])
    seeds, pos = torch.tensor([3, 1, 4, 9]), torch.tensor([0, 6, 2, 11])
    batched = sampling.sample_batch(logits, temps, top_k, top_p, seeds, pos)
    for r in range(4):
        alone = sampling.sample_batch(logits[r:r + 1], temps[r:r + 1], top_k[r:r + 1],
                                      top_p[r:r + 1], seeds[r:r + 1], pos[r:r + 1])
        assert torch.equal(alone[0], batched[r])
    # Another stream position draws anew.
    moved = sampling.sample_batch(logits, temps, top_k, top_p, seeds, pos + 1)
    assert not torch.equal(moved[1:], batched[1:])


def test_single_codebook_sampler_keeps_its_bits():
    """(B, V) logits give the tokens and the noise the sampler gave before
    multi-codebook rows were added (pinned from the earlier code)."""
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32)) * 3
    seed, pos = torch.tensor([0, 1, 2, 3, 12345, 7]), torch.tensor([0, 5, 9, 1, 100, 3])
    out = sampling.sample_batch(logits, torch.tensor([0.0, 1.0, 0.7, 1.3, 1.0, 2.0]),
                                torch.tensor([0, 0, 50, 250, 5, 0]),
                                torch.tensor([1.0, 0.9, 1.0, 0.8, 1.0, 1.0]), seed, pos)
    assert out.tolist() == [117, 3, 184, 162, 162, 276]
    noise = sampling._gumbel(seed, pos, 300)
    assert noise.double().sum().item() == 1054.834181824117
    assert noise[1, :4].tolist() == [0.25489628314971924, 0.7463226318359375,
                                     0.9105219841003418, 2.086721181869507]


# -- the engine ----------------------------------------------------------------

def test_engine_serves_dense_and_refuses_paged(models):
    _, params = models
    eng = LLMEngine(CFG, params, max_batch=2, cache_len=64, prompt_buckets=(16,), device="cpu")
    assert eng.kv_layout == "dense"
    with pytest.raises(ValueError, match="single-codebook"):
        LLMEngine(CFG, params, kv_layout="paged", max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="single-codebook"):
        LLMEngine(CFG, params, kv_dtype="int8", max_batch=2, device="cpu")


@pytest.mark.parametrize("steps", [1, 8])
def test_engine_greedy_ids_match_jax(models, steps):
    """Three greedy prompts of unequal length on two rows (the third waits
    for a free row), 9 new (K,) tokens each, against the JAX engine at the
    same ``steps_per_sync``; a sampled request (stop ids given, which a
    multi-codebook stream ignores) rides along and is held to the port's
    own draws at the other ``steps_per_sync``."""
    jparams, params = models
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, CFG.vocab, size=(n, K)) for n in (11, 6, 16)]
    kw = dict(max_batch=2, cache_len=64, prompt_buckets=(8, 16), steps_per_sync=steps)
    jeng = JaxEngine(CFG_J, jparams, **kw)
    jout = jeng.generate([JaxRequest(uid=i, prompt=p, max_new_tokens=9)
                          for i, p in enumerate(prompts)])
    teng = LLMEngine(CFG, params, device="cpu", **kw)
    tout = teng.generate([Request(uid=i, prompt=p, max_new_tokens=9)
                          for i, p in enumerate(prompts)])
    want = {o.uid: np.stack(o.tokens).tolist() for o in jout}
    got = {o.uid: np.stack(o.tokens).tolist() for o in tout}
    assert got == want
    assert all(np.asarray(t).shape == (K,) and np.asarray(t).dtype == np.int64
               for o in tout for t in o.tokens)
    sampled = SamplingParams(temperature=1.0, top_k=250, max_tokens=9, seed=5,
                             stop_token_ids=(int(prompts[0][0, 0]),))
    draws = {}
    for n in (steps, 9 - steps):
        eng = LLMEngine(CFG, params, device="cpu", **dict(kw, steps_per_sync=n))
        (out,) = eng.generate([Request(uid=0, prompt=prompts[1], sampling=sampled)])
        draws[n] = np.stack(out.tokens).tolist()
        assert len(draws[n]) == 9 and out.finish_reason == "length"
    assert draws[steps] == draws[9 - steps]


# -- training ------------------------------------------------------------------

def test_train_step_matches_jax():
    """2 microbatches of (B, S, K) codes: step-1 gradients per leaf within
    1e-5 of the largest JAX gradient of the leaf, every metric of 3 steps
    within 1e-5 relative; the loss counts B x S x K tokens."""
    jt = jax_ts.TrainConfig(optimizer=JaxAdamW(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                            microbatches=2)
    tt = ts.TrainConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                        microbatches=2)
    jstate = jax_ts.init_train_state(jax.random.PRNGKey(0), CFG_J, jt)

    def port(tree):
        return transformer.from_jax_params(jax.tree.map(np.asarray, tree), CFG, device="cpu",
                                           param_dtype=torch.float32)

    params = port(jstate["params"])
    state = {"params": params, "opt": adamw.init(params, tt.optimizer)}
    pipe = jax_make_pipeline(JaxDataConfig(seq_len=32, global_batch=4, vocab=CFG.vocab,
                                           num_codebooks=K))
    batches = [pipe.batch_at(i) for i in range(3)]
    assert batches[0]["tokens"].shape == (4, 32, K)

    gj, lj, _ = jax.jit(lambda p, b: jax_ts._accumulate_grads(p, CFG_J, b, jt, lambda t: t))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batches[0].items()})
    gt, lt, _ = ts._accumulate_grads(state["params"], CFG, ts.to_device(batches[0], "cpu"), tt)
    assert abs(float(lt) - float(lj)) <= REL_TOL * abs(float(lj))
    for (path, got), want in zip(tree_lib.leaves_with_paths(gt), tree_lib.leaves(port(gj))):
        assert float(want.abs().max()) > 0, path
        assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max()), path

    jstep = jax.jit(jax_ts.make_train_step(CFG_J, jt))
    tstep = ts.make_train_step(CFG, tt)
    for batch in batches:
        jstate, mj = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, mt = tstep(state, ts.to_device(batch, "cpu"))
        assert set(mt) == set(mj)
        for key in mj:
            want, got = float(mj[key]), float(mt[key])
            assert abs(got - want) <= REL_TOL * max(abs(want), 1e-12), (key, got, want)
        assert float(mt["tokens"]) == 2 * 32 * K


def test_adamw_decays_the_codebook_table():
    """Both packages decay the (K, V, D) table: one AdamW step with zero
    gradients moves it by exactly its decay, lr_1 x 0.1 x p, in both."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    table = np.random.default_rng(2).normal(size=(K, 8, 4)).astype(np.float32)
    tree = {"embed": torch.from_numpy(table.copy()), "ln_f": torch.ones(4)}
    grads = tree_lib.map_tree(torch.zeros_like, tree)
    new, _, metrics = adamw.update(cfg, tree, grads, adamw.init(tree, cfg))
    lr = float(metrics["lr"])
    jtree = {"embed": {"table_kvd": jnp.asarray(table)}, "ln_f": {"scale_r": jnp.ones(4)}}
    jcfg = JaxAdamW(lr=1e-2, warmup_steps=0, total_steps=10)
    jnew, _, _ = jax_adamw.update(jcfg, jtree, jax.tree.map(jnp.zeros_like, jtree),
                                  jax_adamw.init(jtree, jcfg))
    want = np.asarray(jnew["embed"]["table_kvd"])
    assert np.allclose(want, table * (1 - lr * 0.1), rtol=1e-6, atol=0)
    assert np.allclose(new["embed"].numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(new["ln_f"], torch.ones(4))
    assert adamw._decayable(("embed",))


def test_launchers_run_musicgen_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train

    train.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu", "--steps", "2",
                "--seq-len", "32", "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    assert "steps=2 retries=0" in capsys.readouterr().out
    serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "4", "--steps-per-sync", "8", "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "kv_layout=dense" in out and out.count("finish=length") == 3
    assert "out=[[" in out
