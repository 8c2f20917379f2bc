"""The port's vision model, llama-3.2-vision-11b, against the JAX package on
the CPU.

SMOKE (two periods of (self, cross) and one self layer, float32), JAX
``init_model`` weights carried across by ``from_jax_params``, with the
cross gates set to distinct non-zero values in the JAX tree first (a fresh
model's zero gates would hide the cross blocks from every output), and
seeded numpy images:

* the configs field for field;
* ``from_jax_params`` consumes every element of every JAX leaf once;
* ``forward`` logits within 1e-4 of the JAX ``forward``, with images and
  without (then the cross weights run as causal self-attention, as in the
  JAX package); a control shows that the gates move the logits by far
  more than that bar;
* ``prefill`` + 3 ``decode_step``s over dense caches against the JAX
  ``prefill`` / ``decode_step`` within 1e-4, one row right-padded through
  ``last_positions``;
* the train step at 2 microbatches: loss and step-1 gradients per leaf
  against ``repro.training.train_step`` at ``test_torch_training``'s 1e-5
  relative, and three AdamW steps with weight decay, which pin the cross
  gates as undecayed;
* the reference's faults (ROADMAP Queue C): the Pallas K1 attends its
  zero-padded keys when not causal, and the JAX engine and ``prefill``
  fail without images; the port computes the unpadded function and refuses
  with ``ValueError``;
* the launchers on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama_3_2_vision_11b as jax_vision
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_pipeline as jax_make_pipeline
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import transformer as jax_tf
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.training import train_step as jax_ts

from repro_torch.configs import llama_3_2_vision_11b, registry
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving import LLMEngine
from repro_torch.training import train_step as ts

TOL = 1e-4
REL_TOL = 1e-5          # tests/test_torch_training.py
CFG_J, CFG = jax_vision.SMOKE, llama_3_2_vision_11b.SMOKE
#: The cross gates set in the JAX tree, one per cross layer in stack order.
GATES = (0.6, -0.9)
LR, WARMUP, TOTAL = 1e-3, 2, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_gates(tree, gates=GATES):
    """``tree`` with its cross gates set to ``gates`` in stack order (the
    scanned periods first, then the remainder layers, as the stack runs)."""
    pattern, rem = CFG_J.pattern_for_depth()
    cross_pos = [j for j, spec in enumerate(pattern) if spec.cross_attn]
    if len(cross_pos) != 1 or any(spec.cross_attn for spec in rem):
        raise AssertionError("the SMOKE pattern holds one cross position, none in the remainder")
    layers = list(tree["layers"])
    j = cross_pos[0]
    layers[j] = dict(layers[j], cross_gate_r=jnp.asarray(gates, jnp.float32))
    return dict(tree, layers=tuple(layers))


@pytest.fixture(scope="module")
def models():
    tree = jax.jit(jax_tf.init_model, static_argnums=1)(jax.random.PRNGKey(0), CFG_J)
    tree = jax.tree.map(np.asarray, _with_gates(tree))
    return (jax.tree.map(jnp.asarray, tree),
            transformer.from_jax_params(tree, CFG, device="cpu"))


def _images(batch, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, CFG.vision_tokens, CFG.vision_dim)).astype(np.float32)


def _tokens(batch, seq, seed=1):
    return np.random.default_rng(seed).integers(1, CFG.vocab, size=(batch, seq)).astype(np.int32)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_are_the_jax_packages_field_for_field(which):
    mine, theirs = _fields(getattr(llama_3_2_vision_11b, which)), _fields(getattr(jax_vision,
                                                                               which))
    pattern = mine.pop("layer_pattern")
    assert [_fields(s) for s in pattern] == [_fields(s) for s in theirs.pop("layer_pattern")]
    assert mine == {k: theirs[k] for k in mine}
    assert "llama-3.2-vision-11b" in registry.ARCH_IDS
    assert registry.get_config("llama-3.2-vision-11b") is llama_3_2_vision_11b.CONFIG
    assert registry.get_smoke_config("llama-3.2-vision-11b") is llama_3_2_vision_11b.SMOKE


def test_full_width():
    cfg = llama_3_2_vision_11b.CONFIG
    specs = cfg.layer_specs()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vision_tokens, cfg.vision_dim) == (40, 4096, 32, 8, 128, 1600, 7680)
    assert [i for i, s in enumerate(specs) if s.cross_attn] == list(range(3, 40, 5))
    # The chip's train cut: one period, its cross layer at index 3.
    assert [s.cross_attn for s in specs[:5]] == [False, False, False, True, False]


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
    assert "vision_proj" in params
    cross = [lp for lp in params["layers"] if "cross" in lp]
    assert len(cross) == 2 and all(lp["cross_gate"].shape == () for lp in cross)


def _jax_forward(jparams, tokens, images):
    fn = jax.jit(lambda p, t, im: jax_tf.forward(p, CFG_J, t, image_embeds=im)[0])
    return np.asarray(fn(jparams, jnp.asarray(tokens),
                         None if images is None else jnp.asarray(images)))


@pytest.mark.parametrize("with_images", [True, False], ids=["images", "text_only"])
def test_forward_logits_match_jax(models, with_images):
    jparams, params = models
    tokens = _tokens(2, 24)
    images = _images(2) if with_images else None
    want = _jax_forward(jparams, tokens, images)
    got, _ = transformer.forward(params, CFG, torch.from_numpy(tokens).long(),
                                 image_embeds=None if images is None else
                                 torch.from_numpy(images))
    assert float(np.abs(got.detach().numpy() - want).max()) < TOL


def test_the_gates_move_the_logits(models):
    """The control of the parity tests: the cross blocks change the logits
    by far more than the 1e-4 bar, both the images (against other images)
    and the gates (against zero gates), in both packages alike."""
    jparams, params = models
    tokens, images = _tokens(2, 24), _images(2)
    base = _jax_forward(jparams, tokens, images)
    other = _jax_forward(jparams, tokens, _images(2, seed=4))
    closed = _jax_forward(_with_gates(jparams, (0.0, 0.0)), tokens, images)
    assert np.abs(base - other).max() > 100 * TOL
    assert np.abs(base - closed).max() > 100 * TOL
    zero = {**params, "layers": [dict(lp, cross_gate=torch.zeros(())) if "cross" in lp
                                 else lp for lp in params["layers"]]}
    got, _ = transformer.forward(zero, CFG, torch.from_numpy(tokens).long(),
                                 image_embeds=torch.from_numpy(images))
    assert float(np.abs(got.detach().numpy() - closed).max()) < TOL


def test_prefill_and_decode_logits_match_jax(models):
    """Prefill of two rows, one right-padded (``last_positions``), then 3
    greedy decode steps over dense caches, the cross caches read-only:
    every logit within 1e-4 of the JAX package's, the same greedy ids."""
    jparams, params = models
    lens, bucket, cache_len = [20, 13], 20, 32
    tokens = np.zeros((2, bucket), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = _tokens(1, n, seed=5 + b)[0]
    last = np.array(lens, np.int32) - 1
    images = _images(2)
    lj, cj = jax.jit(lambda p, t, im, lp: jax_tf.prefill(
        p, CFG_J, t, cache_len=cache_len, image_embeds=im, last_positions=lp))(
        jparams, jnp.asarray(tokens), jnp.asarray(images), jnp.asarray(last))
    lt, ct = transformer.prefill(params, CFG, torch.from_numpy(tokens).long(),
                                 cache_len=cache_len, image_embeds=torch.from_numpy(images),
                                 last_positions=torch.from_numpy(last).long())
    assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < TOL
    cross = [c["cross"] for c in ct if "cross" in c]
    assert [tuple(c["k"].shape) for c in cross] == [(2, 2, CFG.vision_tokens, 16)] * 2
    # Contiguous stripes, as the card's dense decode kernels read them.
    assert all(c[key].is_contiguous() for c in cross for key in ("k", "v"))
    frozen = [c["k"].clone() for c in cross]
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, CFG_J, t, c, n))
    lengths = np.array(lens, np.int32)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(3):
        lengths = lengths + 1
        lj, cj = jdecode(jparams, jnp.asarray(tok), cj, jnp.asarray(lengths))
        lt, ct = transformer.decode_step(params, CFG, torch.from_numpy(tok).long(), ct,
                                         torch.from_numpy(lengths))
        assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < TOL
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        assert np.array_equal(tok, lt.argmax(-1).numpy())
    assert all(torch.equal(c["cross"]["k"], f) for c, f in
               zip([c for c in ct if "cross" in c], frozen))


def test_init_caches_size_the_cross_stripes():
    caches = transformer.init_caches(CFG, 3, 40, "cpu", image_len=CFG.vision_tokens)
    for spec, c in zip(CFG.layer_specs(), caches):
        assert tuple(c["k"].shape) == (3, 2, 40, 16)
        assert ("cross" in c) == spec.cross_attn
        if spec.cross_attn:
            assert tuple(c["cross"]["v"].shape) == (3, 2, CFG.vision_tokens, 16)
    with pytest.raises(ValueError, match="paged"):
        transformer.init_paged_caches(CFG, 8, 8, "cpu")


def _train_batches(n, with_images):
    pipe = jax_make_pipeline(JaxDataConfig(seq_len=32, global_batch=4, vocab=CFG.vocab))
    if not with_images:
        return [pipe.batch_at(i) for i in range(n)]
    return [dict(pipe.batch_at(i), image_embeds=_images(4, seed=10 + i)) for i in range(n)]


@pytest.mark.parametrize("with_images", [True, False], ids=["images", "text_only"])
def test_train_step_matches_jax(with_images):
    """2 microbatches, the images split with the tokens: step-1 gradients
    per leaf within 1e-5 of the largest JAX gradient of the leaf, every
    metric of 3 steps within 1e-5 relative, and after 3 AdamW steps (weight
    decay 0.1) the cross gates within 1e-6 of the JAX package's, which
    leaves them undecayed: decaying them would move them by ~1e-4. Without
    images (what the launchers train) ``vision_proj`` gets the zero
    gradient ``jax.grad`` gives it."""
    jt = jax_ts.TrainConfig(optimizer=JaxAdamW(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                            microbatches=2)
    tt = ts.TrainConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                        microbatches=2)
    assert tt.optimizer.weight_decay == jt.optimizer.weight_decay == 0.1
    jstate = jax_ts.init_train_state(jax.random.PRNGKey(0), CFG_J, jt)
    jstate = dict(jstate, params=_with_gates(jstate["params"]))

    def port(tree):
        return transformer.from_jax_params(jax.tree.map(np.asarray, tree), CFG, device="cpu",
                                           param_dtype=torch.float32)

    params = port(jstate["params"])
    state = {"params": params, "opt": adamw.init(params, tt.optimizer)}
    batches = _train_batches(3, with_images)

    gj, lj, _ = jax.jit(lambda p, b: jax_ts._accumulate_grads(p, CFG_J, b, jt, lambda t: t))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batches[0].items()})
    gt, lt, _ = ts._accumulate_grads(state["params"], CFG, ts.to_device(batches[0], "cpu"), tt)
    assert abs(float(lt) - float(lj)) <= REL_TOL * abs(float(lj))
    for (path, got), want in zip(tree_lib.leaves_with_paths(gt),
                                 tree_lib.leaves(port(gj))):
        if path == ("vision_proj",) and not with_images:
            assert float(want.abs().max()) == float(got.abs().max()) == 0.0
            continue
        assert float(want.abs().max()) > 0, path
        assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max()), path

    gates0 = [float(lp["cross_gate"]) for lp in params["layers"] if "cross" in lp]
    assert gates0 == pytest.approx(GATES)
    jstep = jax.jit(jax_ts.make_train_step(CFG_J, jt))
    tstep = ts.make_train_step(CFG, tt)
    lrs = []
    for batch in batches:
        jstate, mj = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, mt = tstep(state, ts.to_device(batch, "cpu"))
        assert set(mt) == set(mj)
        for key in mj:
            want, got = float(mj[key]), float(mt[key])
            assert abs(got - want) <= REL_TOL * max(abs(want), 1e-12), (key, got, want)
        lrs.append(float(mj["lr"]))
    want = [float(lp["cross_gate"]) for lp in port(jstate["params"])["layers"] if "cross" in lp]
    got = [float(lp["cross_gate"]) for lp in state["params"]["layers"] if "cross" in lp]
    assert np.abs(np.subtract(got, want)).max() < 1e-6
    decay = 0.1 * sum(lrs) * min(abs(g) for g in gates0)
    assert decay > 1e-4          # what decaying the gates would have moved them by, at least
    paths = [p for p, _ in tree_lib.leaves_with_paths(state["params"])]
    assert not any(adamw._decayable(p) for p in paths if p[-1] in ("cross_gate", "ln_cross"))
    assert all(adamw._decayable(p) for p in paths if p[-1] == "vision_proj" or
               (len(p) > 1 and p[-2] == "cross"))


# -- the reference's faults (ROADMAP Queue C) ----------------------------------

def _noncausal_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((1, 2, 64, 64)).astype(np.float32),
            rng.standard_normal((1, 2, 200, 64)).astype(np.float32),
            rng.standard_normal((1, 2, 200, 64)).astype(np.float32))


def test_this_input_exposes_the_noncausal_padding_fault_of_the_reference():
    """The Pallas K1 of the JAX package pads K/V to its key block with zeros
    and, when not causal, attends those zero keys: at Sq 64, Skv 200, D 64
    its output departs from ``ref.attention`` by more than 1e-3."""
    q, k, v = (jnp.asarray(a) for a in _noncausal_inputs())
    o = jax_ops.flash_attention(q, k, v, causal=False, impl="pallas")
    want = jax_ref.attention(q, k, v, causal=False)
    assert float(jnp.abs(o - want).max()) > 1e-3


def test_noncausal_attention_attends_no_padded_key():
    """The port's K1 path (padded to its blocks, keys past Skv masked by
    ``kv_len``) matches ``ref.attention`` on the same input at 2e-5."""
    q, k, v = _noncausal_inputs()
    want = np.asarray(jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=False))
    from repro_torch.kernels import plan as plan_lib
    plan = plan_lib.plan_attention((1, 2, 2, 64, 200, 64), device_type="cpu", dtype_bytes=4)
    with torch.enable_grad():
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        o = ops.flash_attention(qt, kt, vt, causal=False, plan=plan)
    assert float(np.abs(o.detach().numpy() - want).max()) < 2e-5
    o = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    assert float(np.abs(o.numpy() - want).max()) < 2e-5


def test_the_jax_engine_and_prefill_fail_without_images(models):
    """The JAX engine routes the model to its dense backend, whose flush
    passes no images: the first ``generate`` raises ``AttributeError``, as
    does the JAX ``prefill`` without ``image_embeds``."""
    jparams, _ = models
    eng = JaxEngine(CFG_J, jparams, max_batch=2, cache_len=64, prompt_buckets=(16, 32))
    with pytest.raises(AttributeError):
        eng.generate([JaxRequest(uid=0, prompt=_tokens(1, 12)[0], max_new_tokens=2)])
    with pytest.raises(AttributeError):
        jax_tf.prefill(jparams, CFG_J, jnp.asarray(_tokens(1, 12)), cache_len=16)


def test_the_port_refuses_to_serve_without_images(models):
    """The port raises ``ValueError`` where the JAX package fails: its
    engine at construction (requests carry no image), its ``prefill`` when
    no ``image_embeds`` is passed."""
    _, params = models
    with pytest.raises(ValueError, match="no image"):
        LLMEngine(CFG, params, device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        transformer.prefill(params, CFG, torch.from_numpy(_tokens(1, 12)).long(),
                            cache_len=16)


def test_launchers_run_the_vision_model_on_cpu(capsys, tmp_path):
    """``launch.train`` trains the SMOKE model text-only, as the JAX
    launcher does (its data pipeline has no images); ``launch.serve``
    exits with the engine's refusal."""
    from repro_torch.launch import serve, train

    train.main(["--arch", "llama-3.2-vision-11b", "--smoke", "--device", "cpu", "--steps", "2",
                "--seq-len", "32", "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    assert "steps=2 retries=0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no image"):
        serve.main(["--arch", "llama-3.2-vision-11b", "--smoke", "--device", "cpu"])
