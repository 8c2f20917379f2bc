"""The port's MoE family against the JAX package, on the CPU.

moonshot-v1-16b-a3b (64 experts top-6 at full width; 8 top-2 with one
shared expert at SMOKE size) and mixtral-8x7b (8 top-2, window 4096; 4
top-2, window 64 at SMOKE size), float32 end to end, seeded numpy inputs:

* the configs field for field;
* ``moe.moe_ffn`` against ``repro.models.moe.moe_ffn``, with the JAX
  package's capacity and with a capacity small enough to drop slots:
  outputs and aux losses within 2e-5, the same expert ids, and the
  gradient of every parameter and of the input against ``jax.grad``;
* ``prefill`` / ``decode_step`` logits over paged pools and dense stripes,
  and the greedy ids of both engines, against ``repro.models.transformer``
  and the JAX engine, on inputs where the JAX package drops no token (which
  the tests assert, through a recording wrapper around the JAX
  ``moe_ffn``);
* ``forward``'s aux losses, summed over the layers with and without
  remat, against the JAX ``forward`` (3 train steps of both SMOKE configs
  against ``repro.training.train_step`` are in
  ``tests/test_torch_training.py``);
* the reference's padding fault (ROADMAP Queue C): the JAX package gives
  a prefill's pad tokens expert slots, so one row's pads can push the next
  row's tokens out of an expert; the port's padded prefill equals the JAX
  package on the unpadded input, and the input used exposes the
  reference's departure.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x7b as jax_mixtral
from repro.configs import moonshot_v1_16b_a3b as jax_moonshot
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest

from repro_torch.configs import mixtral_8x7b, moonshot_v1_16b_a3b, registry
from repro_torch.core import tree as tree_lib
from repro_torch.models import moe, transformer
from repro_torch.serving import LLMEngine, Request

TOL = 2e-5
ARCHS = {"moonshot-v1-16b-a3b": (jax_moonshot, moonshot_v1_16b_a3b),
         "mixtral-8x7b": (jax_mixtral, mixtral_8x7b)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: Per call of the JAX package's ``moe_ffn`` while ``jax_drops`` is active
#: (traced calls included, through ``jax.debug.callback``): the (token, slot)
#: pairs of the call's real tokens that it dropped, and the real pairs it
#: keeps or drops otherwise than the port does (the port ranks real tokens
#: only, against the same capacity).
_JAX_DROPS = []
#: The real tokens (B, S) of the JAX ``prefill`` being traced, if any.
_JAX_REAL = []


def _jax_keep(params, x, cfg, capacity, real):
    """The kept slots (B, S, k) of the JAX ``moe_ffn`` (written out from its
    code) and of the port's rule, where only ``real`` tokens (B, S) rank."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.num_experts, cfg.top_k
    logits = x.reshape(n, d).astype(jnp.float32) @ params["router_de"].astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    if capacity is None:
        capacity = max(8, min(int(math.ceil(n * k / e * cfg.capacity_factor)), n))
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    real_slot = jnp.repeat(real.reshape(-1), k)

    def keep(oh):
        pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, flat[:, None], axis=1)[:, 0]
        return (pos < capacity).reshape(b, s, k)

    return keep(onehot), keep(onehot * real_slot[:, None]) & real[..., None]


@pytest.fixture
def jax_drops(monkeypatch):
    """Records, at every call of the JAX ``moe_ffn``, how many (token, slot)
    pairs of real tokens (in a prefill, those at or before the row's last
    position; elsewhere every token) it dropped, and how many it keeps or
    drops otherwise than the port. The list starts empty for each test."""
    inner_moe, inner_prefill = jax_moe.moe_ffn, jax_tf.prefill

    def moe_ffn(params, x, cfg, **kw):
        out, aux = inner_moe(params, x, cfg, **kw)
        real = _JAX_REAL[-1] if _JAX_REAL else jnp.ones(x.shape[:2], bool)
        theirs, mine = _jax_keep(params, x, cfg, kw.get("capacity"), real)
        jax.debug.callback(lambda d, o: _JAX_DROPS.append((int(d), int(o))),
                           jnp.sum(~theirs & real[..., None]),
                           jnp.sum((theirs != mine) & real[..., None]))
        return out, aux

    def prefill(params, cfg, tokens, **kw):
        last = kw.get("last_positions")
        s = tokens.shape[1]
        _JAX_REAL.append(jnp.ones(tokens.shape[:2], bool) if last is None
                         else jnp.arange(s)[None, :] <= last[:, None])
        try:
            return inner_prefill(params, cfg, tokens, **kw)
        finally:
            _JAX_REAL.pop()

    monkeypatch.setattr(jax_moe, "moe_ffn", moe_ffn)
    monkeypatch.setattr(jax_tf, "prefill", prefill)
    _JAX_DROPS.clear()
    yield _JAX_DROPS


def _routes_alike(drops) -> bool:
    """The JAX package ran its MoE layers and kept every real token's slot
    that the port keeps, and no other: no pad pushed a real token out."""
    return bool(drops) and all(other == 0 for _, other in drops)


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (arch, (jmod, tmod)) in enumerate(ARCHS.items()):
        tree = jax.jit(jax_tf.init_model, static_argnums=1)(jax.random.PRNGKey(i), jmod.SMOKE)
        tree = jax.tree.map(np.asarray, tree)
        out[arch] = (jax.tree.map(jnp.asarray, tree),
                     transformer.from_jax_params(tree, tmod.SMOKE, device="cpu"))
    return out


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_are_the_jax_packages_field_for_field(arch):
    jmod, tmod = ARCHS[arch]
    assert arch in registry.ARCH_IDS
    assert registry.get_config(arch) is tmod.CONFIG
    assert registry.get_smoke_config(arch) is tmod.SMOKE
    for jcfg, tcfg in ((jmod.CONFIG, tmod.CONFIG), (jmod.SMOKE, tmod.SMOKE)):
        mine, theirs = _fields(tcfg), _fields(jcfg)
        assert _fields(mine.pop("moe")) == _fields(theirs.pop("moe"))
        pattern = mine.pop("layer_pattern")
        assert [_fields(s) for s in pattern] == [_fields(s) for s in theirs.pop("layer_pattern")]
        assert mine == {k: theirs[k] for k in mine}


def test_moonshot_full_width():
    cfg = moonshot_v1_16b_a3b.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vocab) == (48, 2048, 16, 16, 128, 163840)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff, cfg.moe.num_shared_experts,
            cfg.moe.capacity_factor) == (64, 6, 1408, 0, 1.25)
    # The decode tick of 8 rows: capacity 8 (the floor), a whole (E, 8, D) buffer.
    assert moe.capacity_of(8, cfg.moe) == 8
    assert moe.capacity_of(4096, cfg.moe) == 480


def _layer_params(cfg) -> int:
    """One attention + MoE layer's parameters, from the config's widths: the
    q / k / v / o projections, the float32 router, the E SwiGLU experts and
    the two norms."""
    d, h, hkv, hd, m = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.moe
    return (d * hd * (h + 2 * hkv) + h * hd * d + d * m.num_experts
            + m.num_experts * 3 * d * m.d_ff + 2 * d)


def test_mixtral_full_width():
    """mixtral-8x7b's widths, and the sizes behind the depth cuts that
    ``chip_smoke.py`` runs on one H100 80GB: a layer of 1,451,270,144
    parameters (2.90 GB in bf16; the JAX config's count per layer), and the
    MoE capacity at the slice's shapes."""
    cfg = mixtral_8x7b.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.vocab, cfg.tie_embeddings) == (32, 4096, 32, 8, 128, 32000, False)
    assert [(s.kind, s.ffn, s.window) for s in cfg.layer_pattern] == [("attn", "moe", 4096)]
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff, cfg.moe.num_shared_experts,
            cfg.moe.capacity_factor) == (8, 2, 14336, 0, 1.25)
    # The formula is the port's layout: one SMOKE layer's tensors, counted.
    smoke = transformer.init_model(mixtral_8x7b.SMOKE, seed=0, device="cpu")
    assert _layer_params(mixtral_8x7b.SMOKE) == sum(
        t.numel() for t in tree_lib.leaves(smoke["layers"][0]))
    jcfg = jax_mixtral.CONFIG
    per_layer = (dataclasses.replace(jcfg, n_layers=2).param_count()
                 - dataclasses.replace(jcfg, n_layers=1).param_count())
    assert _layer_params(cfg) == per_layer == 1_451_270_144
    # The embedding and the untied head (the JAX count leaves out the final
    # norm's 4096); then the depth cuts in bf16 (served) and at 16 B a
    # parameter (float32 masters, gradients and two AdamW moments:
    # trained), in GB.
    rest = 2 * cfg.vocab * cfg.d_model
    assert rest + 32 * per_layer == jcfg.param_count() == 46_702_788_608

    def gb(layers, nbytes):
        return round((rest + layers * per_layer) * nbytes / 1e9, 1)

    assert [gb(n, 2) for n in (24, 25, 26, 32)] == [70.2, 73.1, 76.0, 93.4]
    assert [gb(n, 16) for n in (2, 3)] == [50.6, 73.9]
    # Capacity: a decode tick of 8 rows, run (a)'s prefill of 8 x 512 in one
    # call, run (b)'s 6144-token prefill, the 8192-token train microbatch.
    assert [moe.capacity_of(n, cfg.moe) for n in (8, 4096, 6144, 8192)] == [8, 1280, 1920,
                                                                              2560]


# -- the layer ---------------------------------------------------------------

def _layer(arch, seed=0):
    """(JAX params, port params, float32 x (2, 24, D)) of the arch's SMOKE
    MoE layer."""
    jcfg = ARCHS[arch][0].SMOKE
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.moe)
    tree = {"ln1": {"scale_r": np.zeros(jcfg.d_model, np.float32)},
            "ln2": {"scale_r": np.zeros(jcfg.d_model, np.float32)},
            "moe": jax.tree.map(np.asarray, jp)}
    lp = transformer._jax_layer(tree, None)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in lp["moe"].items() if k != "shared"}
    if "shared" in lp["moe"]:
        tp["shared"] = {k: torch.from_numpy(np.array(v)) for k, v in lp["moe"]["shared"].items()}
    x = np.random.default_rng(seed + 1).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    return jp, tp, x


def _routes(monkeypatch):
    """Records the expert ids ``moe.route`` returns."""
    got = []
    inner = moe.route

    def recording(logits, k):
        out = inner(logits, k)
        got.append(out[2].clone())
        return out

    monkeypatch.setattr(moe, "route", recording)
    return got


@pytest.mark.parametrize("capacity", [None, 4], ids=["jax_capacity", "forced_drops"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_ffn_matches_jax(monkeypatch, arch, capacity):
    jcfg, tcfg = ARCHS[arch][0].SMOKE, ARCHS[arch][1].SMOKE
    jp, tp, x = _layer(arch)
    routes = _routes(monkeypatch)
    yj, aj = jax.jit(jax_moe.moe_ffn, static_argnums=2, static_argnames="capacity")(
        jp, jnp.asarray(x), jcfg.moe, capacity=capacity)
    yt, at = moe.moe_ffn(tp, torch.from_numpy(x), tcfg.moe, capacity=capacity)
    assert float(np.abs(np.asarray(yj) - yt.numpy()).max()) < TOL
    for key in aj:
        assert abs(float(aj[key]) - float(at[key])) < TOL * max(1.0, abs(float(aj[key]))), key
    logits = jnp.asarray(x).reshape(-1, jcfg.d_model) @ jp["router_de"]
    _, want = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    assert np.array_equal(routes[0].numpy(), np.asarray(want))
    if capacity is not None:
        assert float(at["moe_dropped_frac"]) > 0.2


@pytest.mark.parametrize("capacity", [None, 4], ids=["jax_capacity", "forced_drops"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_ffn_gradient_matches_jax(arch, capacity):
    """The gradient of sum(y * r) + lb + z (r a fixed random tensor) in
    every parameter and in x, against ``jax.grad``, within 2e-5 of each
    leaf's largest entry."""
    jcfg, tcfg = ARCHS[arch][0].SMOKE, ARCHS[arch][1].SMOKE
    jp, tp, x = _layer(arch, seed=3)
    r = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe.moe_ffn(p, xx, jcfg.moe, capacity=capacity)
        return jnp.sum(y * r) + aux["moe_lb_loss"] + aux["moe_z_loss"]

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = tree_lib.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(tp, xt, tcfg.moe, capacity=capacity)
    (torch.sum(y * torch.from_numpy(r)) + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    names = {"router": "router_de", "w_gate": "wi_gate_edm", "w_up": "wi_up_edm",
             "w_down": "wo_emd"}
    pairs = [(tp[k].grad, gp[v]) for k, v in names.items()] + [(xt.grad, gx)]
    if "shared" in tp:
        pairs += [(tp["shared"][k].grad, gp["shared"][v]) for k, v in
                  (("w_gate", "wi_gate_dm"), ("w_up", "wi_up_dm"), ("w_down", "wo_md"))]
    for got, want in pairs:
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= TOL * max(1.0, np.abs(want).max())
    assert float(tp["router"].grad.abs().sum()) > 0


def test_ties_keep_the_lower_expert_first():
    """On exact ties ``route`` orders as ``jax.lax.top_k``: lower id first."""
    logits = np.array([[0.5, 1.0, 1.0, 0.2, 1.0, 0.1, 0.5, 0.5],
                       [0.0] * 8, [2.0, 1.0, 2.0, 1.0, 2.0, 1.0, 2.0, 1.0]], np.float32)
    for k in (1, 2, 3, 6):
        _, _, got = moe.route(torch.from_numpy(logits), k)
        _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), k)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_invalid_tokens_take_no_slot_and_no_loss(arch):
    """With ``valid`` the other tokens change no valid token's output and the
    aux losses are those of the valid tokens alone; all-valid is
    ``valid=None``, bit for bit."""
    tcfg = ARCHS[arch][1].SMOKE
    _, tp, x = _layer(arch)
    x = torch.from_numpy(x)
    valid = torch.zeros(x.shape[:2], dtype=torch.bool)
    valid[0, :10] = True
    valid[1, :17] = True
    y, aux = moe.moe_ffn(tp, x, tcfg.moe, valid=valid)
    noise = 3.0 * torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    noisy = torch.where(valid[..., None], x, noise)
    y2, aux2 = moe.moe_ffn(tp, noisy, tcfg.moe, valid=valid)
    assert torch.equal(y[valid], y2[valid])
    packed = torch.cat([x[0, :10], x[1, :17]])[None]
    yp, auxp = moe.moe_ffn(tp, packed, tcfg.moe)
    assert float((y[valid] - yp[0]).abs().max()) < TOL
    for key in aux:
        assert abs(float(aux[key]) - float(auxp[key])) < TOL, key
    ya, auxa = moe.moe_ffn(tp, x, tcfg.moe, valid=torch.ones_like(valid))
    yn, auxn = moe.moe_ffn(tp, x, tcfg.moe)
    assert torch.equal(ya, yn)
    assert all(torch.equal(auxa[k], auxn[k]) for k in auxn)


# -- the stack and the engines -------------------------------------------------

def _scatter(pools, caches, lengths, table, ps):
    """Write each row's prefilled K/V positions into its pages."""
    for pool, c in zip(pools, caches):
        for b, n in enumerate(lengths):
            for pos in range(n):
                pid = table[b, pos // ps]
                pool["k_pages"][:, pid, pos % ps] = c["k"][b, :, pos]
                pool["v_pages"][:, pid, pos % ps] = c["v"][b, :, pos]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_logits_match_jax(models, jax_drops, arch):
    """Prefill logits of two right-padded rows, then 6 greedy decode steps
    over paged pools and over dense stripes, each within 2e-5 of the JAX
    package's dense decode. The JAX package drops no token here, so its
    padded prefill computes what the port's does."""
    jmod, tmod = ARCHS[arch]
    jparams, params = models[arch]
    cfg_j, cfg = jmod.SMOKE, tmod.SMOKE
    rng = np.random.default_rng(1)
    lens, bucket, ps, steps, cache_len = [70, 41], 72, 8, 6, 80
    tokens = np.zeros((2, bucket), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab, size=(n,))
    last = np.array(lens, np.int32) - 1
    lj, cj = jax.jit(lambda p, t, lp: jax_tf.prefill(p, cfg_j, t, cache_len=cache_len,
                                                     last_positions=lp))(
        jparams, jnp.asarray(tokens), jnp.asarray(last))
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, cfg_j, t, c, n))
    lt, ct = transformer.prefill(params, cfg, torch.from_numpy(tokens).long(),
                                 cache_len=cache_len,
                                 last_positions=torch.from_numpy(last).long())
    assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < TOL

    max_pages = cache_len // ps
    table = np.arange(1, 1 + 2 * max_pages, dtype=np.int32).reshape(2, max_pages)
    pools = transformer.init_paged_caches(cfg, 1 + 2 * max_pages, ps, "cpu")
    _scatter(pools, ct, lens, table, ps)
    dense = [{"k": c["k"].clone(), "v": c["v"].clone()} for c in ct]
    lengths = np.array(lens, np.int32)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(steps):
        lengths = lengths + 1
        lj, cj = jdecode(jparams, jnp.asarray(tok), cj, jnp.asarray(lengths))
        lp, pools = transformer.decode_step(params, cfg, torch.from_numpy(tok).long(), pools,
                                            torch.from_numpy(lengths),
                                            page_table=torch.from_numpy(table))
        ld, dense = transformer.decode_step(params, cfg, torch.from_numpy(tok).long(), dense,
                                            torch.from_numpy(lengths))
        for got in (lp, ld):
            assert float(np.abs(np.asarray(lj) - got.numpy()).max()) < TOL
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        assert np.array_equal(tok, lp.argmax(-1).numpy())
        assert np.array_equal(tok, ld.argmax(-1).numpy())
    assert _routes_alike(jax_drops)


def _serve_both(arch, models, prompts, kv_layout, engine_kw, n_new):
    jmod, tmod = ARCHS[arch]
    jparams, params = models[arch]
    jeng = JaxEngine(jmod.SMOKE, jparams, kv_layout=kv_layout, **engine_kw)
    teng = LLMEngine(tmod.SMOKE, params, kv_layout=kv_layout, device="cpu", **engine_kw)
    jout = jeng.generate([JaxRequest(uid=i, prompt=p, max_new_tokens=n_new)
                          for i, p in enumerate(prompts)])
    tout = teng.generate([Request(uid=i, prompt=p, max_new_tokens=n_new)
                          for i, p in enumerate(prompts)])
    return (teng, {o.uid: [int(t) for t in o.tokens] for o in jout},
            {o.uid: [int(t) for t in o.tokens] for o in tout})


@pytest.mark.parametrize("arch", list(ARCHS))
def test_paged_engine_greedy_ids_match_jax(models, jax_drops, arch):
    """Three prompts share a 48-token prefix (whole pages of 16: the later
    waves extend from it) and one does not; the JAX engine drops no token."""
    rng = np.random.default_rng(4)
    system = rng.integers(1, 500, size=(48,))
    prompts = [np.concatenate([system, rng.integers(1, 500, size=(n,))]) for n in (9, 20, 3)]
    prompts.append(rng.integers(1, 500, size=(30,)))
    kw = dict(num_pages=64, page_size=16, max_batch=2, max_pages_per_seq=8,
              prompt_buckets=(32, 64, 128))
    teng, jtoks, ttoks = _serve_both(arch, models, prompts, "paged", kw, 10)
    assert teng.kv_layout == "paged"
    assert ttoks == jtoks
    assert teng.backend.stats["extend_prefills"] >= 2
    assert _routes_alike(jax_drops)
    teng.close()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dense_engine_greedy_ids_match_jax(models, jax_drops, arch):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, size=(n,)) for n in (60, 17, 33)]
    kw = dict(max_batch=2, cache_len=96, prompt_buckets=(32, 64))
    teng, jtoks, ttoks = _serve_both(arch, models, prompts, "dense", kw, 12)
    assert ttoks == jtoks
    assert _routes_alike(jax_drops)


# -- training (3 train steps against the JAX one: tests/test_torch_training.py) --

def test_forward_sums_the_aux_losses_under_remat():
    """``forward``'s aux is the JAX stack's sum over layers, with and
    without remat (the checkpointed layer returns its losses)."""
    jparams = jax.jit(jax_tf.init_model, static_argnums=1)(jax.random.PRNGKey(2),
                                                          jax_moonshot.SMOKE)
    cfg = moonshot_v1_16b_a3b.SMOKE
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                                         param_dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(1, cfg.vocab, size=(2, 40)).astype(np.int32)
    lj, aj = jax.jit(jax_tf.forward, static_argnums=1)(jparams, jax_moonshot.SMOKE,
                                                       jnp.asarray(tokens))
    for remat in (True, False):
        lt, at = transformer.forward(params, cfg, torch.from_numpy(tokens).long(), remat=remat)
        assert float(np.abs(np.asarray(lj) - lt.detach().numpy()).max()) < TOL
        for key in aj:
            assert abs(float(aj[key]) - float(at[key])) < TOL, key
    assert float(at["moe_lb_loss"]) > 1.0   # two layers, each about 1


# -- the reference's padding fault (ROADMAP Queue C) -----------------------------

#: Row 0: 2 tokens padded to 16; row 1: 8 tokens padded to 16. In the JAX
#: package's padded call (capacity 16 of 32 tokens) row 0's 14 pads (token
#: 0) come first in token order and fill their experts, so 3 of row 1's
#: (token, slot) pairs routed there are dropped. Alone, each row is at most
#: 8 tokens, under the capacity floor of 8: nothing drops.
PAD_LENS, PAD_BUCKET = (2, 8), 16


def _pad_batch(vocab):
    rng = np.random.default_rng(0)
    rows = [rng.integers(1, vocab, size=(n,)).astype(np.int32) for n in PAD_LENS]
    padded = np.zeros((2, PAD_BUCKET), np.int32)
    for b, r in enumerate(rows):
        padded[b, :len(r)] = r
    return rows, padded, np.array(PAD_LENS, np.int32) - 1


def _jax_prefill(jparams, cfg_j, tokens, last=None):
    """The JAX package's prefill, jitted, of numpy ``tokens``."""
    f = jax.jit(lambda p, t, lp: jax_tf.prefill(p, cfg_j, t, cache_len=32, last_positions=lp))
    return f(jparams, jnp.asarray(tokens), None if last is None else jnp.asarray(last))


def test_padded_prefill_equals_jax_unpadded(models, jax_drops):
    """moonshot SMOKE: the port's padded two-row prefill gives each row the
    first logits of the JAX package's prefill of that row alone, unpadded,
    where the JAX package drops nothing."""
    jparams, params = models["moonshot-v1-16b-a3b"]
    cfg_j, cfg = jax_moonshot.SMOKE, moonshot_v1_16b_a3b.SMOKE
    rows, padded, last = _pad_batch(cfg.vocab)
    lt, _ = transformer.prefill(params, cfg, torch.from_numpy(padded).long(), cache_len=32,
                                last_positions=torch.from_numpy(last).long())
    for b, r in enumerate(rows):
        lj, _ = _jax_prefill(jparams, cfg_j, r[None])
        assert float(np.abs(np.asarray(lj)[0] - lt[b].numpy()).max()) < TOL
    assert _routes_alike(jax_drops) and all(d == 0 for d, _ in jax_drops)


def test_this_input_exposes_the_padding_fault_of_the_reference(models, jax_drops):
    """The case above discriminates: the JAX package's own padded prefill (as
    its engines batch it) drops row 1's slots behind row 0's pads, and row
    1's first logits land far from its unpadded prefill, which the port
    matches."""
    jparams, _ = models["moonshot-v1-16b-a3b"]
    cfg_j = jax_moonshot.SMOKE
    rows, padded, last = _pad_batch(cfg_j.vocab)
    lp, _ = _jax_prefill(jparams, cfg_j, padded, last)
    assert max(other for _, other in jax_drops) > 0
    lj, _ = _jax_prefill(jparams, cfg_j, rows[1][None])
    assert np.abs(np.asarray(lp)[1] - np.asarray(lj)[0]).max() > 0.1


def test_launchers_run_moonshot_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train

    serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-new-tokens", "4",
                "--prompt-len", "32", "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "kv_layout=paged device=cpu" in out
    assert out.count("finish=length") == 3
    train.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--steps", "2",
                "--seq-len", "32", "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    assert "steps=2 retries=0" in capsys.readouterr().out
