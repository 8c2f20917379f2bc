"""The port's gemma family against the JAX package, on the CPU.

gemma2-2b (softcaps, alternating window-64 / global layers at SMOKE size)
and gemma3-1b (qk-norm, dual rope thetas, one kv head) at SMOKE size, float32
end to end: the configs field for field, prefill logits and decode logits
over paged pools and dense stripes within 2e-5, and greedy ids through both
engines, paged (a shared prefix, so the extend prefill runs) and dense,
token for token. The JAX weights are carried across by ``from_jax_params``
after the qk-norm gains are set to random non-zero values: at their
zero initialisation ``(1 + scale)`` is the identity, and a fault in the
gains could not show. One ``launch.serve --arch gemma2-2b --smoke`` run.
The tensor-core kernels' arithmetic at head_dim 256 (K1, K2, K3/K4, K7/K8)
is written out in tests/test_torch_kernels.py,
tests/test_torch_paged_prefill_tc.py, tests/test_torch_paged_tc.py and
tests/test_torch_dense.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jax_gemma2
from repro.configs import gemma3_1b as jax_gemma3
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest

from repro_torch.configs import gemma2_2b, gemma3_1b, registry
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request

LOGIT_TOL = 2e-5
ARCHS = {"gemma2-2b": (jax_gemma2, gemma2_2b), "gemma3-1b": (jax_gemma3, gemma3_1b)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_qk_gains(tree, seed):
    """The JAX tree with every ``q_norm`` / ``k_norm`` gain drawn from
    N(0, 0.5) (numpy leaves)."""
    rng = np.random.default_rng(seed)
    for lp in list(tree["layers"]) + list(tree["layers_rem"]):
        for key in ("q_norm", "k_norm"):
            if key in lp.get("attn", {}):
                shape = lp["attn"][key]["scale_r"].shape
                lp["attn"][key]["scale_r"] = (0.5 * rng.standard_normal(shape)).astype(
                    np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (arch, (jmod, tmod)) in enumerate(ARCHS.items()):
        tree = jax.tree.map(np.asarray, jax_tf.init_model(jax.random.PRNGKey(i), jmod.SMOKE))
        tree = _random_qk_gains(tree, seed=10 + i)
        jparams = jax.tree.map(jnp.asarray, tree)
        out[arch] = (jparams, transformer.from_jax_params(tree, tmod.SMOKE, device="cpu"))
    return out


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_are_the_jax_packages_field_for_field(arch):
    jmod, tmod = ARCHS[arch]
    assert arch in registry.ARCH_IDS
    assert registry.get_config(arch) is tmod.CONFIG
    for jcfg, tcfg in ((jmod.CONFIG, tmod.CONFIG), (jmod.SMOKE, tmod.SMOKE)):
        mine, theirs = _fields(tcfg), _fields(jcfg)
        pattern = mine.pop("layer_pattern")
        assert [_fields(s) for s in pattern] == [
            {k: v for k, v in _fields(s).items() if k in _fields(pattern[0])}
            for s in theirs.pop("layer_pattern")]
        assert mine == {k: theirs[k] for k in mine}
        n, pat = jcfg.n_layers, jcfg.layer_pattern
        stack = pat * (n // len(pat)) + pat[:n % len(pat)]
        assert [(s.window, s.rope_theta) for s in tcfg.layer_specs()] == [
            (s.window, s.rope_theta) for s in stack]
    assert tmod.CONFIG.head_dim == 256
    if arch == "gemma3-1b":   # 4 periods of 6, then 2 local layers
        assert tmod.CONFIG.n_periods == 4 and len(tmod.CONFIG.pattern_for_depth()[1]) == 2


def _scatter(pools, caches, lengths, table, ps):
    """Write each row's prefilled K/V positions into its pages."""
    for pool, c in zip(pools, caches):
        for b, n in enumerate(lengths):
            for pos in range(n):
                pid = table[b, pos // ps]
                pool["k_pages"][:, pid, pos % ps] = c["k"][b, :, pos]
                pool["v_pages"][:, pid, pos % ps] = c["v"][b, :, pos]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_logits_match_jax(models, arch):
    """Prefill logits of two right-padded rows, then 6 greedy decode steps
    over paged pools and over dense stripes, each within 2e-5 of the JAX
    package's dense decode. The rows pass the SMOKE window of 64."""
    jmod, tmod = ARCHS[arch]
    jparams, params = models[arch]
    cfg_j, cfg = jmod.SMOKE, tmod.SMOKE
    rng = np.random.default_rng(1)
    lens, bucket, ps, steps, cache_len = [70, 41], 72, 8, 6, 80
    tokens = np.zeros((2, bucket), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab, size=(n,))
    last = np.array(lens, np.int32) - 1
    lj, cj = jax_tf.prefill(jparams, cfg_j, jnp.asarray(tokens), cache_len=cache_len,
                            last_positions=jnp.asarray(last))
    lt, ct = transformer.prefill(params, cfg, torch.from_numpy(tokens).long(),
                                 cache_len=cache_len,
                                 last_positions=torch.from_numpy(last).long())
    assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < LOGIT_TOL

    max_pages = cache_len // ps
    table = np.arange(1, 1 + 2 * max_pages, dtype=np.int32).reshape(2, max_pages)
    pools = transformer.init_paged_caches(cfg, 1 + 2 * max_pages, ps, "cpu")
    _scatter(pools, ct, lens, table, ps)
    dense = [{"k": c["k"].clone(), "v": c["v"].clone()} for c in ct]
    lengths = np.array(lens, np.int32)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(steps):
        lengths = lengths + 1
        lj, cj = jax_tf.decode_step(jparams, cfg_j, jnp.asarray(tok), cj,
                                    jnp.asarray(lengths))
        lp, pools = transformer.decode_step(params, cfg, torch.from_numpy(tok).long(), pools,
                                            torch.from_numpy(lengths),
                                            page_table=torch.from_numpy(table))
        ld, dense = transformer.decode_step(params, cfg, torch.from_numpy(tok).long(), dense,
                                            torch.from_numpy(lengths))
        for got in (lp, ld):
            assert float(np.abs(np.asarray(lj) - got.numpy()).max()) < LOGIT_TOL
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        assert np.array_equal(tok, lp.argmax(-1).numpy())
        assert np.array_equal(tok, ld.argmax(-1).numpy())


def test_zero_qk_gains_are_the_identity_and_random_ones_are_not(models):
    """The qk-norm gains reach the logits: gemma3's prefill with the gains
    zeroed differs from the one with the random gains."""
    _, params = models["gemma3-1b"]
    zeroed = {**params, "layers": [{**lp, "q_norm": torch.zeros_like(lp["q_norm"]),
                                    "k_norm": torch.zeros_like(lp["k_norm"])}
                                   for lp in params["layers"]]}
    tokens = torch.arange(1, 21)[None]
    a, _ = transformer.prefill(params, gemma3_1b.SMOKE, tokens, cache_len=24)
    b, _ = transformer.prefill(zeroed, gemma3_1b.SMOKE, tokens, cache_len=24)
    assert float((a - b).abs().max()) > 1e-3
    init = transformer.init_model(gemma3_1b.SMOKE, seed=0, device="cpu")
    assert all(lp["q_norm"].shape == (16,) and not lp["k_norm"].any()
               for lp in init["layers"])


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
def test_paged_engine_greedy_ids_match_jax(models, arch):
    """Three prompts share a 48-token prefix (whole pages of 16: the second
    and third wave extend from it) and one does not; rows run past the
    window of 64 while they decode."""
    rng = np.random.default_rng(4)
    system = rng.integers(1, 500, size=(48,))
    prompts = [np.concatenate([system, rng.integers(1, 500, size=(n,))]) for n in (9, 20, 3)]
    prompts.append(rng.integers(1, 500, size=(30,)))
    kw = dict(num_pages=64, page_size=16, max_batch=2, max_pages_per_seq=8,
              prompt_buckets=(32, 64, 128))
    teng, jtoks, ttoks = _serve_both(arch, models, prompts, "paged", kw, 10)
    assert ttoks == jtoks
    assert teng.backend.stats["extend_prefills"] >= 2
    teng.close()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dense_engine_greedy_ids_match_jax(models, arch):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, size=(n,)) for n in (60, 17, 33)]
    kw = dict(max_batch=2, cache_len=96, prompt_buckets=(32, 64))
    teng, jtoks, ttoks = _serve_both(arch, models, prompts, "dense", kw, 12)
    assert teng.kv_layout == "dense"
    assert ttoks == jtoks


def test_serve_launcher_runs_gemma2_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new-tokens", "4", "--prompt-len", "32",
                "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "kv_layout=paged device=cpu" in out
    assert out.count("finish=length") == 3 and "3 done" in out
