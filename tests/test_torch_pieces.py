"""Framework-free pieces of the PyTorch port against the JAX package: split
ranges, page hashes, the page pool, the traversal order, the split-K
estimator on the H100 topology, the plan layer, sampling and device
selection."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.cache import layout as jax_layout
from repro.cache import prefix as jax_prefix
from repro.cache.pool import PagePool as JaxPagePool
from repro.configs import llama3_8b as jax_llama
from repro.core import swizzle as jax_swizzle

from repro_torch.cache import layout, prefix
from repro_torch.cache.pool import OutOfPages, PagePool
from repro_torch.configs import llama3_8b, registry
from repro_torch.core import device, numa, perf_model, swizzle
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import plan as plan_lib
from repro_torch.serving import sampling


@pytest.mark.parametrize("num_units", [0, 1, 5, 16, 33, 258])
def test_decode_split_ranges_identical(num_units):
    for splits in range(1, 20):
        assert layout.decode_split_ranges(num_units, splits) == \
            jax_layout.decode_split_ranges(num_units, splits)


@pytest.mark.parametrize("page_size", [1, 8, 16])
def test_page_hashes_byte_identical(page_size):
    rng = np.random.default_rng(page_size)
    for n in (0, 7, 16, 50, 129):
        toks = rng.integers(0, 128256, size=(n,))
        assert prefix.page_hashes(toks, page_size) == \
            jax_prefix.page_hashes(toks, page_size)
        assert prefix.page_hashes(list(toks.astype(np.int32)), page_size) == \
            jax_prefix.page_hashes(toks, page_size)


def test_page_pool_replays_identically():
    """The same operation stream allocates the same pages, COWs and frees
    in both packages."""
    rng = np.random.default_rng(0)
    pools = (PagePool(12, 4), JaxPagePool(12, 4))
    seqs = ([], [])
    for _ in range(200):
        op = int(rng.integers(0, 4))
        arg = int(rng.integers(1, 9))
        results = []
        for pool, live in zip(pools, seqs):
            try:
                if op == 0:
                    live.append(pool.allocate_sequence(arg))
                    results.append(list(live[-1].pages))
                elif op == 1 and live:
                    seq = live[arg % len(live)]
                    results.append(pool.append_token(seq))
                elif op == 2 and live:
                    results.append(pool.release(live.pop(arg % len(live))))
                elif op == 3 and live:
                    live.append(pool.fork(live[arg % len(live)]))
                    results.append(list(live[-1].pages))
                else:
                    results.append(None)
            except Exception as e:  # noqa: BLE001 - the error type is compared
                results.append(type(e).__name__)
        assert results[0] == results[1]
        assert pools[0].free_pages == pools[1].free_pages
    refs = {}
    for s in seqs[0]:
        for pid in s.pages:
            refs[pid] = refs.get(pid, 0) + 1
    assert pools[0].check_leaks(refs) == {}


def test_pool_reserve_and_trim():
    pool = PagePool(8, 4)
    seq = pool.allocate_sequence(3)
    cows = pool.reserve_tokens(seq, 6)
    assert cows == [] and seq.length == 9 and len(seq.pages) == 3
    assert pool.trim_tokens(seq, 4) == 2 and len(seq.pages) == 1
    with pytest.raises(OutOfPages):
        pool.reserve_tokens(seq, 100)


def test_kv_tile_order_matches_jax():
    for traversal in swizzle.TRAVERSALS:
        for sweep in range(4):
            order = [swizzle.kv_tile_order(traversal, sweep, n, 7) for n in range(7)]
            assert order == [jax_swizzle.kv_tile_order(traversal, sweep, n, 7)
                             for n in range(7)]
            assert sorted(order) == list(range(7))


def test_configs_match_jax():
    for mine, theirs in ((llama3_8b.CONFIG, jax_llama.CONFIG),
                         (llama3_8b.SMOKE, jax_llama.SMOKE)):
        for field in ("name", "d_model", "n_layers", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab", "rope_theta", "tie_embeddings",
                      "compute_dtype", "max_seq_len", "attn_softcap", "final_softcap"):
            assert getattr(mine, field) == getattr(theirs, field), field
        assert [s.rope_theta for s in mine.layer_pattern] == \
            [s.rope_theta for s in theirs.layer_pattern]
    assert registry.get_config("llama3-8b") is llama3_8b.CONFIG
    with pytest.raises(KeyError):      # an architecture not ported yet
        registry.get_config("llama3-405b")


def _splits(batch, seq_kv):
    cfg = llama3_8b.CONFIG
    return perf_model.estimate_decode_splits(
        batch=batch, num_q_heads=cfg.n_heads, num_kv_heads=cfg.n_kv_heads,
        seq_kv=seq_kv, granule=16, head_dim=cfg.head_dim, dtype_bytes=2,
        topo=numa.H100)


def test_h100_split_choice_on_the_serving_shapes():
    """The calibrated estimator at the serving shapes. One 4096-token
    llama3-8b sequence is 8 cells on 132 SMs: split (the exact count is not
    pinned: the card measured 8 splits fastest at one row of 260 pages,
    the estimator picks 9, 1.02x that). Pinned where chip_smoke.py's plan
    phase (a) measured the pick fastest on the card: one pass for eight
    rows of 36 pages (the serve engine's 544-token rows) and of 128 pages
    (the loadgen engine's tables)."""
    long_ctx = _splits(1, 4128)
    assert long_ctx.num_splits > 1 and long_ctx.time < long_ctx.base_time
    assert _splits(8, 544).num_splits == 1
    assert _splits(8, 36 * 16).num_splits == 1
    assert _splits(8, 128 * 16).num_splits == 1
    assert _splits(1, 16).num_splits == 1          # one page: nothing to split


def test_plan_resolves_impl_by_device():
    shape = (2, 32, 8, 1, 544, 128)
    cpu = plan_lib.plan_attention(shape, phase=plan_lib.DECODE, kv_layout=plan_lib.PAGED,
                                  page_size=16, device_type="cpu")
    gpu = plan_lib.plan_attention(shape, phase=plan_lib.DECODE, kv_layout=plan_lib.PAGED,
                                  page_size=16, device_type="cuda")
    assert cpu.impl == "plain" and gpu.impl == "cuda"
    assert cpu.num_splits == gpu.num_splits            # same topology either way
    assert gpu.mapping == plan_lib.PAPER_MAPPINGS["swizzled_head_first"]
    assert plan_lib.plan_attention(shape[:3] + (64, 64, 128), device_type="cuda",
                                   impl="plain").impl == "plain"
    with pytest.raises(ValueError):
        plan_lib.plan_attention(shape, device_type="cpu", impl="cuda")
    with pytest.raises(KeyError):
        plan_lib.plan_attention(shape, device_type="cpu", mapping_name="bogus")


def test_paper_mapping_names_alias_the_two_hopper_orders():
    """naive_/swizzled_ differ only in TPU residency and megacore semantics,
    which have no launch form on Hopper: each pair is one launch."""
    maps = fa.PAPER_MAPPINGS
    assert maps["naive_head_first"] == maps["swizzled_head_first"] == \
        fa.MappingConfig(order=fa.HEAD_FIRST)
    assert maps["naive_block_first"] == maps["swizzled_block_first"] == \
        fa.MappingConfig(order=fa.BLOCK_FIRST)
    assert [f.name for f in dataclasses.fields(fa.MappingConfig)] == ["order", "traversal"]


def test_greedy_sampling_is_exact_argmax():
    logits = torch.randn(5, 300, generator=torch.Generator().manual_seed(0))
    toks = sampling.sample_tokens(logits, [0.0] * 5, [0] * 5, [1.0] * 5,
                                  [1] * 5, [0] * 5)
    assert torch.equal(toks, logits.argmax(dim=-1))


def test_stochastic_sampling_keyed_by_seed_and_position():
    """A row's sample depends on (seed, stream position) only — not on its
    batch neighbours; top-k = 1 is greedy; top-p keeps the crossing token."""
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    kw = dict(temperature=[0.9] * 4, top_k=[0] * 4, top_p=[1.0] * 4)
    a = sampling.sample_tokens(logits, kw["temperature"], kw["top_k"], kw["top_p"],
                               [7, 8, 9, 10], [3, 3, 3, 3])
    b = sampling.sample_tokens(logits[2:3], [0.9], [0], [1.0], [9], [3])
    assert int(a[2]) == int(b[0])
    draws = {int(sampling.sample_tokens(logits[:1], [1.0], [0], [1.0], [5], [p])[0])
             for p in range(40)}
    assert len(draws) > 1
    topk1 = sampling.sample_tokens(logits, [1.0] * 4, [1] * 4, [1.0] * 4, [1, 2, 3, 4],
                                   [0] * 4)
    assert torch.equal(topk1, logits.argmax(dim=-1))
    peaked = torch.full((1, 10), -10.0)
    peaked[0, 3] = 10.0
    assert int(sampling.sample_tokens(peaked, [1.0], [0], [0.5], [0], [0])[0]) == 3


def test_device_resolve():
    assert device.resolve("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device.resolve(None)
        with pytest.raises(RuntimeError):
            device.resolve("cuda")
    assert device.dtype_of("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        device.dtype_of("int4")
