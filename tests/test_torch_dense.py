"""Dense-stripe decode of the PyTorch port against the JAX package, on the CPU.

K7/K8 (``kernels.decode_attention.flash_decode``, which on CPU tensors runs
its plain version ``flash_decode_plain``) against
``repro.kernels.decode_attention.flash_decode`` in interpret mode, over the
cases of ``tests/test_decode_attention.py`` and of the dense part of
``tests/test_split_decode.py``; the plan's dense decode chunk and split
choice; ``ops.decode_attention``'s padding of odd capacities; and the
llama stack's dense prefill and decode against the JAX package's. Bars are
the JAX suite's: 2e-5 at float32, 3e-2 at bfloat16, 1e-4 on SMOKE logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jax_llama
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import flash_decode as jax_decode
from repro.models import transformer as jax_tf
from tc_decode_emulation import ROW_TOL, dense_k7_k8, row_err

from repro_torch.configs import llama3_8b
from repro_torch.core import numa, perf_model
from repro_torch.kernels import ops
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.decode_attention import flash_decode, flash_decode_plain
from repro_torch.models import transformer

F32_TOL = 2e-5
BF16_TOL = 3e-2
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, hq, hkv, smax, d, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, d), (b, hkv, smax, d), (b, hkv, smax, d))]
    if dtype == "bfloat16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _lengths(values):
    values = np.asarray(values, np.int32)
    return jnp.asarray(values), torch.from_numpy(values)


def _diff(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


@pytest.mark.parametrize("b,hq,hkv,smax,d", [
    (2, 8, 2, 1024, 64),
    (3, 4, 4, 512, 128),     # MHA
    (1, 25, 5, 512, 64),     # hymba-like odd group
    (2, 4, 1, 1024, 256),    # gemma-like
])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_matches_jax(b, hq, hkv, smax, d, window, softcap):
    (qj, kj, vj), (qt, kt, vt) = _inputs(b, hq, hkv, smax, d)
    lj, lt = _lengths(np.random.default_rng(0).integers(1, smax + 1, size=(b,)))
    oj = jax_decode(qj, kj, vj, lj, window=window, softcap=softcap, chunk=256,
                    interpret=True)
    ot = flash_decode(qt, kt, vt, lt, window=window, softcap=softcap, chunk=256)
    assert _diff(oj, ot) < F32_TOL


@pytest.mark.parametrize("num_splits", [1, 3])
def test_decode_matches_jax_bf16(num_splits):
    (qj, kj, vj), (qt, kt, vt) = _inputs(2, 25, 5, 512, 64, seed=1, dtype="bfloat16")
    lj, lt = _lengths([300, 512])
    kw = dict(window=64, chunk=64, num_splits=num_splits)
    oj = jax_decode(qj, kj, vj, lj, interpret=True, **kw)
    ot = flash_decode(qt, kt, vt, lt, **kw)
    assert ot.dtype == torch.bfloat16
    assert _diff(oj, ot) < BF16_TOL


@pytest.mark.parametrize("lengths,chunk", [([1, 512], 128), ([0, 17], 128)],
                         ids=["length_one_and_full", "length_zero"])
def test_decode_edge_lengths(lengths, chunk):
    (qj, kj, vj), (qt, kt, vt) = _inputs(2, 8, 2, 512, 64, seed=3)
    lj, lt = _lengths(lengths)
    oj = jax_decode(qj, kj, vj, lj, chunk=chunk, interpret=True)
    ot = flash_decode(qt, kt, vt, lt, chunk=chunk)
    assert _diff(oj, ot) < F32_TOL
    if lengths[0] == 0:
        assert float(ot[0].abs().max()) == 0.0


@pytest.mark.parametrize("window", [8, 100])
def test_window_smaller_than_chunk(window):
    (qj, kj, vj), (qt, kt, vt) = _inputs(2, 8, 2, 1024, 64, seed=4)
    lj, lt = _lengths([700, 1024])
    oj = jax_decode(qj, kj, vj, lj, window=window, chunk=256, interpret=True)
    ot = flash_decode(qt, kt, vt, lt, window=window, chunk=256)
    assert _diff(oj, ot) < F32_TOL


@pytest.mark.parametrize("smax", [100, 700, 1000])
def test_ops_decode_pads_capacities_the_chunk_does_not_divide(smax):
    """The plan's chunk divides 1000 (40) and pads 100 and 700 to 128 and
    704; either way the padded tail is masked."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(2, 8, 2, smax, 64, seed=5)
    lj, lt = _lengths([smax // 3, smax])
    oj = jax_ref.decode_attention(qj, kj, vj, lj)
    ot = ops.decode_attention(qt, kt, vt, lt)
    assert _diff(oj, ot) < F32_TOL
    assert _diff(jax_ops.decode_attention(qj, kj, vj, lj, impl="pallas"), ot) < F32_TOL


# -- split-K (K8) ----------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,smax,d,chunk", [
    (2, 8, 2, 1024, 64, 128),     # GQA
    (1, 25, 5, 512, 64, 64),      # hymba-like odd group
    (2, 4, 1, 512, 128, 128),     # MQA
])
@pytest.mark.parametrize("num_splits", [1, 2, 7])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, 50.0)])
def test_split_decode_matches_jax(b, hq, hkv, smax, d, chunk, num_splits, window, softcap):
    """7 splits over 8 or 4 chunks: uneven ranges and a dropped empty one."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(b, hq, hkv, smax, d)
    lj, lt = _lengths(np.random.default_rng(0).integers(1, smax + 1, size=(b,)))
    kw = dict(window=window, softcap=softcap, chunk=chunk, num_splits=num_splits)
    oj = jax_decode(qj, kj, vj, lj, interpret=True, **kw)
    ot = flash_decode(qt, kt, vt, lt, **kw)
    assert _diff(oj, ot) < F32_TOL


@pytest.mark.parametrize("case", ["length_zero_row", "window_inside_one_split",
                                  "more_splits_than_chunks"])
def test_split_decode_edges(case):
    if case == "length_zero_row":
        shape, lengths, kw = (3, 8, 2, 512, 64), [0, 17, 512], dict(chunk=128, num_splits=2)
    elif case == "window_inside_one_split":
        shape, lengths, kw = (2, 8, 2, 1024, 64), [700, 1024], dict(window=8, chunk=128,
                                                                    num_splits=4)
    else:
        shape, lengths, kw = (2, 8, 2, 256, 64), [100, 256], dict(chunk=128, num_splits=64)
    (qj, kj, vj), (qt, kt, vt) = _inputs(*shape, seed=6)
    lj, lt = _lengths(lengths)
    ot = flash_decode(qt, kt, vt, lt, **kw)
    assert _diff(jax_decode(qj, kj, vj, lj, interpret=True, **kw), ot) < F32_TOL
    assert _diff(jax_ref.decode_attention(qj, kj, vj, lj, window=kw.get("window")),
                 ot) < F32_TOL
    if lengths[0] == 0:
        assert float(ot[0].abs().max()) == 0.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(25, 5), (32, 8), (32, 1)], ids=["g5", "g4", "g32"])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("window,softcap,chunk", [(None, None, 64), (100, 30.0, 40),
                                                  (40, None, 64)],
                         ids=["full_c64", "window_softcap_c40", "window_lt_tile_c64"])
def test_tensor_core_k7_k8_arithmetic_matches_jax(d, hq, hkv, num_splits, window, softcap,
                                                   chunk):
    """Rounding P to bf16 before P V, and the per-warp states merged at the
    end, the tensor-core K7/K8's departures from the JAX kernel (which keeps
    P in float32 and one state per cell), stay within the card's bars: per
    row within 2^-6 of the row's max, and within the suite's bf16 bar.
    Capacity 320; lengths 0, 1, 203 (a ragged last tile) and 320."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(4, hq, hkv, 320, d, seed=70 + d, dtype="bfloat16")
    lj, lt = _lengths([0, 1, 203, 320])
    kw = dict(window=window, softcap=softcap, chunk=chunk, num_splits=num_splits)
    oj = jax_decode(qj, kj, vj, lj, interpret=True, **kw)
    ot = dense_k7_k8(qt, kt, vt, lt, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert _diff(oj, ot) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0
    # Rows past each length change nothing: the tiles read them, masked.
    past = torch.arange(320)[None, None, :, None] >= lt.long()[:, None, None, None]
    big = torch.tensor(1e4, dtype=torch.bfloat16)
    ot2 = dense_k7_k8(qt, torch.where(past, big, kt), torch.where(past, -big, vt), lt, **kw)
    assert torch.equal(ot, ot2)


@pytest.mark.parametrize("hq,hkv", [(8, 4), (4, 1), (32, 1)], ids=["gemma2", "gemma3", "g32"])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("window", [None, 100, 40])
def test_tensor_core_k7_k8_d256_arithmetic_matches_jax(hq, hkv, num_splits, window):
    """At head_dim 256 the four warps take every tile, one state a cell,
    S summed from four partial products over 64-column chunks of D and the
    row sums kept per 16-key slice: the lengths of the test above, gemma's
    groups of 2 and 4 and a group of 32 (two m16 tiles), softcap 50; window
    40 masks all but the end of a tile, so the exchanged partial sums of a
    tile are mostly masked."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(4, hq, hkv, 320, 256, seed=75, dtype="bfloat16")
    lj, lt = _lengths([0, 1, 203, 320])
    kw = dict(window=window, softcap=50.0, chunk=64, num_splits=num_splits)
    oj = jax_decode(qj, kj, vj, lj, interpret=True, **kw)
    ot = dense_k7_k8(qt, kt, vt, lt, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert _diff(oj, ot) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0


def test_plain_version_refuses_a_capacity_the_chunk_does_not_divide():
    _, (qt, kt, vt) = _inputs(1, 4, 2, 100, 64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        flash_decode_plain(qt, kt, vt, torch.tensor([50], dtype=torch.int32), chunk=64)


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("capacity,chunk", [(4096, 64), (1536, 64), (1000, 40), (700, 64),
                                            (100, 64), (32, 32), (20, 20)])
def test_dense_decode_chunk_rule(capacity, chunk):
    """The largest multiple of 8 dividing the capacity, at most the kernels'
    64-row staging block; no divisor keeps 64 and ops pads."""
    assert plan_lib.decode_chunk(capacity) == chunk
    p = plan_lib.plan_attention((2, 8, 2, 1, capacity, 64), phase=plan_lib.DECODE,
                                device_type="cpu")
    assert p.kv_layout == plan_lib.DENSE and p.chunk == chunk


def test_dense_decode_splits_follow_the_occupancy_model():
    """One long row of hymba (5 cells on 132 SMs) splits; eight rows of a
    1536-token live width do not. Dense stripes are planned on
    ``plan.DENSE_DECODE_TOPOLOGY`` (K7/K8's split terms are not fitted to
    the card; the paged kernels' are)."""
    def splits(b, width):
        return plan_lib.plan_attention((b, 25, 5, 1, width, 64), phase=plan_lib.DECODE,
                                       device_type="cpu").num_splits

    assert splits(1, 4096) > 1
    assert splits(8, 1536) == 1
    est = perf_model.estimate_decode_splits(batch=1, num_q_heads=25, num_kv_heads=5,
                                            seq_kv=4096, granule=64, head_dim=64,
                                            dtype_bytes=2,
                                            topo=plan_lib.DENSE_DECODE_TOPOLOGY)
    assert splits(1, 4096) == est.num_splits


def test_resolve_kv_layout_and_decode_models():
    """Paged walks live pages only, so it ranks first for an attention mix;
    the dense model charges the whole stripe."""
    shape = (8, 32, 8, 1024, 128)
    assert plan_lib.resolve_kv_layout(shape, capacity=2048, page_size=16) == \
        "paged:head_aligned"
    dense = perf_model.estimate_dense_decode(batch=8, num_q_heads=32, num_kv_heads=8,
                                             capacity=2048, head_dim=128, dtype_bytes=2,
                                             topo=numa.H100)
    paged = perf_model.estimate_paged_decode(batch=8, num_q_heads=32, num_kv_heads=8,
                                             mean_len=1024, page_size=16, head_dim=128,
                                             dtype_bytes=2, topo=numa.H100)
    assert dense.hbm_bytes == 2.0 * 8 * 8 * 2048 * 128 * 2
    assert paged.hbm_bytes == dense.hbm_bytes / 2 and paged.time < dense.time
    shared = perf_model.estimate_paged_decode(batch=8, num_q_heads=32, num_kv_heads=8,
                                              mean_len=1024, page_size=16, head_dim=128,
                                              dtype_bytes=2, topo=numa.H100,
                                              shared_prefix_len=512)
    assert shared.hbm_bytes < paged.hbm_bytes and shared.reuse_rate > 0
    with pytest.raises(ValueError):
        perf_model.estimate_paged_decode(batch=1, num_q_heads=1, num_kv_heads=1,
                                         mean_len=16, page_size=16, head_dim=64,
                                         dtype_bytes=2, topo=numa.H100, policy="interleaved")


# -- the llama stack on dense stripes -----------------------------------------------


def test_llama_dense_prefill_and_decode_match_jax():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         llama3_8b.SMOKE, device="cpu")
    cfg_j, cfg = jax_llama.SMOKE, llama3_8b.SMOKE
    rng = np.random.default_rng(7)
    lens, cache_len = [20, 13], 64
    tokens = np.zeros((2, 24), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab, size=(n,))
    last = np.array(lens, np.int32) - 1
    lj, cj = jax_tf.prefill(jparams, cfg_j, jnp.asarray(tokens), cache_len=cache_len,
                            last_positions=jnp.asarray(last))
    lt, ct = transformer.prefill(params, cfg, torch.from_numpy(tokens).long(),
                                 cache_len=cache_len,
                                 last_positions=torch.from_numpy(last).long())
    assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < LOGIT_TOL
    lengths = np.array(lens, np.int32)
    nxt = np.asarray(lj).argmax(-1)
    for _ in range(6):
        lengths = lengths + 1
        lj, cj = jax_tf.decode_step(jparams, cfg_j, jnp.asarray(nxt), cj,
                                    jnp.asarray(lengths))
        lt, ct = transformer.decode_step(params, cfg, torch.from_numpy(nxt).long(), ct,
                                         torch.from_numpy(lengths.copy()))
        assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < LOGIT_TOL
        nxt = np.asarray(lj).argmax(-1)
