"""Card-only tests: every CUDA kernel of the port against its plain PyTorch
version on the card, at small shapes, plus the paged engine on the kernels
against the same engine on the plain versions.

Run them on a machine with a Hopper card and ``nvcc``::

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Without a card each test skips, decided inside the ``cuda`` fixture, so
every pytest-xdist worker collects the same tests. The file imports no JAX:
the machine with the card has none. Bars: 2e-5 absolute at float32 (the
kernels and the plain versions both compute in float32; only the order of
the sums differs); at bfloat16, per row, max |o - ref| within 2^-6 of the
row's max |ref| (two roundings to bf16 differ by one ulp, at most 2^-7 of
the row's max; a row of ref that is all zero must be exactly zero), as ``chip_smoke.py`` holds them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import llama3_8b
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pd
from repro_torch.kernels import paged_prefill_attention as pp
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request

pytestmark = pytest.mark.requires_cuda

F32_TOL = 2e-5
ROW_TOL = 2.0**-6
LSE_TOL = 1e-5
HEADS = [(8, 2), (4, 4), (4, 1)]          # GQA, MHA, MQA
HEAD_IDS = ["gqa", "mha", "mqa"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _row_err(a, ref) -> float:
    diff = (a.float() - ref.float()).abs().amax(-1)
    den = ref.float().abs().amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


def _close(a, ref) -> bool:
    """The bar of ``a``'s dtype (module docstring)."""
    if a.dtype == torch.float32:
        return _err(a, ref) < F32_TOL
    return _row_err(a, ref) < ROW_TOL


# -- K1 ------------------------------------------------------------------------

# The distinct launches; the paper's four names are aliases of the two orders.
MAPPINGS = {"head_first": fa.MappingConfig(order=fa.HEAD_FIRST),
            "block_first": fa.MappingConfig(order=fa.BLOCK_FIRST),
            "sawtooth": fa.MappingConfig(order=fa.HEAD_FIRST, traversal="sawtooth")}


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
def test_flash_fwd_every_mapping_matches_plain(cuda, mapping, hq, hkv):
    rng = np.random.default_rng(0)
    q = _randn(rng, (2, hq, 200, 128), cuda)
    k, v = _randn(rng, (2, hkv, 200, 128), cuda), _randn(rng, (2, hkv, 200, 128), cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, mapping=MAPPINGS[mapping], causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _err(o, o_ref) < F32_TOL and _err(lse, lse_ref) < F32_TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True, window=37, softcap=20.0),
                                dict(causal=False, kv_len=150),
                                dict(causal=True, kv_len=90)],
                         ids=["window_softcap", "noncausal_kvlen", "causal_kvlen"])
def test_flash_fwd_masks_match_plain(cuda, dtype, d, kw):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    q = _randn(rng, (1, 8, 130, d), cuda, dt)
    k, v = _randn(rng, (1, 2, 170, d), cuda, dt), _randn(rng, (1, 2, 170, d), cuda, dt)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dt and _close(o, o_ref)
    assert _err(lse, lse_ref) < LSE_TOL


def test_flash_fwd_fully_masked_rows(cuda):
    """kv_len 0: every row is fully masked -> o = 0, lse = -1e30."""
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (1, 2, 64, 64), cuda) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False, kv_len=0)
    torch.cuda.synchronize()
    assert float(o.abs().max()) == 0.0
    assert torch.equal(lse, torch.full_like(lse, -1e30))


def test_ops_flash_attention_pads_odd_lengths(cuda):
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 8, 77, 128), cuda)
    k, v = _randn(rng, (2, 2, 77, 128), cuda), _randn(rng, (2, 2, 77, 128), cuda)
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)[0]
    torch.cuda.synchronize()
    assert got.shape == q.shape and _err(got, want) < F32_TOL


# -- K2 ------------------------------------------------------------------------


def _prefill_inputs(rng, dev, dt, hq, hkv, d=128, ps=16, st=70, mp=5, num_pages=24):
    b = 2
    q = _randn(rng, (b, hq, st, d), dev, dt)
    kt, vt = _randn(rng, (b, hkv, st, d), dev, dt), _randn(rng, (b, hkv, st, d), dev, dt)
    kp, vp = (_randn(rng, (hkv, num_pages, ps, d), dev, dt) for _ in range(2))
    table = np.stack([rng.permutation(np.arange(1, num_pages))[:mp] for _ in range(b)])
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    plen = torch.tensor([mp * ps - 7, 17], dtype=torch.int32, device=dev)
    tlen = torch.tensor([st, 41], dtype=torch.int32, device=dev)
    return q, kp, vp, table, kt, vt, plen, tlen


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_prefill_matches_plain(cuda, dtype, hq, hkv, window, softcap):
    dt = DTYPES[dtype]
    args = _prefill_inputs(np.random.default_rng(10), cuda, dt, hq, hkv)
    o = pp.paged_flash_prefill(*args, window=window, softcap=softcap)
    o_ref = pp.paged_flash_prefill_plain(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert _close(o, o_ref)
    assert float(o[1, :, 41:].abs().max()) == 0.0        # rows past tail_len


def test_paged_prefill_empty_table(cuda):
    q, kp, vp, _, kt, vt, _, tlen = _prefill_inputs(np.random.default_rng(11), cuda,
                                                    torch.float32, 8, 2)
    table = torch.zeros((2, 0), dtype=torch.int32, device=cuda)
    plen = torch.zeros((2,), dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, kt, vt, plen, tlen)
    o = pp.paged_flash_prefill(*args)
    torch.cuda.synchronize()
    assert _err(o, pp.paged_flash_prefill_plain(*args)) < F32_TOL


# -- K3 / K4 -------------------------------------------------------------------


def _decode_inputs(rng, dev, dt, hq, hkv, d=128, ps=16, mp=20, b=5):
    num_pages = 1 + b * mp
    q = _randn(rng, (b, hq, d), dev, dt)
    kp, vp = (_randn(rng, (hkv, num_pages, ps, d), dev, dt) for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).reshape(b, mp)
                             .astype(np.int32)).to(dev)
    lengths = torch.tensor([0, 1, 50, 17, mp * ps], dtype=torch.int32, device=dev)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("num_splits", [1, 2, 7])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_decode_matches_plain(cuda, num_splits, dtype, hq, hkv, window, softcap):
    """Length-0 rows give exact zeros; rows of 1 and 17 tokens leave most
    splits empty, so the combine sees (0, -1e30, 0) states."""
    dt = DTYPES[dtype]
    args = _decode_inputs(np.random.default_rng(20 + num_splits), cuda, dt, hq, hkv)
    o = pd.paged_flash_decode(*args, num_splits=num_splits, window=window, softcap=softcap)
    o_ref = pd.paged_flash_decode_plain(*args, num_splits=num_splits, window=window,
                                        softcap=softcap)
    torch.cuda.synchronize()
    assert _close(o, o_ref)
    assert float(o[0].float().abs().max()) == 0.0


def test_launch_counts_count_kernel_launches_only(cuda):
    rng = np.random.default_rng(30)
    args = _decode_inputs(rng, cuda, torch.bfloat16, 8, 2)
    kernels.reset_launch_counts()
    pd.paged_flash_decode_plain(*args, num_splits=3)
    pd.paged_flash_decode(*args, num_splits=1)
    pd.paged_flash_decode(*args, num_splits=3)
    pd.paged_flash_decode(*args, num_splits=3)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["paged_flash_decode"] == 1 and counts["paged_flash_decode_split"] == 2
    assert counts["flash_attention_fwd"] == 0 and counts["paged_flash_prefill"] == 0


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(31)
    q, kp, vp, table, lengths = _decode_inputs(rng, cuda, torch.float32, 8, 2)
    with pytest.raises(ValueError):                       # int64 lengths
        pd.paged_flash_decode(q, kp, vp, table, lengths.long())
    with pytest.raises(ValueError):                       # float16
        pd.paged_flash_decode(q.half(), kp.half(), vp.half(), table, lengths)
    with pytest.raises(ValueError):                       # lengths on the CPU
        pd.paged_flash_decode(q, kp, vp, table, lengths.cpu())
    with pytest.raises(NotImplementedError):              # quantized pools
        pd.paged_flash_decode(q, kp, vp, table, lengths, k_scales=torch.ones(2, 101),
                              v_scales=torch.ones(2, 101))
    x = _randn(rng, (1, 4, 64, 32), cuda)
    with pytest.raises(ValueError):                       # head_dim 32
        fa.flash_attention_fwd(x, x, x)
    y = _randn(rng, (1, 4, 64, 128), cuda).transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):                       # not contiguous
        fa.flash_attention_fwd(y, y, y)


# -- the engine on the kernels -------------------------------------------------


def test_engine_on_kernels_matches_engine_on_plain_versions(cuda):
    """SMOKE widened to head_dim 64 (the kernels take 64 and 128), float32:
    the kernel engine gives the plain engine's greedy ids, with prefix
    sharing, and goes through K1, K2 and the decode kernels."""
    cfg = dataclasses.replace(llama3_8b.SMOKE, head_dim=64)
    params = transformer.init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(40)
    system = rng.integers(1, cfg.vocab, size=(48,))
    prompts = [np.concatenate([system, rng.integers(1, cfg.vocab, size=(n,))])
               for n in (5, 30, 12)]
    kw = dict(num_pages=64, page_size=16, max_batch=3, max_pages_per_seq=10,
              prompt_buckets=(16, 32, 64, 128), device=cuda)
    tokens = {}
    for impl in ("auto", "plain"):
        eng = LLMEngine(dataclasses.replace(cfg, attn_impl=impl), params, **kw)
        kernels.reset_launch_counts()
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=12)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tokens[impl] = {o.uid: [int(t) for t in o.tokens] for o in out}
        eng.close()
        if impl == "auto":
            assert counts["flash_attention_fwd"] > 0 and counts["paged_flash_prefill"] > 0
            assert counts["paged_flash_decode"] + counts["paged_flash_decode_split"] > 0
        else:
            assert sum(counts.values()) == 0
    assert tokens["auto"] == tokens["plain"]
