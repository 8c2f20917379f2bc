"""K5/K6 (the FA2 backward) and the differentiable attention op of the
PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX Pallas backward
(``repro.kernels.flash_attention_bwd``, interpret mode, as
``tests/test_flash_attention.py`` runs it here) and through the port's
``flash_attention_bwd``, which on CPU tensors runs the kernels' plain
version. Bars are the JAX suite's backward bar, 5e-5 at float32
(``tests/test_flash_attention.py:88``), and 3e-2 at bfloat16
(``tests/test_flash_attention.py:61``). The bf16 tensor-core kernels'
arithmetic, which no CPU can run, is written out in float32 and held
against the JAX kernels too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import BLOCK_FIRST as J_BLOCK_FIRST
from repro.kernels.flash_attention import HEAD_FIRST as J_HEAD_FIRST
from repro.kernels.flash_attention import MappingConfig as JaxMapping
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jax_bwd

from tc_decode_emulation import softcap_tanh

from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops

F32_TOL = 5e-5
BF16_TOL = 3e-2
ORDERS = {"head_first": (J_HEAD_FIRST, fa.HEAD_FIRST),
          "block_first": (J_BLOCK_FIRST, fa.BLOCK_FIRST)}
FLAGS = {
    "causal": dict(causal=True, window=None, softcap=None),
    "window": dict(causal=True, window=24, softcap=None),
    "softcap": dict(causal=True, window=None, softcap=20.0),
    "noncausal_kvlen": dict(causal=False, window=None, softcap=None, kv_len=50),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and under
    pytest-xdist those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, hq, hkv, s=64, d=32, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))]


def _jax_fwd_bwd(q, k, v, do, order, dtype, flags, block=32):
    """The JAX forward's (o, lse) and the Pallas backward's (dq, dk, dv)."""
    mc = JaxMapping(order=order, block_m=block, block_n=block)
    qj, kj, vj, doj = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    o, lse = jax_fwd(qj, kj, vj, mapping=mc, interpret=True, **flags)
    return o, lse, jax_bwd(qj, kj, vj, o, lse, doj, mapping=mc, interpret=True, **flags)


def _jax_grads(q, k, v, do, order, dtype, flags):
    return _jax_fwd_bwd(q, k, v, do, order, dtype, flags)[2]


def _graph_names(fn, seen=None):
    """Names of every node of an autograd graph."""
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return set()
    seen.add(fn)
    names = {type(fn).__name__}
    for nxt, _ in fn.next_functions:
        names |= _graph_names(nxt, seen)
    return names


def _diff(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


HEADS = {"gqa": (4, 2), "mha": (2, 2)}
#: Every flag set under both orders with GQA, and the MHA layout under
#: both orders (the Pallas interpret mode costs seconds per case).
CASES = [(order, flags, "gqa") for order in sorted(ORDERS) for flags in sorted(FLAGS)] + [
    ("head_first", "softcap", "mha"), ("block_first", "noncausal_kvlen", "mha")]


@pytest.mark.parametrize("order,flags,heads", CASES)
def test_bwd_matches_jax_pallas(order, flags, heads):
    q, k, v, do = _inputs(0, *HEADS[heads])
    jorder, torder = ORDERS[order]
    kw = FLAGS[flags]
    want = _jax_grads(q, k, v, do, jorder, jnp.float32, kw)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, **kw)
    got = fb.flash_attention_bwd(qt, kt, vt, o, lse, dot,
                                 mapping=fa.MappingConfig(order=torder), **kw)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.shape == w.shape, name
        assert _diff(w, g) < F32_TOL, name


def test_bwd_matches_jax_pallas_bf16():
    q, k, v, do = _inputs(1, 4, 2)
    want = _jax_grads(q, k, v, do, J_HEAD_FIRST, jnp.bfloat16, FLAGS["softcap"])
    qt, kt, vt, dot = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, **FLAGS["softcap"])
    got = fb.flash_attention_bwd(qt, kt, vt, o, lse, dot, **FLAGS["softcap"])
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == torch.bfloat16, name
        assert _diff(w, g) < BF16_TOL, name


SLICE_TOL = 2.0**-6   # per (b, head) slice, against its max |g|: one bf16 ulp is 2^-7


def _k6_walk(nb, sq, group, causal, window, live, tile=64):
    """The (q head of the group, q tile) pairs K6's kv block nb walks at
    head dim 256, in its order: head by head, each head's q tiles upward
    from the diagonal's (causal), none for keys all past ``live``, none
    below the window's reach."""
    m_lo = nb if causal else 0
    m_hi = -(-sq // tile) if nb * tile < live else 0
    if window:
        m_hi = min(m_hi, (nb * tile + tile - 1 + window - 1) // tile + 1)
    return [(g, m) for g in range(group) for m in range(m_lo, m_hi)]


def _tensor_core_bwd(q, k, v, o, lse, do, *, causal, window=None, softcap=None,
                     kv_len=None, tile=64, round_out=True, parts=None):
    """The arithmetic of the bf16 tensor-core K5 / K6 (``fa2_bwd_dq_tc`` /
    ``fa2_bwd_dkv_tc`` in csrc/flash_attention_bwd.cu), written out in
    float32: products of bf16 inputs summed in float32; p recomputed as
    2^(s scale log2(e) - lse log2(e)) (with a softcap 2^(cap tanh(s scale /
    cap) log2(e) - lse log2(e))), 0 where masked or the row is fully masked;
    dS = (P f) (dP - delta) from P unrounded, f = 1 - tanh^2 with a softcap
    (1 without); P and dS rounded to bf16 before dS K, P^T dO and dS^T Q; dQ
    summed over 64-key tiles, dK / dV over each q head's 64-row q tiles and
    the GQA group, in float32; each output rounded to bf16 once (dQ and dK
    after the scale), or left in float32 with ``round_out=False``. At head
    dim 64 and 128 tanh is ``tanhf``; at 256 it is hopper.cuh's one ex2 and
    one rcp (``softcap_tanh``), and one warpgroup forms S and P, the other
    dP and dS, each summing its half of D's output columns: a split of
    independent columns, which changes no sum, so S, dP and the products
    over the 64-row tiles are the same as at the other head dims. With
    ``parts`` (head dim 256), each 64-row kv block's walk (``_k6_walk``) is
    cut into ranges of ceil(longest walk / parts) tiles: dK and dV summed in
    float32 over each range, the ranges then added in order, then one
    rounding."""
    log2e = 1.4426950408889634
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    live = skv if kv_len is None else min(skv, kv_len)
    scale = 1.0 / d**0.5
    qf, dof = q.float(), do.float()
    kf, vf = k.float().repeat_interleave(group, 1), v.float().repeat_interleave(group, 1)
    delta = (dof * o.float()).sum(-1)
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    nl = torch.where(lse > -1e30 / 2, -lse * log2e, torch.tensor(-float("inf")))[..., None]
    if softcap:
        if d == 256:
            th = softcap_tanh(s, scale, softcap)
        else:
            th = torch.tanh(s * torch.tensor(scale / softcap, dtype=torch.float32))
        p = torch.exp2(softcap * th * log2e + nl)
        factor = 1.0 - th * th
    else:
        p = torch.exp2(s * torch.tensor(scale * log2e, dtype=torch.float32) + nl)
        factor = 1.0
    rows, cols = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    ok = cols < live
    if causal:
        ok = ok & (cols <= rows)
    if window:
        ok = ok & (cols > rows - window)
    p = torch.where(ok, p, torch.tensor(0.0))
    ds = p * factor * (dp - delta[..., None])
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.zeros_like(qf)
    for c0 in range(0, skv, tile):
        dq += dsb[..., c0:c0 + tile] @ kf[:, :, c0:c0 + tile]
    pg, dsg = (x.reshape(b, hkv, group, sq, skv) for x in (pb, dsb))
    qg, dog = (x.reshape(b, hkv, group, sq, d) for x in (qf, dof))
    dk = torch.zeros((b, hkv, skv, d))
    dv = torch.zeros((b, hkv, skv, d))
    if parts is None:
        for g in range(group):
            for m0 in range(0, sq, tile):
                rows_ = slice(m0, m0 + tile)
                dv += pg[:, :, g, rows_].transpose(-1, -2) @ dog[:, :, g, rows_]
                dk += dsg[:, :, g, rows_].transpose(-1, -2) @ qg[:, :, g, rows_]
    else:
        walks = [_k6_walk(nb, sq, group, causal, window, live, tile)
                 for nb in range(-(-skv // tile))]
        chunk = max(1, -(-max(len(w) for w in walks) // parts))
        for nb, walk in enumerate(walks):
            cols_ = slice(nb * tile, nb * tile + tile)
            for p in range(max(1, -(-len(walk) // chunk))):
                part_k = torch.zeros_like(dk[:, :, cols_])
                part_v = torch.zeros_like(dv[:, :, cols_])
                for g, m in walk[p * chunk:(p + 1) * chunk]:
                    rows_ = slice(m * tile, m * tile + tile)
                    part_v += pg[:, :, g, rows_, cols_].transpose(-1, -2) @ dog[:, :, g, rows_]
                    part_k += dsg[:, :, g, rows_, cols_].transpose(-1, -2) @ qg[:, :, g, rows_]
                dk[:, :, cols_] += part_k
                dv[:, :, cols_] += part_v
    out = (scale * dq, scale * dk, dv)
    return tuple(x.to(torch.bfloat16) for x in out) if round_out else out


def _slice_err(j, t) -> float:
    """Max over (b, head) slices of max |t - j| / max |j| (an all-zero slice
    of j must be exactly zero in t)."""
    ref = torch.from_numpy(np.array(j, np.float32))
    diff = (t.float() - ref).abs().flatten(2).amax(-1)
    den = ref.abs().flatten(2).amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


TC_FLAGS = {"causal": dict(causal=True),
            "window_softcap": dict(causal=True, window=50, softcap=30.0),
            "noncausal_kvlen": dict(causal=False, kv_len=101)}
#: (head dim, (Hq, Hkv), flags, K6's parts): every flag set at Hq 8 over
#: Hkv 2, and gemma3-1b's group of 4 over one kv head at head dim 256, in
#: one part and with K6's walk in 2 and in 4 parts.
TC_CASES = [(d, (8, 2), f, None) for d in (64, 128, 256) for f in TC_FLAGS] + [
    (256, (4, 1), "window_softcap", None)] + [
    (256, (4, 1), f, parts) for f in ("causal", "window_softcap") for parts in (2, 4)]


@pytest.mark.parametrize("d,heads,flags,parts", TC_CASES,
                         ids=[f"{f}-{d}" + ("-group4-kv1" if h == (4, 1) else "")
                              + (f"-parts{n}" if n else "") for d, h, f, n in TC_CASES])
def test_tensor_core_k5_k6_arithmetic_matches_jax(d, heads, flags, parts):
    """Rounding P and dS to bf16 before their products, the tensor-core
    K5 / K6's one numerical departure from the JAX kernels (which keep both
    in float32), against the JAX Pallas backward. Hq 8 over Hkv 2, and at
    head dim 256 also gemma3-1b's group of 4 over one kv head, with K6's
    walk whole and cut into 2 and 4 parts (ranges that cross heads and
    split a head's q tiles); S 130 (two full 64-row tiles and a ragged one).

    * In bf16, as in training (the JAX forward's bf16 o and its lse, every
      output rounded to bf16 once): each (b, head) slice within 2^-6 of its
      max, the card's bar.
    * On the same bf16 values held in float32 (the JAX kernels' outputs and
      the written-out arithmetic before its final rounding): within the JAX
      suite's 3e-2 absolute bar. It is taken before the rounding that both
      sides share because one bf16 ulp of a gradient of 8 or more is
      0.0625: here dv reaches 9.4, and a difference of one rounding step
      there is not the departure under test.
    """
    kw = TC_FLAGS[flags]
    q, k, v, do = _inputs(80 + d + (heads != (8, 2)), *heads, s=130, d=d, b=1)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    for dtype, round_out in ((jnp.bfloat16, True), (jnp.float32, False)):
        vals = [x.float().numpy() for x in bf]
        o, lse, want = _jax_fwd_bwd(*vals, J_HEAD_FIRST, dtype, kw, block=256)
        ot = torch.from_numpy(np.array(o, np.float32))
        lt = torch.from_numpy(np.array(lse, np.float32))
        if round_out:
            ot = ot.to(torch.bfloat16)
        got = _tensor_core_bwd(bf[0], bf[1], bf[2], ot, lt, bf[3], round_out=round_out,
                               parts=parts, **kw)
        for name, w, g in zip(("dq", "dk", "dv"), want, got):
            assert g.shape == w.shape, name
            assert _slice_err(w, g) < SLICE_TOL, (name, dtype)
            if not round_out:
                assert _diff(w, g) < BF16_TOL, name
        if kw.get("kv_len"):            # keys past kv_len get no gradient
            assert float(got[1][:, :, 101:].abs().max()) == 0.0
            assert float(got[2][:, :, 101:].abs().max()) == 0.0


#: (Sq, Skv, group, kw) of K6's walks: causal and ragged, a window, keys
#: past kv_len without causality, more keys than queries.
K6_WALKS = [(130, 130, 4, dict(causal=True)), (700, 700, 4, dict(causal=True, window=100)),
            (130, 170, 2, dict(causal=False, kv_len=150)),
            (200, 330, 1, dict(causal=True, window=70))]


@pytest.mark.parametrize("sq,skv,group,kw", K6_WALKS)
@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
def test_k6_parts_cover_each_walk_once(sq, skv, group, kw, parts):
    """The wrapper's walks (``dkv_walks``) are the written-out ones
    (``_k6_walk``), and its parts cut each block's walk into at most
    ``parts`` consecutive ranges that cover it once."""
    window, kv_len = kw.get("window"), kw.get("kv_len")
    live = skv if kv_len is None else min(skv, kv_len)
    walks = fb.dkv_walks(sq, skv, group, causal=kw["causal"], window=window, kv_len=kv_len)
    assert walks == [len(_k6_walk(nb, sq, group, kw["causal"], window, live))
                     for nb in range(-(-skv // 64))]
    lengths = fb.dkv_part_walks(walks, parts)
    chunk = max(1, -(-max(walks) // parts))   # the kernel's: the longest walk over parts
    at = 0
    for n in walks:   # each block's parts are consecutive in launch order
        mine = lengths[at:at + max(1, -(-n // chunk))]
        at += len(mine)
        assert len(mine) <= parts and sum(mine) == n and all(0 <= m <= chunk for m in mine)
    assert at == len(lengths)


def test_k6_part_count_fills_the_card_only_where_one_does_not():
    """``dkv_parts`` on 132 SMs: one part at gemma2-2b's train microbatch
    (global and window 4096: 512 blocks) and gemma3-1b's window 512; at
    gemma3-1b's global layer (128 blocks, the longest walking 256 tiles
    against a mean of 130) more, so that the longest part walks at most
    1.3x the mean."""
    for b, hq, hkv, s, window in ((1, 8, 4, 8192, None), (1, 8, 4, 8192, 4096),
                                  (2, 4, 1, 4096, 512)):
        assert fb.dkv_parts(b, hq, hkv, s, s, window=window, sms=132) == 1
    parts = fb.dkv_parts(2, 4, 1, 4096, 4096, sms=132)
    lengths = fb.dkv_part_walks(fb.dkv_walks(4096, 4096, 4), parts)
    assert parts > 1 and max(lengths) <= 1.3 * sum(lengths) / len(lengths)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_bwd_plain_matches_autograd_of_forward(flags):
    """The plain backward against torch.autograd of the plain forward."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 4, 1, s=40, d=16))
    kw = FLAGS[flags]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention_fwd_plain(*leaves, **kw)
    (o * do).sum().backward()
    got = fb.flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do, **kw)
    for name, t, g in zip(("dq", "dk", "dv"), leaves, got):
        assert float((t.grad - g).abs().max()) < F32_TOL, name


def test_bwd_fully_masked_rows_give_zero_gradients():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 2, 2, s=32, d=16))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False, kv_len=0)
    dq, dk, dv = fb.flash_attention_bwd(q, k, v, o, lse, do, causal=False, kv_len=0)
    assert float(dq.abs().max()) == float(dk.abs().max()) == float(dv.abs().max()) == 0.0


def test_ops_flash_attention_grads_match_jax_custom_vjp():
    """The autograd Function on odd lengths that need padding, against the
    gradient of the JAX ``ops.flash_attention(impl="pallas")`` custom VJP."""
    q, k, v, do = _inputs(4, 4, 2, s=77, d=32, b=1)
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))

    def loss(q_, k_, v_):
        return jnp.sum(jax_ops.flash_attention(q_, k_, v_, causal=True, impl="pallas") * doj)

    want = jax.grad(loss, (0, 1, 2))(qj, kj, vj)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    assert out.shape == (1, 4, 77, 32)
    (out * torch.from_numpy(do)).sum().backward()
    for name, w, t in zip(("dq", "dk", "dv"), want, leaves):
        assert t.grad is not None and t.grad.shape == t.shape, name
        assert _diff(w, t.grad) < F32_TOL, name


def test_ops_flash_attention_gives_qkv_a_gradient_on_cpu():
    """The differentiable route: every input gets a gradient, through the
    autograd Function (its plain versions on the CPU), and the launch
    counters stay at zero because no kernel ran."""
    q, k, v, do = _inputs(5, 8, 2, s=50, d=16, b=2)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=True, window=17, softcap=30.0)
    assert "_FlashAttentionBackward" in _graph_names(out.grad_fn)
    (out * torch.from_numpy(do)).sum().backward()
    ref = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o_ref, _ = fa.flash_attention_fwd_plain(*ref, causal=True, window=17, softcap=30.0)
    (o_ref * torch.from_numpy(do)).sum().backward()
    for t, r in zip(leaves, ref):
        assert t.grad is not None and float((t.grad - r.grad).abs().max()) < F32_TOL
    assert sum(kernels.launch_counts().values()) == 0
    with torch.no_grad():
        plain = ops.flash_attention(*(t.detach() for t in leaves), causal=True,
                                    window=17, softcap=30.0)
    assert plain.grad_fn is None and float((plain - out.detach()).abs().max()) < 1e-6
