"""K5/K6 (the FA2 backward) and the differentiable attention op of the
PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX Pallas backward
(``repro.kernels.flash_attention_bwd``, interpret mode, as
``tests/test_flash_attention.py`` runs it here) and through the port's
``flash_attention_bwd``, which on CPU tensors runs the kernels' plain
version. Bars are the JAX suite's backward bar, 5e-5 at float32
(``tests/test_flash_attention.py:88``), and 3e-2 at bfloat16
(``tests/test_flash_attention.py:61``).
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


def _jax_grads(q, k, v, do, order, dtype, flags):
    mc = JaxMapping(order=order, block_m=32, block_n=32)
    qj, kj, vj, doj = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    o, lse = jax_fwd(qj, kj, vj, mapping=mc, interpret=True, **flags)
    return jax_bwd(qj, kj, vj, o, lse, doj, mapping=mc, interpret=True, **flags)


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
