"""K3/K4's bf16 tensor-core arithmetic against the JAX package, on the CPU.

``paged_decode_tc_kernel`` (csrc/paged_decode.cu) runs no CPU mode, so its
arithmetic is written out in float32 (``tc_decode_emulation.paged_k3_k4``,
the walk K7/K8's emulation shares): 64-row stages from the page holding
the first visible position, positions before it masked, slots past the
last live page repeating it, P rounded to bf16 before P V, per-warp states
merged with exp2 weights, a split's (acc, m ln 2, l) through the
natural-unit combine. It is held against
``repro.kernels.paged_decode_attention.paged_flash_decode`` in interpret
mode on scattered page tables: per row within 2^-6 of the row's max |o|
(one bf16 ulp is 2^-7; the card's bar) and within the JAX suite's bf16 bar
of 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode_attention import paged_flash_decode as jax_decode
from tc_decode_emulation import ROW_TOL, paged_k3_k4, row_err

BF16_TOL = 3e-2
CAPACITY = 160    # table capacity in positions: 3 stages, 20 pages of 8 or 10 of 16
LENGTHS = [0, 1, 117, CAPACITY]   # empty, one token, a ragged last page, the full table


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(hq, hkv, d, ps, seed):
    """bf16 q and pools (Hkv, P, ps, D), a scattered page table of
    CAPACITY / ps pages a row (page 0 is the null page, never in a table)."""
    rng = np.random.default_rng(seed)
    b, mp = len(LENGTHS), CAPACITY // ps
    num_pages = 1 + b * mp
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, d), (hkv, num_pages, ps, d), (hkv, num_pages, ps, d))]
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, mp).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    jax_args = [jnp.asarray(a, jnp.bfloat16) for a in arrays] + [jnp.asarray(table),
                                                                 jnp.asarray(lengths)]
    torch_args = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays] + [
        torch.from_numpy(table), torch.from_numpy(lengths)]
    return jax_args, torch_args


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(25, 5), (32, 8), (32, 1)], ids=["g5", "g4", "g32"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 30.0)],
                         ids=["full", "window_softcap"])
def test_tensor_core_k3_k4_arithmetic_matches_jax(d, hq, hkv, ps, num_splits, window,
                                                   softcap):
    """Rows of 0, 1, 117 (a ragged last page) and 160 (the full table)
    tokens; with window 50 the first visible position (67 and 110) falls
    mid-page, so the first stage starts before it and masks the rows in
    between. Three splits put split starts inside a 64-row stage (20 pages
    of 8 split 7 + 7 + 6)."""
    jargs, targs = _inputs(hq, hkv, d, ps, seed=80 + d + ps)
    kw = dict(window=window, softcap=softcap, num_splits=num_splits)
    oj = jax_decode(*jargs, interpret=True, **kw)
    ot = paged_k3_k4(*targs, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0
    # Rows past each length inside its last live page change nothing: the
    # stages read them (and repeat that page into surplus slots), masked.
    q, kp, vp, table, lengths = targs
    kp2, vp2 = kp.clone(), vp.clone()
    big = torch.tensor(1e4, dtype=torch.bfloat16)
    for bi, length in enumerate(LENGTHS):
        if length % ps:
            page = int(table[bi, length // ps])
            kp2[:, page, length % ps:] = big
            vp2[:, page, length % ps:] = -big
    assert not torch.equal(kp, kp2)
    assert torch.equal(ot, paged_k3_k4(q, kp2, vp2, table, lengths, **kw))
