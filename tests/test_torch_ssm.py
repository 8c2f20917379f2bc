"""The port's Mamba-2 path against the JAX package, on the CPU.

K9's module (``kernels.ssd``: ``ssd_intra_chunk`` runs its plain version on
CPU tensors; ``ssd_chunked_cuda`` is the scan around it) and the plain
``models.ssm.ssd_chunked`` against ``repro.kernels.ssd`` in interpret mode
over ``tests/test_ssd_kernel.py``'s sweep, the initial-state hand-off and
the recurrent oracle; then the hymba and mamba2 SMOKE stacks (prefill and
dense decode logits) with the JAX weights carried across, and the padded
prefill that must equal the JAX package's *unpadded* prefill and decode.

Bars: 1e-3 absolute on scan outputs of magnitude 50-250, the bar
``tests/test_ssd_kernel.py`` holds the Pallas kernel to against the jnp
oracle (float32 sums in another order; about 1e-5 relative); 2e-3 against
the recurrent oracle as there; 1e-4 on SMOKE logits (float32 end to end,
logits O(1)), as ``tests/test_torch_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hymba_1_5b as jax_hymba
from repro.configs import mamba2_1_3b as jax_mamba
from repro.kernels import ssd as jax_ssd
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf

from repro_torch.configs import hymba_1_5b, mamba2_1_3b
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ssd
from repro_torch.models import ssm, transformer

SCAN_TOL = 1e-3
RECURRENT_TOL = 2e-3
LOGIT_TOL = 1e-4
CONFIGS = {"hymba": (jax_hymba.SMOKE, hymba_1_5b.SMOKE),
           "mamba2": (jax_mamba.SMOKE, mamba2_1_3b.SMOKE)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal((h,)) * 0.5)).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    arrays = (x, dt, a, bm, cm)
    return [jnp.asarray(v) for v in arrays], [torch.from_numpy(v) for v in arrays]


def _diff(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


SWEEP = [
    (1, 256, 2, 64, 1, 128, 128),   # mamba2-1.3b-like tile
    (2, 256, 4, 64, 2, 16, 128),    # hymba-like (small state)
    (1, 384, 2, 128, 2, 128, 128),  # wider head
    (1, 200, 2, 64, 1, 128, 128),   # padding path (l % chunk != 0)
]


@pytest.mark.parametrize("route", ["plain", "kernel_module"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SWEEP)
def test_ssd_matches_jax_pallas(route, b, l, h, p, g, n, chunk):
    jx, tx = _scan_inputs(b, l, h, p, g, n)
    yj, hj = jax_ssd.ssd_chunked_pallas(*jx, chunk, interpret=True)
    fn = ssm.ssd_chunked if route == "plain" else ssd.ssd_chunked_cuda
    yt, ht = fn(*tx, chunk)
    assert _diff(yj, yt) < SCAN_TOL
    assert _diff(hj, ht) < SCAN_TOL


@pytest.mark.parametrize("n,p,q", [(16, 64, 64), (128, 64, 32)])
def test_intra_chunk_block_matches_jax(n, p, q):
    """K9's own function: the plain version against the Pallas kernel."""
    rng = np.random.default_rng(1)
    b, nc, h = 1, 2, 3
    xdt = rng.standard_normal((b, nc, h, q, p)).astype(np.float32)
    bh = rng.standard_normal((b, nc, h, q, n)).astype(np.float32)
    ch = rng.standard_normal((b, nc, h, q, n)).astype(np.float32)
    acum = np.cumsum(-np.log1p(np.exp(rng.standard_normal((b, nc, h, q)))), -1).astype(
        np.float32)
    args = (xdt, bh, ch, acum)
    yj, sj = jax_ssd.ssd_intra_chunk(*[jnp.asarray(a) for a in args], interpret=True)
    yt, st = ssd.ssd_intra_chunk(*[torch.from_numpy(a) for a in args])
    assert _diff(yj, yt) < SCAN_TOL
    assert _diff(sj, st) < SCAN_TOL


@pytest.mark.parametrize("route", ["plain", "kernel_module"])
def test_initial_state_handoff(route):
    jx, tx = _scan_inputs(1, 256, 2, 64, 1, 32, seed=4)
    fn = ssm.ssd_chunked if route == "plain" else ssd.ssd_chunked_cuda
    y_full, h_full = fn(*tx, 128)
    x, dt, a, bm, cm = tx
    y1, h1 = fn(x[:, :128], dt[:, :128], a, bm[:, :128], cm[:, :128], 128)
    y2, h2 = fn(x[:, 128:], dt[:, 128:], a, bm[:, 128:], cm[:, 128:], 128, h0=h1)
    yj, hj = jax_ssd.ssd_chunked_pallas(*jx, 128, interpret=True)
    assert _diff(yj, torch.cat([y1, y2], 1)) < SCAN_TOL
    assert _diff(hj, h2) < SCAN_TOL
    assert float((h2 - h_full).abs().max()) < SCAN_TOL


def test_recurrent_oracle_matches_jax_and_the_scan():
    jx, tx = _scan_inputs(1, 256, 2, 64, 1, 32, seed=3)
    yj, hj = jax_ssm.ssd_recurrent_ref(*jx)
    yt, ht = ssm.ssd_recurrent_ref(*tx)
    assert _diff(yj, yt) < RECURRENT_TOL and _diff(hj, ht) < RECURRENT_TOL
    yc, hc = ssm.ssd_chunked(*tx, 128)
    assert float((yc - yt).abs().max()) < RECURRENT_TOL
    assert float((hc - ht).abs().max()) < RECURRENT_TOL


def test_ssm_impl_dispatch():
    cfg = mamba2_1_3b.SMOKE.ssm
    x = torch.zeros(1)
    assert ssm._ssd(cfg, x) is ssm.ssd_chunked
    with pytest.raises(ValueError, match="CUDA"):
        ssm._ssd(type(cfg)(impl="cuda"), x)
    with pytest.raises(ValueError, match="impl"):
        ssm._ssd(type(cfg)(impl="pallas"), x)


# -- the hymba and mamba2 stacks ----------------------------------------------------


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (cfg_j, cfg) in CONFIGS.items():
        jparams = jax_tf.init_model(jax.random.PRNGKey(0), cfg_j)
        params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                             device="cpu")
        out[name] = (cfg_j, cfg, jparams, params)
    return out


def _to_slots(cfg, caches, cache_len):
    """Prefill caches (one row) in dense slots of ``cache_len``."""
    slots = transformer.init_caches(cfg, 1, cache_len, "cpu")
    for dst, src in zip(slots, caches):
        for key, val in src.items():
            if key in ("k", "v"):
                dst[key][:, :, :val.shape[2]] = val
            else:
                dst[key].copy_(val)
    return slots


def _greedy_pair(models, name, prompt, pad_to=None, steps=4, cache_len=64):
    """JAX unpadded prefill + decode against the port's prefill (right-padded
    to ``pad_to`` when given) + dense decode; yields logit pairs."""
    cfg_j, cfg, jparams, params = models[name]
    n = len(prompt)
    lj, cj = jax_tf.prefill(jparams, cfg_j, jnp.asarray(prompt[None]), cache_len=cache_len)
    tokens = np.zeros((1, pad_to or n), np.int64)
    tokens[0, :n] = prompt
    lt, ct = transformer.prefill(params, cfg, torch.from_numpy(tokens), cache_len=pad_to or n,
                                 last_positions=torch.tensor([n - 1]))
    yield lj, lt
    slots = _to_slots(cfg, ct, cache_len)
    lengths = np.array([n], np.int32)
    nxt = int(np.asarray(lj)[0].argmax())
    for _ in range(steps):
        lengths = lengths + 1
        lj, cj = jax_tf.decode_step(jparams, cfg_j, jnp.asarray([nxt]), cj,
                                    jnp.asarray(lengths))
        lt, slots = transformer.decode_step(params, cfg, torch.tensor([nxt]), slots,
                                            torch.from_numpy(lengths.copy()))
        yield lj, lt
        nxt = int(np.asarray(lj)[0].argmax())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_dense_decode_match_jax(models, name):
    rng = np.random.default_rng(10)
    prompt = rng.integers(1, 500, size=(37,)).astype(np.int32)
    for lj, lt in _greedy_pair(models, name, prompt, steps=6):
        assert lt.shape == (1, models[name][1].vocab)
        assert _diff(lj, lt) < LOGIT_TOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_padded_prefill_equals_jax_unpadded(models, name):
    """A 20-token prompt right-padded to a 32-token bucket: the port's SSM
    state and conv history are the unpadded prompt's, so its first logits
    and every decode step equal the JAX package's *unpadded* prefill and
    decode. (The JAX engine's padded prefill takes them from the padded
    sequence: ROADMAP Queue C.)"""
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 500, size=(20,)).astype(np.int32)
    for lj, lt in _greedy_pair(models, name, prompt, pad_to=32):
        assert _diff(lj, lt) < LOGIT_TOL


def test_this_input_exposes_the_padding_fault_of_the_reference(models):
    """The case above discriminates: on hymba SMOKE the JAX package's own
    padded prefill (as its dense engine runs it) gives a first decode step
    far from its unpadded one, which the port matches."""
    cfg_j, cfg, jparams, params = models["hymba"]
    prompt = np.random.default_rng(0).integers(1, 500, size=(20,)).astype(np.int32)
    padded = np.zeros((1, 32), np.int32)
    padded[0, :20] = prompt
    steps = []
    for toks, last in ((prompt[None], None), (padded, jnp.asarray([19]))):
        lg, c = jax_tf.prefill(jparams, cfg_j, jnp.asarray(toks), cache_len=64,
                               last_positions=last)
        nxt = int(np.asarray(lg)[0].argmax())
        lg, _ = jax_tf.decode_step(jparams, cfg_j, jnp.asarray([nxt]), c,
                                   jnp.asarray([21], jnp.int32))
        steps.append(np.asarray(lg))
    assert np.abs(steps[0] - steps[1]).max() > 0.1


def test_short_prompts_zero_fill_the_conv_history(models):
    """Prompts shorter than the conv width - 1: prefill (padded) equals
    feeding the prompt token by token from empty caches, the conv history
    zero-filled before position 0."""
    _, cfg, _, params = models["mamba2"]
    for n in (1, 2, 5):
        prompt = np.arange(3, 3 + n)
        tokens = np.zeros((1, 32), np.int64)
        tokens[0, :n] = prompt
        lp, cp = transformer.prefill(params, cfg, torch.from_numpy(tokens), cache_len=32,
                                     last_positions=torch.tensor([n - 1]))
        slots = transformer.init_caches(cfg, 1, 32, "cpu")
        for i, t in enumerate(prompt):
            ls, slots = transformer.decode_step(params, cfg, torch.tensor([int(t)]), slots,
                                                torch.tensor([i + 1], dtype=torch.int32))
        assert float((lp - ls).abs().max()) < LOGIT_TOL
        for a, b in zip(cp, slots):
            assert float((a["ssm"] - b["ssm"]).abs().max()) < LOGIT_TOL
            assert float((a["conv"] - b["conv"]).abs().max()) < LOGIT_TOL


def test_training_of_ssm_stacks_waits():
    """What an SSM stack's training waited for, an MoE FFN, is ported: a
    hybrid stack with MoE FFNs trains and returns its aux losses, and
    ``ffn="moe"`` without ``cfg.moe`` raises. The hybrid and Mamba-2 stacks
    are held to the JAX train step in ``tests/test_torch_training.py``, the
    MoE layer in ``tests/test_torch_moe.py``."""
    moe = dataclasses.replace(hymba_1_5b.SMOKE,
                              layer_pattern=(dataclasses.replace(
                                  hymba_1_5b.SMOKE.layer_pattern[0], ffn="moe"),))
    with pytest.raises(ValueError, match="cfg.moe"):
        transformer.init_model(moe, seed=0, device="cpu")
    moe = dataclasses.replace(moe, moe=MoEConfig(num_experts=4, top_k=2, d_ff=32))
    params = transformer.init_model(moe, seed=0, device="cpu", param_dtype=torch.float32)
    logits, aux = transformer.forward(params, moe, torch.arange(8)[None])
    assert logits.shape == (1, 8, moe.vocab) and torch.isfinite(logits).all()
    assert float(aux["moe_lb_loss"]) > 0 and float(aux["moe_z_loss"]) > 0


def test_init_model_matches_jax_tree_shapes(models):
    """``init_model`` draws the same leaves, with the same shapes, as the JAX
    tree carried across; the tied embedding stays float32 (it is the head)."""
    for name, (_, cfg, _, carried) in models.items():
        drawn = transformer.init_model(cfg, seed=0, device="cpu")
        assert "head" not in drawn and drawn["embed"].dtype == torch.float32
        for a, b in zip(drawn["layers"], carried["layers"]):
            assert a.keys() == b.keys(), name
            for key in a:
                if key == "mamba":
                    assert {k: v.shape for k, v in a[key].items()} == \
                        {k: v.shape for k, v in b[key].items()}
                else:
                    assert a[key].shape == b[key].shape, (name, key)
