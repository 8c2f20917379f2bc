"""The port's fused multi-step decode (``steps_per_sync=N`` and ``"auto"``)
against the port at N = 1 and against the JAX engine's fused scan, on the
CPU, llama3-8b SMOKE (hymba-1.5b and mamba2-1.3b SMOKE for the dense SSM
paths) with the JAX weights carried across by ``transformer.from_jax_params``.

Mirrors ``tests/test_fused_decode.py``: N ticks per sync give the tokens of
N one-tick syncs in both KV layouts (greedy rows, a seeded stochastic row,
a row whose ``max_tokens`` is below N); greedy ids equal the JAX engine's at
the same N, with stops mid-scan and preemption under page pressure;
``decode_traces`` is flat after warmup; reserve and trim leak no page; the
caches are never rebound; and the batched sampler keeps its properties as
tensors, its draw a function of (seed, stream position) only. On the CPU
the tick function runs eagerly; on the card the same function is a captured
CUDA graph (``tests/test_torch_cuda.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import hymba_1_5b as jax_hymba
from repro.configs import llama3_8b as jax_llama
from repro.configs import mamba2_1_3b as jax_mamba
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling

from repro_torch.cache.pool import OutOfPages, PagePool
from repro_torch.configs import hymba_1_5b, llama3_8b, mamba2_1_3b
from repro_torch.core import perf_model
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams
from repro_torch.serving import sampling


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(cfg_j, cfg):
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), cfg_j)
    return jparams, transformer.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                                device="cpu")


@pytest.fixture(scope="module")
def llama():
    return _carry(jax_llama.SMOKE, llama3_8b.SMOKE)


LAYOUTS = {
    "dense": dict(kv_layout="dense", max_batch=3, cache_len=256, prompt_buckets=(32, 64)),
    "paged": dict(kv_layout="paged", max_batch=3, num_pages=96, page_size=16,
                  max_pages_per_seq=8, prompt_buckets=(16, 32, 64)),
}


def toks_of(out):
    return [int(t) for t in out.tokens]


def port_run(params, reqs, n, kw, cfg=llama3_8b.SMOKE):
    eng = LLMEngine(cfg, params, steps_per_sync=n, device="cpu", **kw)
    return eng, {o.uid: o for o in eng.generate(list(reqs))}


def jax_run(jparams, reqs, n, kw, cfg=jax_llama.SMOKE):
    eng = JaxEngine(cfg, jparams, steps_per_sync=n, **kw)
    return eng, {o.uid: o for o in eng.generate(reqs)}


def jax_req(r):
    sp = r.sampling
    return JaxRequest(uid=r.uid, prompt=np.asarray(r.prompt), priority=r.priority,
                      sampling=JaxSampling(temperature=sp.temperature, top_k=sp.top_k,
                                           top_p=sp.top_p, max_tokens=sp.max_tokens,
                                           stop_token_ids=sp.stop_token_ids,
                                           seed=sp.seed))


# -- (a) N ticks per sync == N one-tick syncs ----------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_equals_single_step_and_jax(llama, layout):
    """A sync of 8 ticks gives the tokens of 8 one-tick syncs: greedy rows,
    a seeded stochastic row, and a row whose max_tokens (3) is below N (its
    done mask parks it mid-sync). The greedy rows equal the JAX engine's
    fused scan at N = 8."""
    jparams, params = llama
    rng = np.random.default_rng(30)
    prompts = [rng.integers(1, 400, size=(n,)) for n in (8, 20, 33)]
    reqs = [
        Request(uid=0, prompt=prompts[0], max_new_tokens=9),
        Request(uid=1, prompt=prompts[1],
                sampling=SamplingParams(temperature=0.9, top_k=25, max_tokens=7, seed=3)),
        Request(uid=2, prompt=prompts[2], max_new_tokens=3),
    ]
    kw = LAYOUTS[layout]
    _, base = port_run(params, reqs, 1, kw)
    _, fused = port_run(params, reqs, 8, kw)
    _, jax_out = jax_run(jparams, [jax_req(r) for r in reqs], 8, kw)
    assert sorted(fused) == [0, 1, 2]
    for uid in (0, 1, 2):
        assert toks_of(fused[uid]) == toks_of(base[uid]), (layout, uid)
        assert fused[uid].finish_reason == base[uid].finish_reason
    assert len(fused[1].tokens) == 7
    for uid in (0, 2):
        assert toks_of(fused[uid]) == toks_of(jax_out[uid]), (layout, uid)
        assert fused[uid].finish_reason == jax_out[uid].finish_reason == "length"


# -- (b) stop tokens inside a sync ----------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_stop_token_mid_scan_matches_jax(llama, layout):
    """A stop token sampled at tick i < N ends the row inside the sync, the
    stop token recorded; a fed stop token (the first generated one) ends it
    at once. Ids and finish_reason equal the JAX engine's at N = 8."""
    jparams, params = llama
    prompt = np.random.default_rng(31).integers(1, 400, size=(12,))
    kw = dict(LAYOUTS[layout], max_batch=1)
    _, free = port_run(params, [Request(uid=0, prompt=prompt, max_new_tokens=8)], 8, kw)
    ref = toks_of(free[0])
    i = next(k for k in range(1, 8) if ref[k] not in ref[:k])
    for uid, stop, want in ((1, ref[i], ref[: i + 1]), (2, ref[0], ref[:1])):
        req = Request(uid=uid, prompt=prompt, max_new_tokens=8, eos_id=int(stop))
        _, out = port_run(params, [req], 8, kw)
        _, jout = jax_run(jparams, [jax_req(req)], 8, kw)
        assert toks_of(out[uid]) == want == toks_of(jout[uid]), (layout, uid)
        assert out[uid].finish_reason == jout[uid].finish_reason == "stop"


# -- (c) preemption under page pressure ------------------------------------------


def test_fused_matches_jax_across_preemption(llama):
    """Reserving a sync's pages preempts the lowest-priority row; it resumes
    by replay, and every output still equals the JAX engine's at N = 4."""
    jparams, params = llama
    rng = np.random.default_rng(32)
    prompts = [rng.integers(1, 400, size=(20,)) for _ in range(3)]
    kw = dict(kv_layout="paged", num_pages=12, page_size=16, max_batch=3,
              max_pages_per_seq=4, prompt_buckets=(16, 32))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=30, priority=i)
            for i, p in enumerate(prompts)]
    eng, out = port_run(params, reqs, 4, kw)
    _, jout = jax_run(jparams, [jax_req(r) for r in reqs], 4, kw)
    assert sorted(out) == [0, 1, 2]
    stats = eng.stats()
    assert stats.preemptions >= 1 and stats.resumed_tokens > 0
    for uid in range(3):
        assert toks_of(out[uid]) == toks_of(jout[uid]), uid
    assert eng.backend.check_leaks() == {}


# -- (d) no program rebuilt after warmup -------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_traces_flat_after_warmup(llama, layout):
    """Programs are keyed (N, stop width): after the first wave builds them,
    later waves of the same shape build none."""
    _, params = llama
    eng = LLMEngine(llama3_8b.SMOKE, params, steps_per_sync=4, device="cpu",
                    **dict(LAYOUTS[layout], max_batch=2))
    rng = np.random.default_rng(33)

    def wave(uid0):
        return [Request(uid=uid0 + i, prompt=rng.integers(1, 400, size=(8 + i,)),
                        max_new_tokens=6) for i in range(2)]

    eng.generate(wave(0))
    warm = eng.backend.stats["decode_traces"]
    assert warm >= 1
    for k in (10, 20, 30):
        eng.generate(wave(k))
        assert eng.backend.stats["decode_traces"] == warm


# -- (e) page accounting -----------------------------------------------------------


def test_fused_page_accounting_zero_leak(llama):
    """Reserve then trim over a whole run with shared prefixes and early
    stops: no page leaks after any sync, and none after close()."""
    _, params = llama
    rng = np.random.default_rng(34)
    system = rng.integers(1, 400, size=(32,))
    eng = LLMEngine(llama3_8b.SMOKE, params, kv_layout="paged", num_pages=64,
                    page_size=16, max_batch=3, max_pages_per_seq=8,
                    prompt_buckets=(16, 64), steps_per_sync=8, device="cpu")
    for i in range(3):
        tail = rng.integers(1, 400, size=(6 + i,))
        eng.add_request(Request(uid=i, prompt=np.concatenate([system, tail]),
                                max_new_tokens=5 + i))
    done = []
    while eng.backend.active.any() or eng.scheduler.has_work():
        done += [o for o in eng.step() if o.finished]
        assert eng.backend.check_leaks() == {}
    assert sorted(o.uid for o in done) == [0, 1, 2]
    eng.close()
    assert eng.backend.pool.used_pages == 0
    assert eng.backend.pool.check_leaks() == {}


# -- (f) streaming ------------------------------------------------------------------


def test_step_streams_the_jax_increments(llama):
    """Each step() at N = 4 streams the increments the JAX engine's step()
    streams: one output per request per sync, the same new tokens."""
    jparams, params = llama
    rng = np.random.default_rng(35)
    reqs = [Request(uid=i, prompt=rng.integers(1, 400, size=(10 + 7 * i,)),
                    max_new_tokens=5 + 4 * i) for i in range(3)]
    kw = LAYOUTS["paged"]
    engines = (LLMEngine(llama3_8b.SMOKE, params, steps_per_sync=4, device="cpu", **kw),
               JaxEngine(jax_llama.SMOKE, jparams, steps_per_sync=4, **kw))
    streams = []
    for eng, wrap in zip(engines, (lambda r: r, jax_req)):
        for r in reqs:
            eng.add_request(wrap(r))
        steps = []
        while eng.backend.active.any() or eng.scheduler.has_work():
            steps.append(sorted((o.uid, [int(t) for t in o.new_tokens], o.finished,
                                 o.finish_reason) for o in eng.step()))
        streams.append(steps)
    assert streams[0] == streams[1]
    assert len(streams[0]) >= 3


# -- (g) "auto" ---------------------------------------------------------------------


def test_auto_steps_follow_the_chooser_and_keep_the_ids(llama):
    """"auto" re-picks N before each admission: 1 until a sync has been
    measured, then ``perf_model.choose_steps_per_sync`` of the last sync's
    measured tick, a power of two <= 32; the ids equal N = 1's."""
    _, params = llama
    rng = np.random.default_rng(36)
    reqs = [Request(uid=i, prompt=rng.integers(1, 400, size=(9 + 5 * i,)),
                    max_new_tokens=12) for i in range(3)]
    kw = LAYOUTS["paged"]
    _, base = port_run(params, reqs, 1, kw)
    eng = LLMEngine(llama3_8b.SMOKE, params, steps_per_sync="auto", device="cpu", **kw)
    for r in reqs:
        eng.add_request(r)
    out, ticks = {}, []
    while eng.backend.active.any() or eng.scheduler.has_work():
        tick = eng.backend.decode_tick_s
        ticks.append(tick)
        want = 1 if tick is None else perf_model.choose_steps_per_sync(decode_tick_s=tick)
        out.update({o.uid: o for o in eng.step() if o.finished})
        assert eng.steps_per_sync == want == eng.stats().steps_per_sync
        assert want & (want - 1) == 0 and 1 <= want <= perf_model.MAX_STEPS_PER_SYNC
    assert ticks[0] is None and all(t > 0 for t in ticks[1:])
    assert {u: toks_of(o) for u, o in out.items()} == {u: toks_of(o) for u, o in base.items()}


def test_steps_chooser_amortizes_the_measured_host_sync():
    """The JAX package's rule over the measured host-sync cost h: the
    smallest power of two N with h / N <= 10% of the tick, capped at 32."""
    from types import SimpleNamespace

    from repro_torch.serving.scheduler import Scheduler

    h = perf_model.HOST_SYNC_OVERHEAD_S
    choose = perf_model.choose_steps_per_sync
    assert choose(decode_tick_s=1.0) == choose(decode_tick_s=20 * h) == 1
    assert choose(decode_tick_s=4 * h) == 4
    assert choose(decode_tick_s=h / 100) == choose(decode_tick_s=0.0) == 32
    assert perf_model.amortized_host_overhead(4) == h / 4
    sched = Scheduler()
    assert sched.choose_steps_per_sync(SimpleNamespace(decode_tick_s=None)) == 1
    assert sched.choose_steps_per_sync(SimpleNamespace(decode_tick_s=4 * h)) == 4


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_close_frees_the_programs_and_a_dropped_engine(llama, layout):
    """close() drops the fused decode's programs, input buffers and last
    logits; nothing refers back to the engine, so dropping it frees the
    backend (and its caches) without a garbage collection."""
    import gc
    import weakref

    _, params = llama
    eng = LLMEngine(llama3_8b.SMOKE, params, steps_per_sync=4, device="cpu",
                    **LAYOUTS[layout])
    eng.generate([Request(uid=0, prompt=np.arange(1, 12), max_new_tokens=5)])
    b = eng.backend
    assert b._programs and b._inputs is not None and b.last_logits is not None
    eng.close()
    assert b._programs == {} and b._inputs is None and b.last_logits is None
    gone = weakref.ref(b)
    was = gc.isenabled()
    gc.disable()
    try:
        del eng, b
        assert gone() is None
    finally:
        if was:
            gc.enable()


def test_steps_per_sync_is_validated(llama):
    _, params = llama
    for bad in (0, -2, "fast", 2.0):
        with pytest.raises(ValueError, match="steps_per_sync"):
            LLMEngine(llama3_8b.SMOKE, params, steps_per_sync=bad, device="cpu")
    eng = LLMEngine(llama3_8b.SMOKE, params, steps_per_sync=4, device="cpu")
    with pytest.raises(ValueError, match="max_steps"):
        eng.step(max_steps=0)


def test_serve_launcher_takes_steps_per_sync(capsys):
    from repro_torch.launch import serve

    for flag in ("4", "auto"):
        serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--requests", "3",
                    "--slots", "2", "--max-new-tokens", "6", "--prompt-len", "16",
                    "--steps-per-sync", flag])
        out = capsys.readouterr().out
        assert out.count("finish=length") == 3 and "3 done" in out
    assert "steps per sync" in out


# -- (h) SSM and hybrid stacks, dense ------------------------------------------------


@pytest.mark.parametrize("arch", ["hymba", "mamba2"])
def test_ssm_stacks_fused_equal_single_step(arch):
    """hymba-1.5b and mamba2-1.3b SMOKE: N = 4 gives N = 1's ids; a frozen
    row's SSM state advancing inside the sync touches no live row."""
    cfg_j, cfg = {"hymba": (jax_hymba.SMOKE, hymba_1_5b.SMOKE),
                  "mamba2": (jax_mamba.SMOKE, mamba2_1_3b.SMOKE)}[arch]
    _, params = _carry(cfg_j, cfg)
    rng = np.random.default_rng(37)
    reqs = [Request(uid=i, prompt=rng.integers(1, 500, size=(n,)), max_new_tokens=m)
            for i, (n, m) in enumerate(((12, 9), (30, 3), (7, 6)))]
    kw = dict(max_batch=2, cache_len=128, prompt_buckets=(32,))
    eng1, base = port_run(params, reqs, 1, kw, cfg=cfg)
    eng4, fused = port_run(params, reqs, 4, kw, cfg=cfg)
    assert eng4.kv_layout == eng1.kv_layout == "dense"
    assert {u: toks_of(o) for u, o in fused.items()} == {u: toks_of(o) for u, o in base.items()}


# -- (i) caches written in place ---------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_sync_never_rebinds_a_cache(llama, layout):
    """A captured graph keeps the addresses it saw: every cache leaf keeps
    its data_ptr across fused syncs and prefills."""
    _, params = llama
    eng = LLMEngine(llama3_8b.SMOKE, params, steps_per_sync=4, device="cpu",
                    **LAYOUTS[layout])
    ptrs = [(id(t), t.data_ptr()) for c in eng.backend.caches for t in c.values()]
    rng = np.random.default_rng(38)
    eng.generate([Request(uid=i, prompt=rng.integers(1, 400, size=(10 + i,)),
                          max_new_tokens=6) for i in range(3)])
    assert [(id(t), t.data_ptr()) for c in eng.backend.caches for t in c.values()] == ptrs


# -- (j) the pool's reserve and trim -------------------------------------------------------


def test_pool_reserve_and_trim_tokens():
    pool = PagePool(num_pages=8, page_size=4)
    seq = pool.allocate_sequence(5)
    cows = pool.reserve_tokens(seq, 6)
    assert cows == []
    assert seq.length == 11 and len(seq.pages) == 3
    assert pool.trim_tokens(seq, 6) == 1
    assert seq.length == 6 and len(seq.pages) == 2
    with pytest.raises(ValueError):
        pool.trim_tokens(seq, 7)
    pool.release(seq)
    assert pool.check_leaks() == {}


def test_pool_reserve_tokens_cow_on_shared_tail():
    """Reserving into a fork's shared partial tail gives the (src, dst) copy
    a single-step append would."""
    pool = PagePool(num_pages=8, page_size=4)
    seq = pool.allocate_sequence(6)
    fork = pool.fork(seq)
    cows = pool.reserve_tokens(fork, 2)
    assert len(cows) == 1
    src, dst = cows[0]
    assert src == seq.pages[-1] and dst == fork.pages[-1] and src != dst
    assert seq.length == 6 and fork.length == 8
    pool.release(fork)
    pool.release(seq)
    assert pool.check_leaks() == {}


def test_pool_reserve_tokens_partial_progress_on_exhaustion():
    """OutOfPages mid-reservation keeps the growth so far."""
    pool = PagePool(num_pages=4, page_size=4)
    seq = pool.allocate_sequence(4)
    cows = []
    with pytest.raises(OutOfPages):
        pool.reserve_tokens(seq, 12, cows)
    assert seq.length == 12 and len(seq.pages) == 3
    assert cows == []
    assert pool.trim_tokens(seq, 4) == 2
    pool.release(seq)
    assert pool.check_leaks() == {}


# -- (k) the batched sampler ---------------------------------------------------------------


def _cols(b, temperature=0.0, top_k=0, top_p=1.0, seed=0, pos=0):
    def col(v, dtype):
        return torch.as_tensor(v if isinstance(v, list) else [v] * b, dtype=dtype)

    return (col(temperature, torch.float32), col(top_k, torch.int64),
            col(top_p, torch.float32), col(seed, torch.int64), col(pos, torch.int64))


def test_batched_sampler_keeps_the_sampling_rules():
    """As ``test_torch_pieces.py``'s list form: greedy rows are the exact
    argmax, top-k = 1 is greedy, top-p keeps the crossing token; a row's
    draw does not depend on its neighbours."""
    logits = torch.randn(5, 300, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sampling.sample_batch(logits, *_cols(5)), logits.argmax(-1))
    assert torch.equal(sampling.sample_batch(logits, *_cols(5, temperature=1.0, top_k=1,
                                                            seed=[1, 2, 3, 4, 5])),
                       logits.argmax(-1))
    peaked = torch.full((1, 10), -10.0)
    peaked[0, 3] = 10.0
    assert int(sampling.sample_batch(peaked, *_cols(1, temperature=1.0, top_p=0.5))[0]) == 3
    # top_p 0.6 over (0.5, 0.3, 0.2): 0.5 alone stays below, so 0.3 crosses
    # and is kept; 0.2 never is.
    probs = torch.log(torch.tensor([[0.5, 0.3, 0.2]]))
    draws = {int(sampling.sample_batch(probs, *_cols(1, temperature=1.0, top_p=0.6,
                                                     pos=p))[0]) for p in range(200)}
    assert draws == {0, 1}
    mixed = _cols(5, temperature=[0.0, 0.9, 0.0, 1.3, 0.7], top_k=[0, 40, 3, 0, 0],
                  top_p=[1.0, 1.0, 1.0, 0.9, 0.8], seed=[7, 8, 9, 10, 11], pos=[3, 4, 5, 6, 7])
    a = sampling.sample_batch(logits, *mixed)
    perm = [4, 2, 0, 3, 1]
    b = sampling.sample_batch(logits[perm], *(c[perm] for c in mixed))
    assert torch.equal(a[perm], b)
    for i in range(5):
        one = sampling.sample_batch(logits[i:i + 1], *(c[i:i + 1] for c in mixed))
        assert int(one[0]) == int(a[i])
    assert int(a[0]) == int(logits[0].argmax()) and int(a[2]) == int(logits[2].argmax())


def test_batched_sampler_draw_is_keyed_by_seed_and_position():
    """The draw is a function of (seed, stream position): repeated calls
    agree, another position or seed draws anew, and over many positions
    the draws follow the filtered softmax."""
    logits = torch.randn(1, 64, generator=torch.Generator().manual_seed(1))
    args = _cols(1, temperature=1.0, seed=5, pos=17)
    first = sampling.sample_batch(logits, *args)
    assert all(torch.equal(sampling.sample_batch(logits, *args), first) for _ in range(3))
    by_pos = {int(sampling.sample_batch(logits, *_cols(1, temperature=1.0, seed=5, pos=p))[0])
              for p in range(40)}
    by_seed = {int(sampling.sample_batch(logits, *_cols(1, temperature=1.0, seed=s, pos=17))[0])
               for s in range(40)}
    assert len(by_pos) > 5 and len(by_seed) > 5
    # Frequencies over 6000 positions against the probabilities: each
    # within 4 standard deviations.
    p = torch.tensor([0.5, 0.3, 0.15, 0.05])
    n = 6000
    rows = torch.log(p).expand(n, 4)
    draws = sampling.sample_batch(rows, *_cols(n, temperature=1.0, seed=11,
                                               pos=list(range(n))))
    freq = torch.bincount(draws, minlength=4).double() / n
    sd = torch.sqrt(p.double() * (1 - p.double()) / n)
    assert bool(((freq - p.double()).abs() < 4 * sd).all()), freq
    # The list form is this program.
    lst = sampling.sample_tokens(logits.expand(3, 64), [1.0] * 3, [0] * 3, [1.0] * 3,
                                 [5] * 3, [17, 18, 19])
    assert int(lst[0]) == int(first[0])
