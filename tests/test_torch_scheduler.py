"""The port's scheduler against the JAX package's: model-driven admission
(the occupancy cap, the prefill-savings tie-break) over one pure-Python
fake backend, then ``LLMEngine`` against the JAX engine on
``llama3_8b.SMOKE`` (admission order and greedy ids), then
``PagedBackend.prefill_time_saved`` with a host-tier continuation at the
JAX package's link constants."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import llama3_8b as jax_llama
from repro.core import numa as jax_numa
from repro.core import perf_model as jax_pm
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving.scheduler import Scheduler as JaxScheduler

from repro_torch.configs import llama3_8b
from repro_torch.core import numa, perf_model
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams
from repro_torch.serving.scheduler import Scheduler, SchedulerStats

CFG = llama3_8b.SMOKE


@dataclasses.dataclass
class FakeRequest:
    uid: int
    priority: int
    n: int


class FakeBackend:
    """Rows and a page budget, no model: ``quote`` and
    ``prefill_time_saved`` read tables drawn per request, the decode time
    model is the one under test, and live lengths grow as rows decode."""

    def __init__(self, rows, num_pages, quotes, savings, model=None):
        self.rows = rows
        self.lengths = np.zeros(rows, np.int64)
        self.active = np.zeros(rows, bool)
        self.free = num_pages
        self.reserve_pages = 1
        self.evictable_pages = 0
        self._quotes, self._savings, self._model = quotes, savings, model
        self.held = {}

    @property
    def num_active(self):
        return int(self.active.sum())

    @property
    def free_pages(self):
        return self.free

    def quote(self, req):
        return self._quotes[req.uid]

    def prefill_time_saved(self, req):
        return self._savings[req.uid]

    def try_admit(self, req, resume_tokens=(), pending_hashes=()):
        rows = np.flatnonzero(~self.active)
        total, matched = self.quote(req)
        if not len(rows) or total - matched > self.free:
            return None
        row = int(rows[0])
        self.active[row] = True
        self.lengths[row] = req.n + len(resume_tokens)
        self.free -= total - matched
        self.held[row] = (req, total - matched)
        return {"req": req, "row": row}

    def release(self, row):
        req, pages = self.held.pop(row)
        self.active[row] = False
        self.free += pages
        return req


class ModelBackend(FakeBackend):
    def decode_time_model(self, batch, mean_len=None):
        return self._model(batch, mean_len)


class BatchOnlyBackend(FakeBackend):
    def decode_time_model(self, batch):
        return self._model(batch, None)


def knee(batch, mean_len):
    """Tokens/s rises until the batch covers the machine, then declines;
    the knee moves with the live context."""
    ctx = 256.0 if mean_len is None else mean_len
    return 1e-3 * (1 + ctx / 512) * max(1.0, batch * ctx / 1024) ** 1.5


def linear(batch, mean_len):
    return 2e-6 * batch


MODELS = {
    "knee": (ModelBackend, knee, None),
    "linear": (ModelBackend, linear, None),
    "batch-only knee": (BatchOnlyBackend, knee, None),
    "injected": (FakeBackend, None, lambda b: 1e-3 * max(1.0, b / 3) ** 1.5),
}


def _drive(sched_cls, case, seed, rounds=40):
    """One trace: arrivals with mixed priorities and shared-prefix savings,
    rows that finish, grow and get preempted (requeued). Returns the
    admitted uids of every round and the cap read after it."""
    backend_cls, model, injected = MODELS[case]
    rng = np.random.default_rng(seed)
    n_req = 60
    quotes = {u: (int(t), int(m)) for u, (t, m) in
              enumerate(zip(rng.integers(2, 9, n_req), rng.integers(0, 3, n_req)))}
    savings = {u: float(rng.choice([0.0, 0.0, 1e-4, 3e-4, 1e-3])) for u in range(n_req)}
    backend = backend_cls(rows=6, num_pages=30, quotes=quotes, savings=savings, model=model)
    sched = sched_cls(aging_rounds=3, decode_time_model=injected)
    uid, log = 0, []
    for _ in range(rounds):
        for _ in range(int(rng.integers(0, 3))):
            if uid < n_req:
                sched.add(FakeRequest(uid, int(rng.integers(0, 3)), int(rng.integers(64, 3000))))
                uid += 1
        records = sched.schedule(backend, [])
        log.append(([r["req"].uid for r in records], sched.occupancy_cap(backend)))
        live = np.flatnonzero(backend.active)
        backend.lengths[live] += rng.integers(1, 400, size=len(live))
        if len(live) and rng.random() < 0.4:
            backend.release(int(rng.choice(live)))
        live = np.flatnonzero(backend.active)
        if len(live) and rng.random() < 0.15:
            req = backend.release(int(rng.choice(live)))
            sched.requeue(req, [1, 2, 3])
    return log


@pytest.mark.parametrize("case", list(MODELS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_sequences_and_caps_match_jax(case, seed):
    mine, theirs = _drive(Scheduler, case, seed), _drive(JaxScheduler, case, seed)
    assert mine == theirs
    admitted = [u for uids, _ in mine for u in uids]
    assert len(admitted) > 10
    caps = {cap for _, cap in mine}
    if case == "linear":
        assert caps == {6}                     # a flat tokens/s curve never binds
    else:
        assert min(caps) < 6


def test_savings_break_ties_within_a_priority_class():
    quotes = {0: (2, 0), 1: (2, 0), 2: (2, 1), 3: (2, 0)}
    savings = {0: 0.0, 1: 0.0, 2: 5e-4, 3: 0.0}
    order = {}
    for cls in (Scheduler, JaxScheduler):
        backend = FakeBackend(rows=2, num_pages=20, quotes=quotes, savings=savings)
        sched = cls()
        for u, prio in ((0, 0), (1, 0), (2, 0), (3, 1)):
            sched.add(FakeRequest(u, prio, 100))
        order[cls] = [r["req"].uid for r in sched.schedule(backend, [])]
    assert order[Scheduler] == order[JaxScheduler] == [3, 2]


def test_stats_summary_shows_the_cap():
    assert "(cap 3)" in SchedulerStats(occupancy_cap=3).summary()


# -- the engines -------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams), CFG,
                                         device="cpu")
    return jparams, params


def _record_admissions(engine):
    order = []
    admit = engine.backend.try_admit

    def recorded(req, *a, **kw):
        rec = admit(req, *a, **kw)
        if isinstance(rec, dict):
            order.append(req.uid)
        return rec

    engine.backend.try_admit = recorded
    return order


def test_engine_admits_the_cached_prefix_first_like_jax(models):
    """Two rows. A warm-up request caches a 32-token system prefix; then
    five arrive at once: uids 1, 2 and 4 share nothing, 3 and 5 extend the
    cached prefix. Both engines must admit 3 and 5 before the earlier 1,
    and give every request the same greedy ids."""
    jparams, params = models
    rng = np.random.default_rng(7)
    system = rng.integers(1, CFG.vocab, size=(32,))
    warm = np.concatenate([system, rng.integers(1, CFG.vocab, size=(6,))])
    batch = {1: rng.integers(1, CFG.vocab, size=(20,)),
             2: rng.integers(1, CFG.vocab, size=(25,)),
             3: np.concatenate([system, rng.integers(1, CFG.vocab, size=(10,))]),
             4: rng.integers(1, CFG.vocab, size=(12,)),
             5: np.concatenate([system, rng.integers(1, CFG.vocab, size=(10,))])}
    kw = dict(kv_layout="paged", num_pages=64, page_size=16, max_batch=2,
              max_pages_per_seq=8, prompt_buckets=(16, 32, 64))
    jeng = JaxEngine(jax_llama.SMOKE, jparams, **kw)
    teng = LLMEngine(CFG, params, device="cpu", **kw)
    ids, orders = {}, {}
    for name, eng, req, sampling in (("jax", jeng, JaxRequest, JaxSampling),
                                     ("port", teng, Request, SamplingParams)):
        eng.generate([req(0, warm, sampling(max_tokens=4))])
        orders[name] = _record_admissions(eng)
        out = eng.generate([req(u, p, sampling(max_tokens=5)) for u, p in batch.items()])
        ids[name] = {o.uid: [int(t) for t in o.tokens] for o in out}
    assert orders["jax"][:2] == [3, 5] and orders["jax"].index(3) < orders["jax"].index(1)
    assert orders["port"] == orders["jax"]
    assert ids["port"] == ids["jax"]
    assert teng.stats().occupancy_cap == jeng.stats().occupancy_cap == 2
    teng.close()
    jeng.close()


@pytest.mark.parametrize("link", ["jax", "fast"])
def test_prefill_time_saved_with_host_tier_matches_jax(models, monkeypatch, link):
    """A tiered pool too small for the workload: P's pages demote to the
    host while three other prompts run. Then a request extending P is
    priced by both backends, a host-tier continuation of its device match,
    at the JAX package's topology and the same link constants: the JAX
    package's (at SMOKE widths the transfer costs more than the recompute
    it saves, so nothing is credited) and a link fast enough to be
    credited."""
    monkeypatch.setattr(plan_lib, "TOPOLOGY", numa.Topology(
        **{f.name: getattr(jax_numa.TPU_V5P_MEGACORE, f.name)
           for f in dataclasses.fields(jax_numa.Topology)}))
    if link == "fast":
        monkeypatch.setattr(jax_pm, "HOST_LINK_BW", 1e18)
        monkeypatch.setattr(jax_pm, "HOST_SYNC_OVERHEAD_S", 0.0)
    monkeypatch.setattr(perf_model, "HOST_LINK_BW", jax_pm.HOST_LINK_BW)
    monkeypatch.setattr(perf_model, "TIER_TRANSFER_FIXED_S", jax_pm.HOST_SYNC_OVERHEAD_S)
    jparams, params = models
    rng = np.random.default_rng(0)
    p_shared = rng.integers(1, CFG.vocab, size=33)
    fillers = [rng.integers(1, CFG.vocab, size=40 + 8 * i) for i in range(3)]
    probe = np.concatenate([p_shared, rng.integers(1, CFG.vocab, size=12)])
    unrelated = rng.integers(1, CFG.vocab, size=30)
    kw = dict(kv_layout="paged", num_pages=20, page_size=8, host_pool_bytes=1 << 20)
    jeng = JaxEngine(jax_llama.SMOKE, jparams, **kw)
    teng = LLMEngine(CFG, params, device="cpu", **kw)
    saved = {}
    for name, eng, req, sampling in (("jax", jeng, JaxRequest, JaxSampling),
                                     ("port", teng, Request, SamplingParams)):
        eng.generate([req(0, p_shared, sampling(max_tokens=6))])
        eng.generate([req(10 + i, f, sampling(max_tokens=6)) for i, f in enumerate(fillers)])
        b = eng.backend
        host_run = sum(h in b.host for h in req(99, probe, sampling()).page_hashes(8))
        saved[name] = (b.prefill_time_saved(req(99, probe, sampling())),
                       b.prefill_time_saved(req(98, unrelated, sampling())),
                       b.quote(req(99, probe, sampling())), host_run, b.host.page_nbytes)
    assert saved["port"][2:] == saved["jax"][2:]
    assert saved["jax"][3] > 0                        # a host-tier continuation exists
    assert saved["port"][1] == saved["jax"][1] == 0.0
    assert (saved["jax"][0] > 0) == (link == "fast")
    assert saved["port"][0] == pytest.approx(saved["jax"][0], rel=1e-12, abs=0.0)
    teng.close()
    jeng.close()
