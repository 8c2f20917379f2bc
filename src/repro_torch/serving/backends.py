"""Execution backends for the serving engine: mechanism, not policy.

Port of ``repro.serving.backends``:

  * ``DenseBackend`` (``backends.py:315``): one ``cache_len`` stripe per
    decode row (and the Mamba-2 state of SSM and hybrid models); each
    admitted prompt is right-padded to its bucket and prefilled into its
    slot. No preemption.
  * ``PagedBackend`` (``backends.py:533``): the paged KV pool with
    hash-chain prefix sharing, same-round in-flight page sharing, batched
    tail-prefill flush in dependency waves, page reservation with
    copy-on-write, and preemption with resume by replay.

Both decode through :meth:`_Backend.fused_decode`, the port of the JAX
package's fused multi-step scan (``backends.py:170-307``): N decode ticks
(decode, the batched sampler, the stop and length masks, the cache writes)
with no host read between them, over every ``rows`` row at the full width
(the whole page table, the whole stripe), as the JAX scan runs them. On the
card the N ticks are one captured CUDA graph per (N, stop width), replayed
once per sync; on the CPU the same tick function runs eagerly. There is no
fallback: a capture or replay that fails raises.

The paged pool may hold int8 / fp8 codes with per-(kv head, page) scales
(``kv_dtype``, ``cache.quant``), and may keep a host tier behind it
(``host_pool_bytes``, ``cache.tier``): under pool pressure idle prefix pages
demote to host memory instead of being dropped, and admission promotes them
back. Who is admitted or evicted is the scheduler's call. Left out of this
slice (ROADMAP.md): the serving mesh. The caches, scale tables included, are
updated in place and never rebound, so a captured graph keeps reading the
live caches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.cache import quant
from repro_torch.cache.pool import NULL_PAGE, OutOfPages, PagePool, SequencePages, SequenceReleasedError
from repro_torch.cache.prefix import PrefixCache, page_hashes
from repro_torch.cache.tier import HostPageStore
from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as device_lib
from repro_torch.core import perf_model
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import transformer
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.scheduler import default_choose_victim


class _SeqState:
    """One active decode row."""

    __slots__ = ("req", "pages", "submit_order")

    def __init__(self, req, pages, submit_order):
        self.req = req
        self.pages = pages
        self.submit_order = submit_order


#: Rows of the fused decode's integer inputs (``_Inputs.ints``).
_LEN, _GEN, _DONE, _TOP_K, _SEED, _MAX = range(6)

#: Device index -> the stream every backend on that card captures its
#: graphs on. PyTorch keeps one cuBLAS workspace per (handle, stream) for the
#: life of the process, so a stream per backend left one workspace behind
#: per engine.
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


class _Inputs:
    """The fused decode's input buffers: persistent tensors on the engine's
    device that every sync refills in place (a captured graph reads them
    at fixed addresses), each with a pinned host mirror on the card. The
    tokens to feed are (rows,), or (rows, K) for K > 1 codebooks."""

    def __init__(self, rows: int, table_width: int, device: torch.device,
                 codebooks: int = 1):
        self.device = device
        self.tok = torch.zeros((rows,) if codebooks == 1 else (rows, codebooks),
                               dtype=torch.int64, device=device)
        self.ints = torch.zeros((6, rows), dtype=torch.int64, device=device)
        self.floats = torch.zeros((2, rows), dtype=torch.float32, device=device)
        self.table = (torch.zeros((rows, table_width), dtype=torch.int32, device=device)
                      if table_width else None)
        self.stops: Dict[int, torch.Tensor] = {}
        self._host: Dict[int, torch.Tensor] = {}

    def stops_of(self, width: int) -> torch.Tensor:
        if width not in self.stops:
            self.stops[width] = torch.full((self.ints.shape[1], width), -1,
                                           dtype=torch.int64, device=self.device)
        return self.stops[width]

    def _fill(self, dst: torch.Tensor, src: np.ndarray) -> None:
        src = torch.from_numpy(np.ascontiguousarray(src)).to(dst.dtype)
        if self.device.type == "cpu":
            dst.copy_(src)
            return
        host = self._host.get(id(dst))
        if host is None:
            host = self._host[id(dst)] = torch.empty(dst.shape, dtype=dst.dtype,
                                                     pin_memory=True)
        host.copy_(src)
        dst.copy_(host, non_blocking=True)

    def fill(self, tok: np.ndarray, ints: np.ndarray, floats: np.ndarray,
             table: Optional[np.ndarray], stops: np.ndarray) -> None:
        self._fill(self.tok, tok)
        self._fill(self.ints, ints)
        self._fill(self.floats, floats)
        if self.table is not None:
            self._fill(self.table, table)
        if stops.shape[1]:
            self._fill(self.stops_of(stops.shape[1]), stops)


class _Program:
    """One (n_steps, stop width) fused decode: on the card a captured CUDA
    graph with its output tensors, the kernel launches its capture recorded
    and two events around each replay; on the CPU the tick function
    itself."""

    __slots__ = ("run", "graph", "out", "logits", "launches", "events")

    def __init__(self, run, graph=None, out=None, logits=None, launches=None):
        self.run, self.graph, self.out, self.logits = run, graph, out, logits
        self.launches = launches or {}
        self.events = (None if graph is None else
                       tuple(torch.cuda.Event(enable_timing=True) for _ in range(2)))

    def __call__(self):
        if self.graph is None:
            return self.run()
        start, end = self.events
        start.record()
        self.graph.replay()
        end.record()
        kernels.add_launch_counts(self.launches)
        return self.out, self.logits

    def replay_seconds(self) -> float:
        """Device time of the last replay; call after reading its outputs."""
        start, end = self.events
        return start.elapsed_time(end) / 1e3


class _Backend:
    """Row bookkeeping, prompt buckets and the fused decode, shared by both
    layouts."""

    #: Ticks per sync the engine runs; the paged scheduler prices admission
    #: headroom off it (``PagedBackend.sync_reserve_pages``).
    steps_per_sync = 1

    def _init_rows(self, rows: int, prompt_buckets) -> None:
        self.rows = rows
        self.lengths = np.zeros((rows,), np.int32)
        self.active = np.zeros((rows,), bool)
        #: Generated tokens per row (replayed resume tokens included).
        self.out: List[List] = [[] for _ in range(rows)]
        self.prompt_buckets = tuple(prompt_buckets)
        self._programs: Dict[Tuple[int, int], _Program] = {}
        self._inputs: Optional[_Inputs] = None
        self._graph_pool = None
        #: The last tick's logits (rows, V), or (rows, K, V), of the latest
        #: fused sync; on the card they live in the graphs' memory and hold
        #: until the next sync.
        self.last_logits: Optional[torch.Tensor] = None
        #: Measured time of one tick of the latest sync (the graph replay's
        #: device time on the card, the tick function's host time on the
        #: CPU) over its ticks; None before the first sync.
        self.decode_tick_s: Optional[float] = None

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets {self.prompt_buckets}")

    def fits_buckets(self, n: int) -> bool:
        return any(n <= b for b in self.prompt_buckets)

    # -- fused multi-step decode ---------------------------------------------

    def commit_scan(self, new_lengths: np.ndarray) -> None:
        """Adopt the per-row lengths after a fused sync."""
        self.lengths = np.array(new_lengths, dtype=self.lengths.dtype)

    def fused_decode(self, tok, gen, stops, max_toks, temps, top_k, top_p, seeds,
                     n_steps: int):
        """Run ``n_steps`` decode ticks over every row with no host read
        between them; return ``(ys, final_lengths)``.

        Per tick: decode, :func:`sampling.sample_batch` at stream position
        ``gen + 1``, the fed-stop, sampled-stop and max-token masks, and the
        cache writes. A row finishes mid-sync by freezing: its length stops
        advancing, a paged row's table row turns to the null page (its later
        writes sink there) and a dense row re-feeds its last token at the
        same position, rewriting the same K/V. Rows inactive at the start
        run frozen throughout. A frozen row takes no MoE expert slot.
        ``tok``: (rows,) host array, or (rows, K) for K > 1 codebooks;
        ``gen``, ``max_toks``, the sampling parameters: (rows,) host
        arrays; ``stops``: (rows, W) stop ids padded with -1 (W 0: no stop
        detection, as for every multi-codebook stream). ``ys`` are host
        arrays: the fed token and the sampled token, (n_steps, rows) or
        (n_steps, rows, K), and the live, appended-stop, fed-stop and
        hit-max masks, (n_steps, rows); ``final_lengths`` feeds
        :meth:`commit_scan`."""
        n, width = int(n_steps), int(stops.shape[1])
        program = self.prepare_decode(n, width)
        ints = np.zeros((6, self.rows), np.int64)
        ints[_LEN], ints[_GEN] = self.lengths, gen
        ints[_DONE], ints[_TOP_K], ints[_SEED], ints[_MAX] = ~self.active, top_k, seeds, max_toks
        self._inputs.fill(tok, ints, np.stack([temps, top_p]),
                          self.page_table if self.kv_layout == "paged" else None, stops)
        t0 = time.perf_counter()
        out, self.last_logits = program()
        host = out.cpu().numpy()
        secs = time.perf_counter() - t0 if program.graph is None else program.replay_seconds()
        self.decode_tick_s = secs / n
        k = self.cfg.num_codebooks
        cols = 2 * k + 4
        ys = host[: n * self.rows * cols].reshape(n, self.rows, cols)
        toks = (ys[..., :k], ys[..., k:2 * k]) if k > 1 else (ys[..., 0], ys[..., 1])
        return toks + tuple(ys[..., 2 * k + i] for i in range(4)), host[n * self.rows * cols:]

    def prepare_decode(self, n_steps: int, stop_width: int = 0) -> "_Program":
        """The program of one (n_steps, stop width) key, built (on the card:
        captured) now if it is not yet. A load harness calls it at warm-up
        for every key a run can reach, so no capture lands in a measured
        sync."""
        key = (int(n_steps), int(stop_width))
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = self._build(*key)
        return program

    def _tick_fn(self, n_steps: int, stop_width: int):
        """The fused decode of ``n_steps`` ticks over the input buffers, as a
        function of nothing: it returns the outputs packed into one int64
        tensor (``n_steps`` x rows x (2 K + 4): the fed and sampled tokens'
        K codebooks each, then the four masks; then the final lengths) and
        the last tick's logits. It holds the input buffers and the decoder,
        never the backend, so dropping the backend's programs frees the
        graphs."""
        inputs = self._inputs
        paged = self.kv_layout == "paged"
        decode = self._decoder()

        def per_row(mask, like):
            """(rows,) ``mask`` shaped to broadcast over ``like``'s rows."""
            return mask.reshape(-1, *(1,) * (like.dim() - 1))

        @torch.no_grad()
        def run():
            tok = inputs.tok
            lengths, gen, done = (inputs.ints[i] for i in (_LEN, _GEN, _DONE))
            top_k, seeds, max_toks = (inputs.ints[i] for i in (_TOP_K, _SEED, _MAX))
            temps, top_p = inputs.floats[0], inputs.floats[1]
            stops = inputs.stops_of(stop_width) if stop_width else None
            lengths, done, table = lengths.int(), done.bool(), inputs.table
            ys = []
            for _ in range(n_steps):
                live = ~done
                lengths1 = lengths + live.int()
                logits = decode(tok, lengths1, table, live)
                # A frozen row's logits are discarded: keep whatever they
                # hold out of the sampler.
                logits = logits.masked_fill(per_row(done, logits), 0.0)
                gen1 = gen + live.long()
                nxt = sampling_lib.sample_batch(logits, temps, top_k, top_p, seeds, gen1)
                if stops is not None:
                    fed_stop = live & (tok[:, None] == stops).any(1)
                    nxt_stop = (nxt[:, None] == stops).any(1)
                else:
                    fed_stop = nxt_stop = torch.zeros_like(done)
                hit_max = live & (gen1 >= max_toks)
                done_fed = fed_stop | hit_max
                # A sampled stop token is recorded, never decoded.
                append_nxt = live & ~done_fed & nxt_stop
                newly = done_fed | append_nxt
                if paged:
                    table = table.masked_fill(newly[:, None], NULL_PAGE)
                masks = torch.stack([live, append_nxt, fed_stop, hit_max], 1).long()
                ys.append(torch.cat([tok.reshape(len(tok), -1), nxt.reshape(len(tok), -1),
                                     masks], 1))
                tok = torch.where(per_row(live & ~newly, tok), nxt, tok)
                lengths, gen, done = lengths1, gen1 + append_nxt.long(), done | newly
            return torch.cat([torch.stack(ys).reshape(-1), lengths.long()]), logits

        return run

    def _build(self, n_steps: int, stop_width: int) -> _Program:
        """The program of one (n_steps, stop width) key: on the CPU the tick
        function; on the card its CUDA graph, captured into the backend's
        one memory pool after one eager warm-up tick on the capture stream
        (library workspaces and lazy set-up happen outside the capture). Every
        backend on a device captures on one shared stream, so the library
        workspaces tied to that stream are made once per process.
        ``stats["decode_traces"]`` counts builds."""
        self.stats["decode_traces"] += 1
        if self._inputs is None:
            width = self.max_pages_per_seq if self.kv_layout == "paged" else 0
            self._inputs = _Inputs(self.rows, width, self.device, self.cfg.num_codebooks)
        if stop_width:
            self._inputs.stops_of(stop_width)
        run = self._tick_fn(n_steps, stop_width)
        if self.device.type == "cpu":
            return _Program(run)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = _capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._warm_up(self._tick_fn(1, stop_width))
        torch.cuda.current_stream(self.device).wait_stream(stream)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream):
            out, logits = run()
        after = kernels.launch_counts()
        # The capture launched nothing: take its counts back, and add them
        # at every replay instead.
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernels.add_launch_counts({k: -n for k, n in launches.items()})
        return _Program(run, graph, out, logits, launches)

    def _warm_up(self, run) -> None:
        """One eager tick with every row frozen, at length 0 and on the null
        page: its writes land where :meth:`_scratch_state` restores them."""
        inputs = self._inputs
        restore = self._scratch_state()
        inputs.tok.zero_()
        inputs.ints.zero_()
        inputs.ints[_DONE] = 1
        inputs.floats.zero_()
        if inputs.table is not None:
            inputs.table.fill_(NULL_PAGE)
        run()
        restore()

    def _drop_programs(self) -> None:
        """Free the fused decode's graphs, their memory pool and the input
        buffers (with their pinned mirrors); the next sync builds anew."""
        self._programs = {}
        self._inputs = None
        self._graph_pool = None
        self.last_logits = None


class DenseBackend(_Backend):
    """Slot-based dense KV: each row owns a ``cache_len`` stripe (and, for
    SSM and hybrid models, its recurrent state); a request prefills into a
    free slot, right-padded to its prompt bucket; one decode tick advances
    every active slot. A slot is committed until its sequence finishes."""

    kv_layout = "dense"

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device, rows: int = 8,
                 cache_len: int = 2048, prompt_buckets=(128, 512, 2048)):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.cache_len = cache_len
        self._init_rows(rows, (b for b in prompt_buckets if b <= cache_len))
        self.slot_req: List[Optional[object]] = [None] * rows
        self.stats = {"preemptions": 0, "resumed_tokens": 0, "prefill_launches": 0,
                      "batched_prefills": 0, "decode_traces": 0}
        self.caches = transformer.init_caches(cfg, rows, cache_len, device)

    # -- capacity ----------------------------------------------------------

    def validate(self, req) -> None:
        n = len(req.prompt)
        if not self.fits_buckets(n):
            raise ValueError(f"prompt length {n} exceeds buckets {self.prompt_buckets}")
        if n + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.uid}: prompt {n} + max_tokens {req.max_new_tokens} "
                f"exceeds the dense cache stripe ({self.cache_len} tokens)")

    def decode_time_model(self, batch: int, mean_len: Optional[float] = None) -> float:
        """Modelled tick time (``perf_model.estimate_dense_decode``): the
        whole stripe per cell, whatever ``mean_len`` is live."""
        return perf_model.estimate_dense_decode(
            batch=batch, num_q_heads=self.cfg.n_heads, num_kv_heads=self.cfg.n_kv_heads,
            capacity=self.cache_len, head_dim=self.cfg.head_dim,
            dtype_bytes=device_lib.dtype_of(self.cfg.compute_dtype).itemsize,
            topo=plan_lib.TOPOLOGY).time

    @property
    def page_occupancy(self) -> float:
        return self.num_active / self.rows if self.rows else 0.0

    @property
    def mapping(self):
        """The plan's launch order for the steady-state prefill (every row,
        a full stripe); a pinned paper schedule passes through unchanged."""
        return plan_lib.plan_for_config(
            self.cfg, (self.rows, self.cfg.n_heads, self.cfg.n_kv_heads,
                       self.cache_len, self.cache_len, self.cfg.head_dim),
            device_type=self.device.type, phase=plan_lib.PREFILL,
            dtype_bytes=device_lib.dtype_of(self.cfg.compute_dtype).itemsize).mapping

    def prefix_hit_rate(self) -> None:
        """Dense stripes have no prefix cache: None, not a cache that never hit."""
        return None

    def prefix_stats(self) -> Dict[str, object]:
        """Every sharing counter is a structural zero and
        ``prefix_hit_rate`` is None, as in the JAX package."""
        return {
            "prefix_entries": 0.0, "pages_reused": 0.0, "prompt_pages": 0.0,
            "prefix_hit_rate": None, "prefix_lookup_hits": 0.0,
            "prefix_lookup_queries": 0.0, "prefix_evictions": 0.0,
            **{k: float(v) for k, v in self.stats.items()}, "kv_dtype": "fp32",
        }

    # -- admission / prefill ----------------------------------------------

    def try_admit(self, req, resume_tokens: Sequence = ()):
        if len(resume_tokens):
            raise ValueError("dense backend does not preempt, so it cannot resume")
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return None
        n = len(req.prompt)
        bucket = self._bucket_for(n)
        row = int(free[0])
        self.lengths[row] = n
        self.active[row] = True
        self.slot_req[row] = req
        self.out[row] = []
        return {"req": req, "row": row, "n": n, "bucket": bucket,
                "prompt": np.asarray(req.prompt)}

    def _write_slot(self, row: int, caches: List[dict]) -> None:
        """Copy one prefilled sequence's caches into slot ``row``; the
        stripe past the bucket is zeroed, as the JAX package's full-width
        copy leaves it."""
        for dst, src in zip(self.caches, caches):
            for key, val in src.items():
                if key in ("k", "v"):
                    n = val.shape[2]
                    dst[key][row, :, :n] = val[0].to(dst[key].dtype)
                    dst[key][row, :, n:] = 0
                else:
                    dst[key][row] = val[0].to(dst[key].dtype)

    @torch.no_grad()
    def flush(self, records) -> Dict[int, torch.Tensor]:
        """Prefill each admitted record into its slot (right-padded to its
        bucket along the sequence axis only, a multi-codebook prompt's K
        columns kept; the SSM state is the unpadded prompt's); returns
        per-row last-position logits for the engine's first-token sample."""
        first_logits: Dict[int, torch.Tensor] = {}
        for rec in records:
            n, bucket, prompt = rec["n"], rec["bucket"], rec["prompt"]
            padded = np.pad(prompt, [(0, bucket - n)] + [(0, 0)] * (prompt.ndim - 1))[None]
            self.stats["prefill_launches"] += 1
            logits, caches = transformer.prefill(
                self.params, self.cfg, torch.from_numpy(padded.astype(np.int64)).to(self.device),
                cache_len=bucket,
                last_positions=torch.tensor([n - 1], dtype=torch.int64, device=self.device))
            self._write_slot(rec["row"], caches)
            first_logits[rec["row"]] = logits[0]
        return first_logits

    # -- decode / teardown -------------------------------------------------

    def reserve_rows(self, n_steps: int = 1) -> None:
        """Dense stripes pre-reserve every position at admission."""

    def _decoder(self):
        params, cfg, caches = self.params, self.cfg, self.caches
        return lambda tok, lengths, table, live: transformer.decode_step(
            params, cfg, tok, caches, lengths, live=live)[0]

    def _scratch_state(self) -> Callable[[], None]:
        """Save what a warm-up tick at length 0 overwrites (position 0 of
        every stripe, the SSM state); the returned function restores it."""
        saved = []
        for c in self.caches:
            for key, val in c.items():
                part = val[:, :, 0] if key in ("k", "v") else val
                saved.append((part, part.clone()))

        def restore():
            for part, copy in saved:
                part.copy_(copy)

        return restore

    def row_req(self, row: int):
        return self.slot_req[row]

    def release(self, row: int) -> None:
        if self.slot_req[row] is None:
            raise SequenceReleasedError(f"release of row {row}, which holds no sequence")
        self.active[row] = False
        self.slot_req[row] = None
        self.lengths[row] = 0

    def shutdown(self) -> None:
        """Mark every slot free; dense rows own no pool pages, so there is
        nothing to leak-check. Frees the decode graphs."""
        for row in range(self.rows):
            self.active[row] = False
            self.slot_req[row] = None
            self.lengths[row] = 0
        self._drop_programs()


class PagedBackend(_Backend):
    """Paged KV-cache backend. ``rows`` is the decode batch width;
    capacity is the page pool: admission succeeds when a request's
    non-shared prompt pages fit the free list with ``reserve_pages`` of
    decode headroom. ``kv_dtype`` "int8" / "fp8" stores the pool as codes
    with per-(kv head, page) scales; ``host_pool_bytes`` puts a host tier of
    that budget behind the pool (it needs ``prefix_sharing``: demoted pages
    are keyed by the prefix hash chain). Single-codebook token streams only,
    as in the JAX package: a page's prefix hash chain is over scalar ids."""

    kv_layout = "paged"

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device,
                 num_pages: int = 128, page_size: int = 16, rows: int = 8,
                 max_pages_per_seq: int = 16, prompt_buckets=(32, 64, 128),
                 prefix_sharing: bool = True, reserve_pages: int = 1,
                 batch_prefills: bool = True, kv_dtype: str = "fp32",
                 host_pool_bytes=None):
        if cfg.num_codebooks != 1:
            raise ValueError("paged backend supports single-codebook models")
        self.kv_dtype = quant.validate_kv_dtype(kv_dtype)
        for b in prompt_buckets:
            if b % page_size:
                raise ValueError(
                    f"prompt bucket {b} must be a multiple of page_size {page_size}")
        if num_pages - 1 < max_pages_per_seq:
            raise ValueError(
                f"num_pages={num_pages} (usable {num_pages - 1}) cannot hold one "
                f"max_pages_per_seq={max_pages_per_seq} sequence")
        self.cfg = cfg
        self.params = params
        self.device = device
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.cache_len = max_pages_per_seq * page_size
        self.reserve_pages = reserve_pages
        self.prefix_sharing = prefix_sharing
        self.batch_prefills = batch_prefills

        self._init_rows(rows, (b for b in prompt_buckets if b <= self.cache_len))
        self._submit_counter = 0
        self.preempted: List[Tuple[object, List]] = []
        self.choose_victim: Callable = default_choose_victim
        self.on_preempt: Callable = (
            lambda row, req, toks: self.preempted.append((req, toks)))
        self.stats = {
            "preemptions": 0, "prefix_evictions": 0, "pages_reused": 0,
            "prompt_pages": 0, "cow_copies": 0, "extend_prefills": 0,
            "resumed_tokens": 0, "prefill_launches": 0, "batched_prefills": 0,
            "inflight_pages_reused": 0, "decode_traces": 0, "demoted_pages": 0,
            "promoted_pages": 0,
        }

        self.pool = PagePool(num_pages, page_size)
        self.prefix = PrefixCache(self.pool)
        self.host: Optional[HostPageStore] = None
        if host_pool_bytes:
            if not prefix_sharing:
                raise ValueError("host_pool_bytes requires prefix_sharing=True: demoted "
                                 "pages are keyed by the prefix hash chain")
            self.host = HostPageStore(int(host_pool_bytes), self.page_nbytes())
        #: chain hash -> (physical page, publishing uid) for pages admitted
        #: but not yet prefilled this round; cleared by :meth:`flush`.
        self._pending_pages: Dict[bytes, Tuple[int, int]] = {}
        self.caches = transformer.init_paged_caches(cfg, num_pages, page_size, device,
                                                    kv_dtype=kv_dtype)
        self.page_table = np.zeros((rows, max_pages_per_seq), np.int32)
        self.seqs: List[Optional[_SeqState]] = [None] * rows

    # -- capacity ----------------------------------------------------------

    def page_nbytes(self) -> int:
        """Bytes of one physical page over every layer, K and V: its codes,
        plus one float32 scale per kv head for a quantized pool (the JAX
        package's ``_page_slice_bytes`` on one device). Also the host
        footprint of a demoted page."""
        cfg = self.cfg
        if self.kv_dtype in quant.QMAX:
            per_head = self.page_size * cfg.head_dim * quant.kv_itemsize(self.kv_dtype) + 4
        else:
            per_head = (self.page_size * cfg.head_dim
                        * device_lib.dtype_of(cfg.compute_dtype).itemsize)
        return 2 * cfg.n_layers * cfg.n_kv_heads * per_head

    def kv_pool_bytes(self) -> int:
        """Device bytes of the page pools, scale tables included."""
        return self.page_nbytes() * self.pool.num_pages

    @property
    def mapping(self):
        """The launch order of the steady-state decode plan (decode is part
        of the plan's key, so it may differ from the prefill's)."""
        return self.decode_plan().mapping

    def decode_plan(self) -> plan_lib.AttentionPlan:
        """The plan every decode tick runs: all rows over the full table
        (the fused decode's width), in the compute dtype over the pool's
        format; ``num_splits`` is the split count the ticks launch."""
        return plan_lib.plan_for_config(
            self.cfg, (self.rows, self.cfg.n_heads, self.cfg.n_kv_heads, 1,
                       self.cache_len, self.cfg.head_dim),
            device_type=self.device.type, phase=plan_lib.DECODE,
            kv_layout=plan_lib.PAGED, page_size=self.page_size,
            dtype_bytes=device_lib.dtype_of(self.cfg.compute_dtype).itemsize,
            kv_dtype=self.kv_dtype)

    def modeled_kv_layout(self) -> str:
        """What the layout model picks for this backend's steady state
        (``plan.resolve_kv_layout``: paged head-aligned or dense stripes)
        at the live rows' mean length, or half the table when none is live."""
        live = self.lengths[self.active]
        mean_len = int(live.mean()) if live.size else self.cache_len // 2
        return plan_lib.resolve_kv_layout(
            (self.rows, self.cfg.n_heads, self.cfg.n_kv_heads, max(mean_len, 1),
             self.cfg.head_dim),
            capacity=self.cache_len, page_size=self.page_size,
            dtype_bytes=self._kv_dtype_bytes)

    @property
    def _kv_dtype_bytes(self) -> int:
        """Bytes per pooled element: 1 for int8 / fp8 codes, else the
        compute dtype's."""
        if self.kv_dtype in quant.QMAX:
            return quant.kv_itemsize(self.kv_dtype)
        return device_lib.dtype_of(self.cfg.compute_dtype).itemsize

    def decode_time_model(self, batch: int, mean_len: Optional[float] = None) -> float:
        """Modelled seconds of one decode tick's attention
        (``perf_model.estimate_paged_decode`` on the H100): the kernel only,
        not the whole tick, as in the JAX package. Priced at the pool's
        byte width (1 for int8 / fp8 codes) and at half-full sequences,
        unless ``mean_len`` gives the live mean context (drift cells, the
        occupancy cap)."""
        return perf_model.estimate_paged_decode(
            batch=batch, num_q_heads=self.cfg.n_heads, num_kv_heads=self.cfg.n_kv_heads,
            mean_len=(max(int(mean_len), self.page_size) if mean_len
                      else max(self.cache_len // 2, self.page_size)),
            page_size=self.page_size, head_dim=self.cfg.head_dim,
            dtype_bytes=self._kv_dtype_bytes, topo=plan_lib.TOPOLOGY).time

    def prefill_time_saved(self, req) -> float:
        """Modelled prefill seconds that cache reuse would save ``req`` if
        admitted now: the scheduler's tie-break within a priority class.
        The full prefill minus the extend over the matched prefix, both
        ``perf_model.estimate_extend_prefill`` on the plan's topology under
        the JAX package's formula (its fitted extend terms price K2 against
        the gather route at one shape, in padded tiles, and would read a
        short prefix as no saving, where the whole model's rows are); a
        host-tier continuation of the match adds the recompute it saves
        minus its transfer (``perf_model.estimate_tier_transfer``), credited
        only where the link beats the FLOPs. Zero when nothing matches."""
        _, matched = self.quote(req)
        n = len(req.prompt)
        limit = (n - 1) // self.page_size
        host_run = 0
        if self.host is not None and matched < limit:
            for h in req.page_hashes(self.page_size)[matched:limit]:
                if h not in self.host:
                    break
                host_run += 1
        if matched <= 0 and host_run <= 0:
            return 0.0
        prefix = min(matched * self.page_size, n - 1)
        both = min((matched + host_run) * self.page_size, n - 1)

        topo = dataclasses.replace(plan_lib.TOPOLOGY, extend=None)

        def _t(prefix_len: int) -> float:
            return perf_model.estimate_extend_prefill(
                batch=1, num_q_heads=self.cfg.n_heads, num_kv_heads=self.cfg.n_kv_heads,
                prefix_len=prefix_len, tail_len=n - prefix_len, page_size=self.page_size,
                head_dim=self.cfg.head_dim, dtype_bytes=self._kv_dtype_bytes,
                topo=topo).time

        saved = max(_t(0) - _t(prefix), 0.0)
        if host_run > 0:
            transfer = perf_model.estimate_tier_transfer(host_run * self.host.page_nbytes)
            saved += max(_t(prefix) - _t(both) - transfer, 0.0)
        return saved

    def validate(self, req) -> None:
        tok = np.asarray(req.prompt)
        if tok.ndim != 1:
            raise ValueError("paged backend expects flat token prompts")
        n = len(tok)
        if self.pool.pages_needed(n + req.max_new_tokens) > self.max_pages_per_seq:
            raise ValueError(
                f"request {req.uid}: prompt {n} + max_new_tokens {req.max_new_tokens} "
                f"can outgrow max_pages_per_seq={self.max_pages_per_seq} "
                f"({self.cache_len} tokens) mid-decode; reject at admission instead")
        if not self.prefix_sharing and not self.fits_buckets(n):
            raise ValueError(f"prompt length {n} exceeds buckets {self.prompt_buckets}")

    def quote(self, req) -> Tuple[int, int]:
        """(pages the prompt needs, shared pages it would reuse) — a pure
        peek: LRU order and hit counters stay untouched."""
        n = len(req.prompt)
        total = self.pool.pages_needed(n)
        matched = 0
        if self.prefix_sharing and n > 1:
            limit = (n - 1) // self.page_size
            hashes = req.page_hashes(self.page_size)
            matched = len(self.prefix.lookup(hashes[:limit], touch=False))
            while matched < limit and hashes[matched] in self._pending_pages:
                matched += 1
        return total, matched

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def evictable_pages(self) -> int:
        return len(self.prefix)

    @property
    def page_occupancy(self) -> float:
        return self.pool.used_pages / max(self.pool.num_pages - 1, 1)

    # -- page plumbing -----------------------------------------------------

    def _scatter_tail(self, tail_caches: List[dict], pids: np.ndarray) -> None:
        """Write prefilled tails' K/V into their pages, every layer, through
        ``quant.scatter_pages`` (a quantized pool stores codes and sets the
        pages' scales). ``pids`` (rows, bucket / ps): destinations past a
        tail's real pages are the null page, a garbage sink."""
        flat = torch.from_numpy(pids.reshape(-1).astype(np.int64)).to(self.device)
        ps = self.page_size
        for pool, tail in zip(self.caches, tail_caches):
            for kv in ("k", "v"):
                dense = tail[kv]
                rows, hkv, bucket, hd = dense.shape
                new = dense.reshape(rows, hkv, bucket // ps, ps, hd).permute(1, 0, 2, 3, 4)
                quant.scatter_pages(pool[f"{kv}_pages"], pool.get(f"{kv}_scales"),
                                    new.reshape(hkv, rows * (bucket // ps), ps, hd), flat,
                                    self.kv_dtype)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: physical page ``src`` -> ``dst``, every layer; a
        quantized page's scale entries follow it (``quant.cow_scales``)."""
        for pool in self.caches:
            for kv in ("k", "v"):
                pages = pool[f"{kv}_pages"]
                quant.put_pages(pages, (slice(None), dst), pages[:, src])
                quant.cow_scales(pool.get(f"{kv}_scales"), src, dst)

    def _page_payload(self, pid: int) -> torch.Tensor:
        """Physical page ``pid`` over every layer as one host byte buffer:
        each layer's K and V codes and, for a quantized pool, their scale
        entries, packed on the device so that one copy crosses the host
        link. Pinned memory on the card; returns once the copy has landed,
        so the caller may free the device page."""
        packed = torch.cat([t[:, pid].contiguous().view(torch.uint8).reshape(-1)
                            for pool in self.caches for t in pool.values()])
        if self.device.type != "cuda":
            return packed
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host

    def _restore_page(self, payload: torch.Tensor, dst: int) -> None:
        """Inverse of :meth:`_page_payload`: unpack a promoted page's bytes
        into physical page ``dst``, every layer (codes and scale entries)."""
        data = payload.to(self.device, non_blocking=True)
        offset = 0
        for pool in self.caches:
            for t in pool.values():
                part = t[:, dst]
                n = part.numel() * part.element_size()
                part.copy_(data[offset:offset + n].view(t.dtype).view(part.shape))
                offset += n

    @staticmethod
    def _prefix_page_bucket(pages: int) -> int:
        """Prefix page count bucketed to the next power of two (the width of
        the extend page table; the live length stays exact)."""
        if pages <= 0:
            return 0
        return 1 << (pages - 1).bit_length()

    # -- admission ---------------------------------------------------------

    def _make_room(self, pages_needed: int) -> bool:
        """Evict idle prefix-cache pages until ``pages_needed`` fit (with a
        host tier their content demotes instead of being lost); report
        whether they do."""
        short = pages_needed - self.pool.free_pages
        if short > 0 and len(self.prefix):
            on_evict = self._demote_entry if self.host is not None else None
            self.stats["prefix_evictions"] += self.prefix.evict(short, on_evict=on_evict)
            short = pages_needed - self.pool.free_pages
        return short <= 0

    def _demote_entry(self, h: bytes, pid: int) -> None:
        """Prefix-eviction hook: copy the page host-side before the device
        page is freed (:meth:`_page_payload` returns once the copy has
        landed)."""
        if self.host.admit(h, self._page_payload(pid)):
            self.stats["demoted_pages"] += 1

    def _promote_chain(self, hashes, pinned: Sequence[int]) -> List[int]:
        """Continue a device prefix miss into the host tier: restore the
        longest host-resident run of ``hashes`` into fresh device pages and
        publish them to the prefix cache, so the caller extends off them as
        if they had never left. Each host copy is consumed as its page lands
        (residency stays exclusive). The matched pages ``pinned`` and the
        pages restored so far hold a reference through the walk, so the
        room made for the next page never evicts them. Stops early when the
        pool cannot free a page."""
        run = self.host.lookup_chain(hashes)
        pids: List[int] = []
        for p in pinned:
            self.pool.incref(p)
        try:
            for h in run:
                if not self._make_room(1):
                    break
                try:
                    pid = self.pool.alloc()
                except OutOfPages:
                    break
                if h not in self.host:
                    # The room just made demoted pages that pushed this entry
                    # out of the host LRU: the run is broken.
                    self.pool.decref(pid)
                    break
                self._restore_page(self.host.take(h), pid)
                self.prefix.insert([h], [pid])
                pids.append(pid)
                self.stats["promoted_pages"] += 1
        finally:
            for p in list(pinned) + pids:
                self.pool.decref(p)
        return pids

    def _reserve(self, num_tokens: int, matched) -> Optional[SequencePages]:
        """Pin the matched prefix pages, make room, allocate; None when the
        pool cannot hold the request."""
        for p in matched:
            self.pool.incref(p)
        try:
            need = self.pool.pages_needed(num_tokens) - len(matched)
            if not self._make_room(need + self.reserve_pages):
                return None
            try:
                return self.pool.allocate_sequence(num_tokens, shared_prefix=matched)
            except OutOfPages:
                return None
        finally:
            for p in matched:
                self.pool.decref(p)

    def try_admit(self, req, resume_tokens: Sequence = ()):
        """Reserve a decode row and pages for ``req`` (prefill runs at
        :meth:`flush`). The prefix-cache match continues through pages a
        record admitted earlier this round will publish. ``resume_tokens``
        (a preempted run's output) replay as more prompt. Returns an
        admission record, or None when the pool or rows cannot hold it."""
        free_rows = np.flatnonzero(~self.active)
        if len(free_rows) == 0:
            return None
        tok = np.asarray(req.prompt)
        if tok.ndim != 1:
            raise ValueError("paged backend expects flat token prompts")
        orig_n = len(tok)
        if len(resume_tokens):
            tok = np.concatenate([tok, np.asarray([int(t) for t in resume_tokens], tok.dtype)])
        n = len(tok)
        ps = self.page_size
        total_pages = self.pool.pages_needed(n)
        if total_pages > self.max_pages_per_seq:
            raise ValueError(
                f"prompt needs {total_pages} pages > max_pages_per_seq {self.max_pages_per_seq}")
        self.validate(req)

        if not self.prefix_sharing:
            hashes = []
        elif len(resume_tokens):
            hashes = page_hashes(tok, ps)
        else:
            hashes = req.page_hashes(ps)
        # At least one tail token is prefilled here, for the next-token logits.
        limit = (n - 1) // ps
        matched = self.prefix.lookup(hashes[:limit])
        after: set = set()
        if self.prefix_sharing:
            inflight = 0
            while len(matched) < limit and hashes[len(matched)] in self._pending_pages:
                pid, owner = self._pending_pages[hashes[len(matched)]]
                matched.append(pid)
                after.add(owner)
                inflight += 1
            self.stats["inflight_pages_reused"] += inflight
            # ... and then into the host tier.
            if self.host is not None and len(matched) < limit:
                matched.extend(self._promote_chain(hashes[len(matched):limit], matched))

        if not self.fits_buckets(n - len(matched) * ps):
            if len(resume_tokens):
                # Drop replayed tokens until the tail fits a bucket; decode
                # regenerates them exactly.
                m_full = len(matched)
                for keep in range(len(resume_tokens) - 1, -1, -1):
                    nk = orig_n + keep
                    mk = min(m_full, (nk - 1) // ps)
                    if self.fits_buckets(nk - mk * ps):
                        return self.try_admit(req, list(resume_tokens)[:keep])
            raise ValueError(
                f"prompt tail {n - len(matched) * ps} exceeds buckets {self.prompt_buckets}")
        seq = self._reserve(n, matched)
        if seq is None and matched and self.fits_buckets(n):
            # Reuse blocked admission: prefill from scratch instead.
            matched = []
            after = set()
            seq = self._reserve(n, matched)
        if seq is None:
            return None
        m = len(matched)
        tail = tok[m * ps:]
        bucket = self._bucket_for(len(tail))
        self.stats["pages_reused"] += m
        self.stats["prompt_pages"] += total_pages

        row = int(free_rows[0])
        self.seqs[row] = _SeqState(req=req, pages=seq, submit_order=self._submit_counter)
        self._submit_counter += 1
        self._set_table(row)
        self.lengths[row] = n
        self.active[row] = True
        self.out[row] = list(resume_tokens)
        self.stats["resumed_tokens"] += len(resume_tokens)
        if self.prefix_sharing:
            for i in range(m, n // ps):
                self._pending_pages[hashes[i]] = (seq.pages[i], req.uid)
        return {
            "req": req, "row": row, "seq": seq, "matched": matched, "tail": tail,
            "bucket": bucket, "n": n, "hashes": hashes,
            "mb": self._prefix_page_bucket(m) if m else 0,
            "after": frozenset(after),
        }

    def _set_table(self, row: int) -> None:
        pages = self.seqs[row].pages.pages
        self.page_table[row] = NULL_PAGE
        self.page_table[row, : len(pages)] = pages

    @torch.no_grad()
    def flush(self, records) -> Dict[int, torch.Tensor]:
        """Run the admitted tail prefills in dependency waves (a borrower of
        same-round pages runs after their publisher). Returns per-row
        last-position logits. Serving takes no gradient: parameters that
        require grad build no graph here."""
        first_logits: Dict[int, torch.Tensor] = {}
        todo = list(records)
        published: set = set()
        while todo:
            wave = [r for r in todo if r.get("after", frozenset()) <= published] or list(todo)
            done = {id(r) for r in wave}
            todo = [r for r in todo if id(r) not in done]
            self._flush_wave(wave, first_logits)
            published.update(r["req"].uid for r in wave)
        self._pending_pages.clear()
        return first_logits

    def _flush_wave(self, records, first_logits: Dict[int, torch.Tensor]) -> None:
        """One wave: group by (tail bucket, prefix-page bucket), run each
        group as one batched prefill, scatter the tails into their pages,
        publish full pages to the prefix cache."""
        ps = self.page_size
        dev = self.device
        groups: Dict[Tuple[int, ...], list] = {}
        for i, rec in enumerate(records):
            key = (rec["bucket"], rec["mb"]) if self.batch_prefills else (
                rec["bucket"], rec["mb"], i)
            groups.setdefault(key, []).append(rec)
        for (bucket, mb, *_), grp in groups.items():
            rows = len(grp)
            padded = np.stack([np.pad(r["tail"], (0, bucket - len(r["tail"]))) for r in grp])
            tokens = torch.from_numpy(padded.astype(np.int64)).to(dev)
            last = torch.tensor([len(r["tail"]) - 1 for r in grp], dtype=torch.int64,
                                device=dev)
            self.stats["prefill_launches"] += 1
            self.stats["batched_prefills"] += rows > 1
            if mb == 0:
                logits, tail_caches = transformer.prefill(
                    self.params, self.cfg, tokens, cache_len=bucket, last_positions=last)
            else:
                pt = np.full((rows, mb), NULL_PAGE, np.int32)
                for i, r in enumerate(grp):
                    pt[i, : len(r["matched"])] = r["matched"]
                plens = torch.tensor([len(r["matched"]) * ps for r in grp],
                                     dtype=torch.int32, device=dev)
                self.stats["extend_prefills"] += rows
                plan = plan_lib.plan_for_config(
                    self.cfg,
                    (rows, self.cfg.n_heads, self.cfg.n_kv_heads, bucket,
                     mb * ps + bucket, self.cfg.head_dim),
                    device_type=dev.type, phase=plan_lib.EXTEND,
                    kv_layout=plan_lib.PAGED, page_size=ps, prefix_pages=mb,
                    kv_dtype=self.kv_dtype)
                logits, tail_caches = transformer.prefill(
                    self.params, self.cfg, tokens, cache_len=bucket, last_positions=last,
                    prefix_caches=self.caches, page_table=torch.from_numpy(pt).to(dev),
                    prefix_len=plens, plan=plan)
            pids = np.full((rows, bucket // ps), NULL_PAGE, np.int32)
            for i, r in enumerate(grp):
                tail_pages = r["seq"].pages[len(r["matched"]):]
                pids[i, : len(tail_pages)] = tail_pages
            self._scatter_tail(tail_caches, pids)
            for i, r in enumerate(grp):
                if self.prefix_sharing:
                    nfull = r["n"] // ps
                    if self.host is not None:
                        # A freshly prefilled page supersedes a host copy
                        # under the same hash: device or host, never both.
                        for h in r["hashes"][:nfull]:
                            self.host.discard(h)
                    self.prefix.insert(r["hashes"][:nfull], r["seq"].pages[:nfull])
                first_logits[r["row"]] = logits[i]

    # -- preemption / decode ----------------------------------------------

    def _preempt_one(self, protect: int) -> bool:
        """Evict the active row the ``choose_victim`` policy names (never
        ``protect``) and report it through ``on_preempt``."""
        candidates = [
            (s.req.priority, s.submit_order, row)
            for row, s in enumerate(self.seqs)
            if s is not None and self.active[row] and row != protect
        ]
        row = self.choose_victim(candidates, protect) if candidates else None
        if row is None:
            return False
        state = self.seqs[row]
        self.stats["preemptions"] += 1
        self.pool.release(state.pages)
        generated = list(self.out[row])
        self.active[row] = False
        self.seqs[row] = None
        self.page_table[row] = NULL_PAGE
        self.lengths[row] = 0
        self.out[row] = []
        self.on_preempt(row, state.req, generated)
        return True

    def reserve_rows(self, n_steps: int = 1) -> None:
        """Reserve every active row's next ``min(n_steps, remaining)`` token
        slots before a sync, preempting other rows under pool pressure;
        partial progress is kept across retries. Copy-on-write copies happen
        here, so a sync never writes a shared page. Slots a sync does not
        use go back in :meth:`commit_scan`."""
        for row in range(self.rows):
            if not self.active[row]:
                continue
            state = self.seqs[row]
            # A sync never writes past max_tokens, so never past validate()'s cap.
            remaining = state.req.max_new_tokens - len(self.out[row])
            target = state.pages.length + min(n_steps, max(remaining, 1))
            cows: List[Tuple[int, int]] = []
            while state.pages.length < target:
                try:
                    self.pool.reserve_tokens(state.pages, target - state.pages.length, cows)
                except OutOfPages:
                    if not (self._make_room(1) or self._preempt_one(row)):
                        raise OutOfPages("pool exhausted and nothing left to preempt")
            for src, dst in cows:
                self.stats["cow_copies"] += 1
                self._copy_page(src, dst)
            self._set_table(row)

    def commit_scan(self, new_lengths: np.ndarray) -> None:
        """Trim each live row's reservation to what the sync used (its
        final length); unused reserved pages go back on the free list. Rows
        the sync finished are released by the engine after this."""
        for row in range(self.rows):
            state = self.seqs[row]
            if state is None or not self.active[row]:
                continue
            want = int(new_lengths[row])
            if want < state.pages.length:
                self.pool.trim_tokens(state.pages, want)
            self._set_table(row)
        super().commit_scan(new_lengths)

    @property
    def sync_reserve_pages(self) -> int:
        """Decode headroom the scheduler prices at admission: with N ticks a
        sync, every live row (and the candidate) can grow ceil(N /
        page_size) pages before the host next intervenes."""
        n = self.steps_per_sync
        if n <= 1:
            return self.reserve_pages
        return self.reserve_pages + -(-n // self.page_size) * (self.num_active + 1)

    def _decoder(self):
        params, cfg, caches = self.params, self.cfg, self.caches
        return lambda tok, lengths, table, live: transformer.decode_step(
            params, cfg, tok, caches, lengths, page_table=table, live=live)[0]

    def _scratch_state(self) -> Callable[[], None]:
        """A warm-up tick writes only the null page: save its codes and, for
        a quantized pool, its scale entries (which the frozen rows' appends
        move), so the first replay sees the state the eager path would."""
        saved = [(t, t[:, NULL_PAGE].clone()) for pool in self.caches for t in pool.values()]

        def restore():
            for t, copy in saved:
                t[:, NULL_PAGE].copy_(copy)

        return restore

    def row_req(self, row: int):
        return self.seqs[row].req

    def release(self, row: int) -> None:
        state = self.seqs[row]
        if state is None:
            raise SequenceReleasedError(f"release of row {row}, which holds no sequence")
        self.pool.release(state.pages)
        self.active[row] = False
        self.seqs[row] = None
        self.page_table[row] = NULL_PAGE
        self.lengths[row] = 0

    # -- teardown / introspection ------------------------------------------

    def live_page_refs(self) -> Dict[int, int]:
        refs: Dict[int, int] = {}
        for state in self.seqs:
            if state is not None:
                for pid in state.pages.pages:
                    refs[pid] = refs.get(pid, 0) + 1
        for pid in self.prefix.pages():
            refs[pid] = refs.get(pid, 0) + 1
        return refs

    def check_leaks(self, raise_on_leak: bool = True):
        return self.pool.check_leaks(self.live_page_refs(), raise_on_leak=raise_on_leak)

    def shutdown(self) -> None:
        """Release every live row, drain the prefix cache, prove the pool
        is fully free; free the decode graphs."""
        for row in range(self.rows):
            if self.seqs[row] is not None:
                self.release(row)
        self.prefix.drain()
        if self.host is not None:
            self.host.drain()
        self._pending_pages.clear()
        self._drop_programs()
        self.pool.check_leaks()

    def prefix_hit_rate(self) -> float:
        total = self.stats["prompt_pages"]
        return self.stats["pages_reused"] / total if total else 0.0

    def prefix_stats(self) -> Dict[str, object]:
        """The sharing and tier counters, the pool's storage format and its
        device bytes, and what the host tier holds. The prefix cache's own
        counters give the page-level lookup hits and queries and
        ``prefix_evictions``, the entries it dropped, as in the JAX package
        (``stats["prefix_evictions"]`` counts the pages those drops freed)."""
        host = self.host
        pc = self.prefix.counters()
        return {
            "prefix_entries": float(len(self.prefix)),
            "prefix_hit_rate": self.prefix_hit_rate(),
            **{k: float(v) for k, v in self.stats.items()},
            "prefix_lookup_hits": float(pc["hits"]),
            "prefix_lookup_queries": float(pc["queries"]),
            "prefix_evictions": float(pc["evictions"]),
            "free_pages": float(self.pool.free_pages),
            "kv_dtype": self.kv_dtype,
            "kv_pool_bytes": float(self.kv_pool_bytes()),
            "host_entries": float(len(host)) if host is not None else 0.0,
            "host_bytes_resident": float(host.bytes_resident) if host is not None else 0.0,
        }
