"""Hybrid device / host sampling for graphs whose CSR stays in host memory
(port of ``legion_tpu/cache/hybrid.py``).

The reference reads the whole CSR zero-copy from pinned host memory in GPU
threads and short-circuits hot rows to a device sub-CSR
(``kernel_random_sampler_2``'s partition branch, ``src/Kernels.cu:
387-397``, with GraphCache). The JAX package made that split explicit per
hop, and the port is held against it draw for draw:

  device: sample the frontier's hot nodes from the sub-CSR (``TopoCache``,
          through the sampling kernel)
  host:   sample the misses from the host CSR (the C++ runtime, threaded)
  device: merge, then dedup and renumber (``grow_frontier``)

The host leg costs one device->host read of the packed miss ids and one
host->device copy of the cold draws per hop, both metered. Hotness caching
keeps the host leg small: that is what the topology cache's share of the
cost model's budget buys.

``HybridTrainer``'s device stages are the reference's compiled programs
(``_j_start``, one ``_j_steps[k]`` per inner hop, ``_j_finish``,
``_jit_train``, ``_jit_eval``): on a capturing ``GraphPool`` each is a
CUDA graph (``train/graphed.py``) that replays between the host legs,
which stay eager: the packed reads, the C++ host sampler, the miss
gather, and the copies up of the cold draws and of exactly the staged
rows. Those legs are spans of ``utils/trace.py``: ``hybrid.fetch`` (a
packed read; counter ``fetches``), ``hybrid.host_sample`` (the C++
sampler) and ``pipeline.stage`` (the plan's read and the staging); the
cold draws' copies count in ``h2d_bytes`` and
``host_topo_copied_bytes``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from legion_tpu_torch import runtime
from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.cache.pipeline import make_cache_step_fns, run_ties
from legion_tpu_torch.cache.topo_cache import TopoCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.sampling.block import SampledBatch
from legion_tpu_torch.sampling.sampler import grow_frontier
from legion_tpu_torch.train.graphed import (GraphedStep, GraphPool, HostRing,
                                            Run, StageGraph, lend, row_at,
                                            serving_run, store)
from legion_tpu_torch.train.train_state import (TrainState,
                                                maybe_checkpoint_step)
from legion_tpu_torch.utils import trace

# Device uniforms come from a generator or, for parity tests, from a
# callable (step, hop) -> (caps[hop], fanouts[hop]) float32 tensor.
Uniforms = Union[torch.Generator, Callable[[int, int], torch.Tensor]]


def _host_csr(indptr, indices):
    """The host CSR as the C++ sampler reads it: int64 offsets, int32 ids.
    Arrays of those types (memmaps included) are kept, not copied."""
    return (np.ascontiguousarray(np.asarray(indptr), np.int64),
            np.ascontiguousarray(np.asarray(indices), np.int32))


def _merge(nbrs_hot, cold, hit):
    return torch.where(hit[:, None], nbrs_hot, cold)


class HybridSampler:
    """The naive per-hop hybrid sampler: every hop reads the hit mask and
    the frontier back and waits for the host. ``HybridTrainer`` is the
    pipelined form the driver trains with; this one serves a caller that
    wants one batch."""

    def __init__(self, topo: TopoCache, host_indptr: np.ndarray,
                 host_indices: np.ndarray, fanouts: Sequence[int],
                 caps: Sequence[int]):
        self.topo = topo
        self.host_indptr, self.host_indices = _host_csr(host_indptr,
                                                        host_indices)
        self.fanouts = tuple(fanouts)
        self.caps = tuple(caps)
        self.stats = {"hot": 0, "cold": 0, "host_bytes": 0}

    def sample_batch(self, seeds: torch.Tensor, num_seeds,
                     labels: torch.Tensor,
                     host_seed: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[Sequence[torch.Tensor]] = None
                     ) -> SampledBatch:
        """One batch; hop k's host leg is seeded ``host_seed * 1_000_003 +
        k``. Device randomness as ``sampling.sampler.sample_batch``: a
        generator or per-hop uniforms. Without ``host_seed`` one is drawn
        from the generator, so that repeated calls vary the cold draws
        too; injected uniforms need an explicit one."""
        if (uniforms is None) == (generator is None):
            raise ValueError("pass exactly one of generator and uniforms")
        dev = seeds.device
        if host_seed is None:
            if generator is None:
                raise ValueError("injected uniforms need a host_seed")
            host_seed = int(torch.randint(0, 2 ** 31 - 1, (), device=dev,
                                          generator=generator))
        caps = self.caps
        frontier = torch.full((caps[0],), -1, dtype=torch.int32, device=dev)
        frontier[: seeds.shape[0]] = seeds
        num_seeds = torch.as_tensor(num_seeds, dtype=torch.int32, device=dev)
        num = num_seeds
        blocks = []
        for k, fanout in enumerate(self.fanouts):
            u = (uniforms[k].to(dev) if uniforms is not None else
                 torch.rand((caps[k], fanout), generator=generator,
                            device=dev, dtype=torch.float32))
            nbrs_hot, hit = self.topo.sample_hot(frontier, u)
            # host leg for the cache misses
            hit_np = hit.cpu().numpy()
            frontier_np = frontier.cpu().numpy()
            miss_ids = np.where(~hit_np & (frontier_np >= 0), frontier_np,
                                -1).astype(np.int32)
            cold = runtime.sample_neighbors(
                self.host_indptr, self.host_indices, miss_ids, fanout,
                seed=host_seed * 1_000_003 + k)
            ncold = int((miss_ids >= 0).sum())
            self.stats["hot"] += int(hit_np.sum())
            self.stats["cold"] += ncold
            self.stats["host_bytes"] += ncold * fanout * 4
            nbrs = _merge(nbrs_hot, torch.from_numpy(cold).to(dev), hit)
            frontier, num, blk = grow_frontier(frontier, num, nbrs,
                                               caps[k + 1])
            blocks.append(blk)
        return SampledBatch(seeds=seeds, labels=labels, num_seeds=num_seeds,
                            frontier=frontier, num_frontier=num,
                            blocks=tuple(blocks))

    def hot_fraction(self) -> float:
        t = self.stats["hot"] + self.stats["cold"]
        return self.stats["hot"] / t if t else float("nan")


class HybridTrainer:
    """Pipelined hybrid training: each hop's host leg is fed by ONE packed
    device->host read, and batch i+1's first hop is enqueued in batch i's
    finish stage, so its host leg overlaps the device's train step (the
    two-stream sample / train overlap of the reference runner,
    ``src/Server.cu:310-316``, as one stream running ahead of the host).

    Per step with H hops: H device->host reads (one packed array a hop;
    the feature plan and the NEXT batch's hop-0 miss ids share the last
    one) against 2H+1 for ``HybridSampler``'s hit + frontier + plan reads,
    plus H+1 host->device copies (the cold draws of each hop, the staged
    feature rows). Reads are counted in the counter ``fetches``: H a step
    and one for the epoch's prologue.

    Step structure (H = 2):

      [held from the last step] hop-0 hot draws + packed miss ids
      host: sample the cold hop-0 rows     [overlaps train(i-1) on device]
      dev:  merge, dedup, sample hot hop 1             -> packed miss ids
      host: read them, sample the cold hop-1 rows
      dev:  merge, dedup, feature plan; hop 0 of batch i+1 -> packed
      host: read (plan statistics + miss ids | next hop-0 pack), stage rows
      dev:  train step (enqueued, not waited for)

    A packed array travels as in ``cache/pipeline.py``: a non-blocking
    copy into pinned memory and an event, and the host waits for that
    event only, never for the stream. Generator order within a step: hops
    1..H-1, the next batch's hop 0, then the train step's dropout.

    The device stages (``_start``, ``_step`` for each inner hop,
    ``_finish``, the train or eval step) are captured in ``pool`` when it
    captures (None: eager), one graph each, since one batch is in flight:
    each stage writes what the next reads into static buffers made
    outside the pool (``train/graphed.py``'s ``StageGraph``).

    The striped trainer (``cache/striped_hybrid.py``) runs this pipeline
    through its hooks: ``_uniform_shape``, ``_draw`` and ``_hot`` (a hop's
    uniforms and hot draws), ``_plan`` (the feature plan and statistics
    beyond it), ``_cold_seed`` (the host leg's seed), ``_sum_ranks`` (an
    epoch's figures over the ranks) and ``save`` (a mid-epoch
    checkpoint)."""

    save: Optional[Callable] = None

    n_stats = 4            # hit, miss, valid, staging overflow

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 topo: TopoCache, host_indptr: np.ndarray,
                 host_indices: np.ndarray, fcache: FeatureCache,
                 reducer: Optional[Callable] = None,
                 pool: Optional[GraphPool] = None):
        self.cfg = cfg
        self.model = model
        self.topo = topo
        self.device = topo.hot_ids.device
        self.host_indptr, self.host_indices = _host_csr(host_indptr,
                                                        host_indices)
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.caps = tuple(caps)
        self.fcache = fcache
        self.pool = pool
        self.runs: Dict = {}
        # host_topo_bytes: the cold draws' bytes (the reference's meter);
        # what the copies up carry, the -1 rows of hot and padding entries
        # included, is the counter host_topo_copied_bytes
        self.stats = {"hot": 0, "cold": 0, "host_topo_bytes": 0}
        self.train_from, self.eval_from = make_cache_step_fns(
            cfg, combine=lambda rows, plan, staged, frontier:
            fcache.combine(plan, staged, frontier), reducer=reducer)

    def release(self) -> None:
        """Drop the captured stages and their buffers."""
        self.runs.clear()

    # -- device stages ------------------------------------------------------

    def _uniform_shape(self, hop: int):
        return (self.caps[hop], self.fanouts[hop])

    def _draw(self, gens: Sequence[torch.Generator], hop: int) -> torch.Tensor:
        """Hop ``hop``'s uniforms drawn on the device from ``gens`` (one
        generator here)."""
        return torch.rand(self._uniform_shape(hop), generator=gens[0],
                          device=self.device, dtype=torch.float32)

    def _given(self, uniforms: Callable, step: int, hop: int) -> torch.Tensor:
        """``uniforms(step, hop)``, checked against the hop's shape."""
        u = uniforms(step, hop)
        shape = self._uniform_shape(hop)
        if tuple(u.shape) != shape or u.dtype != torch.float32:
            raise ValueError(f"uniforms({step}, {hop}) is {u.dtype} "
                             f"{tuple(u.shape)}, want float32 {shape}")
        return u

    def _hot(self, frontier, u, hop: int):
        """Hop ``hop``'s draws for the frontier's cache hits and the hit
        mask."""
        return self.topo.sample_hot(frontier, u)

    def _plan(self, frontier):
        """(the feature plan, () int32 statistics beyond the plan's)."""
        return self.fcache.plan(frontier), []

    def _cold_seed(self, seed: int) -> int:
        return seed

    def _sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """An epoch's figures as every rank holds them: here the one
        device's own."""
        return t

    @staticmethod
    def _pack_hop(frontier, hit):
        """[n_hot | miss ids (-1 where hot or padding)]: one read serves
        the host sampler and the hot / cold metering."""
        miss = torch.where(~hit & (frontier >= 0), frontier, -1)
        return torch.cat([hit.sum(dtype=torch.int32)[None], miss])

    def _start(self, seeds, num_seeds, u):
        """Hop 0's hot half: (carry, packed miss ids)."""
        frontier = torch.full((self.caps[0],), -1, dtype=torch.int32,
                              device=self.device)
        frontier[: seeds.shape[0]] = seeds
        nbrs_hot, hit = self._hot(frontier, u, 0)
        return ((frontier, num_seeds.to(torch.int32), nbrs_hot, hit),
                self._pack_hop(frontier, hit))

    def _step(self, k, carry, cold, u):
        """Close hop k-1 and open hop k (1 <= k < H): (carry, block,
        packed miss ids)."""
        frontier, num, nbrs_hot, hit = carry
        frontier, num, blk = grow_frontier(
            frontier, num, _merge(nbrs_hot, cold, hit), self.caps[k])
        nbrs_hot, hit = self._hot(frontier, u, k)
        return ((frontier, num, nbrs_hot, hit), blk,
                self._pack_hop(frontier, hit))

    def _finish(self, carry, cold, seeds_next, num_next, u_next):
        """Close the last hop, plan the feature cache, and open the next
        batch's hop 0; both packed arrays leave in one copy."""
        frontier, num, nbrs_hot, hit = carry
        frontier, num, blk = grow_frontier(
            frontier, num, _merge(nbrs_hot, cold, hit), self.caps[-1])
        plan, extra = self._plan(frontier)
        nxt, next_pack = self._start(seeds_next, num_next, u_next)
        packed = torch.cat([
            torch.stack([plan.num_hit, plan.num_miss, plan.num_valid,
                         plan.overflow()] + extra),
            plan.miss_ids, next_pack])
        return frontier, num, blk, plan, nxt, packed

    def _build(self, rows: int, width: int, gens, consume: Callable,
               consume_gens, injected: bool, out: torch.Tensor,
               label: str) -> Run:
        """A pass's static buffers and stages. Rows ``0 .. rows`` of the
        seeds (the last a copy of the first: the epoch's last finish
        opens step 0 again); ``run.at`` is the step the consume stage
        trains or evaluates next, which it advances. The hop-0 carry
        (``carry0``), which the prologue and every finish write, lives
        apart from the inner hops' outputs, which the train step of the
        same batch still reads when the finish opens the next batch. The
        sampling stages draw from ``gens`` unless the uniforms are given
        (``ubufs``); ``consume(run)`` (the span ``stage.<label>``) from
        ``consume_gens``. One pinned
        buffer serves each host leg (``cold_host`` a hop, ``packed`` a
        stage: start, inner hops, finish; ``staging``): the host writes
        or reads one only after waiting for a packed array that stream
        order puts after the last copy out of it."""
        dev, hops = self.device, len(self.fanouts)
        i32 = dict(dtype=torch.int32, device=dev)
        rows_d = self.fcache.rows
        run = Run(rows, width, None,
                  seeds=torch.full((rows + 1, width), -1, **i32),
                  labels=torch.full((rows + 1, width), -1, **i32),
                  nums=torch.zeros((rows + 1,), **i32),
                  at=torch.zeros((1,), dtype=torch.int64, device=dev),
                  ubufs=[torch.empty(self._uniform_shape(k),
                                     dtype=torch.float32, device=dev)
                         for k in range(hops)] if injected else None,
                  gens=gens, carry0=None, fin=None,
                  cold=[torch.empty((c, f), **i32)
                        for c, f in zip(self.caps, self.fanouts)],
                  cold_host=HostRing(dev, hops),
                  packed=HostRing(dev, hops + 1),
                  staged=torch.empty((self.fcache.miss_cap, rows_d.shape[1]),
                                     dtype=rows_d.dtype, device=dev),
                  staging=HostRing(dev), out=out)

        def u(hop):
            return run.ubufs[hop] if injected else self._draw(run.gens, hop)

        def start():
            i = run.at
            carry, pack = self._start(row_at(run.seeds, i),
                                      row_at(run.nums, i), u(0))
            run.carry0 = store(run.carry0, carry)
            return pack

        def hop(k):
            carry = run.carry0 if k == 1 else run.hops[k - 2].out[0]
            return self._step(k, carry, run.cold[k - 1], u(k))

        def finish():
            carry = run.carry0 if hops == 1 else run.hops[-1].out[0]
            i = run.at + 1
            frontier, num, blk, plan, nxt, packed = self._finish(
                carry, run.cold[-1], row_at(run.seeds, i),
                row_at(run.nums, i), u(0))
            run.fin = store(run.fin, (frontier, num, blk, plan, packed))
            # last: with one hop the block's dst count is the carry's
            store(run.carry0, nxt)

        def step():
            consume(run)
            run.at.add_(1)

        draws = () if injected else tuple(gens)
        run.start = StageGraph(start, self.pool, draws, "start")
        run.hops = [StageGraph(functools.partial(hop, k), self.pool, draws,
                               f"hop{k}")
                    for k in range(1, hops)]
        run.finish = GraphedStep(finish, self.pool, draws, "finish")
        run.step = GraphedStep(step, self.pool, consume_gens, label)
        return run

    def _batch(self, run: Run):
        """(the batch of step ``run.at``, its plan) from the run's static
        buffers, as the consume stage reads them."""
        frontier, num, blk, plan, _ = run.fin
        blocks = tuple(h.out[1] for h in run.hops) + (blk,)
        batch = SampledBatch(
            seeds=row_at(run.seeds, run.at), labels=row_at(run.labels, run.at),
            num_seeds=row_at(run.nums, run.at), frontier=frontier,
            num_frontier=num, blocks=blocks)
        return batch, plan

    def _train_stage(self, state: TrainState, run: Run) -> None:
        batch, plan = self._batch(run)
        step = state.step
        loss = self.train_from(state, self.fcache.rows, batch, plan,
                               run.staged)
        # the host counts the step (``run_epoch``): a replay runs no Python
        state.step = step
        # ids a static cap dropped thin the neighborhoods silently:
        # counted as train.loop's ``cap_overflow`` is
        edges = torch.stack([blk.num_edges() for blk in batch.blocks]).sum()
        overflow = sum((blk.num_src - cap).clamp(min=0)
                       for blk, cap in zip(batch.blocks, self.caps[1:]))
        row = torch.stack([loss.to(torch.float64), edges.to(torch.float64),
                           overflow.to(torch.float64)])
        run.out.index_copy_(0, run.at, row[None])

    def _eval_stage(self, model: torch.nn.Module, run: Run) -> None:
        batch, plan = self._batch(run)
        a, b = self.eval_from(model, self.fcache.rows, batch, plan,
                              run.staged)
        run.out.add_(torch.stack([a, b]).float())

    def _run(self, kind: str, source, owner, steps: int, width: int,
             consume: Callable, consume_gens, out: Callable):
        """(the run that serves a pass of ``steps`` rows whose sampling
        draws from ``source``, the generators it borrows from). The
        source: a callable's uniforms, the state's generator itself
        (``owner.generator``: dropout and sampling then interleave on it
        as the eager steps do), or other generators, which lend their
        state to generators of the run's own for the pass
        (``graphed.lend``), so that the run's graphs serve every pass."""
        injected = callable(source) and not isinstance(
            source, (torch.Generator, list, tuple))
        own = isinstance(owner, TrainState) and source is owner.generator
        draw = "given" if injected else "state" if own else "lent"
        n_gens = (0 if injected else 1 if isinstance(source, torch.Generator)
                  else len(source))

        def build(rows):
            gens = ([] if injected else [owner.generator] if own else
                    [torch.Generator(device=self.device)
                     for _ in range(n_gens)])
            return self._build(rows, width, gens, consume, consume_gens,
                               injected, out(rows), f"{kind}_from")
        run = serving_run(self.runs, (kind, draw, n_gens), steps, width,
                          run_ties(owner, self._tables()), build)
        if draw != "lent":
            return run, []
        return run, ([source] if isinstance(source, torch.Generator)
                     else list(source))

    def _tables(self):
        return (self.topo.hot_ids, self.topo.sub_indptr,
                self.topo.sub_indices, self.fcache.rows, self.fcache.hot_ids)

    # -- host legs ----------------------------------------------------------

    def _fetch(self, ring: HostRing, slot: int) -> np.ndarray:
        trace.count("fetches", 1)
        with trace.span("hybrid.fetch"):
            return ring.numpy(slot)

    def _cold(self, run: Run, hop: int, miss_pack: np.ndarray, fanout: int,
              seed: int) -> None:
        """miss_pack: [n_hot | miss ids]. The host sampler's draws for the
        misses, written into the hop's pinned buffer and copied into its
        static device buffer. The whole (caps[k], fanout) buffer goes up,
        not the cold rows compacted: both sizes are metered. One pinned
        buffer a hop serves: the host writes it only after waiting for a
        packed array that stream order puts after the last copy out of
        it."""
        miss = miss_pack[1:]
        host = run.cold_host.buffer(hop, (miss.shape[0], fanout),
                                    torch.int32)
        with trace.span("hybrid.host_sample"):
            runtime.sample_neighbors(self.host_indptr, self.host_indices,
                                     miss, fanout, self._cold_seed(seed),
                                     out=host.numpy())
        n_cold = int((miss >= 0).sum())
        self.stats["hot"] += int(miss_pack[0])
        self.stats["cold"] += n_cold
        self.stats["host_topo_bytes"] += n_cold * fanout * 4
        trace.count("host_topo_copied_bytes", host.numel() * 4)
        trace.count("h2d_bytes", host.numel() * 4)
        run.cold[hop].copy_(host, non_blocking=run.cold_host.cuda)

    def _uniforms_for(self, run: Run, uniforms, step: int, hop: int) -> None:
        if uniforms is not None:
            run.ubufs[hop].copy_(self._given(uniforms, step, hop))

    def _prologue(self, run: Run, uniforms) -> np.ndarray:
        """The pass's first hop-0 stage and its packed read."""
        self._uniforms_for(run, uniforms, 0, 0)
        run.packed.fetch(0, run.start())
        return self._fetch(run.packed, 0)

    def _advance(self, run: Run, packed0: np.ndarray, step: int,
                 seed_base: int, uniforms, next_step: int):
        """Hops 1..H-1 and the finish stage of the batch whose hop-0 state
        is in ``run.carry0`` / ``packed0``, with the staged rows on their
        way up (the span ``pipeline.stage``). Returns (plan statistics, the
        next batch's packed0): views of the host ring, read before their
        slots' next fetch."""
        hops = len(self.fanouts)
        for k in range(1, hops):
            self._cold(run, k - 1, packed0, self.fanouts[k - 1],
                       seed_base * 131 + k - 1)
            self._uniforms_for(run, uniforms, step, k)
            run.packed.fetch(k, run.hops[k - 1]()[2])
            packed0 = self._fetch(run.packed, k)
        self._cold(run, hops - 1, packed0, self.fanouts[-1],
                   seed_base * 131 + hops - 1)
        self._uniforms_for(run, uniforms, next_step, 0)
        run.finish()
        run.packed.fetch(hops, run.fin[-1])
        with trace.span("pipeline.stage"):
            fused = self._fetch(run.packed, hops)
            miss_cap, ns = self.fcache.miss_cap, self.n_stats
            fstats = fused[:ns]
            # the staged rows: one pinned buffer and one device buffer
            # serve, as the last copy out of them went before the last
            # train step
            self.fcache.stage_to(
                self.device, fused[ns:ns + min(int(fstats[1]), miss_cap)],
                run.staged, run.staging.buffer(0, run.staged.shape,
                                               run.staged.dtype))
        return fstats, fused[ns + miss_cap:]

    @staticmethod
    def _load(run: Run, seeds: np.ndarray, nums, labels: np.ndarray) -> None:
        """A pass's rows into the run (row ``steps`` repeats row 0;
        ``h2d_bytes``) and its step to 0: the span ``epoch.load``."""
        with trace.span("epoch.load"):
            steps = seeds.shape[0]
            for buf, x in ((run.seeds, seeds), (run.nums, nums),
                           (run.labels, labels)):
                x = torch.from_numpy(np.ascontiguousarray(x, np.int32))
                buf[:steps].copy_(x)
                buf[steps].copy_(x[0])
                trace.count("h2d_bytes", (x.numel() + x[0].numel()) * 4)
            run.at.zero_()

    def run_epoch(self, state: TrainState, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray, epoch: int,
                  uniforms: Optional[Callable] = None) -> Dict:
        """One epoch over (steps, batch) seeds and labels. Device uniforms
        and dropout draw from ``state.generator`` (``uniforms(step, hop)``
        replaces the former in parity tests); the host legs of step i are
        seeded ``(epoch * 1_000_003 + i) * 131 + hop``. The hot / cold /
        byte / fetch figures are this epoch's, not the trainer's running
        totals; ``host_topo_gb`` counts the cold draws alone, as the
        reference does, and ``host_topo_copied_gb`` the buffers that
        carry them up. The epoch is a ``train`` root: ``seconds`` is its
        time up to the record, ``stage_s``, ``fetch_s`` and
        ``host_sample_s`` its ``pipeline.stage``, ``hybrid.fetch`` and
        ``hybrid.host_sample`` seconds, ``fetches`` its count; the record
        carries its ``spans`` and ``counts``."""
        steps, b = seeds_epoch.shape
        dev = self.device
        source = uniforms if uniforms is not None else state.generator
        with trace.epoch("train") as root:
            root.steps = steps
            tally = root.tally
            stats0 = dict(self.stats)
            tot = np.zeros(self.n_stats, np.int64)   # hit, miss, valid, ...
            row_bytes = (self.fcache.rows.shape[1]
                         * self.fcache.rows.element_size())
            host_rows = 0
            if steps:
                with trace.span("epoch.prepare"):
                    run, lent = self._run(
                        "train", source, state, steps, b,
                        functools.partial(self._train_stage, state),
                        (state.generator,),
                        # a row past the last step's: a capture records
                        # the step after its warm-up's
                        lambda rows: torch.zeros((rows + 1, 3),
                                                 dtype=torch.float64,
                                                 device=dev))
                    self._load(run, seeds_epoch, np.full(steps, b),
                               labels_epoch)
                given = uniforms if run.ubufs is not None else None
                with trace.span("epoch.steps"), \
                        lend(run.gens if lent else [], lent):
                    packed0 = self._prologue(run, given)
                    for i in range(steps):
                        fstats, packed0 = self._advance(
                            run, packed0, i, epoch * 1_000_003 + i, given,
                            (i + 1) % steps)
                        # batch i+1's hop-0 host leg runs at the top of the
                        # next iteration, while the device still trains on
                        # batch i
                        run.step()
                        state.step += 1
                        tot += fstats
                        host_rows += min(int(fstats[1]),
                                         self.fcache.miss_cap)
                        maybe_checkpoint_step(self.cfg.train, state, i,
                                              self.save)
                # Adam's state exists now
                run.ties = run_ties(state, self._tables())

            with trace.span("epoch.read"):
                # the epoch's one read besides the packed arrays: losses,
                # the device counts and the host figures, summed over the
                # ranks
                d = {k: self.stats[k] - stats0[k] for k in self.stats}
                host = [*tot, host_rows] + [d[k] for k in (
                    "hot", "cold", "host_topo_bytes")] + [
                    tally.counts.get("host_topo_copied_bytes", 0)]
                f64 = dict(dtype=torch.float64, device=dev)
                up = torch.tensor(host, dtype=torch.float64)
                trace.count("h2d_bytes", up.numel() * up.element_size())
                summed = self._sum_ranks(torch.cat([
                    run.out[:steps, 0] if steps else torch.zeros(0, **f64),
                    run.out[:steps, 1:].sum(0) if steps
                    else torch.zeros(2, **f64),
                    up.to(dev)])).cpu()
            with trace.span("epoch.record"):
                loss_h = summed[:steps].to(torch.float32).numpy()
                n_edges, cap_overflow, *host = summed[steps:].to(
                    torch.int64).tolist()
                ns = self.n_stats
                tot, host_rows = host[:ns], host[ns]
                hot, cold, topo_b, copied_b = host[ns + 1:]
                dt = root.elapsed()
                rec = {
                    "state": state, "steps": steps, "seconds": dt,
                    "loss": float(loss_h[-1]) if steps else float("nan"),
                    "losses": loss_h.tolist(),
                    "feat_hit_rate": int(tot[0]) / max(int(tot[2]), 1),
                    "staging_overflow": int(tot[3]),
                    "host_feat_gb": host_rows * row_bytes / 2 ** 30,
                    "host_topo_gb": topo_b / 2 ** 30,
                    "host_topo_copied_gb": copied_b / 2 ** 30,
                    "topo_hot_fraction": hot / max(hot + cold, 1),
                    "fetches": tally.counts.get("fetches", 0),
                    "cap_overflow": cap_overflow,
                    "edges": n_edges, "edges_per_s": n_edges / dt,
                    "stage_s": trace.seconds(tally, "pipeline.stage"),
                    "host_sample_s": trace.seconds(tally,
                                                   "hybrid.host_sample"),
                    "fetch_s": trace.seconds(tally, "hybrid.fetch"),
                    **self._extra(tot),
                }
        rec["spans"], rec["counts"] = root.entry["spans"], root.entry["counts"]
        return rec

    def _extra(self, tot) -> Dict:
        """Figures of a subclass's own statistics."""
        return {}

    def eval_epoch(self, model: torch.nn.Module, seeds: np.ndarray,
                   counts: np.ndarray, labels: np.ndarray,
                   uniforms: Optional[Uniforms] = None) -> float:
        """Accuracy (for ``lp_sage`` the mean LP loss per valid pair) over
        (steps, batch) eval seeds through the hybrid sampling and cached
        feature path, with ``run_epoch``'s structure and fetch budget,
        summed on the device: one more read for the epoch. The host legs
        of step t are seeded ``(777_000 + t) * 131 + hop``; the device
        uniforms come from a generator seeded 4242 unless given."""
        dev = self.device
        steps, b = seeds.shape
        if steps == 0:
            return float("nan")
        source = (uniforms if uniforms is not None else
                  torch.Generator(device=dev).manual_seed(4242))
        with trace.epoch("eval") as root:
            root.steps = steps
            with trace.span("epoch.prepare"):
                run, lent = self._run(
                    "eval", source, model, steps, b,
                    functools.partial(self._eval_stage, model), (),
                    lambda rows: torch.zeros(2, dtype=torch.float32,
                                             device=dev))
                self._load(run, seeds, counts, labels)
                run.out.zero_()
            given = source if run.ubufs is not None else None
            with trace.span("epoch.steps"), \
                    lend(run.gens if lent else [], lent):
                packed0 = self._prologue(run, given)
                for t in range(steps):
                    _, packed0 = self._advance(run, packed0, t, 777_000 + t,
                                               given, (t + 1) % steps)
                    run.step()
            run.ties = run_ties(model, self._tables())
            with trace.span("epoch.read"):
                a, b = self._sum_ranks(run.out.clone()).tolist()
        return a / max(b, 1.0)
