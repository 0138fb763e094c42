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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from legion_tpu_torch import runtime
from legion_tpu_torch.cache.feature_cache import FeatureCache
from legion_tpu_torch.cache.pipeline import _Packed, make_cache_step_fns
from legion_tpu_torch.cache.topo_cache import TopoCache
from legion_tpu_torch.config import Config
from legion_tpu_torch.sampling.block import SampledBatch
from legion_tpu_torch.sampling.sampler import grow_frontier
from legion_tpu_torch.train.train_state import (TrainState,
                                                maybe_checkpoint_step)

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
    feature rows). Reads are counted in ``stats["fetches"]``: H a step and
    one for the epoch's prologue.

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

    The striped trainer (``cache/striped_hybrid.py``) runs this pipeline
    through its hooks: ``_uniform`` and ``_hot`` (a hop's uniforms and hot
    draws), ``_plan`` (the feature plan and statistics beyond it),
    ``_cold_seed`` (the host leg's seed), ``_sum_ranks`` (an epoch's
    figures over the ranks) and ``save`` (a mid-epoch checkpoint)."""

    save: Optional[Callable] = None

    n_stats = 4            # hit, miss, valid, staging overflow

    def __init__(self, cfg: Config, model: torch.nn.Module, caps,
                 topo: TopoCache, host_indptr: np.ndarray,
                 host_indices: np.ndarray, fcache: FeatureCache,
                 reducer: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.topo = topo
        self.device = topo.hot_ids.device
        self.host_indptr, self.host_indices = _host_csr(host_indptr,
                                                        host_indices)
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.caps = tuple(caps)
        self.fcache = fcache
        # host_topo_bytes: the cold draws' bytes (the reference's meter);
        # host_topo_copied_bytes: what the copies up carry, the -1 rows of
        # hot and padding entries included
        self.stats = {"hot": 0, "cold": 0, "host_topo_bytes": 0,
                      "host_topo_copied_bytes": 0, "fetches": 0,
                      "host_sample_s": 0.0, "fetch_s": 0.0}
        self.train_from, self.eval_from = make_cache_step_fns(
            cfg, combine=lambda rows, plan, staged, frontier:
            fcache.combine(plan, staged, frontier), reducer=reducer)

    # -- device stages ------------------------------------------------------

    def _uniform(self, source: Uniforms, step: int, hop: int) -> torch.Tensor:
        shape = (self.caps[hop], self.fanouts[hop])
        if isinstance(source, torch.Generator):
            return torch.rand(shape, generator=source, device=self.device,
                              dtype=torch.float32)
        u = source(step, hop)
        if tuple(u.shape) != shape or u.dtype != torch.float32:
            raise ValueError(f"uniforms({step}, {hop}) is {u.dtype} "
                             f"{tuple(u.shape)}, want float32 {shape}")
        return u.to(self.device)

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
        """Hop 0's hot half: (carry, packed miss ids still on the device)."""
        frontier = torch.full((self.caps[0],), -1, dtype=torch.int32,
                              device=self.device)
        frontier[: seeds.shape[0]] = seeds
        nbrs_hot, hit = self._hot(frontier, u, 0)
        return ((frontier, num_seeds.to(torch.int32), nbrs_hot, hit),
                self._pack_hop(frontier, hit))

    def _step(self, k, carry, cold, u):
        """Close hop k-1 and open hop k (1 <= k < H)."""
        frontier, num, nbrs_hot, hit = carry
        frontier, num, blk = grow_frontier(
            frontier, num, _merge(nbrs_hot, cold, hit), self.caps[k])
        nbrs_hot, hit = self._hot(frontier, u, k)
        return ((frontier, num, nbrs_hot, hit), blk,
                _Packed(self._pack_hop(frontier, hit)))

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
        return frontier, num, blk, plan, nxt, _Packed(packed)

    # -- host legs ----------------------------------------------------------

    def _fetch(self, packed: _Packed) -> np.ndarray:
        self.stats["fetches"] += 1
        t = time.perf_counter()
        out = packed.numpy()
        self.stats["fetch_s"] += time.perf_counter() - t
        return out

    def _cold(self, miss_pack: np.ndarray, fanout: int,
              seed: int) -> torch.Tensor:
        """miss_pack: [n_hot | miss ids]. The host sampler's draws for the
        misses, written into pinned memory and on their way to the
        device. The whole (caps[k], fanout) buffer goes up, not the cold
        rows compacted: both sizes are metered."""
        miss = miss_pack[1:]
        on_cuda = self.device.type == "cuda"
        host = torch.empty((miss.shape[0], fanout), dtype=torch.int32,
                           pin_memory=on_cuda)
        t = time.perf_counter()
        runtime.sample_neighbors(self.host_indptr, self.host_indices, miss,
                                 fanout, self._cold_seed(seed),
                                 out=host.numpy())
        self.stats["host_sample_s"] += time.perf_counter() - t
        n_cold = int((miss >= 0).sum())
        self.stats["hot"] += int(miss_pack[0])
        self.stats["cold"] += n_cold
        self.stats["host_topo_bytes"] += n_cold * fanout * 4
        self.stats["host_topo_copied_bytes"] += host.numel() * 4
        return host.to(self.device, non_blocking=True) if on_cuda else host

    def _advance(self, carry, packed0: np.ndarray, step: int, seed_base: int,
                 source: Uniforms, next_step: int, seeds_next, num_next):
        """Hops 1..H-1 and the finish stage of the batch whose hop-0 state
        is ``carry`` / ``packed0``. Returns (blocks, frontier, num, plan,
        plan statistics, staged rows, host seconds fetching the plan and
        staging, next carry, next packed0)."""
        hops = len(self.fanouts)
        blocks = []
        for k in range(1, hops):
            cold = self._cold(packed0, self.fanouts[k - 1],
                              seed_base * 131 + k - 1)
            carry, blk, packed = self._step(
                k, carry, cold, self._uniform(source, step, k))
            blocks.append(blk)
            packed0 = self._fetch(packed)
        cold = self._cold(packed0, self.fanouts[-1],
                          seed_base * 131 + hops - 1)
        frontier, num, blk, plan, nxt, packed = self._finish(
            carry, cold, seeds_next, num_next,
            self._uniform(source, next_step, 0))
        blocks.append(blk)
        t = time.perf_counter()
        fused = self._fetch(packed)
        miss_cap, ns = self.fcache.miss_cap, self.n_stats
        fstats = fused[:ns]
        staged = self.fcache.stage_to(
            self.device, fused[ns:ns + min(int(fstats[1]), miss_cap)])
        stage_s = time.perf_counter() - t
        return (blocks, frontier, num, plan, fstats, staged, stage_s, nxt,
                fused[ns + miss_cap:])

    def _prologue(self, seeds, num_seeds, source: Uniforms):
        carry, pack = self._start(seeds, num_seeds,
                                  self._uniform(source, 0, 0))
        return carry, self._fetch(_Packed(pack))

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
        carry them up."""
        steps, b = seeds_epoch.shape
        dev = self.device
        source = uniforms if uniforms is not None else state.generator
        t0 = time.perf_counter()
        stats0 = dict(self.stats)
        seeds_d = torch.from_numpy(np.ascontiguousarray(
            seeds_epoch, np.int32)).to(dev)
        labels_d = torch.from_numpy(np.ascontiguousarray(
            labels_epoch, np.int32)).to(dev)
        nb = torch.full((), b, dtype=torch.int32, device=dev)
        losses, counts = [], []              # counts: edges, cap overflow
        tot = np.zeros(self.n_stats, np.int64)   # hit, miss, valid, ...
        row_bytes = (self.fcache.rows.shape[1]
                     * self.fcache.rows.element_size())
        host_rows, stage_s = 0, 0.0

        if steps:
            carry, packed0 = self._prologue(seeds_d[0], nb, source)
        for i in range(steps):
            nxt = (i + 1) % steps
            (blocks, frontier, num, plan, fstats, staged, dt_stage, carry,
             packed0) = self._advance(carry, packed0, i,
                                      epoch * 1_000_003 + i, source, nxt,
                                      seeds_d[nxt], nb)
            batch = SampledBatch(seeds=seeds_d[i], labels=labels_d[i],
                                 num_seeds=nb, frontier=frontier,
                                 num_frontier=num, blocks=tuple(blocks))
            # batch i+1's hop-0 host leg runs at the top of the next
            # iteration, while the device still trains on batch i
            losses.append(self.train_from(state, self.fcache.rows, batch,
                                          plan, staged))
            # ids a static cap dropped thin the neighborhoods silently:
            # counted as train.loop's ``cap_overflow`` is
            counts.append(torch.stack([
                torch.stack([blk.num_edges() for blk in blocks]).sum(),
                sum((blk.num_src - cap).clamp(min=0)
                    for blk, cap in zip(blocks, self.caps[1:]))]))
            tot += fstats
            host_rows += min(int(fstats[1]), self.fcache.miss_cap)
            stage_s += dt_stage
            maybe_checkpoint_step(self.cfg.train, state, i, self.save)

        # the epoch's one read besides the packed arrays: losses, the
        # device counts and the host figures, summed over the ranks
        d = {k: self.stats[k] - stats0[k] for k in self.stats}
        host = [*tot, host_rows] + [d[k] for k in (
            "hot", "cold", "host_topo_bytes", "host_topo_copied_bytes")]
        f64 = dict(dtype=torch.float64, device=dev)
        summed = self._sum_ranks(torch.cat([
            torch.stack(losses).to(torch.float64) if losses
            else torch.zeros(0, **f64),
            torch.stack(counts).to(torch.float64).sum(0) if counts
            else torch.zeros(2, **f64),
            torch.tensor(host, **f64)])).cpu()
        loss_h = summed[:steps].to(torch.float32).numpy()
        n_edges, cap_overflow, *host = summed[steps:].to(
            torch.int64).tolist()
        ns = self.n_stats
        tot, host_rows = host[:ns], host[ns]
        hot, cold, topo_b, copied_b = host[ns + 1:]
        dt = time.perf_counter() - t0
        return {
            "state": state, "steps": steps, "seconds": dt,
            "loss": float(loss_h[-1]) if steps else float("nan"),
            "losses": loss_h.tolist(),
            "feat_hit_rate": int(tot[0]) / max(int(tot[2]), 1),
            "staging_overflow": int(tot[3]),
            "host_feat_gb": host_rows * row_bytes / 2 ** 30,
            "host_topo_gb": topo_b / 2 ** 30,
            "host_topo_copied_gb": copied_b / 2 ** 30,
            "topo_hot_fraction": hot / max(hot + cold, 1),
            "fetches": d["fetches"], "cap_overflow": cap_overflow,
            "edges_per_s": n_edges / dt, "stage_s": stage_s,
            "host_sample_s": d["host_sample_s"], "fetch_s": d["fetch_s"],
            **self._extra(tot),
        }

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
        steps = seeds.shape[0]
        if steps == 0:
            return float("nan")
        source = (uniforms if uniforms is not None else
                  torch.Generator(device=dev).manual_seed(4242))
        seeds_d = torch.from_numpy(np.ascontiguousarray(seeds, np.int32)
                                   ).to(dev)
        counts_d = torch.from_numpy(np.ascontiguousarray(counts, np.int32)
                                    ).to(dev)
        labels_d = torch.from_numpy(np.ascontiguousarray(labels, np.int32)
                                    ).to(dev)
        acc = torch.zeros(2, dtype=torch.float32, device=dev)
        carry, packed0 = self._prologue(seeds_d[0], counts_d[0], source)
        for t in range(steps):
            nxt = (t + 1) % steps
            (blocks, frontier, num, plan, _, staged, _, carry,
             packed0) = self._advance(carry, packed0, t, 777_000 + t, source,
                                      nxt, seeds_d[nxt], counts_d[nxt])
            batch = SampledBatch(seeds=seeds_d[t], labels=labels_d[t],
                                 num_seeds=counts_d[t], frontier=frontier,
                                 num_frontier=num, blocks=tuple(blocks))
            a, b = self.eval_from(model, self.fcache.rows, batch, plan,
                                  staged)
            acc.add_(torch.stack([a, b]).float())
        a, b = self._sum_ranks(acc).tolist()
        return a / max(b, 1.0)
