"""Measurement tools of the port, run on a machine with the card.

* ``pa_cell``: the cached path at papers100M class, the configuration and
  cached dataset that ``chip_smoke.py``'s phase 6 and ``profile_cached``
  share;
* ``profile_cached``: that cell's steady-state breakdown under
  ``torch.profiler`` (``python -m legion_tpu_torch.tools.profile_cached``);
* ``k2_bench.py``: K2's forward, backward and the backward's three passes
  at the shapes the port runs them at, of this checkout or another one
  (run as a script, see its docstring);
* ``k4_bench.py``: the sampling kernel (K4's counterpart) at every
  path's hop shapes with a warm and a cold L2, of this checkout or
  another one (run as a script, see its docstring); its
  ``ragged_cases()`` are the kernel's edge cases, which ``chip_smoke.py``
  and the ``cuda`` test hold it to;
* ``cache_group_cell``: the three cache-group paths at cache axis 2
  against cache axis 1 on two ranks, sharing one card where there is one
  (``python -m legion_tpu_torch.tools.cache_group_cell OUT.json``;
  ``chip_smoke.py``'s ``mesh_striped_k2``);
* ``partition_cell``: the edge-partitioned path at 2 ranks (exact
  exchange against psum) and at 1 rank, the same way
  (``python -m legion_tpu_torch.tools.partition_cell OUT.json``;
  ``chip_smoke.py``'s ``mesh_partitioned_k2``);
* ``parity_ogb``: the OGB accuracy-parity harness: convert, train, one
  JSON verdict line (``python -m legion_tpu_torch.tools.parity_ogb``);
* ``products_cell``: a stand-in for ``ogb.nodeproppred`` serving an
  ogbn-products-shaped graph made from a seed (``chip_smoke.py``'s
  ``ogb_products``).
"""
