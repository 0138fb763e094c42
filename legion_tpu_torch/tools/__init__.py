"""Measurement tools of the port, run on a machine with the card.

* ``pa_cell``: the cached path at papers100M class, the configuration and
  cached dataset that ``chip_smoke.py``'s phase 6 and ``profile_cached``
  share;
* ``profile_cached``: that cell's steady-state breakdown under
  ``torch.profiler`` (``python -m legion_tpu_torch.tools.profile_cached``);
* ``ab_trainer.py``: a main-path A/B of two checkouts on the same saved
  graph (run as a script, see its docstring);
* ``k2_bench.py``: K2's forward, backward and the backward's three passes
  at the shapes the port runs them at, of this checkout or another one
  (run as a script, see its docstring).
"""
