"""The benchmark of ``legion_tpu_torch``: one cell (a configuration under a
traffic mix) a run, driven by the files under this folder.

    python3 -m gnnbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Nothing here imports JAX or the JAX package; the reference that decides
``correct`` (``reference.py``) imports nothing of the port either.
"""
