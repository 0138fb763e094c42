"""legion_tpu_torch — the PyTorch / CUDA port of ``legion_tpu``.

The port mirrors ``legion_tpu``'s package layout so each module has a
counterpart under the same name. Plain tensor code is PyTorch; every
kernel that ``legion_tpu`` wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (``csrc/``), built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/_build.py``). Each kernel has a plain
PyTorch version beside it, which a tensor on the CPU goes through.

``legion_tpu`` stays the reference: the port imports nothing of it, and
never ``jax``, ``flax``, ``optax`` or ``orbax``; numpy copies of its
configuration, dataset format and synthetic graphs live under ``config``
and ``data``. ``tools`` holds the measurement scripts run on the card.
"""

__version__ = "0.1.0"
