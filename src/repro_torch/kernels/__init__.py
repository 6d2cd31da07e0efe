"""Hopper kernels of the PyTorch port: CUDA C++ sources under ``csrc/``,
their launchers, their plain PyTorch versions (``ref.py``) and the public
wrappers (``ops.py``)."""
