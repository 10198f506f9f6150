"""BEVFusion in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The layout mirrors ``bevfusion_tpu`` (``ops/``, ``core/``, ``models/``,
``models/heads/``, ``runtime/``) so each module's counterpart is found
under the same name. Importing this package imports neither JAX nor the
JAX package; kernels are compiled at first use, never at import.
"""
