"""The port's ops. Importing this package registers the hand kernels as
the ``bevfusion::`` custom ops (``library.py``)."""
from . import library  # noqa: F401
