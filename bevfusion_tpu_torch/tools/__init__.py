"""The port's measurement entry points, counterparts of the JAX package's
``tools/``: ``tools/X.py`` there is ``bevfusion_tpu_torch/tools/X.py`` here,
run as ``python -m bevfusion_tpu_torch.tools.X`` (on the card unless
``--device cpu``). Each splits into functions that take a model, a batch
and a device or tensors (the tests call them on the CPU at tiny sizes,
``chip_smoke.py`` on the model it holds) and a ``main(argv)`` that builds
the full-width flagship."""
