"""The host-side data pipeline (numpy), copied from ``bevfusion_tpu/data``."""
