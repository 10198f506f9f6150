"""The host-side data layer (numpy), copied from ``bevfusion_tpu/data``:
datasets, pipeline transforms (``ObjectPaste`` in ``dbsampler``), loader.
Importing it registers every pipeline step and dataset."""
from . import dbsampler  # noqa: F401
from . import loading  # noqa: F401
from . import transforms  # noqa: F401
from .loader import DataLoader, collate  # noqa: F401
from .nuscenes import CBGSDataset, NuScenesDataset, build_dataset  # noqa: F401
from .points import LiDARPoints  # noqa: F401
