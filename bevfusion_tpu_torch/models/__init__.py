"""Model zoo of the port: importing this package registers every component."""
from . import bevfusion  # noqa: F401
from . import fusers  # noqa: F401
from . import necks  # noqa: F401
from . import second  # noqa: F401
from . import sparse_encoder  # noqa: F401
from . import swin  # noqa: F401
from . import vtransforms  # noqa: F401
from .heads import transfusion  # noqa: F401

from ..registry import FUSIONMODELS


def build_model(model_cfg, device="cpu"):
    """Build the top-level model from the ``model`` tree of a config
    (``bevfusion_tpu_torch.config.load_config(path).model``), on
    ``device``, in eval mode."""
    return FUSIONMODELS.build(dict(model_cfg)).to(device).eval()
