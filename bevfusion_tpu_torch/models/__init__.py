"""Model zoo of the port: importing this package registers every component."""
from . import bevdepth  # noqa: F401
from . import bevfusion  # noqa: F401
from . import fusers  # noqa: F401
from . import necks  # noqa: F401
from . import pillar_encoder  # noqa: F401
from . import radar_encoder  # noqa: F401
from . import resnet  # noqa: F401
from . import second  # noqa: F401
from . import sparse_encoder  # noqa: F401
from . import swin  # noqa: F401
from . import vtransforms  # noqa: F401
from .heads import centerpoint  # noqa: F401
from .heads import segm  # noqa: F401
from .heads import transfusion  # noqa: F401

from ..devices import resolve_device
from ..registry import FUSIONMODELS


def build_model(model_cfg, device="cuda"):
    """Build the top-level model from the ``model`` tree of a config
    (``bevfusion_tpu_torch.config.load_config(path).model``), on
    ``device`` (the card unless the caller passes ``"cpu"``), in eval
    mode."""
    dev = resolve_device(device)
    return FUSIONMODELS.build(dict(model_cfg)).to(dev).eval()
