"""Model loading for evaluation; counterpart of
wespeaker_tpu/bin/extract.py::load_model_for_eval. The extraction CLI
itself is not ported yet."""

from typing import Any, Dict

import torch.nn as nn

from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.train.composite import build_model
from wespeaker_tpu_torch.utils.weights import load_checkpoint


def load_model_for_eval(configs: Dict[str, Any], checkpoint_path: str,
                        device: DeviceLike = None) -> nn.Module:
    """config + `.pt` checkpoint -> the model on `device`, in eval mode.
    The checkpoint is a model state_dict (port or upstream) or a file the
    trainer (bin/train.py) wrote, whose model part is read."""
    dev = resolve_device(device)
    model = load_checkpoint(build_model(configs), checkpoint_path)
    return model.to(dev).eval()
