"""Where the port's tensors live.

Entry points run on the card. Without one they raise, unless the caller
asked for the CPU, either per call (``device="cpu"``) or for the process
(``set_default_device("cpu")``, which the CPU tests use). No code path
moves to the CPU by itself.
"""

import torch

_default = None


def set_default_device(device):
    """Make ``device`` (e.g. ``"cpu"``) the default for the process;
    ``None`` restores the rule "the card, or raise"."""
    global _default
    _default = None if device is None else torch.device(device)


def default_device():
    """The process default: ``cuda`` unless ``set_default_device`` chose
    another. Raises when that is ``cuda`` and no card is present."""
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or call "
            "cornac_tpu_torch.set_default_device('cpu') to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None):
    """``torch.device`` for an explicit request, else the default."""
    return default_device() if device is None else torch.device(device)
