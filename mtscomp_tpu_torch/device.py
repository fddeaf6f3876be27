"""Device selection for the port: an explicit ``torch.device``, never a
silent fallback.

``'cuda'`` (or ``'cuda:N'``) runs the hand-written Hopper kernels and
raises when no GPU is visible; ``'cpu'`` runs each kernel's plain PyTorch
twin (what the CPU test suite uses). The ``device`` key of the
configuration also takes ``'none'`` (the host codec, no device) and
``'auto'``: ``'cuda'`` where a GPU is visible, else ``'none'``, decided
when the file is opened (:func:`configured_device`). Any other name is
refused before torch sees it. Nothing here is process-global: every
entry point takes the device it should run on.
"""

import re

import torch

#: What the ``device`` key of the configuration may hold.
CONFIG_DEVICES = "'cuda', 'cuda:N', 'cpu', 'none' or 'auto'"

_DEVICE_NAME = re.compile(r'cpu|cuda(:\d+)?')


def resolve_device(device):
    """Validate ``device`` (``'cuda'``, ``'cuda:N'``, ``'cpu'`` or a
    ``torch.device`` of those types) and return it as a ``torch.device``.

    Raises ``ValueError`` for any other name or device type, and
    ``RuntimeError`` for a CUDA device that does not exist here.
    """
    if isinstance(device, str):
        if not _DEVICE_NAME.fullmatch(device):
            raise ValueError(
                "unknown device %r: mtscomp_tpu_torch runs on 'cuda' (the "
                "GPU kernels; 'cuda:N' picks a card) or 'cpu' (their plain "
                "PyTorch twins). The device key of the configuration takes "
                "%s; a file written for the JAX package with another name "
                "(such as 'tpu') should say 'auto' or 'cuda' instead."
                % (device, CONFIG_DEVICES))
        dev = torch.device(device)
    elif isinstance(device, torch.device):
        dev = device
    else:
        raise ValueError("device must be a name or a torch.device, not %r"
                         % (device,))
    if dev.type == 'cpu':
        return dev
    if dev.type != 'cuda':
        raise ValueError("mtscomp_tpu_torch runs on 'cuda' or 'cpu', "
                         "not %r." % str(dev))
    if not torch.cuda.is_available():
        raise RuntimeError("device %r requested but no CUDA GPU is "
                           "available; pass device='cpu' to run the "
                           "plain PyTorch twins." % str(dev))
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError("device %r requested but only %d CUDA "
                           "device(s) are visible."
                           % (str(dev), torch.cuda.device_count()))
    return dev


def configured_device(device):
    """The configuration's ``device`` value as a ``torch.device``, or None
    for the host codec: ``'none'``, or ``'auto'`` on a host without a
    GPU (``'auto'`` is ``'cuda'`` where one is visible). Every other
    value goes through :func:`resolve_device`: ``'cuda'`` still raises
    without a GPU."""
    if device == 'none':
        return None
    if device == 'auto':
        return torch.device('cuda') if torch.cuda.is_available() else None
    return resolve_device(device)
