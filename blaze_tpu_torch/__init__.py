"""blaze_tpu_torch: the PyTorch/CUDA port of ``blaze_tpu``.

The same padded columnar batch model, Spark-exact expressions and
operators, with torch tensors in place of JAX arrays and hand-written
Hopper kernels (``csrc/``) in place of the Pallas TPU kernels.  The
package imports neither JAX nor anything of ``blaze_tpu``.

Device policy: work runs on the CUDA card unless the caller asks for
the CPU, through :func:`set_default_device` or an explicit ``device=``
argument.  There is no silent fallback: asking for ``cuda`` where no
card is present raises.
"""

from __future__ import annotations

from typing import Union

import torch

_default_device = torch.device("cuda")


def set_default_device(device: Union[str, torch.device]) -> None:
    """Choose the device that scans and batch builders stage onto when
    no ``device=`` is given (``"cuda"`` unless changed)."""
    global _default_device
    _default_device = torch.device(device)


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``device`` or the default; raises when it names CUDA and no
    card is present."""
    d = _default_device if device is None else torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "blaze_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' or call set_default_device('cpu')")
    return d


__all__ = ["set_default_device", "resolve_device"]
