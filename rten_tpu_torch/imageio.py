"""Image IO (the port of ``rten_tpu/imageio.py``): read/write and tensor
conversion (rten-imageio/src/lib.rs:38).

``image_to_tensor`` produces CHW f32 in [0, 1], matching the reference's
convention for model inputs, as a tensor on the card unless the caller
passes ``device="cpu"``; the pixel arithmetic runs on the host in numpy,
as the JAX package computes it, and the result is copied once. PIL is
imported only by ``read_image`` and ``write_image``.
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime.executor import resolve_device


def read_image(path, device=None) -> torch.Tensor:
    """Load an image file -> CHW f32 [0,1] on ``device``."""
    from PIL import Image

    with Image.open(path) as im:
        return image_to_tensor(np.asarray(im.convert("RGB")), device=device)


def image_to_tensor(hwc, device=None) -> torch.Tensor:
    """HWC uint8/float (numpy or a tensor) -> CHW f32 in [0,1] on ``device``."""
    arr = hwc.detach().cpu().numpy() if isinstance(hwc, torch.Tensor) else np.asarray(hwc)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    chw = np.ascontiguousarray(np.transpose(arr.astype(np.float32), (2, 0, 1)))
    return torch.from_numpy(chw).to(resolve_device(device))


def tensor_to_image(chw) -> np.ndarray:
    """CHW f32 [0,1] (a tensor on any device, or numpy) -> HWC uint8 on the
    host."""
    arr = chw.detach().cpu().numpy() if isinstance(chw, torch.Tensor) else np.asarray(chw)
    arr = np.clip(arr, 0.0, 1.0)
    return (np.transpose(arr, (1, 2, 0)) * 255.0 + 0.5).astype(np.uint8)


def write_image(path, chw) -> None:
    from PIL import Image

    hwc = tensor_to_image(chw)
    if hwc.shape[2] == 1:
        hwc = hwc[:, :, 0]
    Image.fromarray(hwc).save(path)
