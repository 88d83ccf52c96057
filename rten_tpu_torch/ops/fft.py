"""Spectral ops: DFT, STFT (the port of ``rten_tpu/ops/fft.py``; rten
src/ops/fft.rs:137 STFT, :384 DFT).

Used by the Whisper mel front end. The JAX package leaves the transform to
XLA's FFT, and the port to ``torch.fft`` (cuFFT on the card). Complex
values use ONNX's trailing [real, imag] layout.
"""

from __future__ import annotations

import torch

from .registry import OpError, as_tensor, get_input, opt_input, register, static_value


def _from_complex(z: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(z).to(torch.float32).contiguous()


@register("DFT")
def _dft(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    dft_length = opt_input(inputs, 1)
    axis_in = opt_input(inputs, 2)
    inverse = bool(attrs.get("inverse", 0))
    onesided = bool(attrs.get("onesided", 0))
    axis = attrs.get("axis", None)
    if axis is None:
        axis = int(static_value(axis_in, "axis").reshape(())) if axis_in is not None else 1
    n = int(static_value(dft_length, "dft_length").reshape(())) if dft_length is not None else None

    if x.shape[-1] == 2:
        sig = torch.complex(x[..., 0].float(), x[..., 1].float())
    else:
        sig = x.squeeze(-1)
    ax = axis if axis >= 0 else axis + sig.ndim

    if inverse:
        if onesided:
            raise OpError("DFT: inverse+onesided unsupported")
        return _from_complex(torch.fft.ifft(sig, n=n, dim=ax))
    if onesided:
        real = sig.real if sig.is_complex() else sig
        return _from_complex(torch.fft.rfft(real, n=n, dim=ax))
    return _from_complex(torch.fft.fft(sig, n=n, dim=ax))


@register("STFT")
def _stft(ctx, inputs, attrs):
    signal = as_tensor(ctx, get_input(inputs, 0))  # [B, L] or [B, L, 1] (real)
    frame_step = int(static_value(get_input(inputs, 1, "frame_step")).reshape(()))
    window = opt_input(inputs, 2)
    frame_length = opt_input(inputs, 3)
    onesided = bool(attrs.get("onesided", 1))

    if signal.shape[-1] == 1:
        signal = signal.squeeze(-1)
    elif signal.ndim == 3 and signal.shape[-1] == 2:
        raise OpError("STFT: complex signals unsupported")

    if frame_length is not None:
        flen = int(static_value(frame_length, "frame_length").reshape(()))
    elif window is not None:
        flen = window.shape[-1]
    else:
        raise OpError("STFT requires window or frame_length")

    frames = signal.unfold(1, flen, frame_step)  # [B, F, flen], F = 1 + (L - flen) // step
    if window is not None:
        frames = frames * as_tensor(ctx, window)
    z = torch.fft.rfft(frames, dim=-1) if onesided else torch.fft.fft(frames, dim=-1)
    return _from_complex(z)  # [B, F, bins, 2]
