"""ADC simulation: quantization + noise of the low/high-precision paths.

Twin of ``repro.sensing.adc``. Two representations of the same capture:
:func:`quantize` — the float reconstruction ``codes * LSB`` the float32
datapath consumes — and :func:`quantize_codes` (+ :func:`pack_codes`) —
the raw integer codes the integer precisions consume untouched. The
``"int4"`` precision rides the two-codes-per-byte wire format
(:func:`pack_nibbles` / :func:`unpack_nibbles`, low nibble first).

Every constant is a float32 tensor on the operand's device, so that the
card and the CPU compute the same float32 arithmetic as the reference's
compiled code (PyTorch would otherwise pick its own form for a Python
scalar operand); a code on a rounding edge depends on it. The constants
are made by a fill on the device, not copied from the host, so a
conversion never waits for the card.
"""

from __future__ import annotations

import torch

#: full-scale voltage of the simulated converter (shared by both paths)
V_MAX = 1.5

#: the datapath precisions of the scoring hot path: "float32" consumes ADC
#: reconstructions; the rest consume raw ADC codes (int32 accumulation,
#: float only at the similarity epilogue)
PRECISIONS = ("float32", "int8", "int4", "binary")

#: the precisions that run the integer-code datapath
INT_PRECISIONS = ("int8", "int4", "binary")


def lsb(bits: int, v_max: float = V_MAX) -> float:
    """The quantization step: ``reconstruction = codes * lsb(bits)``."""
    return v_max / ((1 << bits) - 1)


def codes_dtype(bits: int) -> torch.dtype:
    """Narrowest dtype that holds every ``bits``-bit ADC code: ``uint8`` up
    to 8 bits, ``uint16`` up to 16, ``int32`` beyond."""
    if bits <= 8:
        return torch.uint8
    return torch.uint16 if bits <= 16 else torch.int32


def _scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _recip(x: torch.Tensor, value: float) -> torch.Tensor:
    """``1 / value`` rounded to float32, as a compiler folds ``x / value``."""
    return _scalar(x, 1.0) / _scalar(x, value)


def quantize_codes(frame: torch.Tensor, bits: int,
                   v_max: float = V_MAX) -> torch.Tensor:
    """Integer ADC codes: ``round(clip(frame, 0, v_max) / v_max * levels)``
    (round half to even), as int32.

    Computed as the reference's compiler computes it, since a code on a
    half-LSB edge rounds by what is actually computed: the division by the
    constant ``v_max`` becomes a multiply by its float32 reciprocal, folded
    with ``levels`` into ONE float32 factor.
    """
    factor = _recip(frame, v_max) * _scalar(frame, float((1 << bits) - 1))
    return torch.round(torch.clamp(frame, 0.0, v_max) * factor).to(
        torch.int32)


def quantize(frame: torch.Tensor, bits: int,
             v_max: float = V_MAX) -> torch.Tensor:
    """Uniform mid-rise quantization to ``bits`` bits over [0, v_max],
    defined as ``quantize_codes(frame) * LSB`` (idempotent)."""
    levels = (1 << bits) - 1
    codes = quantize_codes(frame, bits, v_max)
    return codes.to(torch.float32) * _scalar(frame, v_max / levels)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Narrow int32 codes to the wire dtype (:func:`codes_dtype`)."""
    return codes.to(codes_dtype(bits))


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Widen packed codes back to int32 (exact inverse of ``pack``)."""
    return packed.to(torch.int32)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """``(..., W)`` 4-bit codes -> ``(..., W/2)`` uint8, two per byte, low
    nibble first. Codes must already be 4-bit and the row width even."""
    if codes.shape[-1] % 2:
        raise ValueError(
            f"int4 nibble packing needs an even row width, got "
            f"{codes.shape[-1]} — pad or crop the frame")
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """``(..., W/2)`` packed bytes -> ``(..., W)`` int32 (exact inverse)."""
    p = packed.to(torch.int32)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(
        *p.shape[:-1], -1)


def check_codes_range(codes, bits: int) -> None:
    """Reject codes outside ``[0, 2^bits - 1]``: packing them would silently
    wrap. ``codes`` is one tensor or a sequence of tensors on one device:
    one fused min/max reduction over all of them and one device->host
    fetch; a no-op on empty tensors."""
    parts = [codes] if isinstance(codes, torch.Tensor) else list(codes)
    parts = [c for c in parts if c.numel()]
    if not parts:
        return
    ext = torch.stack([torch.stack(torch.aminmax(c.to(torch.int64)))
                       for c in parts])
    lo, hi = torch.stack([ext[:, 0].min(), ext[:, 1].max()]).tolist()
    check_codes_bounds(lo, hi, bits)


def check_codes_bounds(lo: int, hi: int, bits: int) -> None:
    """Reject a code range ``[lo, hi]`` outside ``[0, 2^bits - 1]`` (the
    host half of :func:`check_codes_range`, for codes already on the
    host)."""
    if lo < 0 or hi > (1 << bits) - 1:
        raise ValueError(
            f"integer input holds codes in [{lo}, {hi}], outside the "
            f"{bits}-bit range [0, {(1 << bits) - 1}] — the pack would "
            f"silently wrap; requantize (or pass the matching adc_bits)")


def _levels(frames: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    bits = torch.as_tensor(bits, dtype=torch.int32, device=frames.device)
    levels = (torch.ones_like(bits) << bits) - 1
    return levels.reshape(bits.shape + (1,) * (frames.ndim - bits.ndim)
                          ).to(torch.float32)


def quantize_codes_per_frame(frames: torch.Tensor, bits: torch.Tensor,
                             v_max: float = V_MAX) -> torch.Tensor:
    """Variable-depth conversion: frame ``i``'s codes at ``bits[i]`` bits
    (``bits[i] == 0`` -> the converter never ran -> all-zero codes), with
    the per-frame factor ``(1 / v_max) * levels`` formed first, as in
    :func:`quantize_codes`."""
    levels = _levels(frames, bits)
    factor = _recip(frames, v_max) * torch.clamp(levels, min=1.0)
    codes = torch.round(torch.clamp(frames, 0.0, v_max) * factor)
    return torch.where(levels > 0, codes, 0.0).to(torch.int32)


def quantize_per_frame(frames: torch.Tensor, bits: torch.Tensor,
                       v_max: float = V_MAX) -> torch.Tensor:
    """Reconstruction twin of :func:`quantize_codes_per_frame`: ``codes *
    per-frame LSB`` (skipped frames, ``bits == 0``, are zeros)."""
    levels = _levels(frames, bits)
    codes = quantize_codes_per_frame(frames, bits, v_max)
    step = _scalar(frames, v_max) / torch.clamp(levels, min=1.0)
    return torch.where(levels > 0, codes.to(torch.float32) * step, 0.0)


def adc_noise(frame: torch.Tensor, thermal_sigma: float,
              generator: torch.Generator) -> torch.Tensor:
    """Additive thermal/reference noise ahead of the converter, drawn from
    ``generator``, which must live on the frame's device (else
    ``ValueError``)."""
    if generator.device.type != frame.device.type:
        raise ValueError(f"the noise generator is on {generator.device}, "
                         f"the frame on {frame.device}")
    return frame + thermal_sigma * torch.randn(
        frame.shape, generator=generator, device=frame.device,
        dtype=frame.dtype)


def low_precision_view(frame: torch.Tensor, bits: int = 4,
                       thermal_sigma: float = 0.01, *,
                       generator: torch.Generator) -> torch.Tensor:
    """The always-on sensing path: noisy low-precision capture,
    :func:`quantize` of :func:`adc_noise` (the generator on the frame's
    device)."""
    return quantize(adc_noise(frame, thermal_sigma, generator), bits)
