"""Packing codecs: octahedral normals, half2x16-in-float32, and the
reference's colour and byte codecs (`gbuffer_packing.glsl`).

Bit-exact with the JAX package's ``core/packing.py``: the Poisson
kernel decodes these bits on the device (`gbuffer_packing.glsl:36-63`).
All bit manipulation runs on int32/int64 tensors with defined overflow.
"""

from __future__ import annotations

import torch


def encode_oct(n: torch.Tensor) -> torch.Tensor:
    """Unit normal (..., 3) -> octahedral (..., 2) in [0, 1]^2."""
    n = n / (n[..., 0:1].abs() + n[..., 1:2].abs() + n[..., 2:3].abs())
    xy = n[..., :2]
    sign = torch.where(xy >= 0.0, 1.0, -1.0)
    wrapped = (1.0 - xy.flip(-1).abs()) * sign
    xy = torch.where(n[..., 2:3] > 0.0, xy, wrapped)
    return xy * 0.5 + 0.5


def decode_oct(f: torch.Tensor) -> torch.Tensor:
    """Octahedral (..., 2) -> unit normal (..., 3)."""
    f = f * 2.0 - 1.0
    fx, fy = f[..., 0], f[..., 1]
    z = 1.0 - fx.abs() - fy.abs()
    t = torch.clamp(-z, min=0.0)
    x = fx + torch.where(fx >= 0.0, -t, t)
    y = fy + torch.where(fy >= 0.0, -t, t)
    norm = torch.sqrt(x * x + y * y + z * z)
    return torch.stack([x, y, z], dim=-1) / torch.clamp(norm, min=1e-20)[..., None]


def _f16_bits(v: torch.Tensor) -> torch.Tensor:
    """float -> its float16 bit pattern as int64 in [0, 0xFFFF]."""
    return v.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _bits_f16(b: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 0xFFFF] -> the float16 with those bits, as float32."""
    signed = torch.where(b >= 0x8000, b - 0x10000, b)
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def pack_half2x16(v: torch.Tensor) -> torch.Tensor:
    """(..., 2) float -> float32 whose bits hold two f16 (GLSL
    packHalf2x16 + uintBitsToFloat, `gbuffer_packing.glsl:61`)."""
    packed = _f16_bits(v[..., 0]) | (_f16_bits(v[..., 1]) << 16)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    return packed.to(torch.int32).view(torch.float32)


def unpack_half2x16(f: torch.Tensor) -> torch.Tensor:
    bits = f.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    return torch.stack([_bits_f16(bits & 0xFFFF), _bits_f16(bits >> 16)],
                       dim=-1)


def pack_normal(n: torch.Tensor) -> torch.Tensor:
    """Normal (..., 3) -> one float32 (oct + half2x16), as the velocity
    buffer's B channel stores it (`VelocityDepthNormalMaterial.js:179`)."""
    return pack_half2x16(encode_oct(n))


def unpack_normal(f: torch.Tensor) -> torch.Tensor:
    return decode_oct(unpack_half2x16(f))


# --- colour <-> single float codecs (parity with the reference) ------------


