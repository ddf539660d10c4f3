"""Packing codecs: octahedral normals, half2x16-in-float32, and the
reference's colour and byte codecs (`gbuffer_packing.glsl`).

Bit-exact with the JAX package's ``core/packing.py``: the Poisson
kernel decodes these bits on the device (`gbuffer_packing.glsl:36-63`).
All bit manipulation runs on int32/int64 tensors with defined overflow.
"""

from __future__ import annotations

import torch

_C_PRECISION = 256.0
_C_PRECISION_P1 = 257.0
_ONE_SAFE = 0.999999
_NON_ZERO_OFFSET = 0.0001


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

def color2float(color: torch.Tensor) -> torch.Tensor:
    """(..., 3) in [0, 1] -> one float (`gbuffer_packing.glsl:17-22`)."""
    c = torch.clamp(color + _NON_ZERO_OFFSET, max=_ONE_SAFE)
    q = torch.floor(c * _C_PRECISION + 0.5)
    return (q[..., 0] + q[..., 2] * _C_PRECISION_P1
            + q[..., 1] * _C_PRECISION_P1 * _C_PRECISION_P1)


def float2color(value: torch.Tensor) -> torch.Tensor:
    r = torch.remainder(value, _C_PRECISION_P1) / _C_PRECISION
    b = torch.remainder(torch.floor(value / _C_PRECISION_P1),
                        _C_PRECISION_P1) / _C_PRECISION
    g = torch.floor(value / (_C_PRECISION_P1 * _C_PRECISION_P1)) / _C_PRECISION
    c = torch.stack([r, g, b], dim=-1) - _NON_ZERO_OFFSET
    return torch.clamp(c, min=0.0)


def encode_rgbe8(rgb: torch.Tensor) -> torch.Tensor:
    """HDR rgb -> shared-exponent RGBE8 (`gbuffer_packing.glsl:127-134`)."""
    max_c = torch.clamp(rgb.amax(-1), min=1e-32)
    f_exp = torch.ceil(torch.log2(max_c))
    mant = rgb / torch.exp2(f_exp)[..., None]
    a = (f_exp + 128.0) / 255.0
    return torch.cat([mant, a[..., None]], dim=-1)


def decode_rgbe8(rgbe: torch.Tensor) -> torch.Tensor:
    f_exp = rgbe[..., 3] * 255.0 - 128.0
    return rgbe[..., :3] * torch.exp2(f_exp)[..., None]


def vec4_to_float(v: torch.Tensor) -> torch.Tensor:
    """(..., 4) in [0, 1] -> one float32 holding 4 bytes
    (`gbuffer_packing.glsl:143-149`)."""
    v = torch.clamp(v + _NON_ZERO_OFFSET, max=_ONE_SAFE)
    b = (v * 255.0).to(torch.int64)
    packed = (b[..., 3] << 24) | (b[..., 2] << 16) | (b[..., 1] << 8) | b[..., 0]
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    return packed.to(torch.int32).view(torch.float32)


def float_to_vec4(f: torch.Tensor) -> torch.Tensor:
    bits = f.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    v = torch.stack([((bits >> s) & 0xFF).to(torch.float32)
                     for s in (0, 8, 16, 24)], dim=-1) / 255.0
    return torch.clamp(v - _NON_ZERO_OFFSET, min=0.0)
