"""Parameter-free direction encodings (counterpart of
``nvsf_tpu/models/encodings.py``): frequency degree 12 for the LiDAR heads,
spherical harmonics degree 4 for the camera head. Inputs lie in [0, 1]."""

from __future__ import annotations

import math

import torch


def frequency_encode(x: torch.Tensor, degree: int = 12) -> torch.Tensor:
    """Per input dim, (sin, cos) at frequencies 2^l * pi, l < degree; output
    [..., D * degree * 2], dim-major."""
    freqs = (2.0 ** torch.arange(degree, dtype=torch.float32,
                                 device=x.device)) * math.pi
    ang = x[..., :, None] * freqs
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * degree * 2)


def sh_encode_deg4(u: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 4 (16 coefficients) of the
    direction 2u - 1."""
    d = u * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [
        0.28209479177387814 * torch.ones_like(x),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(out, dim=-1)


FREQ_DEG12_DIM = 3 * 12 * 2
SH_DEG4_DIM = 16
