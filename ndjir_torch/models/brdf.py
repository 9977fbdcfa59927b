"""Specular microfacet BRDFs, Filament and UE4 (counterpart of
``ndjir_tpu/models/brdf.py``; math of reference python/specular_brdf.py:40-191,
white light).  In the importance-sampled branch the GGX NDF D cancels
against the sampling pdf, leaving V * F * (4 voh / noh) (Filament) or
G * F * voh / (noh * nov) (UE4); the uniform branch keeps D and multiplies
by pi.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ndjir_torch.ops.ties import clip


def masked_dot(u: torch.Tensor, v: torch.Tensor, eps: float = 1e-8,
               with_mask: bool = False):
    """Clamped dot product with optional positivity mask
    (reference: specular_brdf.py:23-37)."""
    uv = torch.sum(u * v, dim=-1, keepdim=True)
    mask = (uv > eps).to(uv.dtype).detach()
    uv = clip(uv, eps)
    if with_mask:
        return uv, mask
    return uv


def _broadcast_inputs(normal, view_dir, roughness, specular_color, M,
                      channels):
    """(B, R, C) -> (B, R, M, C) broadcasts shared by both models."""
    def bc(x, C):
        x = x.reshape(*x.shape[:-1], 1, C) if x.ndim == 3 else x
        return x.expand(*x.shape[:2], M, C)
    return (bc(normal, 3),
            bc(view_dir.reshape(view_dir.shape[0], view_dir.shape[1], 3), 3),
            bc(roughness, 1), bc(specular_color, channels))


def _half(light_dir, view_dir):
    h = light_dir + view_dir
    return h / torch.linalg.norm(h, dim=-1, keepdim=True)


def filament_specular_brdf(normal, view_dir, light_dir, roughness,
                           specular_color, conf
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GGX D + Smith height-correlated V + Schlick F
    (reference: specular_brdf.py:40-118)."""
    M = light_dir.shape[2]
    channels = conf.specular_reflectance_network.channels
    normal, view_dir, roughness, specular_color = _broadcast_inputs(
        normal, view_dir, roughness, specular_color, M, channels)
    half_dir = _half(light_dir, view_dir)

    a2 = roughness ** 2
    eps_dot = conf.renderer.eps_dot
    eps = 1e-6

    nol, mask_nol = masked_dot(normal, light_dir, eps_dot, True)
    nov, mask_nov = masked_dot(normal, view_dir, eps_dot, True)
    noh, mask_noh = masked_dot(normal, half_dir, eps_dot, True)

    def specular_V1(nou):
        return 1.0 / (nou + torch.sqrt(a2 + (1.0 - a2) * nou ** 2) + eps)

    def specular_F():
        voh = masked_dot(view_dir, half_dir, eps_dot)
        return specular_color + (1.0 - specular_color) * (1.0 - voh) ** 5

    if conf.specular_brdf.sampling == "importance":
        V = specular_V1(nol) * specular_V1(nov)
        Fs = specular_F()
        voh = masked_dot(view_dir, half_dir, eps_dot)
        noh_u = masked_dot(normal, half_dir, eps_dot)
        sBRDF = V * Fs * (4.0 * voh / noh_u)
    else:  # uniform
        D = a2 / (math.pi * (noh ** 2 * (a2 - 1.0) + 1.0) ** 2 + eps)
        sBRDF = math.pi * D * specular_V1(nol) * specular_V1(nov) \
            * specular_F()
    sBRDF = sBRDF * (mask_nol * mask_nov * mask_noh)
    return sBRDF, nol


def ue4_specular_brdf(normal, view_dir, light_dir, roughness, specular_color,
                      conf) -> Tuple[torch.Tensor, torch.Tensor]:
    """UE4 k-remapped Smith G + spherical-gaussian Schlick F
    (reference: specular_brdf.py:121-191)."""
    M = light_dir.shape[2]
    channels = conf.specular_reflectance_network.channels
    normal, view_dir, roughness, specular_color = _broadcast_inputs(
        normal, view_dir, roughness, specular_color, M, channels)
    half_dir = _half(light_dir, view_dir)

    a = roughness ** 2
    a2 = a ** 2
    eps_dot = conf.renderer.eps_dot
    eps = 1e-6

    nol, mask_nol = masked_dot(normal, light_dir, eps_dot, True)
    nov, mask_nov = masked_dot(normal, view_dir, eps_dot, True)
    noh, mask_noh = masked_dot(normal, half_dir, eps_dot, True)
    k = (roughness + 1.0) ** 2 / 8.0

    def specular_G1(nou):
        return nou / (nou * (1.0 - k) + k + eps)

    def specular_F():
        voh = masked_dot(view_dir, half_dir, eps_dot)
        power = (-5.55473 * voh - 6.98316) * voh
        return specular_color + (1.0 - specular_color) * 2.0 ** power

    if conf.specular_brdf.sampling == "importance":
        G = specular_G1(nol) * specular_G1(nov)
        Fs = specular_F()
        voh = masked_dot(view_dir, half_dir, eps_dot)
        noh_u = masked_dot(normal, half_dir, eps_dot)
        sBRDF = G * Fs * (voh / (noh_u * nov))
    else:
        noh_u = masked_dot(normal, half_dir, eps_dot)
        D = a2 / (math.pi * (noh_u ** 2 * (a2 - 1.0) + 1.0) ** 2 + eps)
        sBRDF = math.pi * D * specular_G1(nol) * specular_G1(nov) \
            * specular_F() / (4.0 * nov * nol)
    sBRDF = sBRDF * (mask_nol * mask_nov * mask_noh)
    return sBRDF, nol


def specular_brdf_model(normal, view_dir, light_dir, roughness,
                        specular_color, conf):
    models = dict(filament=filament_specular_brdf, ue4=ue4_specular_brdf)
    return models[conf.specular_brdf.model](
        normal, view_dir, light_dir, roughness, specular_color, conf)
