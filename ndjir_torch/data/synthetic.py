"""Synthetic IDR-format scene generators (the port's copy of
``ndjir_tpu/data/synthetic.py``).

Gives tests, CLI drives, and benchmarks a dataset with exactly the IDR
layout the reference consumes (image/, mask/, cameras.npz with
world_mat_i / scale_mat_i) without needing DTU data on disk:
:func:`render_sphere_scene` returns the analytic lambert sphere's arrays,
:func:`make_synthetic_scene` writes them as a folder, and
:func:`make_hard_synthetic_scene` / :func:`make_hard_synthetic_scene_v2`
write the quality-benchmark scenes with their ``gt_sdf.npz``.  The images
are written with the port's PNG writer and decode to the JAX package's
pixels, bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ndjir_torch.utils.png import write_png


def _write_view(out_dir: str, i: int, img: np.ndarray,
                mask: np.ndarray) -> None:
    write_png(os.path.join(out_dir, "image", f"{i:06d}.png"), img)
    write_png(os.path.join(out_dir, "mask", f"{i:06d}.png"), mask)


def _look_at(eye: np.ndarray) -> np.ndarray:
    """World-to-camera rotation looking at the origin (z forward)."""
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rwc = np.stack([right, down, fwd], axis=0)  # rows: camera axes
    return Rwc


def render_sphere_scene(n_views: int = 8, H: int = 64, W: int = 64,
                        radius: float = 0.5, cam_dist: float = 2.5
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   Dict[str, np.ndarray]]:
    """Render a lambert sphere of ``radius`` from cameras on a tilted circle.

    Returns (images (n, H, W, 3) uint8, masks (n, H, W) uint8, cameras with
    ``world_mat_i`` / ``scale_mat_i``): byte for byte what
    ``ndjir_tpu.data.synthetic.make_synthetic_scene`` writes.
    """
    f = 0.8 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    light_dir = np.array([0.5, 0.3, 0.8])
    light_dir /= np.linalg.norm(light_dir)
    albedo = np.array([0.8, 0.45, 0.25])

    images, masks, cams = [], [], {}
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = cam_dist * np.array(
            [np.cos(th) * 0.9, np.sin(th) * 0.9, 0.45 + 0.1 * np.sin(3 * th)])
        Rwc = _look_at(eye)
        t = -Rwc @ eye
        P34 = K @ np.concatenate([Rwc, t[:, None]], axis=1)
        world_mat = np.eye(4, dtype=np.float32)
        world_mat[:3, :4] = P34

        # per-pixel rays in world space
        xx, yy = np.meshgrid(np.arange(W) + 0.0, np.arange(H) + 0.0)
        pix = np.stack([xx, yy, np.ones_like(xx)], axis=-1).reshape(-1, 3)
        dirs_cam = (np.linalg.inv(K) @ pix.T).T
        dirs = (Rwc.T @ dirs_cam.T).T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

        # analytic ray-sphere
        cv = dirs @ eye
        cc = eye @ eye
        disc = cv ** 2 - (cc - radius ** 2)
        hit = disc > 0
        tt = -cv - np.sqrt(np.maximum(disc, 0.0))
        x = eye[None, :] + tt[:, None] * dirs
        n = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
        lam = np.clip(n @ light_dir, 0.0, 1.0)
        shade = 0.15 + 0.85 * lam
        img = np.where(hit[:, None], albedo[None, :] * shade[:, None], 0.05)
        images.append((np.clip(img, 0, 1).reshape(H, W, 3) * 255)
                      .astype(np.uint8))
        masks.append((hit.reshape(H, W) * 255).astype(np.uint8))
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    return np.stack(images), np.stack(masks), cams


def make_synthetic_scene(out_dir: str, n_views: int = 8, H: int = 64,
                         W: int = 64, radius: float = 0.5,
                         cam_dist: float = 2.5, seed: int = 0) -> str:
    """Render a lambert sphere of ``radius`` from cameras on a tilted circle;
    writes IDR-format files and returns ``out_dir``.  (``seed`` is kept for
    the JAX package's signature: the sphere draws no random numbers.)"""
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    images, masks, cams = render_sphere_scene(n_views, H, W, radius, cam_dist)
    for i in range(n_views):
        _write_view(out_dir, i, images[i], masks[i])
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)
    return out_dir


# ---------------------------------------------------------------------------
# hard synthetic benchmark scene (textured + specular + shadowed blobby)
# ---------------------------------------------------------------------------

def _blobby_sdf(x: np.ndarray) -> np.ndarray:
    """Smooth-min union of three spheres (analytic, Lipschitz ~1).

    x (..., 3) -> sdf (...).  The smooth minimum uses the polynomial smin
    with k=0.1, giving a blobby genus-0 surface with concavities — a harder
    reconstruction target than a sphere.
    """
    centers = np.array([[0.18, 0.0, 0.05], [-0.2, 0.12, -0.08],
                        [-0.02, -0.22, 0.12]])
    radii = np.array([0.3, 0.26, 0.22])
    k = 0.1
    d = None
    for c, r in zip(centers, radii):
        di = np.linalg.norm(x - c, axis=-1) - r
        if d is None:
            d = di
        else:
            h = np.clip(0.5 + 0.5 * (di - d) / k, 0.0, 1.0)
            d = di * (1 - h) + d * h - k * h * (1 - h)
    return d


def _blobby_normal(x: np.ndarray, h: float = 1e-5) -> np.ndarray:
    g = np.stack([
        _blobby_sdf(x + np.array([h, 0, 0])) - _blobby_sdf(x - np.array([h, 0, 0])),
        _blobby_sdf(x + np.array([0, h, 0])) - _blobby_sdf(x - np.array([0, h, 0])),
        _blobby_sdf(x + np.array([0, 0, h])) - _blobby_sdf(x - np.array([0, 0, h])),
    ], axis=-1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def _sphere_trace(eye, dirs, t0, t1, iters=96):
    """Vectorized sphere tracing of the blobby SDF; returns (t, hit)."""
    t = t0.copy()
    for _ in range(iters):
        x = eye[None, :] + t[:, None] * dirs
        d = _blobby_sdf(x)
        t = t + 0.9 * d
        t = np.minimum(t, t1)
    x = eye[None, :] + t[:, None] * dirs
    hit = (_blobby_sdf(x) < 1.5e-3) & (t < t1 - 1e-6)
    return t, hit


def _soft_shadow(x, light_dir, k=16.0, t_max=1.2):
    """SDF soft-shadow factor in [0, 1] along the light ray."""
    res = np.ones(x.shape[:-1])
    t = np.full(x.shape[:-1], 2e-2)
    for _ in range(48):
        p = x + t[..., None] * light_dir
        d = _blobby_sdf(p)
        res = np.minimum(res, np.clip(k * d / np.maximum(t, 1e-6), 0.0, 1.0))
        t = t + np.clip(d, 5e-3, 0.08)
        t = np.minimum(t, t_max)
    return res


def _albedo_texture(x: np.ndarray) -> np.ndarray:
    """Procedural 3-D albedo: two-tone stripes + color blotches."""
    s = 0.5 + 0.5 * np.sin(21.0 * x[..., 0] + 13.0 * x[..., 2])
    blotch = 0.5 + 0.5 * np.sin(9.0 * x[..., 1] + 6.0 * x[..., 0] * x[..., 2])
    a = np.stack([0.75 * s + 0.15, 0.25 + 0.5 * blotch,
                  0.6 - 0.35 * s], axis=-1)
    return np.clip(a, 0.05, 0.95)


def make_hard_synthetic_scene(out_dir: str, n_views: int = 16, H: int = 96,
                              W: int = 96, cam_dist: float = 2.5,
                              seed: int = 0) -> str:
    """Hard quality-benchmark scene: blobby SDF, procedural texture, GGX-ish
    specular highlight, SDF soft shadows, constant ambient.

    Writes the IDR layout + ``gt_sdf.npz`` (a dense SDF lattice from which
    the ground-truth mesh is extracted for Chamfer evaluation).
    """
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    f = 1.6 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    light_dir = np.array([0.45, 0.35, 0.82])
    light_dir /= np.linalg.norm(light_dir)

    cams = {}
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        ele = 0.35 + 0.25 * np.sin(2.0 * th + 0.7)
        eye = cam_dist * np.array(
            [np.cos(th) * np.cos(ele), np.sin(th) * np.cos(ele), np.sin(ele)])
        Rwc = _look_at(eye)
        t = -Rwc @ eye
        P34 = K @ np.concatenate([Rwc, t[:, None]], axis=1)
        world_mat = np.eye(4, dtype=np.float32)
        world_mat[:3, :4] = P34

        xx, yy = np.meshgrid(np.arange(W) + 0.0, np.arange(H) + 0.0)
        pix = np.stack([xx, yy, np.ones_like(xx)], axis=-1).reshape(-1, 3)
        dirs = (Rwc.T @ (np.linalg.inv(K) @ pix.T)).T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

        cv = dirs @ eye
        cc = eye @ eye
        disc = cv ** 2 - (cc - 0.55 ** 2)   # bounding sphere r=0.55
        near = np.where(disc > 0, -cv - np.sqrt(np.maximum(disc, 0)), 1e9)
        far = np.where(disc > 0, -cv + np.sqrt(np.maximum(disc, 0)), 1e9)
        tt, hit = _sphere_trace(eye, dirs, near, far)

        x = eye[None, :] + tt[:, None] * dirs
        n = _blobby_normal(x)
        view = -dirs
        albedo = _albedo_texture(x)
        lam = np.clip(n @ light_dir, 0.0, 1.0)
        shadow = _soft_shadow(x, light_dir)
        half = light_dir[None, :] + view
        half /= np.maximum(np.linalg.norm(half, axis=-1, keepdims=True), 1e-9)
        noh = np.clip(np.sum(n * half, axis=-1), 0.0, 1.0)
        spec = 0.6 * noh ** 64 * shadow * (lam > 0)
        shade = (0.12 + 0.88 * lam * shadow)[:, None] * albedo \
            + spec[:, None]
        img = np.where(hit[:, None], shade, 0.04)
        img = (np.clip(img, 0, 1).reshape(H, W, 3) * 255).astype(np.uint8)
        mask = (hit.reshape(H, W) * 255).astype(np.uint8)

        _write_view(out_dir, i, img, mask)
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)

    # ground-truth SDF lattice for the Chamfer reference mesh
    G = 192
    lin = np.linspace(-0.6, 0.6, G).astype(np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = _blobby_sdf(np.stack([X, Y, Z], axis=-1)).astype(np.float32)
    np.savez_compressed(os.path.join(out_dir, "gt_sdf.npz"), sdf=sdf,
                        vmin=-0.6, vmax=0.6)
    return out_dir


# ---------------------------------------------------------------------------
# hard synthetic benchmark scene v2: representable illumination
# ---------------------------------------------------------------------------
#
# The v1 hard scene shades with a single *directional* light + Blinn-Phong
# (noh^64) — an image-formation model OUTSIDE the framework's forward family
# (a near-delta light cannot be expressed by the PE-band-6 environment-light
# MLP integrated with 128 fixed Monte-Carlo directions, and Blinn-Phong is
# not the Filament GGX estimator).  Quality on v1 therefore caps at the
# model-mismatch residual, which grows with resolution (QUALITY_r02 96^2
# SSIM 0.62 -> QUALITY_r03 128^2 SSIM 0.40); scripts/quality_diagnosis.py
# quantifies this.  v2 keeps the HARD parts (blobby geometry, procedural
# texture, SDF soft shadows, specular) but forms images with the SAME
# physical model the framework fits — analogous to the NeRF-synthetic
# datasets being rendered under the assumed image formation, and to DTU
# photos being lit by broad lab illumination the reference's model family
# can represent:
#
#   - white environment light L(omega): constant + two broad lobes
#     (representable by the env-light MLP, PE bands 6);
#   - diffuse = albedo * E_{uniform-in-cos-theta}[L * Vis * cos], the exact
#     converged value of the framework's diffuse estimator
#     (ops/directions.py:63-77, renderer.py diffuse branch);
#   - specular = E_{GGX(alpha) dirs around n}[V1*V1*F*(4 voh/noh) * L * Vis
#     * nol], the converged value of the framework's importance-sampled
#     Filament estimator (models/brdf.py:42-82, ops/directions.py:80-97)
#     with constant roughness 0.3 and F0 0.04 (both inside the nets' output
#     ranges);
#   - Vis = SDF soft shadows (smooth in x and omega -> fits the
#     soft-visibility MLP).
#
# GT integrals use the same sampling formulas with many samples + a fixed
# seed, so the scene is exactly representable up to MC noise and network
# capacity — quality scores then measure the FRAMEWORK, not the scene.

_ENV_LOBES = [
    # (weight, direction, power): broad white lobes + constant ambient
    (3.0, np.array([0.45, 0.35, 0.82]), 8.0),
    (1.2, np.array([-0.55, 0.25, 0.80]), 2.0),
]
_ENV_AMBIENT = 0.40


def _env_light(dirs: np.ndarray) -> np.ndarray:
    """White environment radiance L(omega) for (..., 3) dirs -> (...)."""
    L = np.full(dirs.shape[:-1], _ENV_AMBIENT, dtype=np.float32)
    for w, d, p in _ENV_LOBES:
        dn = d / np.linalg.norm(d)
        L = L + w * np.clip(dirs @ dn, 0.0, None) ** p
    return L


def _tangent_frame_np(n: np.ndarray):
    """Tangent frame matching ops/directions.py:_tangent_frame (eps=0)."""
    z = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    xa = np.stack([-n[..., 1], n[..., 0], np.zeros_like(n[..., 0])], axis=-1)
    na = np.linalg.norm(xa, axis=-1, keepdims=True)
    xa = np.where(na < 1e-9, np.array([1.0, 0.0, 0.0]), xa / np.maximum(na, 1e-12))
    y = np.cross(z, xa)
    return xa, y, z


def _orient_np(local_dirs: np.ndarray, n: np.ndarray) -> np.ndarray:
    xa, ya, za = _tangent_frame_np(n)
    return (local_dirs[..., 0:1] * xa[..., None, :]
            + local_dirs[..., 1:2] * ya[..., None, :]
            + local_dirs[..., 2:3] * za[..., None, :])


def _soft_shadow_dirs(x: np.ndarray, dirs: np.ndarray, k: float = 16.0,
                      t_max: float = 1.2, iters: int = 32) -> np.ndarray:
    """SDF soft-shadow factor for per-point direction sets.

    x (P, 3), dirs (P, M, 3) -> (P, M) in [0, 1]."""
    P, M, _ = dirs.shape
    xe = x[:, None, :]
    res = np.ones((P, M), dtype=np.float32)
    t = np.full((P, M), 2e-2, dtype=np.float32)
    for _ in range(iters):
        p = xe + t[..., None] * dirs
        d = _blobby_sdf(p).astype(np.float32)
        res = np.minimum(res, np.clip(k * d / np.maximum(t, 1e-6), 0.0, 1.0))
        t = np.minimum(t + np.clip(d, 5e-3, 0.08), t_max)
    return res


def _shade_v2(x: np.ndarray, n: np.ndarray, view: np.ndarray,
              rng: np.random.RandomState, n_diffuse: int = 256,
              n_spec: int = 256, rough: float = 0.3,
              f0: float = 0.04) -> np.ndarray:
    """Converged-model shading at hit points: (P,3),(P,3),(P,3) -> (P,3)."""
    P = x.shape[0]
    albedo = _albedo_texture(x).astype(np.float32)

    # diffuse: uniform-in-cos-theta hemisphere MC (ops/directions.py:63-77)
    u = rng.rand(P, n_diffuse).astype(np.float32)
    phi = 2 * np.pi * rng.rand(P, n_diffuse).astype(np.float32)
    st = np.sqrt(np.maximum(1.0 - u * u, 0.0))
    local = np.stack([st * np.cos(phi), st * np.sin(phi), u], axis=-1)
    wd = _orient_np(local, n)                            # (P, Md, 3)
    cos_d = np.maximum(np.sum(n[:, None, :] * wd, axis=-1), 1e-8)
    vis_d = _soft_shadow_dirs(x, wd)
    diffuse = np.mean(_env_light(wd) * vis_d * cos_d, axis=-1)

    # specular: GGX-NDF light dirs around n (ops/directions.py:80-97) with
    # the Filament importance estimator (models/brdf.py:42-82)
    a2 = rough * rough
    u = rng.rand(P, n_spec).astype(np.float32)
    phi = 2 * np.pi * rng.rand(P, n_spec).astype(np.float32)
    ct = np.sqrt(np.clip((1.0 - u) / ((a2 - 1.0) * u + 1.0), 0.0, 1.0))
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    local = np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)
    ws = _orient_np(local, n)                            # (P, Ms, 3)
    h = ws + view[:, None, :]
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    eps_dot = 1e-8

    def mdot(a, b):
        d = np.sum(a * b, axis=-1)
        return np.maximum(d, eps_dot), (d > eps_dot).astype(np.float32)

    nol, m_nol = mdot(n[:, None, :], ws)
    nov, m_nov = mdot(n[:, None, :], np.broadcast_to(view[:, None, :], ws.shape))
    noh, m_noh = mdot(n[:, None, :], h)
    voh, _ = mdot(np.broadcast_to(view[:, None, :], h.shape), h)

    def V1(nou):
        return 1.0 / (nou + np.sqrt(a2 + (1.0 - a2) * nou ** 2) + 1e-6)

    F = f0 + (1.0 - f0) * (1.0 - voh) ** 5
    sBRDF = V1(nol) * V1(nov) * F * (4.0 * voh / noh) * (m_nol * m_nov * m_noh)
    vis_s = _soft_shadow_dirs(x, ws)
    spec = np.mean(sBRDF * _env_light(ws) * vis_s * nol, axis=-1)

    return np.clip(albedo * diffuse[:, None] + spec[:, None], 0.0, 1.0)


def make_hard_synthetic_scene_v2(out_dir: str, n_views: int = 24, H: int = 128,
                                 W: int = 128, cam_dist: float = 2.5,
                                 seed: int = 0) -> str:
    """Quality-benchmark scene v2: blobby SDF + procedural texture + soft
    shadows + GGX specular, image-formed with the framework's OWN physical
    model (converged estimators) — see the module comment above."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    f = 1.6 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])

    cams = {}
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        ele = 0.35 + 0.25 * np.sin(2.0 * th + 0.7)
        eye = cam_dist * np.array(
            [np.cos(th) * np.cos(ele), np.sin(th) * np.cos(ele), np.sin(ele)])
        Rwc = _look_at(eye)
        t = -Rwc @ eye
        P34 = K @ np.concatenate([Rwc, t[:, None]], axis=1)
        world_mat = np.eye(4, dtype=np.float32)
        world_mat[:3, :4] = P34

        xx, yy = np.meshgrid(np.arange(W) + 0.0, np.arange(H) + 0.0)
        pix = np.stack([xx, yy, np.ones_like(xx)], axis=-1).reshape(-1, 3)
        dirs = (Rwc.T @ (np.linalg.inv(K) @ pix.T)).T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

        cv = dirs @ eye
        cc = eye @ eye
        disc = cv ** 2 - (cc - 0.55 ** 2)
        near = np.where(disc > 0, -cv - np.sqrt(np.maximum(disc, 0)), 1e9)
        far = np.where(disc > 0, -cv + np.sqrt(np.maximum(disc, 0)), 1e9)
        tt, hit = _sphere_trace(eye, dirs, near, far)

        img = np.full((H * W, 3), 0.04, dtype=np.float32)
        idx = np.nonzero(hit)[0]
        if len(idx):
            x = (eye[None, :] + tt[:, None] * dirs)[idx]
            n = _blobby_normal(x)
            view = -dirs[idx]
            img[idx] = _shade_v2(x.astype(np.float32), n.astype(np.float32),
                                 view.astype(np.float32), rng)
        img = (np.clip(img, 0, 1).reshape(H, W, 3) * 255).astype(np.uint8)
        mask = (hit.reshape(H, W) * 255).astype(np.uint8)

        _write_view(out_dir, i, img, mask)
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)

    G = 192
    lin = np.linspace(-0.6, 0.6, G).astype(np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = _blobby_sdf(np.stack([X, Y, Z], axis=-1)).astype(np.float32)
    np.savez_compressed(os.path.join(out_dir, "gt_sdf.npz"), sdf=sdf,
                        vmin=-0.6, vmax=0.6)
    return out_dir
