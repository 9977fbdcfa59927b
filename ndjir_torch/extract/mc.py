"""Mesh extraction: SDF volume -> iso-surface -> attribute meshes.

Counterpart of ``ndjir_tpu/extract/mc.py`` (reference
python/extract_by_mc.py:37-288).  The SDF volume and the per-vertex
attribute queries run on the device ``params`` live on, in batches of
``extraction.batch_size`` points padded to a whole batch; the iso-surface
and the mesh bookkeeping run in the native host library
(:mod:`ndjir_torch.extract.native`).  On a grid in the octa layout
:func:`extract` builds the octa table once (one B3 launch) and every query
of the call reads it.

Outputs per extraction (parity with save_attributed_mesh,
extract_by_mc.py:197-223): OBJ meshes with vertex colors for base color,
implicit illumination, roughness, specular reflectance, and both aleatoric
stds, plus an equirect environment-map PNG; for final extractions, mask-
trimmed connected-component meshes (top 5 by face count).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.ndimage import maximum_filter1d

from ndjir_torch.extract.native import connected_components, marching_cubes
from ndjir_torch.models import fields
from ndjir_torch.render.image import params_device
from ndjir_torch.utils.mesh_io import save_obj
from ndjir_torch.utils.monitor import logger
from ndjir_torch.utils.png import write_png


def compute_sdf_volume(params, conf, G: int) -> np.ndarray:
    """Dense SDF evaluation on the G^3 grid over the bounding box, batched
    (reference: compute_pts_vol, extract_by_mc.py:47-73).  The points are
    the JAX package's ``meshgrid(linspace, indexing="ij")`` ones, made per
    batch on the device; the last batch is padded with the origin."""
    dev = params_device(params)
    params = fields.with_octa_table(params, conf)
    geo = params["geometric-network"]
    radius = conf.renderer.bounding_sphere_radius
    lin = torch.from_numpy(
        np.linspace(-radius, radius, G).astype(np.float32)).to(dev)
    n = G ** 3
    B = conf.extraction.batch_size
    out = torch.empty(n + (-n) % B, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for b in range(0, out.numel(), B):
            i = torch.arange(b, b + B, device=dev)
            pts = torch.stack([lin[i // (G * G) % G], lin[i // G % G],
                               lin[i % G]], dim=-1)
            pts[i >= n] = 0.0
            sdf, _, _ = fields.geometric_apply(geo, pts, conf)
            out[b:b + B] = sdf[..., 0]
    return out[:n].cpu().numpy().reshape(G, G, G)


def mesh_from_volume(vol: np.ndarray, level: float, radius: float,
                     gradient_direction: str = "descent"):
    """Iso-surface + rescale voxel coords to world (reference:
    create_mesh_from_volume, extract_by_mc.py:37-43)."""
    field = vol if gradient_direction == "descent" else -vol
    lvl = level if gradient_direction == "descent" else -level
    verts, tris = marching_cubes(field, lvl)
    G = vol.shape[0]
    verts = verts * (2 * radius) / (G - 1) - radius
    return verts.astype(np.float32), tris


def _attribute(params, pts, feature, normal, conf, attr: str):
    """One attribute head at points with their feature and normal."""
    if attr == "base_color":
        return fields.base_color_apply(
            params["base-color-network"], pts, feature, normal, conf)
    if attr == "implicit_illumination":
        return fields.implicit_illumination_apply(
            params.get("implicit-illumination-network"), pts, feature,
            normal, conf)
    if attr in ("roughness", "roughness_std"):
        v, s = fields.roughness_apply(
            params["roughness-network"], pts, feature, normal, conf)
        return v if attr == "roughness" else s
    if attr in ("specular_reflectance", "specular_reflectance_std"):
        v, s = fields.specular_reflectance_apply(
            params.get("specular-reflectance-network"), pts, feature, normal,
            conf)
        return v if attr == "specular_reflectance" else s
    raise ValueError(attr)


def compute_vertex_attribute(params, conf, verts: np.ndarray,
                             attr: str) -> np.ndarray:
    """Per-vertex attribute with the spatial-gradient normal (reference
    ``_attr_batch``: the normal is d sdf / d x, kept without a graph)."""
    dev = params_device(params)
    params = fields.with_octa_table(params, conf)
    geo = params["geometric-network"]
    B = conf.extraction.batch_size
    n = len(verts)
    v = np.concatenate([verts, np.zeros(((-n) % B, 3), np.float32)])
    v = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
    out = []
    for b in range(0, len(v), B):
        x = v[b:b + B].detach().requires_grad_(True)
        with torch.enable_grad():
            sdf, feature, _ = fields.geometric_apply(geo, x, conf)
            (normal,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf))
        with torch.no_grad():
            out.append(_attribute(params, x.detach(), feature.detach(),
                                  normal, conf, attr))
    return torch.cat(out)[:n].cpu().numpy()


def _to_rgb(color: np.ndarray, fill_dim: int) -> np.ndarray:
    """1-channel attributes fill a single RGB dim (reference:
    create_rgb_color, extract_by_mc.py:187-194)."""
    if fill_dim == -1:
        return np.clip(color, 0.0, 1.0)
    rgb = np.zeros((color.shape[0], 3), np.float32)
    rgb[:, fill_dim:fill_dim + 1] = np.clip(color[:, :1], 0.0, 1.0)
    return rgb


_ATTR_SPECS = [
    # (attr name, fill dim when the value is 1-channel, is_std) — fill dims
    # match reference extract_by_mc.py:199-207 (illum -> blue, roughness ->
    # green, 1-channel specular -> red)
    ("base_color", -1, False),
    ("implicit_illumination", 2, False),
    ("roughness", 1, False),
    ("specular_reflectance", 0, False),
    ("roughness_std", 1, True),
    ("specular_reflectance_std", 0, True),
]


def save_attributed_meshes(params, conf, dirname, fname, verts, tris,
                           mesh_type: str, idx: int, train: bool) -> str:
    G = conf.extraction.rough_grid_size if train else conf.extraction.grid_size
    fpath = ""
    for attr, fill_dim_1ch, is_std in _ATTR_SPECS:
        vc = compute_vertex_attribute(params, conf, verts, attr)
        fill = fill_dim_1ch if vc.shape[-1] == 1 else -1
        colors = _to_rgb(vc, fill)
        # stds normalize AFTER the [0,1] clip (reference order,
        # extract_by_mc.py:213-216)
        if is_std and colors.max() > 0:
            colors = colors / colors.max()
        fpath = os.path.join(
            dirname, f"{fname}_{G}grid_{mesh_type}_{attr}_mesh{idx:02d}.obj")
        save_obj(fpath, verts, tris, colors)
    logger.info(f"#vertices = {len(verts)}  #triangles = {len(tris)}")
    return fpath


def environment_map_directions(H: int = 256) -> np.ndarray:
    """(H * 2H, 3) float32 equirect directions, the reference's angle-grid
    convention (extract_by_mc.py:226-261, which swaps the names)."""
    W = 2 * H
    thetas = np.linspace(0, np.pi, H)
    phis = np.linspace(-np.pi, np.pi, W)
    the, phi = np.meshgrid(phis, thetas)  # reference swaps the names
    x = np.cos(phi) * np.sin(the)
    y = np.sin(phi) * np.sin(the)
    z = np.cos(the)
    return np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)


def extract_environment_map(params, conf, dirname: str) -> None:
    """Equirect env-light export: ``environment_map.png`` and
    ``environment_map_min_max.txt`` (reference: extract_by_mc.py:226-261)."""
    H = 256
    W = 2 * H
    dirs = torch.from_numpy(environment_map_directions(H)).to(
        params_device(params))
    with torch.no_grad():
        vals = fields.environment_light_apply(
            params["environment-light-network"], dirs, conf).cpu().numpy()
    M, m = vals.max(), vals.min()
    if conf.environment_light_network.act_last == "sigmoid":
        img = vals * 255.0
    elif m != M:
        img = vals / M * 255.0
    else:
        img = 255.0 * np.ones_like(vals)
    ch = img.shape[-1]
    img = img.reshape((H, W, 3) if ch == 3 else (H, W))
    img = np.clip(img, 0, 255).astype(np.uint8)
    write_png(os.path.join(dirname, "environment_map.png"), img)
    with open(os.path.join(dirname, "environment_map_min_max.txt"), "w") as f:
        f.write(f"min, max = {m}, {M}")


def ellipse_footprint(margin: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (2m+1, 2m+1)) as a bool
    array: row i spans c +- round(c * sqrt((r^2 - dy^2) / r^2)), dy = i - r,
    r = c = m, rounded half to even as cv2's ``saturate_cast<int>`` does.
    Not the disc x^2 + y^2 <= r^2."""
    size = 2 * margin + 1
    r = c = margin
    inv_r2 = 1.0 / (r * r) if r else 0.0
    fp = np.zeros((size, size), bool)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        fp[i, max(c - dx, 0):min(c + dx + 1, size)] = True
    return fp


def dilate(mask: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Binary dilation of a bool (H, W) mask by a centred footprint whose
    rows are centred runs (as :func:`ellipse_footprint`'s are), outside the
    image counting as False: ``scipy.ndimage.binary_dilation(mask,
    footprint)``, computed as the OR over footprint rows of a 1-D maximum
    filter of the row's width shifted by the row's offset (linear in the
    footprint's height instead of its area)."""
    r = footprint.shape[0] // 2
    m = mask.astype(np.uint8)
    H = m.shape[0]
    out = np.zeros(m.shape, bool)
    by_width = {}
    for i, row in enumerate(footprint):
        w, dy = int(row.sum()), i - r
        if w == 0 or abs(dy) >= H:
            continue
        if w not in by_width:
            by_width[w] = maximum_filter1d(m, w, axis=1, mode="constant",
                                           cval=0).astype(bool)
        h = by_width[w]
        # out[y] |= h[y - dy]
        if dy >= 0:
            out[dy:] |= h[:H - dy]
        else:
            out[:H + dy] |= h[-dy:]
    return out


def clean_points_by_mask(points: np.ndarray, dataset, conf) -> np.ndarray:
    """Visibility trim: a vertex survives if it projects inside every view's
    dilated mask (reference: clean_points_by_mask, extract_by_mc.py:77-102 —
    which hardcodes DTU's 1600x1200; the dataset's true size is used)."""
    margin = conf.valid.dtumvs.pixel_margin
    fp = ellipse_footprint(margin)
    inside = np.ones(len(points), bool)
    H, W = dataset.H, dataset.W
    for i in range(dataset.size):
        pose = dataset.poses[i]
        R = np.linalg.inv(pose[:3, :3])
        t = -R @ pose[:3, 3:]
        K = dataset.intrinsics[i]
        pts_img = (K @ (R @ points.T + t)).T
        pts_img = pts_img / pts_img[:, 2:]
        pts_img = np.round(pts_img).astype(np.int32) + 1

        mask = dilate(dataset.masks[i][..., 0] >= 0.5, fp).astype(np.int32)
        # 1-pixel all-ones border so out-of-view points survive
        mask = np.pad(mask, 1, constant_values=1)
        cur = mask[pts_img[:, 1].clip(0, H + 1), pts_img[:, 0].clip(0, W + 1)]
        inside &= cur.astype(bool)
    return inside


def _component_mesh(verts, tris, labels, comp):
    cmask = labels == comp
    ctris = tris[cmask]
    used = np.unique(ctris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used].copy(), remap[ctris]


def largest_component_meshes(verts, tris, top_k: int = 3):
    """Top-k components by surface AREA (reference: create_largest_meshes,
    extract_by_mc.py:131-140)."""
    labels = connected_components(tris, len(verts))
    tri_v = verts[tris]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]),
        axis=-1)
    comp_area = np.bincount(labels, weights=areas)
    order = np.argsort(comp_area)[::-1][:top_k]
    return [_component_mesh(verts, tris, labels, comp) for comp in order]


def trimmed_component_meshes(verts, tris, keep_mask: np.ndarray, top_k=5):
    """Drop masked-out vertices, split into components, largest first
    (reference: create_trimmed_meshes, extract_by_mc.py:106-128)."""
    idx_map = np.full(len(verts), -1, np.int64)
    idx_map[keep_mask] = np.arange(keep_mask.sum())
    fmask = keep_mask[tris].all(axis=1)
    new_tris = idx_map[tris[fmask]]
    new_verts = verts[keep_mask]
    if len(new_tris) == 0:
        return []
    labels = connected_components(new_tris, len(new_verts))
    counts = np.bincount(labels)
    order = np.argsort(counts)[::-1][:top_k]
    return [_component_mesh(new_verts, new_tris, labels, comp)
            for comp in order]


def extract(params, conf, dirname: str, fname: str, dataset=None,
            final: bool = False, train: bool = False) -> str:
    """Full extraction pipeline (reference: extract, extract_by_mc.py:263-288).
    Returns the path of the last mesh written, "" for an empty surface."""
    os.makedirs(dirname, exist_ok=True)
    extract_environment_map(params, conf, dirname)
    params = fields.with_octa_table(params, conf)

    radius = conf.renderer.bounding_sphere_radius
    G = conf.extraction.rough_grid_size if train else conf.extraction.grid_size
    logger.info(f"Extracting mesh at {G}^3")
    vol = compute_sdf_volume(params, conf, G)
    verts, tris = mesh_from_volume(vol, conf.extraction.level, radius,
                                   conf.extraction.gradient_direction)
    if len(verts) == 0:
        logger.info("Empty iso-surface; skipping mesh export")
        return ""
    fpath = save_attributed_meshes(params, conf, dirname, fname, verts, tris,
                                   "raw", 0, train)

    if final and dataset is not None:
        logger.info("Trimming mesh by mask")
        keep = clean_points_by_mask(verts, dataset, conf)
        comps = trimmed_component_meshes(verts, tris, keep, top_k=5)
        for k in range(len(comps) - 1, -1, -1):
            cv_, ct_ = comps[k]
            fpath = save_attributed_meshes(params, conf, dirname, fname,
                                           cv_, ct_, "trimmed", k, train)
    return fpath


def extract_mesh_for_validation(params, conf, monitor_path: str, epoch: int,
                                final: bool = False, dataset=None) -> str:
    return extract(params, conf, monitor_path, f"model_{epoch:05d}",
                   dataset=dataset, final=final, train=not final)
