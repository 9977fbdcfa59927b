"""Mesh postprocessing: smoothing, illumination rebake, texture baking (the
port's counterpart of ``ndjir_tpu/tools/mesh_post.py``).

Parity surface with reference scripts/smooth_mesh.py,
rebake_implicit_illumination.py, bake_vertex_attribute_to_texture.py — all
rebuilt dependency-free (the reference needs open3d + Blender bpy):
smoothing is the umbrella laplacian of ``eval/chamfer.py`` and the rebake
is elementwise, both host numpy as in the JAX package; texture baking uses
a per-face triangle atlas (every triangle gets a right-triangle patch in a
grid atlas, vertex colors interpolated barycentrically) with matching OBJ
UVs + MTL, readable by any DCC tool.  The bake interpolates every patch at
once on a device (the JAX package loops over the faces in Python), and the
files are the JAX package's byte for byte: the same float64 interpolation
of the float32 colours, stored as float32 and truncated to uint8, the same
``%.6f`` UV text.

Run: python -m ndjir_torch.tools.mesh_post <smooth|rebake|bake> ...
     (bake takes --device cuda|cpu)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ndjir_torch.eval.chamfer import laplacian_smooth
from ndjir_torch.utils.mesh_io import _lines, load_obj, save_obj
from ndjir_torch.utils.png import write_png

# faces interpolated at once by the bake (bounds its float64 temporaries,
# ~0.4 GB at 4x4-pixel patches)
FACE_CHUNK = 1 << 20


def smooth_mesh(fpath: str, iterations: int = 2) -> str:
    """reference: smooth_mesh.py (open3d filter_smooth_simple)."""
    V, F, C = load_obj(fpath)
    V2 = laplacian_smooth(V, F, iterations)
    out = os.path.splitext(fpath)[0] + "_smoothed.obj"
    save_obj(out, V2, F, C)
    return out


def rebake_implicit_illumination(base_color_path: str, illum_path: str,
                                 num_lerps: int = 3) -> list[str]:
    """Multiply the implicit-illumination channel into the base-color mesh
    plus alpha-blended variants (reference:
    rebake_implicit_illumination.py:22-47; illumination lives in the blue
    channel of the attribute mesh)."""
    V0, F0, C0 = load_obj(base_color_path)
    _, _, C1 = load_obj(illum_path)
    if C0 is None or C1 is None:
        raise ValueError("Both meshes must carry vertex colors")
    illum = np.repeat(C1[:, 2:3], 3, axis=1)  # blue channel -> gray
    baked = C0 * illum

    stem = os.path.splitext(base_color_path)[0]
    outs = []
    p = f"{stem}_ilbaked.obj"
    save_obj(p, V0, F0, baked)
    outs.append(p)
    for alpha in np.linspace(0.0, 1.0, num_lerps + 2)[1:]:
        pa = f"{stem}_ilbaked_{alpha}.obj"
        save_obj(pa, V0, F0, (1 - alpha) * C0 + alpha * baked)
        outs.append(pa)
    return outs


def bake_atlas(F: np.ndarray, C: np.ndarray, texture_size: int = 1024,
               patch_px: int | None = None, device="cuda"):
    """The per-face atlas of :func:`bake_vertex_colors_to_texture`: the
    (T, T, 3) uint8 texture, computed on ``device``, and the (nf, 3, 2)
    float32 UVs.

    Face i owns the patch at row i // per_row, column i % per_row.  A patch
    pixel (y, x) sits at (u, v) = ((x + 1/4) / patch, (y + 1/4) / patch) in
    the right triangle (0,0), (1,0), (0,1), and takes the colour
    w0 c0 + w1 c1 + w2 c2 with (w0, w1, w2) = clip((1 - u - v, u, v), 0, 1)
    where u + v <= 1 + 1.5 / patch (a gutter of about a pixel), else black;
    so all patches are one (nf, patch, patch, 3) block, laid out row by row.
    """
    nf = len(F)
    per_row = int(np.ceil(np.sqrt(nf)))
    patch = patch_px or max(4, texture_size // per_row)
    tex_size = per_row * patch

    yy, xx = np.mgrid[0:patch, 0:patch]
    # barycentric coords of the right triangle (0,0), (1,0), (0,1) in patch
    u = (xx + 0.25) / patch
    v = (yy + 0.25) / patch
    inside = u + v <= 1.0 + 1.5 / patch  # gutter: fill slightly beyond edge
    w = [torch.from_numpy(np.clip(a, 0, 1)).to(device)[None, :, :, None]
         for a in (1 - u - v, u, v)]
    inside = torch.from_numpy(inside).to(device)[None, :, :, None]

    # float32 colours against float64 weights: the products and sums in
    # float64, rounded once into the float32 texture; faces in chunks of
    # FACE_CHUNK to bound the float64 temporaries
    Fd = torch.from_numpy(np.asarray(F, np.int64)).to(device)
    Cd = torch.from_numpy(np.asarray(C, np.float32)).to(device)
    block = torch.zeros((per_row * per_row, patch, patch, 3),
                        dtype=torch.float32, device=device)
    for i in range(0, nf, FACE_CHUNK):
        c = [Cd[Fd[i:i + FACE_CHUNK, k]].double()[:, None, None, :]
             for k in range(3)]
        colors = w[0] * c[0] + w[1] * c[1] + w[2] * c[2]
        block[i:i + len(colors)] = torch.where(inside, colors, 0.0).float()
    tex = (block.view(per_row, per_row, patch, patch, 3)
           .permute(0, 2, 1, 3, 4).reshape(tex_size, tex_size, 3))
    tex8 = (tex.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    # UVs (image y axis flipped for OBJ convention), as the face loop makes
    # them: float64 sums stored as float32
    r, col = np.divmod(np.arange(nf), per_row)
    base_u = (col * patch) / tex_size
    base_v = 1.0 - (r * patch) / tex_size
    d = patch / tex_size * (1 - 1.0 / patch)
    uvs = np.stack([np.stack([base_u, base_v], -1),
                    np.stack([base_u + d, base_v], -1),
                    np.stack([base_u, base_v - d], -1)], 1).astype(np.float32)
    return tex8, uvs


def bake_vertex_colors_to_texture(fpath: str, texture_size: int = 1024,
                                  patch_px: int | None = None,
                                  device="cuda") -> str:
    """Bake per-vertex colors into a texture with a per-face triangle atlas
    (:func:`bake_atlas`, on ``device``).

    Each triangle gets an axis-aligned right-triangle patch in a grid atlas;
    UVs point into the patch and colors are interpolated barycentrically with
    a 1px gutter.  Output: <stem>_textured.obj + .mtl + .png.
    (The reference shells out to headless Blender Cycles for this,
    bake_vertex_attribute_to_texture.py:24-52.)
    """
    V, F, C = load_obj(fpath)
    if C is None:
        raise ValueError("Mesh has no vertex colors to bake")
    tex, uvs = bake_atlas(F, C, texture_size, patch_px, device)

    stem = os.path.splitext(fpath)[0]
    tex_path = f"{stem}_texture.png"
    write_png(tex_path, tex)

    mtl_path = f"{stem}_textured.mtl"
    with open(mtl_path, "w") as f:
        f.write("newmtl baked\nKa 1 1 1\nKd 1 1 1\n"
                f"map_Kd {os.path.basename(tex_path)}\n")

    obj_path = f"{stem}_textured.obj"
    # face i: its corners' vertices (1-based) and its three UVs 3i + 1..3
    a = np.asarray(F, np.int64) + 1
    t = 3 * np.arange(len(F), dtype=np.int64) + 1
    with open(obj_path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\nusemtl baked\n")
        f.write(_lines("v %.6f %.6f %.6f\n", np.asarray(V, np.float32)))
        f.write(_lines("vt %.6f %.6f\n", uvs.reshape(-1, 2)))
        f.write(_lines("f %d/%d %d/%d %d/%d\n", np.stack(
            [a[:, 0], t, a[:, 1], t + 1, a[:, 2], t + 2], axis=1)))
    return obj_path


def main(argv=None):
    import argparse

    from ndjir_torch.cli import _device

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("smooth")
    s.add_argument("mesh")
    s.add_argument("--iters", type=int, default=2)
    r = sub.add_parser("rebake")
    r.add_argument("-f0", "--base_color", required=True)
    r.add_argument("-f1", "--illumination", required=True)
    r.add_argument("-n", "--num_lerps", type=int, default=3)
    b = sub.add_parser("bake")
    b.add_argument("mesh")
    b.add_argument("--size", type=int, default=1024)
    b.add_argument("--device", default="cuda",
                   help="device of the bake (default cuda; cpu runs it on "
                   "the host)")
    args = p.parse_args(argv)
    if args.cmd == "smooth":
        print(smooth_mesh(args.mesh, args.iters))
    elif args.cmd == "rebake":
        print(rebake_implicit_illumination(args.base_color,
                                           args.illumination, args.num_lerps))
    elif args.cmd == "bake":
        print(bake_vertex_colors_to_texture(args.mesh, args.size,
                                            device=_device(args)))


if __name__ == "__main__":
    main()
