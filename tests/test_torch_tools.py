"""The port's capture-to-DCC tools (``ndjir_torch/tools/``) against the JAX
package's (``ndjir_tpu/tools/``) on the same inputs, on the CPU: COLMAP
import, the visual hull and camera normalization, smoothing, illumination
rebake and texture baking, the mesh views, camera export and the image
folder tools."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from ndjir_tpu.extract.native import marching_cubes
from ndjir_tpu.utils.mesh_io import save_obj


def _sphere_obj(path, G=32, blob=0.0):
    """A marching-cubes sphere of radius 0.5 (a bumpy blob with ``blob``)
    with vertex colours, written by the JAX package's OBJ writer."""
    lin = np.linspace(-1, 1, G).astype(np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    bump = blob * np.sin(5 * X) * np.sin(4 * Y + 1) * np.sin(3 * Z + 2)
    vol = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5 - bump
    verts, tris = marching_cubes(vol, 0.0)
    w = (verts * 2 / (G - 1) - 1).astype(np.float32)
    save_obj(path, w, tris, (w * 0.5 + 0.5).astype(np.float32))
    return path


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    return _sphere_obj(str(tmp_path_factory.mktemp("mesh") / "sphere.obj"))


def _copy(src, dst_dir):
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, os.path.basename(src))
    shutil.copy(src, dst)
    return dst


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---------------------------------------------------------------------------
# COLMAP import
# ---------------------------------------------------------------------------

def _colmap_scene(root, rng, n_views=3, model="PINHOLE"):
    """sparse/0 text files of ``n_views`` random cameras (view 1 dropped by
    COLMAP: no pose line) and n_views image/mask files."""
    sp = os.path.join(root, "sparse", "0")
    os.makedirs(sp)
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(root, sub))
        for i in range(n_views):
            open(os.path.join(root, sub, f"{i:03d}.png"), "w").close()
    params = "500 320 240" if model.startswith("SIMPLE") \
        else "500 510 320 240"
    with open(os.path.join(sp, "cameras.txt"), "w") as f:
        f.write(f"# comment\n1 {model} 640 480 {params}\n")
    from ndjir_tpu.tools.colmap import qvec2rotmat

    with open(os.path.join(sp, "images.txt"), "w") as f:
        f.write("# header\n")
        for i in range(n_views):
            if i == 1:
                continue
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            t = -qvec2rotmat(q) @ (rng.randn(3) + [0, 0, 4.0])
            f.write(f"{i + 1} " + " ".join(repr(float(a)) for a in
                                           (*q, *t))
                    + f" 1 im{i:03d}.png\n")
            f.write("0.0 0.0 -1\n")


@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_RADIAL"])
def test_colmap_matches_jax(tmp_path, rng, model):
    """cameras.npz arrays equal, and the same files deleted for the view
    COLMAP dropped."""
    from ndjir_torch.tools import colmap as P
    from ndjir_tpu.tools import colmap as J

    _colmap_scene(str(tmp_path / "jax"), rng, model=model)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    pj = J.convert_colmap_to_npz(str(tmp_path / "jax"))
    pp = P.convert_colmap_to_npz(str(tmp_path / "port"))
    assert sorted(pj) == sorted(pp)
    with np.load(tmp_path / "jax" / "cameras.npz") as a, \
            np.load(tmp_path / "port" / "cameras.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for sub in ("image", "mask"):
        assert sorted(os.listdir(tmp_path / "jax" / sub)) == \
            sorted(os.listdir(tmp_path / "port" / sub))
    assert len(os.listdir(tmp_path / "port" / "image")) == 2


def test_colmap_rejects_other_models(tmp_path, rng):
    from ndjir_torch.tools.colmap import read_cameras

    p = tmp_path / "cameras.txt"
    p.write_text("1 OPENCV 640 480 500 510 320 240 0 0 0 0\n")
    with pytest.raises(ValueError, match="OPENCV"):
        read_cameras(str(p))


# ---------------------------------------------------------------------------
# visual hull and camera normalization
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from ndjir_tpu.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(str(tmp_path_factory.mktemp("s") / "scene"),
                                n_views=8, H=48, W=48, radius=0.5)


def _Ps(scene):
    with np.load(os.path.join(scene, "cameras.npz")) as cams:
        n = len([k for k in cams.files if k.startswith("world_mat_")
                 and "inv" not in k])
        return np.stack([cams[f"world_mat_{i}"][:3, :4] for i in range(n)])


@pytest.mark.parametrize("scale,grid_size,center",
                         [(2.0, 100, (0.0, 0.0, 0.0)),
                          (3.0, 64, (0.05, -0.1, 0.0))])
def test_visual_hull_matches_jax(scene, scale, grid_size, center):
    """The same hull points in the same order; centroid and radius within
    1e-12 of the JAX function's."""
    from ndjir_torch.tools import normalize_cameras as P
    from ndjir_tpu.tools import normalize_cameras as J

    masks_np = J.load_masks(os.path.join(scene, "mask"))
    masks = P.load_masks(os.path.join(scene, "mask"), "cpu")
    assert masks.dtype == torch.bool
    np.testing.assert_array_equal(masks.numpy(), masks_np > 0.5)
    Ps = _Ps(scene)
    cj, rj, hj = J.visual_hull(masks_np, Ps, scale=scale, center=center,
                               grid_size=grid_size)
    cp, rp, hp = P.visual_hull(masks, Ps, scale=scale, center=center,
                               grid_size=grid_size)
    assert hp.shape == hj.shape and len(hj) > 100
    np.testing.assert_array_equal(hp.numpy(), hj)
    np.testing.assert_allclose(cp, cj, rtol=1e-12, atol=1e-15)
    assert abs(rp - rj) <= 1e-12 * abs(rj)


def test_visual_hull_points_behind_the_camera():
    """A camera inside the grid: points at depth <= 0 (inf or nan after the
    division) are never counted, as in the JAX function."""
    from ndjir_torch.tools import normalize_cameras as P
    from ndjir_tpu.tools import normalize_cameras as J

    K = np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]])
    Ps = np.stack([K @ np.eye(3, 4), K @ np.array(
        [[0, 0, 1.0, 0], [0, 1.0, 0, 0], [-1.0, 0, 0, 0]])])
    masks = np.zeros((2, 32, 32), np.float32)
    masks[:, 8:24, 8:24] = 1
    cj, rj, hj = J.visual_hull(masks, Ps, scale=1.0, grid_size=21,
                               min_views=1)
    cp, rp, hp = P.visual_hull(torch.from_numpy(masks > 0.5), Ps,
                               scale=1.0, grid_size=21, min_views=1)
    np.testing.assert_array_equal(hp.numpy(), hj)
    np.testing.assert_allclose(cp, cj, rtol=1e-12, atol=1e-15)


def test_normalize_cameras_matches_jax(scene, tmp_path):
    from ndjir_torch.tools import normalize_cameras as P
    from ndjir_tpu.tools import normalize_cameras as J

    shutil.copytree(scene, tmp_path / "jax")
    shutil.copytree(scene, tmp_path / "port")
    a = J.normalize_cameras(str(tmp_path / "jax"), grid_scale=2.0)
    b = P.normalize_cameras(str(tmp_path / "port"), grid_scale=2.0,
                            device="cpu")
    with np.load(a) as ja, np.load(b) as pb:
        assert sorted(ja.files) == sorted(pb.files)
        for k in ja.files:
            assert ja[k].dtype == pb[k].dtype
            np.testing.assert_allclose(pb[k], ja[k], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(pb["scale_mat_0"][:3, 3], 0.0, atol=0.15)


def test_normalize_cameras_cli(scene, tmp_path):
    from ndjir_torch.tools import normalize_cameras as P

    shutil.copytree(scene, tmp_path / "s")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.main(["--source_dir", str(tmp_path / "s")])
    P.main(["--source_dir", str(tmp_path / "s"), "--device", "cpu",
            "--replace"])
    with np.load(tmp_path / "s" / "cameras.npz") as c:
        assert "scale_mat_0" in c.files
    assert not (tmp_path / "s" / "cameras_new.npz").exists()


# ---------------------------------------------------------------------------
# mesh post-processing
# ---------------------------------------------------------------------------

def test_smooth_and_rebake_match_jax(sphere, tmp_path):
    """The OBJ files byte-equal."""
    from ndjir_torch.tools import mesh_post as P
    from ndjir_tpu.tools import mesh_post as J

    a, b = _copy(sphere, str(tmp_path / "jax")), \
        _copy(sphere, str(tmp_path / "port"))
    for it in (1, 2):
        assert _same_bytes(J.smooth_mesh(a, it), P.smooth_mesh(b, it))
    outs_j = J.rebake_implicit_illumination(a, a, num_lerps=3)
    outs_p = P.rebake_implicit_illumination(b, b, num_lerps=3)
    assert [os.path.basename(p) for p in outs_j] == \
        [os.path.basename(p) for p in outs_p]
    assert len(outs_p) == 5
    for x, y in zip(outs_j, outs_p):
        assert _same_bytes(x, y)


@pytest.mark.parametrize("size,patch", [(256, None), (64, None),
                                        (1024, None), (256, 3)])
def test_bake_matches_jax(sphere, tmp_path, size, patch):
    """OBJ and MTL text byte-equal, the decoded textures equal (imageio's
    PNG bytes differ by compressor)."""
    import imageio.v2 as imageio

    from ndjir_torch.tools import mesh_post as P
    from ndjir_torch.utils.png import read_png
    from ndjir_tpu.tools import mesh_post as J

    a, b = _copy(sphere, str(tmp_path / "jax")), \
        _copy(sphere, str(tmp_path / "port"))
    oa = J.bake_vertex_colors_to_texture(a, size, patch)
    ob = P.bake_vertex_colors_to_texture(b, size, patch, device="cpu")
    assert _same_bytes(oa, ob)
    assert _same_bytes(oa.replace(".obj", ".mtl"),
                       ob.replace(".obj", ".mtl"))
    ta = np.asarray(imageio.imread(a.replace(".obj", "_texture.png")))
    tb = read_png(b.replace(".obj", "_texture.png"))
    assert ta.shape == tb.shape and tb.dtype == np.uint8
    np.testing.assert_array_equal(ta, tb)
    assert tb.any()


def test_bake_in_face_chunks(sphere, tmp_path, monkeypatch):
    """The bake's face chunks (a few faces each here) give the texture of
    one pass."""
    from ndjir_torch.tools import mesh_post as P
    from ndjir_torch.utils.mesh_io import load_obj

    _, F, C = load_obj(sphere)
    tex, uvs = P.bake_atlas(F, C, 256, device="cpu")
    monkeypatch.setattr(P, "FACE_CHUNK", 997)
    tex2, uvs2 = P.bake_atlas(F, C, 256, device="cpu")
    np.testing.assert_array_equal(tex, tex2)
    np.testing.assert_array_equal(uvs, uvs2)


def test_mesh_post_cli(sphere, tmp_path):
    from ndjir_torch.tools import mesh_post as P

    b = _copy(sphere, str(tmp_path))
    P.main(["smooth", b, "--iters", "1"])
    P.main(["rebake", "-f0", b, "-f1", b, "-n", "1"])
    P.main(["bake", b, "--size", "128", "--device", "cpu"])
    for name in ("sphere_smoothed.obj", "sphere_ilbaked.obj",
                 "sphere_ilbaked_0.5.obj", "sphere_textured.obj",
                 "sphere_textured.mtl", "sphere_texture.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_laplacian_smooth_matches_jax(rng):
    """The edge keys' unique gives np.unique(axis=0)'s edges: the smoothed
    vertices bitwise, on a mesh with repeated and reversed edges."""
    from ndjir_torch.eval.chamfer import laplacian_smooth as P
    from ndjir_tpu.eval.chamfer import laplacian_smooth as J

    n = 500
    tris = rng.randint(0, n, (1500, 3))
    tris = np.concatenate([tris, tris[:200, ::-1], tris[:100]])
    v = rng.randn(n + 7, 3).astype(np.float32)   # 7 vertices unused
    for it in (0, 1, 3):
        np.testing.assert_array_equal(P(v, tris, it), J(v, tris, it))


# ---------------------------------------------------------------------------
# the OBJ reader's fast path
# ---------------------------------------------------------------------------

def _obj_texts(rng):
    v = (rng.randn(40, 3) * 10.0 ** rng.randint(-9, 9, (40, 1))
         ).astype(np.float32)
    c = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    f = rng.randint(0, 40, (30, 3))
    vl = "".join(f"v {a!r} {b!r} {d!r}\n" for a, b, d in v.tolist())
    cl = "".join(f"v {a:.6f} {b:.6f} {d:.6f} {x:.9g} {y:.9g} {z:.3e}\n"
                 for (a, b, d), (x, y, z) in zip(v.tolist(), c.tolist()))
    fl = "".join(f"f {a + 1} {b + 1} {d + 1}\n" for a, b, d in f.tolist())
    return {
        "plain": vl + fl,
        "colors": "# a comment\nmtllib x.mtl\n" + cl + fl + "\n",
        "slashes": cl + "vt 0.5 0.5\n" + "".join(
            f"f {a + 1}/1 {b + 1}/1 {d + 1}/1\n" for a, b, d in f.tolist()),
        "indented": " " + cl + fl,
        "tabs": cl.replace(" ", "\t", 5) + fl,
        "crlf": (cl + fl).replace("\n", "\r\n"),
        "ragged colors": cl + vl.splitlines(True)[0] + fl,
        "double space": cl.replace(" ", "  ", 3) + fl,
        "quads": cl + "".join(f"f {a + 1} {b + 1} {d + 1} {a + 1}\n"
                              for a, b, d in f.tolist()),
        "no faces": cl,
    }


def test_load_obj_matches_jax(tmp_path, rng):
    """The port's reader (a whole-file fast path for save_obj's layout,
    else line by line) returns the JAX reader's arrays on plain, coloured,
    textured, indented, tab-, CRLF- and double-spaced files."""
    from ndjir_torch.utils import mesh_io as P
    from ndjir_tpu.utils import mesh_io as J

    fast = set()
    for name, text in _obj_texts(rng).items():
        path = tmp_path / (name.replace(" ", "_") + ".obj")
        path.write_bytes(text.encode())
        with open(path, "rb") as fh:
            if P._load_obj_plain(fh.read()) is not None:
                fast.add(name)
        got, want = P.load_obj(str(path)), J.load_obj(str(path))
        for g, w in zip(got, want):
            if w is None:
                assert g is None, name
            else:
                assert g.dtype == w.dtype and g.shape == w.shape, name
                np.testing.assert_array_equal(g, w, err_msg=name)
    assert fast == {"plain", "colors", "quads"}


# ---------------------------------------------------------------------------
# views
# ---------------------------------------------------------------------------

def painter_reference(verts, faces, colors, eye, res, fov=45.0):
    """A plain painter's loop at the pixel centres: faces in the stable
    far-to-near order of their mean camera depth, each painting every pixel
    centre inside it (edges included) with its colour, rounded to 8 bits
    as Agg rounds it."""
    from ndjir_tpu.tools.viewers import _look_at_rotation

    eye = np.asarray(eye, float)
    R = _look_at_rotation(eye)
    V = np.asarray(verts, np.float32)
    d = [V[:, k].astype(np.float64) - eye[k] for k in range(3)]
    cam = [(d[0] * R[k, 0] + d[1] * R[k, 1]) + d[2] * R[k, 2]
           for k in range(3)]
    f = 1.0 / np.tan(np.radians(fov) / 2)
    z = np.maximum(cam[2], 1e-6)
    x, y = f * cam[0] / z, -f * cam[1] / z
    zf = cam[2][faces]
    order = np.argsort(-((zf[:, 0] + zf[:, 1] + zf[:, 2]) / 3), kind="stable")
    if colors is not None:
        c = colors[faces]
        fc = ((c[:, 0] + c[:, 1] + c[:, 2]) / np.float32(3)).astype(float)
    else:
        v0, v1, v2 = (V[faces[:, k]] for k in range(3))
        a, b = v1 - v0, v2 - v0
        n = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                      a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                      a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)
        norm = np.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                       + n[:, 2] * n[:, 2])
        n = (n / np.maximum(norm, np.float32(1e-12))[:, None]).astype(float)
        lam = np.abs(n[:, 0] * R[2, 0] + n[:, 1] * R[2, 1]
                     + n[:, 2] * R[2, 2])
        fc = np.repeat((lam * 0.8 + 0.1)[:, None], 3, axis=1)
    fc8 = np.floor(np.clip(fc, 0, 1) * 255 + 0.5).astype(np.uint8)
    jj, ii = np.meshgrid(np.arange(res), np.arange(res))
    cx = (2 * jj + 1) / res - 1
    cy = 1 - (2 * ii + 1) / res
    img = np.full((res, res, 3), 255, np.uint8)
    for fi in order:
        px, py = x[faces[fi]], y[faces[fi]]
        area = ((px[1] - px[0]) * (py[2] - py[0])
                - (py[1] - py[0]) * (px[2] - px[0]))
        if not np.isfinite(area) or area == 0:
            continue
        inside = np.ones((res, res), bool)
        for a, b in ((0, 1), (1, 2), (2, 0)):
            e = ((px[b] - px[a]) * (cy - py[a])
                 - (py[b] - py[a]) * (cx - px[a]))
            inside &= e * np.sign(area) >= 0
        img[inside] = fc8[fi]
    return img


def _normalized(path):
    from ndjir_tpu.utils.mesh_io import load_obj

    V, F, C = load_obj(path)
    Vc = V - V.mean(axis=0)
    return Vc / np.abs(Vc).max(), F, C


@pytest.mark.parametrize("colored", [True, False])
@pytest.mark.parametrize("eye", [(1.2, -1.2, 0.8), (0.0, 0.05, 1.6),
                                 (0.3, 0.2, 0.4)])
def test_render_matches_painter_loop(sphere, colored, eye):
    """Bitwise the plain painter's loop: from outside, from above (the
    look-at's other up vector) and from inside the mesh (faces behind the
    camera, clamped to depth 1e-6)."""
    from ndjir_torch.tools.viewers import render_mesh_view

    V, F, C = _normalized(sphere)
    C = C if colored else None
    eye = np.asarray(eye) * 2 / 1.9
    got = render_mesh_view(V, F, C, eye, res=64, device="cpu")
    want = painter_reference(V, F, C, eye, 64)
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any()


def test_render_in_candidate_chunks_and_ties(sphere, monkeypatch):
    """Chunks of a few candidates give the image of one pass; two copies
    of every face at the same depth show the later one, as a stable
    painter's sequence draws it."""
    from ndjir_torch.tools import viewers as P

    V, F, C = _normalized(sphere)
    eye = np.array([1.2, -1.2, 0.8])
    one = P.render_mesh_view(V, F, C, eye, res=48, device="cpu")
    monkeypatch.setattr(P, "CANDIDATES", 64)
    np.testing.assert_array_equal(
        P.render_mesh_view(V, F, C, eye, res=48, device="cpu"), one)
    V2 = np.concatenate([V, V])
    F2 = np.concatenate([F, F + len(V)])
    C2 = np.concatenate([C, 1 - C])
    two = P.render_mesh_view(V2, F2, C2, eye, res=48, device="cpu")
    np.testing.assert_array_equal(two, painter_reference(V2, F2, C2, eye,
                                                         48))
    hit = (one != 255).any(-1)
    assert (two[hit] != one[hit]).any()


def test_render_against_jax_silhouette(tmp_path):
    """Against the JAX function (matplotlib's antialiased Agg painter) on a
    ~40k-face blob at res 256: the silhouettes agree with IoU >= 0.98; the
    colour gap inside them (antialiased edges blend in what lies behind)
    is reported, not held."""
    from ndjir_torch.tools.viewers import render_mesh_view
    from ndjir_tpu.tools import viewers as J

    V, F, C = _normalized(_sphere_obj(str(tmp_path / "blob.obj"), G=76,
                                      blob=0.06))
    assert 30_000 < len(F) < 60_000
    eye = np.array([1.2, -1.2, 0.8]) * 2 / 1.9
    for colors in (C, None):
        want = J.render_mesh_view(V, F, colors, eye, res=256)
        got = render_mesh_view(V, F, colors, eye, res=256, device="cpu")
        sw, sg = (want != 255).any(-1), (got != 255).any(-1)
        iou = (sw & sg).sum() / (sw | sg).sum()
        both = sw & sg
        gap = np.abs(got.astype(int) - want.astype(int))[both]
        print(f"{len(F)} faces, colours {colors is not None}: silhouette "
              f"IoU {iou:.4f}, mean |diff| inside {gap.mean():.2f} levels "
              f"(per channel {gap.mean(0).round(2).tolist()})")
        assert iou >= 0.98


def test_view_turntable_and_camera_renders(sphere, scene, tmp_path):
    """view_mesh, turntable and render_with_camera_params write the
    render_mesh_view images of the JAX package's cameras; their
    silhouettes agree with the JAX tools' PNGs."""
    import imageio.v2 as imageio

    from ndjir_torch.tools import viewers as P
    from ndjir_torch.utils.png import read_png
    from ndjir_tpu.tools import viewers as J

    a, b = _copy(sphere, str(tmp_path / "jax")), \
        _copy(sphere, str(tmp_path / "port"))
    V, F, C = _normalized(sphere)
    png = P.view_mesh(b, res=96, device="cpu")
    np.testing.assert_array_equal(read_png(png), P.render_mesh_view(
        V, F, C, np.array([1.2, -1.2, 0.8]) * 2.0 / 1.9, res=96,
        device="cpu"))
    pairs = [(J.view_mesh(a, res=96), png)]
    out = P.turntable(b, n_views=3, res=64, device="cpu")
    assert sorted(os.listdir(out)) == ["0000.png", "0001.png", "0002.png"]
    jout = J.turntable(a, n_views=3, res=64)
    pairs += [(os.path.join(jout, n), os.path.join(out, n))
              for n in sorted(os.listdir(out))]
    npz = os.path.join(scene, "cameras.npz")
    outs = P.render_with_camera_params(b, npz, res=64, indices=[0, 3],
                                       device="cpu")
    pairs += list(zip(J.render_with_camera_params(a, npz, res=64,
                                                  indices=[0, 3]), outs))
    assert [os.path.basename(p) for p in outs] == ["000000.png",
                                                   "000003.png"]
    for pj, pp in pairs:
        want = np.asarray(imageio.imread(pj))[..., :3]
        got = read_png(pp)
        assert got.shape == want.shape
        sw, sg = (want != 255).any(-1), (got != 255).any(-1)
        assert (sw & sg).sum() / (sw | sg).sum() >= 0.9


def test_export_cameras_json_matches_jax(scene, tmp_path):
    from ndjir_torch.tools import viewers as P
    from ndjir_tpu.tools import viewers as J

    npz = os.path.join(scene, "cameras.npz")
    a = J.export_cameras_json(npz, str(tmp_path / "jax.json"))
    b = P.export_cameras_json(npz, str(tmp_path / "port.json"))
    assert _same_bytes(a, b)
    with open(b) as f:
        assert len(json.load(f)) == 8


def test_viewers_cli(sphere, scene, tmp_path):
    from ndjir_torch.tools import viewers as P

    b = _copy(sphere, str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.main(["mesh", b])
    P.main(["mesh", b, "--device", "cpu", "--out", str(tmp_path / "v.png")])
    P.main(["turntable", b, "--views", "2", "--device", "cpu"])
    P.main(["export-cameras", _copy(os.path.join(scene, "cameras.npz"),
                                    str(tmp_path))])
    assert (tmp_path / "v.png").stat().st_size > 0
    assert len(os.listdir(tmp_path / "sphere_turntable")) == 2
    assert (tmp_path / "cameras_cameras.json").stat().st_size > 0


# ---------------------------------------------------------------------------
# image folders
# ---------------------------------------------------------------------------

def test_apply_mask_matches_jax(tmp_path, rng):
    import imageio.v2 as imageio

    from ndjir_torch.tools.images import apply_mask_to_images as P
    from ndjir_torch.utils.png import read_png
    from ndjir_tpu.tools.images import apply_mask_to_images as J

    for sub in ("img", "msk"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        im = rng.randint(0, 256, (16, 20, 3 + (i == 2))).astype(np.uint8)
        mk = rng.randint(0, 256, (16, 20) + ((3,) if i == 1 else ()))
        imageio.imwrite(str(tmp_path / "img" / f"{i}.png"), im)
        imageio.imwrite(str(tmp_path / "msk" / f"{i}.png"),
                        mk.astype(np.uint8))
    J(str(tmp_path / "img"), str(tmp_path / "msk"), str(tmp_path / "jax"))
    P(str(tmp_path / "img"), str(tmp_path / "msk"), str(tmp_path / "port"))
    for i in range(3):
        want = np.asarray(imageio.imread(str(tmp_path / "jax" / f"{i}.png")))
        got = read_png(str(tmp_path / "port" / f"{i}.png"))
        np.testing.assert_array_equal(got, want)


def test_rename_sequential_matches_jax(tmp_path):
    from ndjir_torch.tools.images import main, rename_sequential
    from ndjir_tpu.tools.images import rename_sequential as J

    names = ["b.png", "a.png", "c10.png", "c9.png"]
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        for n in names:
            (tmp_path / d / n).write_text(n)
    J(str(tmp_path / "jax"))
    rename_sequential(str(tmp_path / "port"))
    got = {n: (tmp_path / "port" / n).read_text()
           for n in os.listdir(tmp_path / "port")}
    assert got == {n: (tmp_path / "jax" / n).read_text()
                   for n in os.listdir(tmp_path / "jax")}
    main(["rename", str(tmp_path / "port")])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(got)
