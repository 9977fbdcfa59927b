"""The port's synthetic scenes, PNG reader and ray-batch dataset against
the JAX package's (CPU).

The port renders the sphere scene in memory or writes it, and the hard
benchmark scenes, as IDR folders with its own PNG writer; it reads folders
with its own PNG reader, where the JAX package uses imageio.  Both must give
the same pixels, cameras, datasets and ray batches, bit for bit.
"""

import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.data import synthetic as jax_synthetic
from ndjir_tpu.data.cameras import generate_raydir_camloc as jax_rays
from ndjir_tpu.data.dataset import IDRDataset as JaxIDRDataset

from ndjir_torch.config import load_config
from ndjir_torch.data import synthetic
from ndjir_torch.data.cameras import generate_raydir_camloc
from ndjir_torch.data.dataset import IDRDataset, load_idr_folder
from ndjir_torch.data.synthetic import (
    make_synthetic_scene,
    render_sphere_scene,
)
from ndjir_torch.utils.png import decode_png, read_png

N_VIEWS, H, W = 5, 24, 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sphere"))
    jax_synthetic.make_synthetic_scene(path, n_views=N_VIEWS, H=H, W=W)
    return path, render_sphere_scene(n_views=N_VIEWS, H=H, W=W)


def test_sphere_scene_matches_the_written_one(scene):
    path, (images, masks, cameras) = scene
    for i in range(N_VIEWS):
        np.testing.assert_array_equal(
            images[i], imageio.imread(os.path.join(path, "image",
                                                   f"{i:06d}.png")))
        np.testing.assert_array_equal(
            masks[i], imageio.imread(os.path.join(path, "mask",
                                                  f"{i:06d}.png")))
    written = np.load(os.path.join(path, "cameras.npz"))
    for i in range(N_VIEWS):
        for k in (f"world_mat_{i}", f"scale_mat_{i}"):
            np.testing.assert_array_equal(cameras[k], written[k])


@pytest.mark.parametrize("mode", [
    [],                                          # uniform random pixels
    ["train.patch_ray_sampling=true"],           # 2^n x 2^m patches
    ["train.mask_ray_sample_ratio=0.6"],         # fg / bg stratified
])
def test_batches_and_rays_match(scene, mode):
    path, (images, masks, cameras) = scene
    ov = ["train.n_rays=32", f"data_path={path}"] + mode
    conf, jconf = load_config("default", ov), jax_load_config("default", ov)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    jds = JaxIDRDataset(jconf, train=True, shuffle=True)
    np.testing.assert_array_equal(ds.intrinsics, jds.intrinsics)
    np.testing.assert_array_equal(ds.poses, jds.poses)
    assert ds.iters_per_epoch == jds.iters_per_epoch
    for _ in range(4):           # crosses an epoch: the reshuffle too
        got, want = ds.next_batch(2), jds.next_batch(2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        color, mask, intrinsic, pose, xy = got
        for g, w in zip(generate_raydir_camloc(pose, intrinsic, xy),
                        jax_rays(pose, intrinsic, xy)):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the PNG reader
# ---------------------------------------------------------------------------

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(samples, ftypes, color_type, palette=None, depth=8,
            interlace=0, n_idat=1):
    """A PNG file of ``samples`` (H, W, bpp) uint8 with row ``ftypes``
    applied, the image data split over ``n_idat`` chunks."""
    H, W, bpp = samples.shape
    x = samples.reshape(H, W * bpp).astype(np.int64)
    up = np.concatenate([np.zeros((1, W * bpp), np.int64), x[:-1]])
    left = np.concatenate([np.zeros((H, bpp), np.int64), x[:, :-bpp]], 1)
    upleft = np.concatenate([np.zeros((H, bpp), np.int64), up[:, :-bpp]], 1)
    pred = [np.zeros_like(x), left, up, (left + up) // 2,
            _paeth(left, up, upleft)]
    rows = [np.concatenate([[t], (x[r] - pred[t][r]) % 256])
            for r, t in enumerate(ftypes)]
    z = zlib.compress(np.asarray(rows, np.uint8).tobytes())
    cut = np.linspace(0, len(z), n_idat + 1).astype(int)
    out = PNG_SIG + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    for a, b in zip(cut[:-1], cut[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


PNG_SIG = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6])
def test_png_reader_undoes_every_filter_and_color_type(ftype, color_type):
    rng = np.random.RandomState(color_type * 7 + (5 if ftype == "mixed"
                                                  else ftype))
    H, W, bpp = 9, 13, CHANNELS[color_type]     # odd width
    palette = None
    if color_type == 3:
        palette = rng.randint(0, 256, (200, 3)).astype(np.uint8)
        samples = rng.randint(0, 200, (H, W, 1)).astype(np.uint8)
        want = palette[samples[..., 0]]
    else:
        # smooth ramps and noise: every predictor sees a mix of cases
        yy, xx = np.mgrid[:H, :W]
        ramp = (17 * xx + 29 * yy)[..., None] + 40 * np.arange(bpp)
        samples = ((ramp + rng.randint(0, 60, (H, W, bpp))) % 256
                   ).astype(np.uint8)
        want = samples[..., 0] if bpp == 1 else samples
    ftypes = rng.randint(0, 5, H) if ftype == "mixed" else [ftype] * H
    got = decode_png(_encode(samples, ftypes, color_type, palette,
                             n_idat=3 if ftype == "mixed" else 1))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,shape", [
    ("L", (7, 11)), ("LA", (5, 9, 2)), ("RGB", (6, 13, 3)),
    ("RGBA", (8, 15, 4)), ("P", (7, 9, 3))])
def test_png_reader_reads_pil_files_as_imageio_does(mode, shape, tmp_path):
    from PIL import Image

    rng = np.random.RandomState(len(mode))
    arr = rng.randint(0, 256, shape).astype(np.uint8)
    img = (Image.fromarray(arr).quantize(200) if mode == "P"
           else Image.fromarray(arr, mode))
    path = str(tmp_path / "x.png")
    img.save(path)
    np.testing.assert_array_equal(read_png(path), imageio.imread(path))


@pytest.mark.parametrize("case,match", [
    ("16-bit", "bit depth 16"), ("interlaced", "interlaced"),
    ("crc", "CRC"), ("not a png", "not a PNG"),
    ("truncated", "truncated")])
def test_png_reader_refuses_what_it_does_not_read(case, match):
    samples = np.zeros((4, 5, 3), np.uint8)
    data = _encode(samples, [0] * 4, 2)
    if case == "16-bit":
        data = _encode(np.zeros((4, 10, 3), np.uint8), [0] * 4, 2, depth=16)
    elif case == "interlaced":
        data = _encode(samples, [0] * 4, 2, interlace=1)
    elif case == "crc":
        data = data[:-13] + bytes([data[-13] ^ 1]) + data[-12:]
    elif case == "not a png":
        data = b"GIF89a" + data[6:]
    else:
        data = data[:-20]
    with pytest.raises(ValueError, match=match):
        decode_png(data)


# ---------------------------------------------------------------------------
# synthetic scenes and the folder dataset
# ---------------------------------------------------------------------------

WRITERS = {"sphere": (make_synthetic_scene, jax_synthetic.make_synthetic_scene,
                      dict(n_views=2, H=16, W=24)),
           "v1": (synthetic.make_hard_synthetic_scene,
                  jax_synthetic.make_hard_synthetic_scene,
                  dict(n_views=2, H=20, W=16)),
           "v2": (synthetic.make_hard_synthetic_scene_v2,
                  jax_synthetic.make_hard_synthetic_scene_v2,
                  dict(n_views=2, H=16, W=16))}


@pytest.fixture(scope="module", params=list(WRITERS))
def written(request, tmp_path_factory):
    port_writer, jax_writer, kw = WRITERS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    port_writer(str(root / "port"), **kw)
    jax_writer(str(root / "jax"), **kw)
    return root, kw["n_views"]


def test_scene_files_decode_to_the_jax_packages(written):
    """Every PNG the JAX package writes (through imageio) reads back equal
    to ``imageio.imread``, and the port's files to the same pixels."""
    root, n = written
    for sub in ("image", "mask"):
        names = sorted(os.listdir(root / "jax" / sub))
        assert names == sorted(os.listdir(root / "port" / sub))
        assert len(names) == n
        for name in names:
            want = imageio.imread(root / "jax" / sub / name)
            np.testing.assert_array_equal(
                read_png(str(root / "jax" / sub / name)), want)
            np.testing.assert_array_equal(
                read_png(str(root / "port" / sub / name)), want)


def test_scene_arrays_are_the_jax_packages(written):
    root, _ = written
    for name in ("cameras.npz", "gt_sdf.npz"):
        if not os.path.exists(root / "jax" / name):
            assert name == "gt_sdf.npz"
            assert not os.path.exists(root / "port" / name)
            continue
        with np.load(root / "port" / name) as got, \
                np.load(root / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


@pytest.fixture(scope="module")
def idr_folder(tmp_path_factory):
    """A sphere folder with RGBA images, RGB masks and a scale matrix that
    is not the identity: the alpha drop, the mask average and the
    de-normalization all take part."""
    path = str(tmp_path_factory.mktemp("idr"))
    make_synthetic_scene(path, n_views=N_VIEWS, H=H, W=W)
    for i in range(N_VIEWS):
        name = f"{i:06d}.png"
        img = imageio.imread(os.path.join(path, "image", name))
        alpha = np.full(img.shape[:2] + (1,), 200, np.uint8)
        imageio.imwrite(os.path.join(path, "image", name),
                        np.concatenate([img, alpha], -1))
        m = imageio.imread(os.path.join(path, "mask", name))
        imageio.imwrite(os.path.join(path, "mask", name),
                        np.stack([m, m // 2, m], -1))
    cams = dict(np.load(os.path.join(path, "cameras.npz")))
    S = np.array([[0.8, 0, 0, 0.1], [0, 0.8, 0, -0.2], [0, 0, 0.8, 0.3],
                  [0, 0, 0, 1]], np.float32)
    for i in range(N_VIEWS):
        cams[f"world_mat_{i}"] = (cams[f"world_mat_{i}"]
                                  @ np.linalg.inv(S)).astype(np.float32)
        cams[f"scale_mat_{i}"] = S
    np.savez(os.path.join(path, "cameras.npz"), **cams)
    return path


def test_load_idr_folder_reads_what_imageio_reads(idr_folder):
    images, masks, cameras = load_idr_folder(idr_folder)
    assert images.shape == (N_VIEWS, H, W, 4) and masks.shape == (
        N_VIEWS, H, W, 3)
    for i in range(N_VIEWS):
        name = f"{i:06d}.png"
        np.testing.assert_array_equal(
            images[i], imageio.imread(os.path.join(idr_folder, "image",
                                                   name)))
        np.testing.assert_array_equal(
            masks[i], imageio.imread(os.path.join(idr_folder, "mask", name)))
    assert len(cameras) == 2 * N_VIEWS


@pytest.mark.parametrize("mode", [
    [],                                          # uniform random pixels
    ["train.patch_ray_sampling=true"],           # 2^n x 2^m patches
    ["train.mask_ray_sample_ratio=0.6"],         # fg / bg stratified
])
def test_folder_dataset_is_the_jax_packages(idr_folder, mode):
    ov = ["train.n_rays=32", f"data_path={idr_folder}"] + mode
    conf, jconf = load_config("default", ov), jax_load_config("default", ov)
    ds = IDRDataset.from_folder(conf, train=True, shuffle=True)
    jds = JaxIDRDataset(jconf, train=True, shuffle=True)
    for k in ("images", "masks", "intrinsics", "poses", "scale", "trans"):
        got, want = getattr(ds, k), getattr(jds, k)
        assert np.asarray(got).dtype == np.asarray(want).dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert ds.scale != 1.0 and ds.images.shape[-1] == 3
    # two epochs of 5 views in batches of 2: the reshuffles too
    for _ in range(5):
        for g, w in zip(ds.next_batch(2), jds.next_batch(2)):
            np.testing.assert_array_equal(g, w)
