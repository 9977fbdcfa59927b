"""Image folder tools: sequential renaming and mask application (the port's
counterpart of ``ndjir_tpu/tools/images.py``).

Parity surface with reference scripts/rename_images.sh and
apply_mask_to_image.py.  Images are read and written with the port's PNG
reader and writer (``utils/png.py``), so the folders hold PNG files.  Frame
extraction (cv2), mask creation (cv2, rembg) and deblurring (basicsr) are
not ported: the card's machine has none of those libraries.

Run: python -m ndjir_torch.tools.images <rename|apply-mask> ...
"""

from __future__ import annotations

import glob
import os

from ndjir_torch.utils.png import read_png, write_png


def rename_sequential(dir_path: str, ext: str = "png"):
    """Sequential zero-padded renaming (reference: rename_images.sh)."""
    files = sorted(glob.glob(os.path.join(dir_path, "*")))
    for i, f in enumerate(files):
        os.rename(f, os.path.join(dir_path, f"{i:06d}.{ext}"))
    print(f"Renamed {len(files)} files in {dir_path}")


def apply_mask_to_images(image_dir: str, mask_dir: str, out_dir: str):
    """Multiply masks into images (reference: apply_mask_to_image.py)."""
    os.makedirs(out_dir, exist_ok=True)
    for fi, fm in zip(sorted(glob.glob(os.path.join(image_dir, "*"))),
                      sorted(glob.glob(os.path.join(mask_dir, "*")))):
        img = read_png(fi)
        m = read_png(fm)
        if m.ndim == 3:
            m = m[..., 0]
        out = (img[..., :3] * (m > 127.5)[..., None]).astype("uint8")
        write_png(os.path.join(out_dir, os.path.basename(fi)), out)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("rename")
    r.add_argument("dir")
    a = sub.add_parser("apply-mask")
    a.add_argument("image_dir")
    a.add_argument("mask_dir")
    a.add_argument("out_dir")
    args = p.parse_args(argv)
    if args.cmd == "rename":
        rename_sequential(args.dir)
    elif args.cmd == "apply-mask":
        apply_mask_to_images(args.image_dir, args.mask_dir, args.out_dir)


if __name__ == "__main__":
    main()
