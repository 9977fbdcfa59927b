"""Render driver: ``render.image.render_image`` of ``ndjir_torch``, the
validation render and ``python -m ndjir_torch.cli render``: whole views of
the scene's cameras at ``valid.n_down_samples``, in chunks of
``valid.n_rays``, from weights drawn from the seed (no optimizer state,
as the command holds them).

Set-up draws the weights on the card, decomposes the scene's cameras as
the port's dataset does, and renders one chunk's worth of a view (the
same chunk shapes as a whole view) as the warm-up.  The window renders
views, cycling through the cameras from one drawn from the seed, until
``--seconds`` have passed; each ends in ``render_image``'s copy of the
maps to the host.  ``render_rays_per_s`` is the pixels of the whole views
over the time from the window's start to the end of the last one.

The comparison renders one of the window's views, drawn from the seed,
by the plain reference and compares the colour and normal maps.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List

import numpy as np

from benchmark import compare
from benchmark import scene as scene_mod


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cell = ctx.cell
        self.traffic = ctx.cell.traffic

    def setup(self) -> None:
        import torch
        from ndjir_torch.config import Config
        from benchmark.reference import weights
        from benchmark.reference.data.cameras import load_K_Rt_from_P

        ctx, sc = self.ctx, self.traffic["scene"]
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seeds["scene"])
        cams = scene_mod.camera_arrays(*scene_mod.cameras(sc, gen,
                                                          ctx.device))
        self.poses, self.intrinsics = [], []
        for i in range(int(sc["views"])):
            P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
            intrinsic, pose = load_K_Rt_from_P(P)
            self.poses.append(pose.astype(np.float32))
            self.intrinsics.append(intrinsic[:3, :3].astype(np.float32))
        self.resolution = (int(sc["width"]), int(sc["height"]))
        self.data = copy.deepcopy(self.cell.config["config"])
        self.conf = Config(self.data)
        self.params = weights.draw(self.data, ctx.seeds["weights"],
                                   ctx.device)
        self.first = ctx.seeds["sample"] % len(self.poses)
        # warm-up: the smallest view that is one whole chunk
        dn = 2 ** self.conf.valid.n_down_samples
        P = self.conf.valid.n_rays
        w = 25
        self._render(0, (w * dn, (P // w) * dn))
        self.views: List = []

    def _render(self, i: int, resolution):
        from ndjir_torch.render.image import render_image
        return render_image(self.params, self.poses[i][None],
                            self.intrinsics[i][None], resolution, self.conf,
                            return_aux=True)

    def window(self, seconds: float) -> Dict:
        dn = 2 ** self.conf.valid.n_down_samples
        W, H = self.resolution
        pixels = (W // dn) * (H // dn)
        t0 = time.perf_counter()
        n = 0
        while True:
            i = (self.first + n) % len(self.poses)
            out = self._render(i, self.resolution)
            self.views.append((i, out))
            n += 1
            end = time.perf_counter() - t0
            if end >= seconds:
                break
        failed = sum(1 for _, o in self.views
                     if not all(np.isfinite(a).all() for a in o))
        return {"kind": "render", "attempted": n, "failed": failed,
                "rays": n * pixels, "conf": self.data,
                "metrics": {"render_rays_per_s": n * pixels / end}}

    def release(self) -> None:
        del self.params

    def check(self, limits: Dict) -> List[Dict]:
        from benchmark.reference import follow

        rng = np.random.RandomState(self.ctx.seeds["sample"])
        i, prog = self.views[rng.randint(len(self.views))]
        ref = follow.render_view(self.data, self.ctx.seeds["weights"],
                                 self.poses[i][None],
                                 self.intrinsics[i][None], self.resolution,
                                 self.ctx.device,
                                 chunk=int(self.traffic["check_chunk"]))
        return compare.render_checks(prog, ref, limits)
